"""Prefill attention on the card: the wrapper of
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.

``flash_attention`` takes CUDA tensors only and launches the kernel or
raises; ``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.flash_attention``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
VALUE_WIDTHS = (16, 32, 64, 112, 128, 256)
MAX_HEAD_DIM = 256

launches = LaunchCounter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, K); k: (B, Skv, Hkv, K); v: (B, Skv, Hkv, Kv), all
    contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device. Returns (B, Sq, H, Kv) in that dtype. Any Sq and Skv: ragged
    tails are masked in the kernel."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}; "
                            f"need one of {DTYPES}, all equal")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a "
                             "contiguous 4-d tensor")
    B, Sq, H, K = q.shape
    Skv, Hkv, Kv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != K
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (need H % Hkv == 0)")
    if not 0 < K <= MAX_HEAD_DIM or Kv not in VALUE_WIDTHS:
        raise ValueError(f"flash_attention: head dims K={K} (1..."
                         f"{MAX_HEAD_DIM}), Kv={Kv} (one of {VALUE_WIDTHS})")
    out = torch.empty((B, Sq, H, Kv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = extension().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Hkv, K, Kv, bool(causal), int(window), K ** -0.5, float(softcap),
        q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "flash_attention")
    launches.add()
    return out

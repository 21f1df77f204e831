"""Decode attention on the card: the wrapper of
``csrc/decode_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.

``decode_attention`` takes CUDA tensors only and launches the kernel or
raises; ``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.decode_attention``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
# (G, K) the kernel is instantiated for: G = H / Hkv, G * K <= 512
GROUPS = (1, 2, 4, 8)
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP_WIDTH = 512

launches = LaunchCounter()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, K); k/v: (B, W, Hkv, K); valid: (B, W) bool, all
    contiguous CUDA tensors on one device, q/k/v of one dtype (float32 or
    bfloat16). Returns (B, H, K) in that dtype."""
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"decode_attention: {name} dtype {t.dtype}; "
                            f"need one of {DTYPES}, equal to q's")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attention: valid must be bool, "
                        f"got {valid.dtype}")
    if q.dim() != 3 or k.dim() != 4 or valid.dim() != 2:
        raise ValueError("decode_attention: need q (B,H,K), k/v (B,W,Hkv,K)"
                         ", valid (B,W)")
    B, H, K = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != K
            or valid.shape != (B, W) or Hkv == 0 or H % Hkv):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, valid "
                         f"{tuple(valid.shape)} do not match")
    G = H // Hkv
    if G not in GROUPS or K not in HEAD_DIMS or G * K > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: no kernel for G={G}, K={K} "
                         f"(G in {GROUPS}, K in {HEAD_DIMS}, "
                         f"G*K <= {MAX_GROUP_WIDTH})")
    out = torch.empty((B, H, K), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    err = extension().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), B, W, H, Hkv, K, K ** -0.5, float(softcap),
        q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "decode_attention")
    launches.add()
    return out

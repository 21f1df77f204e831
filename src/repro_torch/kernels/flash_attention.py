"""Prefill attention on the card: the wrappers of
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``, and of
``csrc/flash_attention_bwd.cu``, its gradient (JAX computes it in
``repro/kernels/flash_ref.py::_bwd_impl``, the custom VJP of its jnp
flash path; no Pallas kernel).

``flash_attention`` and ``flash_attention_bwd`` take CUDA tensors only and
launch their kernels or raise; ``kernels.ops`` sends CPU tensors to the
plain versions (``kernels.ref.flash_attention``, ``flash_attention_lse``
and ``flash_attention_bwd``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
VALUE_WIDTHS = (16, 32, 64, 112, 128, 256)
MAX_HEAD_DIM = 256

launches = LaunchCounter()
bwd_launches = LaunchCounter()
# the backward's tiles of 64 query rows and 64 keys in shared memory, as
# float32 rows padded by one word: Q, dO, K and V tiles, two score tiles
# and the rows' lse and delta (csrc/flash_attention_bwd.cu, smem_floats)
BWD_TILE = 64
MAX_SMEM = 232448


def bwd_smem_bytes(K: int, Kv: int) -> int:
    """Shared memory a backward block takes: K padded to 16 columns."""
    KP = -(-K // 16) * 16
    return 4 * (2 * BWD_TILE * (KP + 1 + Kv + 1)
                + 2 * BWD_TILE * (BWD_TILE + 1) + 2 * BWD_TILE)


def _check(name: str, t: torch.Tensor, like: torch.Tensor, dtypes,
           dim: int) -> None:
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"{name} must be a CUDA tensor on {like.device}, "
                         f"got {t.device}")
    if t.dtype != like.dtype or t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype}; need one of {dtypes}, "
                        "all equal")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d tensor")


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            what: str, dtypes) -> tuple:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(f"{what}: {name}", t, q, dtypes, 4)
    B, Sq, H, K = q.shape
    Skv, Hkv, Kv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != K
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (need H % Hkv == 0)")
    if not 0 < K <= MAX_HEAD_DIM or Kv not in VALUE_WIDTHS:
        raise ValueError(f"{what}: head dims K={K} (1..{MAX_HEAD_DIM}), "
                         f"Kv={Kv} (one of {VALUE_WIDTHS})")
    return B, Sq, Skv, H, Hkv, K, Kv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """q: (B, Sq, H, K); k: (B, Skv, Hkv, K); v: (B, Skv, Hkv, Kv), all
    contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device. Returns (B, Sq, H, Kv) in that dtype. Any Sq and Skv: ragged
    tails are masked in the kernel. With ``return_lse`` (float32 only: the
    backward's input) also each row's log-sum-exp, (B, H, Sq) float32,
    which the float32 body writes beside ``out`` without changing a bit
    of it."""
    B, Sq, Skv, H, Hkv, K, Kv = _shapes(q, k, v, "flash_attention", DTYPES)
    if return_lse and q.dtype != torch.float32:
        raise TypeError(f"flash_attention: no {q.dtype} backward kernel "
                        "(float32 only), so no log-sum-exp for it")
    out = torch.empty((B, Sq, H, Kv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        err = extension().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, Sq, Skv, H, Hkv, K, Kv,
            bool(causal), int(window), K ** -0.5, float(softcap),
            q.dtype == torch.bfloat16,
            torch.cuda.current_stream(q.device).cuda_stream)
        check_launch(err, "flash_attention")
        launches.add()
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``flash_attention`` at (q, k, v), given its
    ``out`` and ``lse`` (``return_lse``) and the output's gradient
    ``dout`` (B, Sq, H, Kv): float32 contiguous CUDA tensors, the masks as
    the forward's. Three CUDA kernels a call (a row pass for ``delta``,
    dq over KV tiles, dk and dv over query tiles with the G query heads of
    a kv head summed in one block), counted as one launch."""
    B, Sq, Skv, H, Hkv, K, Kv = _shapes(q, k, v, "flash_attention_bwd",
                                        (torch.float32,))
    for name, t, shape in (("out", out, (B, Sq, H, Kv)),
                           ("dout", dout, (B, Sq, H, Kv)),
                           ("lse", lse, (B, H, Sq))):
        _check(f"flash_attention_bwd: {name}", t, q, (torch.float32,),
               len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} of shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if bwd_smem_bytes(K, Kv) > MAX_SMEM:
        raise ValueError(f"flash_attention_bwd: K={K} with Kv={Kv} needs "
                         f"{bwd_smem_bytes(K, Kv)} bytes of shared memory "
                         f"a block, more than {MAX_SMEM}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B * H and (Sq or Skv):
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        err = extension().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, Sq, Skv, H, Hkv, K, Kv,
            bool(causal), int(window), K ** -0.5, float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
        check_launch(err, "flash_attention_bwd")
        bwd_launches.add()
    return dq, dk, dv

"""Decode attention on the card: the wrappers of
``csrc/decode_attention.cu``, which replaces the Pallas TPU kernels
``repro/kernels/decode_attention.py::decode_attention`` and
``::decode_attention_int8``.

``decode_attention`` and ``decode_attention_int8`` take CUDA tensors only
and launch their kernel or raise; ``kernels.ops`` sends CPU tensors to
the plain version (``kernels.ref.decode_attention``) instead.

``decode_attention`` (and ``paged_decode_attention``) run the split body
(``csrc/decode_split.cuh``), ``decode_attention_int8`` (and
``paged_decode_attention_int8``) the int8 split body
(``csrc/decode_int8_split.cuh``): blocks over ``SPLIT`` logical
positions of a row, then a merge pass over the splits in order, through
a float32 workspace this wrapper allocates; ``split_layout`` gives its
size, the same for both storages.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
# (G, K) the kernels are instantiated for: G = H / Hkv, G * K <= 512
GROUPS = (1, 2, 4, 8)
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP_WIDTH = 512
# positions a block of the split body covers (the kernel's P, which it
# checks against the value passed)
SPLIT = 64

launches = LaunchCounter()
int8_launches = LaunchCounter()


def check_cuda(name: str, q: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on q's
    device (``name`` is the caller's, for the message)."""
    for arg, t in {"q": q, **tensors}.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on "
                             f"{q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_kernel_shape(name: str, H: int, Hkv: int, K: int) -> None:
    """Raise unless the kernels are instantiated for G = H / Hkv and K."""
    G = H // Hkv
    if G not in GROUPS or K not in HEAD_DIMS or G * K > MAX_GROUP_WIDTH:
        raise ValueError(f"{name}: no kernel for G={G}, K={K} "
                         f"(G in {GROUPS}, K in {HEAD_DIMS}, "
                         f"G*K <= {MAX_GROUP_WIDTH})")


def split_layout(extent: int, B: int, Hkv: int, G: int,
                 K: int) -> tuple[int, tuple[int, ...]]:
    """The split body's splits a row and its workspace shape for rows of
    ``extent`` logical positions (W for the dense ring, nblk * bs for the
    pages): each (row, kv head, split) leaves G*K context floats, then
    each (row, kv head, split, query head) a max and a normaliser."""
    nsplit = -(-extent // SPLIT)
    return nsplit, (B * Hkv * nsplit * G * (K + 2),)


def check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor starts on 16 bytes (the split bodies read
    K/V rows in loads of up to 16 bytes)."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def check_int8(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               k_scale: torch.Tensor, v_scale: torch.Tensor) -> None:
    """The int8 kernels' storage: q in float32/bfloat16, int8 K/V, and
    float32 scales shaped like K/V without the head-dim axis."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: q dtype {q.dtype}; need one of {DTYPES}")
    for arg, t in (("k", k), ("v", v)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {arg} must be int8, got {t.dtype}")
    for arg, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.shape != k.shape[:-1]:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} does not "
                             f"match k {tuple(k.shape)} without its last "
                             "axis")


def _check_dense(name: str, q, k, v, valid) -> tuple[int, int, int, int, int]:
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be bool, got {valid.dtype}")
    if q.dim() != 3 or k.dim() != 4 or valid.dim() != 2:
        raise ValueError(f"{name}: need q (B,H,K), k/v (B,W,Hkv,K), "
                         "valid (B,W)")
    B, H, K = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != K
            or valid.shape != (B, W) or Hkv == 0 or H % Hkv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, valid "
                         f"{tuple(valid.shape)} do not match")
    check_kernel_shape(name, H, Hkv, K)
    return B, W, H, Hkv, K


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, K); k/v: (B, W, Hkv, K), 16-byte aligned; valid: (B, W)
    bool, all contiguous CUDA tensors on one device, q/k/v of one dtype
    (float32 or bfloat16). Returns (B, H, K) in that dtype."""
    check_cuda("decode_attention", q, k=k, v=v, valid=valid)
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"decode_attention: {name} dtype {t.dtype}; "
                            f"need one of {DTYPES}, equal to q's")
    B, W, H, Hkv, K = _check_dense("decode_attention", q, k, v, valid)
    check_aligned("decode_attention", k=k, v=v)
    _, shape = split_layout(W, B, Hkv, H // Hkv, K)
    out = torch.empty((B, H, K), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    work = torch.empty(shape, dtype=torch.float32, device=q.device)
    err = extension().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), work.data_ptr(), B, W, H, Hkv, K, SPLIT, K ** -0.5,
        float(softcap), q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "decode_attention")
    launches.add()
    return out


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, *,
                          softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, K) float32 or bfloat16; k/v: (B, W, Hkv, K) int8 codes;
    valid: (B, W) bool; k_scale/v_scale: (B, W, Hkv) float32, one scale
    per (slot, kv head), so a key is ``k.float() * k_scale[..., None]``.
    All contiguous CUDA tensors on one device, k/v 16-byte aligned.
    Returns (B, H, K) in q's dtype."""
    name = "decode_attention_int8"
    check_cuda(name, q, k=k, v=v, valid=valid, k_scale=k_scale,
               v_scale=v_scale)
    check_int8(name, q, k, v, k_scale, v_scale)
    B, W, H, Hkv, K = _check_dense(name, q, k, v, valid)
    check_aligned(name, k=k, v=v)
    _, shape = split_layout(W, B, Hkv, H // Hkv, K)
    out = torch.empty((B, H, K), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    work = torch.empty(shape, dtype=torch.float32, device=q.device)
    err = extension().decode_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, W, H, Hkv, K, SPLIT, K ** -0.5, float(softcap),
        q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, name)
    int8_launches.add()
    return out

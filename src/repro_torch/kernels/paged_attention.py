"""Paged decode attention on the card: the wrappers of
``csrc/paged_attention.cu``, which replaces the Pallas TPU kernels
``repro/kernels/paged_attention.py::paged_decode_attention`` and
``::paged_decode_attention_int8``.

``paged_decode_attention`` and ``paged_decode_attention_int8`` take CUDA
tensors only and launch their kernel or raise; ``kernels.ops`` sends CPU
tensors to the plain version (``kernels.ref.paged_decode_attention``)
instead. Each shares its body with its dense sibling (the split body
for ``paged_decode_attention``, the int8 split body for
``paged_decode_attention_int8``, each with the same ``SPLIT`` and
workspace), so each takes its sibling's (G, K): the split body's
``KERNEL_SHAPES``, the int8 split body's ``INT8_SHAPES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension
from repro_torch.kernels.decode_attention import (DTYPES, SPLIT,
                                                  check_aligned, check_cuda,
                                                  check_int8,
                                                  check_kernel_shape,
                                                  split_layout)

launches = LaunchCounter()
int8_launches = LaunchCounter()


def _check_paged(name: str, q, k_pages, v_pages, table, lengths, *,
                 int8: bool = False) -> tuple[int, int, int, int, int, int]:
    for arg, t in (("table", table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    if (q.dim() != 3 or k_pages.dim() != 4 or table.dim() != 2
            or lengths.dim() != 1):
        raise ValueError(f"{name}: need q (B,H,K), pages (P+1,bs,Hkv,K), "
                         "table (B,nblk), lengths (B,)")
    B, H, K = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    nblk = table.shape[1]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != K
            or table.shape[0] != B or lengths.shape[0] != B or Hkv == 0
            or H % Hkv or bs == 0):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"table {tuple(table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not match")
    check_kernel_shape(name, H, Hkv, K, int8=int8)
    return B, nblk, bs, H, Hkv, K


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, K); k_pages/v_pages: (P+1, bs, Hkv, K), 16-byte aligned;
    table: (B, nblk) int32 page indices; lengths: (B,) int32 live
    positions per row. All contiguous CUDA tensors on one device, q and
    the pages of one dtype (float32 or bfloat16). Returns (B, H, K) in
    that dtype. The table's values are not checked here (that would cost
    a host sync per call): every entry below a row's length must name a
    page of the pool."""
    name = "paged_decode_attention"
    check_cuda(name, q, k_pages=k_pages, v_pages=v_pages, table=table,
               lengths=lengths)
    for arg, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name}: {arg} dtype {t.dtype}; need one of "
                            f"{DTYPES}, equal to q's")
    B, nblk, bs, H, Hkv, K = _check_paged(name, q, k_pages, v_pages, table,
                                          lengths)
    check_aligned(name, k_pages=k_pages, v_pages=v_pages)
    _, shape = split_layout(nblk * bs, B, Hkv, H // Hkv, K)
    out = torch.empty((B, H, K), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    work = torch.empty(shape, dtype=torch.float32, device=q.device)
    err = extension().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, nblk, bs, H, Hkv, K, SPLIT, K ** -0.5,
        float(softcap), q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, name)
    launches.add()
    return out


def paged_decode_attention_int8(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                k_scale_pages: torch.Tensor,
                                v_scale_pages: torch.Tensor,
                                table: torch.Tensor, lengths: torch.Tensor,
                                *, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, K) float32 or bfloat16; k_pages/v_pages: (P+1, bs, Hkv,
    K) int8 codes; k_scale_pages/v_scale_pages: (P+1, bs, Hkv) float32,
    one scale per (position, kv head); table: (B, nblk) int32; lengths:
    (B,) int32. All contiguous CUDA tensors on one device, the code
    pages 16-byte aligned. Returns (B, H, K) in q's dtype. As for
    ``paged_decode_attention``, the table's values are not checked."""
    name = "paged_decode_attention_int8"
    check_cuda(name, q, k_pages=k_pages, v_pages=v_pages,
               k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
               table=table, lengths=lengths)
    check_int8(name, q, k_pages, v_pages, k_scale_pages, v_scale_pages)
    B, nblk, bs, H, Hkv, K = _check_paged(name, q, k_pages, v_pages, table,
                                          lengths, int8=True)
    check_aligned(name, k_pages=k_pages, v_pages=v_pages)
    _, shape = split_layout(nblk * bs, B, Hkv, H // Hkv, K)
    out = torch.empty((B, H, K), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    work = torch.empty(shape, dtype=torch.float32, device=q.device)
    err = extension().paged_decode_attention_int8(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale_pages.data_ptr(), v_scale_pages.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, nblk, bs, H, Hkv, K, SPLIT, K ** -0.5,
        float(softcap), q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, name)
    int8_launches.add()
    return out

"""Paged decode attention on the card: the wrapper of
``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention``.

``paged_decode_attention`` takes CUDA tensors only and launches the kernel
or raises; ``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.paged_decode_attention``) instead. The kernel shares its
body with the dense decode kernel, so it takes the same (G, K).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension
from repro_torch.kernels.decode_attention import (DTYPES, GROUPS, HEAD_DIMS,
                                                  MAX_GROUP_WIDTH)

launches = LaunchCounter()


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, K); k_pages/v_pages: (P+1, bs, Hkv, K); table: (B, nblk)
    int32 page indices; lengths: (B,) int32 live positions per row. All
    contiguous CUDA tensors on one device, q and the pages of one dtype
    (float32 or bfloat16). Returns (B, H, K) in that dtype. The table's
    values are not checked here (that would cost a host sync per call):
    every entry below a row's length must name a page of the pool."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("lengths", lengths)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} must be a "
                             f"CUDA tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"paged_decode_attention: {name} dtype "
                            f"{t.dtype}; need one of {DTYPES}, equal to q's")
    for name, t in (("table", table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode_attention: {name} must be int32, "
                            f"got {t.dtype}")
    if (q.dim() != 3 or k_pages.dim() != 4 or table.dim() != 2
            or lengths.dim() != 1):
        raise ValueError("paged_decode_attention: need q (B,H,K), pages "
                         "(P+1,bs,Hkv,K), table (B,nblk), lengths (B,)")
    B, H, K = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    nblk = table.shape[1]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != K
            or table.shape[0] != B or lengths.shape[0] != B or Hkv == 0
            or H % Hkv or bs == 0):
        raise ValueError(f"paged_decode_attention: shapes q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}, table "
                         f"{tuple(table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not match")
    G = H // Hkv
    if G not in GROUPS or K not in HEAD_DIMS or G * K > MAX_GROUP_WIDTH:
        raise ValueError(f"paged_decode_attention: no kernel for G={G}, "
                         f"K={K} (G in {GROUPS}, K in {HEAD_DIMS}, "
                         f"G*K <= {MAX_GROUP_WIDTH})")
    out = torch.empty((B, H, K), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    err = extension().paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, nblk, bs,
        H, Hkv, K, K ** -0.5, float(softcap), q.dtype == torch.bfloat16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "paged_decode_attention")
    launches.add()
    return out

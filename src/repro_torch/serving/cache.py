"""The engine's dense KV cache: one private (max_len, ...) row per slot.

A port of ``repro.serving.cache.DenseCache``. A row is the reservation,
so there is nothing to allocate or free; ``insert`` copies prefill rows
into their slots in place (JAX donated the cache to a jitted scatter).
The paged cache and its block allocator come with the next slice.
"""
from __future__ import annotations

import torch


class DenseCache:
    """Row-per-slot cache over a model's per-layer ``{"k", "v"}`` tensors
    of shape (n_rows, max_len, Hkv, hd)."""

    def __init__(self, tree: list, n_rows: int):
        self.tree = tree
        self.n_rows = n_rows

    def insert(self, src_cache: list, rows: list[int],
               offset: int = 0) -> None:
        """Copy whole prefill rows (one per admitted request, same layout)
        into the engine cache at ``rows``, in place."""
        if offset:
            raise ValueError("DenseCache rows always start at position 0")
        idx = torch.as_tensor(rows, dtype=torch.long,
                              device=self.tree[0]["k"].device)
        for dst, src in zip(self.tree, src_cache):
            for name, t in dst.items():
                t.index_copy_(0, idx, src[name].to(t.dtype))

"""Paged KV-cache layout: fixed-size blocks + per-sequence block tables.

A port of the attention and MLA groups of ``repro.models.cache``. The dense cache
gives every sequence a private ``(max_len, ...)`` row; the paged layout
breaks the cache into ``block_size``-token physical pages shared by all
sequences, and each sequence holds a row of page indices (the block
table), paying only for the blocks its live prefix covers.

Per-layer group::

    {"table": (B, nblk) int32,
     "k_pages"/"v_pages": (P+1, block_size, Hkv, hd)}

and with ``kv_cache_dtype="int8"`` int8 pages plus
``"k_scale_pages"``/``"v_scale_pages"``: (P+1, block_size, Hkv) float32,
one scale per (position, kv head), reached through the same table. An
MLA layer's group holds latent pages instead::

    {"table": (B, nblk) int32,
     "ckv_pages": (P+1, block_size, r), "k_rope_pages": (P+1, block_size, dr)}

with ``nblk = max_len // block_size`` and ``P = max_blocks``. Page ``P``
is the SCRATCH page: unreserved table entries point at it, so lockstep
decode writes for idle or finished rows land there. Attention never reads
past a row's length, so scratch and unowned pages are never read.

A whisper layer nests its self attention's group under ``"self"`` beside
its memory rows, which never page (``groups`` flattens such a tree).

One logical block spans every layer, so the port keeps ONE table tensor
that every layer's group refers to (JAX stacks a replica per layer); a
table write is then one write, not one per layer.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static description of a paged cache: ``max_blocks`` physical pages
    of ``block_size`` tokens, shared by every pageable layer group."""
    block_size: int = 16
    max_blocks: int = 64

    def __post_init__(self):
        if self.block_size < 1 or self.max_blocks < 1:
            raise ValueError("block_size and max_blocks must be >= 1")

    @property
    def scratch_page(self) -> int:
        """Index of the write-sink page for unreserved table entries."""
        return self.max_blocks

    def n_blocks(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return -(-n_tokens // self.block_size)


def pageable(window: int, max_len: int) -> bool:
    """True when a cache window covers the whole horizon (the ring never
    wraps, so slot == position and the layer pages exactly)."""
    return window == 0 or window >= max_len


def new_table(batch: int, max_len: int, layout: PagedLayout,
              device: torch.device) -> torch.Tensor:
    """A (batch, nblk) block table with every entry on the scratch page."""
    if max_len % layout.block_size:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"block_size={layout.block_size}")
    return torch.full((batch, max_len // layout.block_size),
                      layout.scratch_page, dtype=torch.int32, device=device)


def init_paged_attn_cache(cfg: ArchConfig, table: torch.Tensor,
                          layout: PagedLayout, dtype: torch.dtype) -> dict:
    """One layer's paged group over the shared ``table`` (full-window
    caches only), in ``dtype`` or as int8 pages with scale pages."""
    shape = (layout.max_blocks + 1, layout.block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        dev = table.device
        return {"table": table,
                "k_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale_pages": torch.zeros(shape[:-1], device=dev),
                "v_scale_pages": torch.zeros(shape[:-1], device=dev)}
    return {"table": table,
            "k_pages": torch.zeros(shape, dtype=dtype, device=table.device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=table.device)}


def init_paged_mla_cache(cfg: ArchConfig, table: torch.Tensor,
                         layout: PagedLayout, dtype: torch.dtype) -> dict:
    """One MLA layer's latent and rope-key pages over the shared
    ``table``; decode gathers them into the logical view and runs the
    dense latent kernel (``models.attention.mla_decode``)."""
    n = layout.max_blocks + 1
    return {"table": table,
            "ckv_pages": torch.zeros((n, layout.block_size,
                                      cfg.kv_lora_rank), dtype=dtype,
                                     device=table.device),
            "k_rope_pages": torch.zeros((n, layout.block_size,
                                         cfg.qk_rope_head_dim), dtype=dtype,
                                        device=table.device)}


def is_paged_group(cache: dict) -> bool:
    """A per-layer cache dict built by one of the paged constructors."""
    return "k_pages" in cache or "ckv_pages" in cache


def groups(tree: list) -> list[dict]:
    """A cache tree's groups, in order: each layer's dict, or for a layer
    that nests its self attention's group under ``"self"`` (whisper) that
    group, then a dict of the layer's other leaves (its memory rows, the
    same tensors). Two trees of one model give groups that pair up."""
    out = []
    for layer in tree:
        if "self" in layer:
            out.append(layer["self"])
            out.append({k: v for k, v in layer.items() if k != "self"})
        else:
            out.append(layer)
    return out

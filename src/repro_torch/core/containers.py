"""Container counts and their memory budgets.

The port's own copy of the numpy-only parts of ``repro.core.containers``
(``ContainerSpec``, ``factorizations``, the per-chip weight and KV-block
budgets, ``feasible_counts`` and ``partition_indices``), plus the card's
counterpart of the TPU sub-mesh budget: ``card_feasible_counts``.

On a TPU pod a container is a sub-mesh that holds its own weight replica.
On one card the port's containers share the card: thread containers share
one weight copy in the process, and process containers map the parent's
one copy over CUDA IPC. What each container adds is its engine: its cache
(``engine_cache_bytes``, from the shapes the port's caches allocate), its
chunk buffers, its decode graph's private pool and a cuBLAS workspace for
its (thread, stream) pair. ``card_feasible_counts`` is the set of counts
whose engines fit beside the one weight copy; the scheduler searches it,
as the TPU budget capped the paper's TX2 at 6 containers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

MIB = 1 << 20
# a decode graph's private pool: 23-65 MB measured on an H100 for the
# ported models' engines, so 64 MiB a container is reserved
GRAPH_POOL_RESERVE_BYTES = 64 * MIB
# cuBLAS's workspace for each (thread handle, stream) pair on Hopper
CUBLAS_WORKSPACE_BYTES = 32 * MIB


@dataclasses.dataclass(frozen=True)
class ContainerSpec:
    n_containers: int
    chips_per_container: int
    total_chips: int

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return (self.n_containers, self.chips_per_container)


def factorizations(total_chips: int, max_containers: int | None = None
                   ) -> list[ContainerSpec]:
    """All 2^k factorisations n × (chips/n) of the pod."""
    out = []
    n = 1
    while n <= total_chips:
        if max_containers is None or n <= max_containers:
            out.append(ContainerSpec(n, total_chips // n, total_chips))
        n *= 2
    return out


def weight_bytes_per_chip(cfg: ArchConfig, spec: ContainerSpec,
                          bytes_per_param: int = 2) -> float:
    """Weights are sharded inside a container, replicated across them."""
    return cfg.param_count() * bytes_per_param / spec.chips_per_container


def _pageable_window(window: int, max_len: int) -> bool:
    # mirror of models.cache.pageable without a core -> models import
    return window == 0 or window >= max_len


def kv_cache_bytes_per_token(cfg: ArchConfig, *, max_len: int = 512,
                             dtype_bytes: int = 2) -> float:
    """Bytes of paged KV cache one context token costs across all pageable
    layers (a logical block spans every layer, so a block costs
    ``block_size ×`` this). Counts exactly the groups the paged engine
    pages: full-horizon attention / MLA layers; SSM states, genuinely
    sliding windows and whisper encoder memories are per-SEQUENCE costs,
    not per-token, and are excluded."""
    attn_tok = 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    if cfg.kv_cache_dtype == "int8":
        # int8 pages + one f32 absmax scale per (token, kv head) for k and v
        attn_tok = 2 * cfg.n_kv_heads * (cfg.head_dim + 4)
    mla_tok = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * dtype_bytes
    win_ok = _pageable_window(cfg.sliding_window, max_len)
    if cfg.arch_type == "audio":
        return cfg.n_layers * attn_tok          # decoder self-attn, W=max_len
    if cfg.arch_type == "hybrid":
        return (cfg.n_layers // cfg.shared_attn_every) * attn_tok
    if cfg.arch_type == "ssm":
        return 0.0
    if cfg.is_moe:
        return cfg.n_layers * (mla_tok if cfg.mla else
                               (attn_tok if win_ok else 0.0))
    if cfg.local_global_pattern:
        per = cfg.local_global_pattern + 1
        n_global = cfg.n_layers // per
        n_local = cfg.n_layers - n_global
        return (n_global + (n_local if win_ok else 0)) * attn_tok
    return cfg.n_layers * attn_tok if win_ok else 0.0


def kv_block_bytes(cfg: ArchConfig, block_size: int = 16, *,
                   max_len: int = 512, dtype_bytes: int = 2) -> float:
    """HBM cost of ONE logical KV block (summed over all pageable layers)."""
    return block_size * kv_cache_bytes_per_token(cfg, max_len=max_len,
                                                 dtype_bytes=dtype_bytes)


def feasible(cfg: ArchConfig, spec: ContainerSpec, hbm_bytes: float = 16e9,
             activation_headroom: float = 0.35,
             extra_bytes_per_chip: float = 0.0, kv_blocks: int = 0,
             block_size: int = 16, kv_dtype_bytes: int = 2,
             max_len: int = 512, prefix_cached_blocks: int = 0) -> bool:
    """Does one container's weight shard (+KV/activations) fit per chip?
    ``kv_blocks > 0`` adds the block-granular paged-cache pool (shared
    inside a container, so divided over its chips) — the memory model the
    paged engine actually allocates, replacing the n_slots × max_len
    dense worst case. ``prefix_cached_blocks`` budgets a resident
    prefix-cache working set ON TOP of the concurrency pool: those blocks
    stay allocated between requests (refcount-held by the cache index),
    so a deployment sized for ``kv_blocks`` of in-flight state plus R
    cached blocks must fit ``kv_blocks + R``."""
    need = weight_bytes_per_chip(cfg, spec) + extra_bytes_per_chip
    if kv_blocks or prefix_cached_blocks:
        need += ((kv_blocks + prefix_cached_blocks)
                 * kv_block_bytes(cfg, block_size, max_len=max_len,
                                  dtype_bytes=kv_dtype_bytes)
                 / spec.chips_per_container)
    return need <= hbm_bytes * (1.0 - activation_headroom)


def feasible_counts(cfg: ArchConfig, total_chips: int,
                    hbm_bytes: float = 16e9,
                    max_containers: int | None = None,
                    activation_headroom: float = 0.35,
                    extra_bytes_per_chip: float = 0.0, kv_blocks: int = 0,
                    block_size: int = 16, kv_dtype_bytes: int = 2,
                    max_len: int = 512,
                    prefix_cached_blocks: int = 0) -> list[int]:
    """Container counts the online scheduler may search: the power-of-two
    factorisations of the pod whose per-chip weight shard (+headroom) fits
    — the memory bound that capped the paper's TX2 at 6 containers. With
    ``kv_blocks`` set, each container additionally budgets its paged KV
    pool (plus ``prefix_cached_blocks`` of resident prefix-cache working
    set), so DivideAndSaveScheduler sees the block-granular frontier."""
    return [s.n_containers
            for s in factorizations(total_chips, max_containers)
            if feasible(cfg, s, hbm_bytes, activation_headroom,
                        extra_bytes_per_chip, kv_blocks, block_size,
                        kv_dtype_bytes, max_len, prefix_cached_blocks)]


def partition_indices(total_chips: int, n_containers: int) -> list[range]:
    """Pure index partition behind ``container_meshes``: ``n`` contiguous,
    equal, disjoint ranges covering ``range(total_chips)`` — the device-set
    invariant the property tests pin down without needing devices."""
    if n_containers <= 0:
        raise ValueError("n_containers must be positive")
    if total_chips % n_containers != 0:
        raise ValueError(
            f"{n_containers} containers do not divide {total_chips} chips")
    per = total_chips // n_containers
    return [range(i * per, (i + 1) * per) for i in range(n_containers)]


def _itemsize(dtype) -> int:
    """Bytes of one element of a torch dtype (or of anything with an
    ``itemsize``), read without importing torch."""
    return int(dtype.itemsize)


def engine_cache_bytes(cfg: ArchConfig, engine_config) -> int:
    """Bytes of the cache one port engine allocates for ``cfg`` under
    ``engine_config`` (a ``serving.engine.EngineConfig``), leaf by leaf as
    ``Model.init_cache`` builds it: dense rows ``(n_rows, max_len, ...)``,
    or ``max_blocks + 1`` pages of ``block_size`` positions and one
    shared int32 block table; a sliding-window ring ``(n_rows,
    min(window, max_len), ...)`` under either cache; int8 codes with
    float32 scales for an int8 cache; latent rows or pages for MLA (which
    ignores the int8 option); conv and state rows, ``n_rows`` of them,
    for each SSM layer under either cache (a hybrid model's beside the
    attention groups of its shared block's applications); whisper's
    memory rows, ``(n_rows, encoder_seq, Hkv, hd)`` keys and values a
    decoder layer in ``dtype`` (an int8 cache too) under either cache,
    beside its self attention's groups."""
    ec = engine_config
    item = _itemsize(ec.dtype)
    rows, L = ec.n_rows, cfg.n_layers
    ssm_bytes = 0
    if cfg.is_ssm:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
        per_row = ((cfg.ssm_conv_width - 1) * conv_dim
                   + cfg.ssm_n_heads * cfg.ssm_head_dim * cfg.ssm_state)
        ssm_bytes = L * rows * per_row * item
        if cfg.arch_type == "ssm":
            return ssm_bytes
        L = cfg.n_layers // cfg.shared_attn_every   # attention groups
    if cfg.mla:
        per_pos = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * item
    elif cfg.kv_cache_dtype == "int8":
        per_pos = 2 * cfg.n_kv_heads * (cfg.head_dim + 4)
    else:
        per_pos = 2 * cfg.n_kv_heads * cfg.head_dim * item
    # a sliding ring (window < max_len; MLA takes none) is dense rows
    # min(window, max_len) wide under either cache; the other groups are
    # max_len-wide rows or pages over one shared table
    windows = ([0] * L if cfg.mla or cfg.is_ssm
               else cfg.layer_windows())
    rings = [w for w in windows if 0 < w < ec.max_len]
    n_full = L - len(rings)
    if ec.cache == "paged":
        full = (ec.resolved_max_blocks + 1) * ec.block_size
        table = rows * (ec.max_len // ec.block_size) * 4 if n_full else 0
    else:
        full, table = rows * ec.max_len, 0
    memory = (L * rows * 2 * cfg.encoder_seq * cfg.n_kv_heads
              * cfg.head_dim * item if cfg.arch_type == "audio" else 0)
    return (ssm_bytes + memory + (n_full * full + rows * sum(rings))
            * per_pos + table)


def chunk_buffer_bytes(engine_config) -> int:
    """Bytes of an engine's chunk state on the card
    (``Model.chunk_buffers``: one int32 tensor of ``5 B + 6 + chunk B``
    elements over ``B`` rows)."""
    B = engine_config.n_rows
    return (5 * B + 6 + engine_config.chunk_tokens * B) * 4


def container_bytes(cfg: ArchConfig, engine_config) -> int:
    """What one container adds on the card: its engine's cache and chunk
    buffers, the graph-pool reserve and one cuBLAS workspace."""
    return (engine_cache_bytes(cfg, engine_config)
            + chunk_buffer_bytes(engine_config)
            + GRAPH_POOL_RESERVE_BYTES + CUBLAS_WORKSPACE_BYTES)


def card_feasible_counts(cfg: ArchConfig, engine_config, *,
                         card_bytes: int, max_containers: int,
                         headroom: float = 0.35) -> list[int]:
    """The power-of-two container counts ``n <= max_containers`` whose
    engines fit on one card beside ONE shared copy of the weights:
    ``weights + n * container_bytes <= card_bytes * (1 - headroom)``.
    ``card_bytes`` is the caller's (on the card,
    ``torch.cuda.get_device_properties(0).total_memory``); the headroom
    keeps room for activations and the allocator's slack, as the TPU
    budget's does."""
    weights = cfg.param_count() * _itemsize(engine_config.dtype)
    per = container_bytes(cfg, engine_config)
    budget = card_bytes * (1.0 - headroom)
    out, n = [], 1
    while n <= max_containers:
        if weights + n * per <= budget:
            out.append(n)
        n *= 2
    return out

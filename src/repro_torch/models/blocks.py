"""The residual blocks, as ``repro.models.blocks``: the dense block
(pre-norm attention + MLP, gated or not, its activation the config's
``act``: prefill into the cache, residual-suffix prefill behind a shared
prefix, one-token decode; ``attn_mlp_*``), the MoE block (pre-norm
attention + mixture of experts; ``attn_moe_*``), the SSM block (pre-norm
Mamba2; ``ssm_*``), and whisper's encoder layer (the dense block, not
causal; ``encoder_fwd``) and decoder layer (self attention, cross
attention over the encoder's output, MLP; ``cross_*``). Attention is
GQA or, when the layer's parameters hold ``w_dkv``, DeepSeek's MLA over
the latent cache; a config with ``mla`` builds MLA in its dense layers
too. A prefill takes its layer's
``window`` (0: full horizon), and ``init_block_cache`` builds the
layer's cache group for that window."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import cache as paged
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, init_norm, mlp_fwd, norm_fwd


def _init_attn(cfg: ArchConfig, dtype: torch.dtype,
               generator: torch.Generator) -> dict:
    return (attn.init_mla if cfg.mla else attn.init_attn)(cfg, dtype,
                                                          generator)


def _attn_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  cache: dict, window: int) -> torch.Tensor:
    if "w_dkv" in p:
        return attn.mla_prefill_into_cache(p, cfg, x, cache)
    return attn.attn_prefill_into_cache(p, cfg, x, cache, window=window)


def _attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                 pos: torch.Tensor) -> torch.Tensor:
    if "w_dkv" in p:
        return attn.mla_decode(p, cfg, x, cache, pos)
    return attn.attn_decode(p, cfg, x, cache, pos)


def init_attn_mlp(cfg: ArchConfig, dtype: torch.dtype,
                  generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
            "attn": _init_attn(cfg, dtype, generator),
            "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                            cfg.mlp_gated)}


def attn_mlp_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache: dict, *, window: int = 0) -> torch.Tensor:
    x = x + _attn_prefill(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache,
                          window)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x), cfg.act)


def attn_mlp_suffix_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                            cache: dict, ctx_k: torch.Tensor,
                            ctx_v: torch.Tensor, offset: int) -> torch.Tensor:
    x = x + attn.attn_suffix_prefill_into_cache(
        p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache, ctx_k, ctx_v,
        offset)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x), cfg.act)


def attn_mlp_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                    pos: torch.Tensor) -> torch.Tensor:
    x = x + _attn_decode(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache,
                         pos)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x), cfg.act)


def init_attn_moe(cfg: ArchConfig, dtype: torch.dtype,
                  generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
            "attn": _init_attn(cfg, dtype, generator),
            "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
            "moe": moe_lib.init_moe(cfg, dtype, generator)}


def attn_moe_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache: dict, *, window: int = 0) -> torch.Tensor:
    x = x + _attn_prefill(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache,
                          window)
    return x + moe_lib.moe_fwd(p["moe"], cfg, norm_fwd(cfg, p["ln2"], x))


def attn_moe_suffix_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                            cache: dict, ctx_k: torch.Tensor,
                            ctx_v: torch.Tensor, offset: int) -> torch.Tensor:
    """GQA only: the engine shares no prefix of a latent cache."""
    x = x + attn.attn_suffix_prefill_into_cache(
        p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache, ctx_k, ctx_v,
        offset)
    return x + moe_lib.moe_fwd(p["moe"], cfg, norm_fwd(cfg, p["ln2"], x))


def attn_moe_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                    pos: torch.Tensor) -> torch.Tensor:
    x = x + _attn_decode(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache,
                         pos)
    return x + moe_lib.moe_fwd(p["moe"], cfg, norm_fwd(cfg, p["ln2"], x))


def init_block_cache(cfg: ArchConfig, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device, *,
                     window: int = 0, table: torch.Tensor | None = None,
                     layout: paged.PagedLayout | None = None) -> dict:
    """One attention layer's cache group, by JAX's rule: with a
    ``layout``, a group whose window covers the horizon
    (``cache.pageable``) pages over the shared ``table``; a genuinely
    sliding ring (W < max_len) has no block-table form and stays dense
    rows, ``batch`` of them. Without a layout: a ring ``min(window,
    max_len)`` wide with a window (``attention.init_attn_cache``), or MLA
    latent rows (an MLA layer takes no window)."""
    if layout is not None and paged.pageable(window, max_len):
        init = (paged.init_paged_mla_cache if cfg.mla
                else paged.init_paged_attn_cache)
        return init(cfg, table, layout, dtype)
    if cfg.mla:
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device)
    return attn.init_attn_cache(cfg, batch, max_len, dtype, device,
                                window=window)


def init_ssm_block(cfg: ArchConfig, dtype: torch.dtype,
                   generator: torch.Generator) -> dict:
    return {"ln": init_norm(cfg, cfg.d_model, dtype, generator.device),
            "mamba": ssm_lib.init_mamba2(cfg, dtype, generator)}


def ssm_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                cache: dict, *, window: int = 0) -> torch.Tensor:
    """Builds the layer's cache (conv tail + final state) from scratch."""
    del window  # an SSM layer attends over nothing
    return x + ssm_lib.mamba2_fwd(p["mamba"], cfg, norm_fwd(cfg, p["ln"], x),
                                  cache)


def ssm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> torch.Tensor:
    del pos  # SSM state is position-free
    return x + ssm_lib.mamba2_decode(p["mamba"], cfg,
                                     norm_fwd(cfg, p["ln"], x), cache)


# ---------------------------------------------------------------------------
# whisper encoder / decoder layers
# ---------------------------------------------------------------------------
def encoder_fwd(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """One encoder layer (``init_attn_mlp``'s parameters), not causal,
    in x's dtype."""
    x = x + attn.attn_prefill(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x),
                              causal=False)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x), cfg.act)


def init_cross_block(cfg: ArchConfig, dtype: torch.dtype,
                     generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
            "self_attn": attn.init_attn(cfg, dtype, generator),
            "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
            "cross_attn": attn.init_attn(cfg, dtype, generator),
            "ln3": init_norm(cfg, cfg.d_model, dtype, dev),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                            cfg.mlp_gated)}


def cross_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  memory: torch.Tensor, cache: dict) -> torch.Tensor:
    """A decoder layer's prefill: causal self attention into
    ``cache["self"]``, cross attention over ``memory`` (the encoder's
    output, in its own dtype: float32 frames give float32 keys and
    values, which this prefill's cross attention reads before
    ``mem_k``/``mem_v`` store them in the cache's dtype, as JAX's engine
    stores its prefill's float32 memory), then the MLP."""
    x = x + attn.attn_prefill_into_cache(
        p["self_attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache["self"])
    k, v = attn.cross_attn_memory(p["cross_attn"], cfg, memory)
    x = x + attn.cross_attn_prefill(p["cross_attn"], cfg,
                                    norm_fwd(cfg, p["ln2"], x), k, v)
    cache["mem_k"].copy_(k)
    cache["mem_v"].copy_(v)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln3"], x), cfg.act)


def cross_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                 pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """A decoder layer's decode step: self attention over
    ``cache["self"]`` (the dense ring or the pages), cross attention over
    the stored memory rows (``valid``: the step's all-true mask), then
    the MLP."""
    x = x + attn.attn_decode(p["self_attn"], cfg,
                             norm_fwd(cfg, p["ln1"], x), cache["self"], pos)
    x = x + attn.cross_attn_decode(p["cross_attn"], cfg,
                                   norm_fwd(cfg, p["ln2"], x),
                                   cache["mem_k"], cache["mem_v"], valid)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln3"], x), cfg.act)


def init_cross_cache(cfg: ArchConfig, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device, *,
                     table: torch.Tensor | None = None,
                     layout: paged.PagedLayout | None = None) -> dict:
    """A decoder layer's cache, as JAX nests it: the self attention's
    group (``"self"``: paged over the shared ``table`` with a layout,
    else a dense ring ``max_len`` wide; int8 with an int8 cache) beside
    the memory rows ``"mem_k"``/``"mem_v"`` (batch, encoder_seq, Hkv,
    hd) in ``dtype``, which no layout pages."""
    mem = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"self": init_block_cache(cfg, batch, max_len, dtype, device,
                                     table=table, layout=layout),
            "mem_k": torch.zeros(mem, dtype=dtype, device=device),
            "mem_v": torch.zeros(mem, dtype=dtype, device=device)}

"""The residual blocks, as ``repro.models.blocks``: the dense block
(pre-norm attention + SwiGLU MLP: prefill into the cache, residual-suffix
prefill behind a shared prefix, one-token decode; ``attn_mlp_*``), the
MoE block (pre-norm attention + mixture of experts; ``attn_moe_*``) and
the SSM block (pre-norm Mamba2; ``ssm_*``). Attention is GQA or, when the
layer's parameters hold ``w_dkv``, DeepSeek's MLA over the latent cache;
a config with ``mla`` builds MLA in its dense layers too."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, init_norm, mlp_fwd, norm_fwd


def _init_attn(cfg: ArchConfig, dtype: torch.dtype,
               generator: torch.Generator) -> dict:
    return (attn.init_mla if cfg.mla else attn.init_attn)(cfg, dtype,
                                                          generator)


def _attn_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  cache: dict) -> torch.Tensor:
    if "w_dkv" in p:
        return attn.mla_prefill_into_cache(p, cfg, x, cache)
    return attn.attn_prefill_into_cache(p, cfg, x, cache)


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
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, dtype, generator)}


def attn_mlp_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache: dict) -> torch.Tensor:
    x = x + _attn_prefill(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x))


def attn_mlp_suffix_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                            cache: dict, ctx_k: torch.Tensor,
                            ctx_v: torch.Tensor, offset: int) -> torch.Tensor:
    x = x + attn.attn_suffix_prefill_into_cache(
        p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache, ctx_k, ctx_v,
        offset)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x))


def attn_mlp_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                    pos: torch.Tensor) -> torch.Tensor:
    x = x + _attn_decode(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache,
                         pos)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x))


def init_attn_moe(cfg: ArchConfig, dtype: torch.dtype,
                  generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
            "attn": _init_attn(cfg, dtype, generator),
            "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
            "moe": moe_lib.init_moe(cfg, dtype, generator)}


def attn_moe_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache: dict) -> torch.Tensor:
    x = x + _attn_prefill(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x), cache)
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


def init_ssm_block(cfg: ArchConfig, dtype: torch.dtype,
                   generator: torch.Generator) -> dict:
    return {"ln": init_norm(cfg, cfg.d_model, dtype, generator.device),
            "mamba": ssm_lib.init_mamba2(cfg, dtype, generator)}


def ssm_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                cache: dict) -> torch.Tensor:
    """Builds the layer's cache (conv tail + final state) from scratch."""
    return x + ssm_lib.mamba2_fwd(p["mamba"], cfg, norm_fwd(cfg, p["ln"], x),
                                  cache)


def ssm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> torch.Tensor:
    del pos  # SSM state is position-free
    return x + ssm_lib.mamba2_decode(p["mamba"], cfg,
                                     norm_fwd(cfg, p["ln"], x), cache)

"""The residual blocks, as ``repro.models.blocks``: the dense block
(pre-norm attention + SwiGLU MLP: prefill into the cache, residual-suffix
prefill behind a shared prefix, one-token decode; ``attn_mlp_*``) and the
SSM block (pre-norm Mamba2; ``ssm_*``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, init_norm, mlp_fwd, norm_fwd


def init_attn_mlp(cfg: ArchConfig, dtype: torch.dtype,
                  generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
            "attn": attn.init_attn(cfg, dtype, generator),
            "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, dtype, generator)}


def attn_mlp_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache: dict) -> torch.Tensor:
    x = x + attn.attn_prefill_into_cache(p["attn"], cfg,
                                         norm_fwd(cfg, p["ln1"], x), cache)
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
    x = x + attn.attn_decode(p["attn"], cfg, norm_fwd(cfg, p["ln1"], x),
                             cache, pos)
    return x + mlp_fwd(p["mlp"], norm_fwd(cfg, p["ln2"], x))


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

"""Mamba2 block (arXiv:2405.21060): conv stem + SSD scan + gated norm.

A port of ``repro.models.ssm``, with its parameter names and layouts:
``in_proj`` -> [z | x | B | C | dt]; a causal depthwise conv over
[x | B | C]; the SSD scan over ``ssm_n_heads`` heads of width
``ssm_head_dim``; a gated RMSNorm (norm(y * silu(z))); ``out_proj``.
``A_log``, ``D`` and ``dt_bias`` are float32 whatever the model's dtype
(``F32_LEAVES``).

Prefill runs the scan through ``kernels.ops.ssd_scan`` (the CUDA kernel
on the card) and writes the conv tail and the final state into the
layer's cache group in place. Decode is the one-token recurrence
``ssd_decode_step`` in plain tensor code on both devices, as JAX computes
it outside any Pallas kernel. Both round where JAX rounds: ``dt`` is cast
to the activations' dtype before the scan, the scan's state comes out in
x's dtype and the decode state is kept in the cache's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import project, rmsnorm_fwd, truncated_normal

# leaves kept in float32 whatever the model's dtype
F32_LEAVES = ("A_log", "D", "dt_bias")


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    nh = cfg.ssm_n_heads
    ng, ds = cfg.ssm_n_groups, cfg.ssm_state
    conv_dim = di + 2 * ng * ds
    return di, nh, ng, ds, conv_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|),
    with no threshold (``F.softplus`` returns x itself past 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba2(cfg: ArchConfig, dtype: torch.dtype,
                generator: torch.Generator) -> dict:
    d = cfg.d_model
    di, nh, ng, ds, conv_dim = _dims(cfg)
    dev = generator.device
    f32 = torch.float32
    d_in_proj = 2 * di + 2 * ng * ds + nh
    u = torch.rand((nh,), dtype=f32, device=dev, generator=generator)
    dt = torch.linspace(1e-3, 1e-1, nh, dtype=f32, device=dev).clamp_min(1e-4)
    K = cfg.ssm_conv_width
    return {
        "in_proj": truncated_normal((d, d_in_proj), dtype, d ** -0.5,
                                    generator),
        "conv_w": truncated_normal((K, conv_dim), dtype, K ** -0.5,
                                   generator),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        # A uniform in [1, 16] on a log scale, as the reference draws it
        "A_log": u * math.log(16.0),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=dev)},
        "out_proj": truncated_normal((di, d), dtype, di ** -0.5, generator),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, nh, ng, ds, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di + 2 * ng * ds, nh], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv in the working dtype, as JAX writes it: a sum
    of K shifted products (no ``F.conv1d``, which would take cuDNN, in
    TF32 for float32). xbc: (B, S, C); w: (K, C). Returns silu(y) and the
    trailing (K - 1) inputs as the next conv state."""
    K, S = w.shape[0], xbc.shape[1]
    pad = (torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]), dtype=xbc.dtype,
                       device=xbc.device)
           if state is None else state.to(xbc.dtype))
    xp = torch.cat([pad, xbc], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    y = y + b
    return F.silu(y), xp[:, xp.shape[1] - (K - 1):]


def _gate_out(p: dict, cfg: ArchConfig, y: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    y = rmsnorm_fwd(p["norm"], y * F.silu(z), cfg.norm_eps)
    return project(y, p["out_proj"])


def mamba2_fwd(p: dict, cfg: ArchConfig, x: torch.Tensor,
               cache: dict | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). With ``cache`` (a group of
    ``init_mamba2_cache``), its conv tail and state are overwritten in
    place with this prefill's, for the decode that follows."""
    B, S, _ = x.shape
    di, nh, ng, ds, _ = _dims(cfg)
    z, xbc, dt_raw = _split_proj(cfg, project(x, p["in_proj"]))
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, B_, C_ = torch.split(xbc, [di, ng * ds, ng * ds], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    y, final_state = ops.ssd_scan(
        xs.reshape(B, S, nh, cfg.ssm_head_dim).contiguous(),
        dt.to(xs.dtype).contiguous(), -torch.exp(p["A_log"]),
        B_.reshape(B, S, ng, ds).contiguous(),
        C_.reshape(B, S, ng, ds).contiguous(), p["D"],
        chunk=min(cfg.ssm_chunk, S))
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(final_state)
    return _gate_out(p, cfg, y.reshape(B, S, di), z)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                    D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence (``repro.kernels.ref.ssd_decode_step``):
    plain tensor code on every device, since JAX computes it outside any
    Pallas kernel. state: (B, nh, hd, ds); x: (B, nh, hd); dt: (B, nh);
    B_/C_: (B, ng, ds). Returns y in x's dtype and the new state in the
    state's dtype."""
    rep = x.shape[1] // B_.shape[1]
    f32 = torch.float32
    Bh = B_.to(f32).repeat_interleave(rep, dim=1)            # (B, nh, ds)
    Ch = C_.to(f32).repeat_interleave(rep, dim=1)
    dtf = dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))                          # (B, nh)
    upd = (dtf[..., None] * x.to(f32))[..., None] * Bh[:, :, None, :]
    new_state = state.to(f32) * dA[..., None, None] + upd
    y = torch.einsum("bhpd,bhd->bhp", new_state, Ch)
    y = y + x.to(f32) * D.to(f32)[:, None]
    return y.to(x.dtype), new_state.to(state.dtype)


def mamba2_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  cache: dict) -> torch.Tensor:
    """x: (B, 1, d); cache: {conv: (B, K-1, conv_dim), state: (B, nh, hd,
    ds)}, both updated in place."""
    B = x.shape[0]
    di, nh, ng, ds, _ = _dims(cfg)
    z, xbc, dt_raw = _split_proj(cfg, project(x, p["in_proj"]))
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   cache["conv"])
    xs, B_, C_ = torch.split(xbc[:, 0], [di, ng * ds, ng * ds], dim=-1)
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])
    y, new_state = ssd_decode_step(
        cache["state"], xs.reshape(B, nh, cfg.ssm_head_dim),
        dt.to(xs.dtype), -torch.exp(p["A_log"]), B_.reshape(B, ng, ds),
        C_.reshape(B, ng, ds), p["D"])
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(new_state)
    return _gate_out(p, cfg, y.reshape(B, 1, di), z)


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                      device: torch.device) -> dict:
    di, nh, ng, ds, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, cfg.ssm_head_dim, ds), dtype=dtype,
                             device=device),
    }

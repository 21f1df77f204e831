"""Layer primitives: norms, rotary embeddings, MLP, embedding, linear.

Plain functions on tensors over nested parameter dicts, mirroring
``repro.models.layers`` (the same parameter names and layouts, so weights
cross over leaf by leaf). Norms and rotary embeddings compute in float32
and cast back, as the JAX versions do; RMSNorm goes through
``kernels.ops`` (the CUDA ``rmsnorm`` kernel on the card).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops


def truncated_normal(shape, dtype: torch.dtype, scale: float,
                     generator: torch.Generator) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [-2, 2], drawn in
    float32 on the generator's device and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, scale, -2.0 * scale, 2.0 * scale,
                                generator=generator)
    return t.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_fwd(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Through ``ops``: the plain version on the CPU, the CUDA kernel on
    the card."""
    return ops.rmsnorm(x, p["scale"], eps)


def layernorm_fwd(p: dict, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def init_norm(cfg: ArchConfig, d: int, dtype: torch.dtype,
              device: torch.device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_fwd(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        return layernorm_fwd(p, x, cfg.norm_eps)
    return rmsnorm_fwd(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary position embeddings (partial factor + theta per config)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, partial: float,
               device: torch.device) -> torch.Tensor:
    rot_dim = int(head_dim * partial) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)                      # (rot_dim // 2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial: float = 1.0) -> torch.Tensor:
    """x: (B, S, heads, head_dim); positions: (B or 1, S)."""
    inv = rope_freqs(x.shape[-1], theta, partial, x.device)
    rot_dim = inv.shape[0] * 2
    ang = positions[..., :, None].float() * inv       # (B, S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]             # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
# Inside a prefill (``prefill_products``) a float32 product on the card
# runs in fixed slices of this many rows, so a row's bits do not depend on
# the batch's row count (serving.engine's MIN_PREFILL_ROWS note says which
# module keeps that for which dtype). A decode step keeps one product: its
# rows are the engine's slots, a fixed count.
ROW_SLICE = 128

_prefill = threading.local()


@contextlib.contextmanager
def prefill_products():
    """Within it, ``project`` slices float32 products on the card (per
    thread: a ThreadBackend runs one engine a thread)."""
    was = getattr(_prefill, "on", False)
    _prefill.on = True
    try:
        yield
    finally:
        _prefill.on = was


def sliced_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` as products of exactly ``ROW_SLICE`` rows
    each, the last slice zero-padded: every row goes through a GEMM of one
    shape."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    n = x2.shape[0]
    padded = -(-n // ROW_SLICE) * ROW_SLICE
    if padded != n:
        x2 = torch.cat([x2, x2.new_zeros((padded - n, K))])
    out = x2.new_empty((padded, w.shape[1]))
    for i in range(0, padded, ROW_SLICE):
        torch.mm(x2[i:i + ROW_SLICE], w, out=out[i:i + ROW_SLICE])
    return out[:n].reshape(*lead, w.shape[1])


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for every projection of a forward: float32 on the card
    inside ``prefill_products`` through ``sliced_matmul``; otherwise (a
    decode step, bfloat16, the CPU) as one product."""
    if (x.device.type == "cuda" and x.dtype == torch.float32
            and getattr(_prefill, "on", False)):
        return sliced_matmul(x, w)
    return x @ w


# ---------------------------------------------------------------------------
# MLP (gated: SwiGLU or GeGLU), embedding, linear
# ---------------------------------------------------------------------------
def init_mlp(d_model: int, d_ff: int, dtype: torch.dtype,
             generator: torch.Generator) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {"w_gate": truncated_normal((d_model, d_ff), dtype, s_in,
                                       generator),
            "w_up": truncated_normal((d_model, d_ff), dtype, s_in, generator),
            "w_down": truncated_normal((d_ff, d_model), dtype, s_out,
                                       generator)}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (the exact erf
    form is another function)."""
    return F.gelu(x, approximate="tanh")


# the config's ``act`` by name, as ``repro.models.layers.mlp_fwd`` reads it
ACTIVATIONS = {"silu": F.silu, "gelu": gelu_tanh}


def mlp_fwd(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The gated MLP ``act(x·w_gate) * (x·w_up) · w_down``."""
    return project(ACTIVATIONS[act](project(x, p["w_gate"]))
                   * project(x, p["w_up"]), p["w_down"])


def embed_fwd(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def linear_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = project(x, p["w"])
    return y + p["b"] if "b" in p else y

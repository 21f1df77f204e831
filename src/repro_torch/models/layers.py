"""Layer primitives: norms, rotary embeddings, MLP, sinusoidal
positions, embedding, linear.

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
# Prefix sharing prefills a few suffix rows where the plain path prefills
# the whole prompt, so on the card a prefill row's bits must not depend on
# how many rows its batch holds; cuBLAS picks its GEMM algorithm by shape
# and gives a row other bits at other row counts, in float32 (above 128
# rows too) and in bfloat16 (below 128 rows at qwen3's down projection,
# K = 3072, N = 1024; at 128, 192 and 384 rows against 2304 or 4096 at
# internvl2-26b's, K = 16384, N = 6144; and in its logits head at 1-4
# rows against 256, on the H100). One strided-batched GEMM over the
# slices does not help: it too gives a row other bits at other batch
# counts. So inside a prefill (``prefill_products``) a product on the card
# runs as products of exactly ROW_SLICE rows each, which gives a row the
# same bits at any count (tests/test_torch_gpu.py::
# test_prefill_gemms_give_a_row_the_same_bits_from_min_prefill_rows_on):
# every float32 product (so a request's bits do not depend on its batch),
# and every product with ``every_dtype``, which the engines of a model
# that can share a prefix ask for (``Model.prefill``'s ``row_invariant``).
# A prefill is host-bound on the card, so its cost is the calls a slice
# makes: 512 rows cost phases 4 and 6c less than 128 or 256 did
# (scripts/prefill_turns.py, PERF.md). A decode step keeps one product:
# its rows are the engine's slots, a fixed count.
ROW_SLICE = 512

_prefill = threading.local()


@contextlib.contextmanager
def prefill_products(every_dtype: bool = False):
    """Within it, ``project`` slices float32 products on the card, and
    with ``every_dtype`` every product (per thread: a ThreadBackend runs
    one engine a thread)."""
    was = getattr(_prefill, "on", False), getattr(_prefill, "every", False)
    _prefill.on, _prefill.every = True, every_dtype
    try:
        yield
    finally:
        _prefill.on, _prefill.every = was


def sliced_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` as products of exactly ``ROW_SLICE`` rows
    each, the last slice zero-padded: every row goes through a GEMM of one
    shape. A prefill is host-bound on the card, so this makes as few
    calls as it can: one product where one slice holds every row."""
    K, N = w.shape
    x2 = x.reshape(-1, K)
    n = x2.shape[0]
    if n % ROW_SLICE:
        x2 = F.pad(x2, (0, 0, 0, ROW_SLICE - n % ROW_SLICE))
    if x2.shape[0] == ROW_SLICE:
        y = x2 @ w
    else:
        y = torch.cat([part @ w for part in x2.split(ROW_SLICE)])
    return y[:n].reshape(*x.shape[:-1], N)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for every projection of a forward: on the card inside
    ``prefill_products`` through ``sliced_matmul`` (float32, or every
    dtype with ``every_dtype``); otherwise (a decode step, the CPU) as one
    product. Operands of two dtypes meet in the wider one, as JAX
    promotes them (whisper's float32 frames against bfloat16 weights)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if (x.device.type == "cuda" and getattr(_prefill, "on", False)
            and (x.dtype == torch.float32 or _prefill.every)):
        return sliced_matmul(x, w)
    return x @ w


# ---------------------------------------------------------------------------
# MLP (gated: SwiGLU or GeGLU; or not gated), embedding, linear
# ---------------------------------------------------------------------------
def init_mlp(d_model: int, d_ff: int, dtype: torch.dtype,
             generator: torch.Generator, gated: bool = True) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    p = {"w_gate": truncated_normal((d_model, d_ff), dtype, s_in,
                                    generator)} if gated else {}
    p["w_up"] = truncated_normal((d_model, d_ff), dtype, s_in, generator)
    p["w_down"] = truncated_normal((d_ff, d_model), dtype, s_out, generator)
    return p


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (the exact erf
    form is another function)."""
    return F.gelu(x, approximate="tanh")


# the config's ``act`` by name, as ``repro.models.layers.mlp_fwd`` reads it
ACTIVATIONS = {"silu": F.silu, "gelu": gelu_tanh}


def mlp_fwd(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The gated MLP ``act(x·w_gate) * (x·w_up) · w_down``, or without
    ``w_gate`` the plain one, ``act(x·w_up) · w_down``."""
    actfn = ACTIVATIONS[act]
    if "w_gate" in p:
        h = actfn(project(x, p["w_gate"])) * project(x, p["w_up"])
    else:
        h = actfn(project(x, p["w_up"]))
    return project(h, p["w_down"])


# ln(1e4) as float32 rounds it (jnp.log(10000.0)), held as a Python float
# so no host-to-device copy enters a captured step
_LN_1E4 = float(torch.log(torch.tensor(10000.0)))


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """JAX's fixed absolute positions (``repro.models.model._sinusoid``):
    ``[sin | cos]`` of ``positions * exp(-ln(1e4) * i / max(d/2 - 1,
    1))``, float32, shape ``positions.shape + (d,)`` (a zero column last
    for odd ``d``)."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-_LN_1E4 * i / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return F.pad(out, (0, d % 2))


def embed_fwd(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def linear_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = project(x, p["w"])
    return y + p["b"] if "b" in p else y

"""Mixture of Experts: top-k router and capacity-bounded grouped dispatch.

A port of the single-device path of ``repro.models.moe.moe_fwd`` with its
drop semantics (the mesh paths, ``_dispatch_shard_map`` and the sharding
constraints, have no counterpart on one card):

* the router's logits are float32 (``router`` is a float32 leaf whatever
  the model's dtype), softmaxed, cut to the top ``K`` experts (sorted,
  largest first) and renormalised by their sum clipped at 1e-9;
* the T = B·S tokens (pad tokens included) split into G groups, G =
  ``moe_dispatch_groups`` halved while it does not divide T; within a
  group each (token, k) assignment takes the number of earlier
  assignments to its expert, in (token, k) order, as its position;
* an expert holds C = max(4, min(Tg, int(Tg·K/E·cf + 0.5))) assignments
  per group (cf = ``moe_eval_cf``, or ``moe_train_cf`` in training); an
  assignment at position >= C is dropped: it is written nowhere and adds
  0;
* the (G, E, C, d) buffer goes through every expert's SwiGLU as one
  batched product per weight (JAX leaves it to XLA outside any Pallas
  kernel), and each kept assignment's row comes back times its gate in
  x's dtype, summed over its K experts, plus the shared experts' MLP;
* in training (``train=True``) it also returns the Switch load-balance
  loss ``E · Σ_e mean_t(probs) · mean_t(count of e in the token's top
  K)``, whose gradient flows through the router's probabilities.

Parameters: ``{"router": (d, E) float32, "experts": {"w_gate", "w_up":
(E, d, f), "w_down": (E, f, d)}, "shared": {...}}`` (the shared experts
are one MLP of width ``moe_d_ff * n_shared_experts``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (ACTIVATIONS, init_mlp, mlp_fwd,
                                      truncated_normal)

# leaves kept in float32 whatever the model's dtype
F32_LEAVES = ("router",)


def init_moe(cfg: ArchConfig, dtype: torch.dtype,
             generator: torch.Generator) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": truncated_normal((d, E), torch.float32, d ** -0.5,
                                    generator),
         # experts stacked on a leading E axis
         "experts": {"w_gate": truncated_normal((E, d, f), dtype, d ** -0.5,
                                                generator),
                     "w_up": truncated_normal((E, d, f), dtype, d ** -0.5,
                                              generator),
                     "w_down": truncated_normal((E, f, d), dtype, f ** -0.5,
                                                generator)}}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(d, f * cfg.n_shared_experts, dtype, generator)
    return p


def _capacity(n_tokens: int, cfg: ArchConfig, train: bool = False) -> int:
    """Slots per expert per group (the serving or training capacity
    factor)."""
    cf = cfg.moe_train_cf if train else cfg.moe_eval_cf
    per = n_tokens * cfg.n_experts_per_tok / cfg.n_experts
    return max(4, min(n_tokens, int(per * cf + 0.5)))


def _groups(n_tokens: int, cfg: ArchConfig) -> int:
    G = max(1, cfg.moe_dispatch_groups)
    while G > 1 and n_tokens % G:
        G //= 2
    return G


def route(p: dict, cfg: ArchConfig, xt: torch.Tensor, train: bool = False):
    """Routing of tokens xt (T, d): the top-K gates (T, K) float32 and
    experts (T, K), and per group the expert position of each (token, k)
    assignment and whether it is kept, at the serving capacity or with
    ``train`` the training one. Returns ``(gates, experts, pos, keep,
    C, probs)`` with pos and keep (G, Tg·K) and the router's float32
    probabilities (T, E)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gates, experts = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    G = _groups(T, cfg)
    flat_e = experts.reshape(G, (T // G) * K)
    onehot = F.one_hot(flat_e, E)                        # (G, Tg·K, E)
    before = torch.cumsum(onehot, dim=1) - onehot        # earlier ones
    pos = before.gather(2, flat_e[..., None])[..., 0]
    C = _capacity(T // G, cfg, train)
    return gates, experts, pos, pos < C, C, probs


def moe_fwd(p: dict, cfg: ArchConfig, x: torch.Tensor, train: bool = False):
    """x: (B, S, d) -> (B, S, d) (serving); with ``train`` the training
    capacity and ``(out, aux)``, aux the float32 Switch loss."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    xt = x.reshape(T, d)
    gates, experts, pos, keep, C, probs = route(p, cfg, xt, train)
    G, TgK = pos.shape
    # kept assignments own distinct (expert, position) slots of their
    # group's buffer; dropped ones all land on one sink row past the end
    slot = torch.where(keep, experts.reshape(G, TgK) * C + pos, E * C)
    rows = xt.reshape(G, T // G, d).repeat_interleave(K, dim=1)
    buf = x.new_zeros((G, E * C + 1, d))
    buf.scatter_(1, slot[..., None].expand(G, TgK, d), rows)
    xe = buf[:, :E * C].reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    w = p["experts"]
    act = ACTIVATIONS[cfg.act]
    h = torch.bmm(act(torch.bmm(xe, w["w_gate"]))
                  * torch.bmm(xe, w["w_up"]), w["w_down"])   # (E, G·C, d)
    h = h.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    back = h.gather(1, torch.where(keep, slot, 0)[..., None].expand(
        G, TgK, d))
    back = torch.where(keep[..., None], back, 0.0)
    back = back * gates.reshape(G, TgK, 1).to(x.dtype)
    out = back.reshape(T, K, d).sum(dim=1)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xt, cfg.act)
    out = out.reshape(B, S, d)
    if not train:
        return out
    me = probs.mean(dim=0)                               # (E,)
    ce = F.one_hot(experts, E).float().sum(dim=1).mean(dim=0)
    return out, E * torch.sum(me * ce)

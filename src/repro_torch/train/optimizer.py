"""AdamW with a warmup + cosine schedule, as ``repro.train.optimizer``:
float32 moments, the global-norm clip, bias correction, and weight decay
on tensors of two or more dimensions only.

Where JAX returns a new tree, ``apply_update`` updates the port's
parameter dict and the moments in place, under ``torch.no_grad()``. A
tensor that appears at several places of the dict (zamba's shared block,
one dict at every application) is one parameter: it is counted once in
the gradient norm and updated once, and its moments are shared likewise.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``: linear warmup to ``lr`` over
    ``warmup_steps``, then a cosine down to ``min_lr_frac · lr`` at
    ``total_steps``, in float32 as JAX computes it."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return float(cfg.lr * warm * frac)


def map_tree(fn, tree, memo: dict | None = None):
    """``tree`` (nested dicts and lists of tensors) with ``fn`` applied to
    each tensor once: a tensor at several places maps to one result."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, memo) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, memo) for v in tree]
    if id(tree) not in memo:
        memo[id(tree)] = (tree, fn(tree))
    return memo[id(tree)][1]


def zip_leaves(tree, *others) -> list[tuple]:
    """The tensors of ``tree`` in order, each once, each beside the leaf
    at the same place (dict key, list index) of every tree of
    ``others``."""
    out: dict[int, tuple] = {}

    def walk(t, os_):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, [o[k] for o in os_])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, [o[i] for o in os_])
        else:
            out.setdefault(id(t), (t, *os_))
    walk(tree, others)
    return list(out.values())


def unique_leaves(tree) -> list:
    """The tensors of ``tree`` in order, each once."""
    return [t for t, in zip_leaves(tree)]


def init_opt_state(params) -> dict:
    """Zero float32 moments shaped like ``params`` (shared where the
    parameters are) and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": 0}


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ g²) over the distinct tensors of ``grads``, float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in unique_leaves(grads)))


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params, grads, state: dict
                 ) -> tuple[dict, dict, dict]:
    """One AdamW step of ``params`` by ``grads`` (a tree of the same keys,
    read where the parameters are; a parameter at several places is
    stepped once), in place. Returns ``(params, state,
    {"grad_norm", "lr"})``: the same parameter dict, the state with its
    moments updated in place and its step advanced."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.betas
    lr = schedule(cfg, step)
    bc1 = float(1 - _f32(b1) ** _f32(step))
    bc2 = float(1 - _f32(b2) ** _f32(step))
    for p, g, m, v in zip_leaves(params, grads, state["m"], state["v"]):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:          # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}

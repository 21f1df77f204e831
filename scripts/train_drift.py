#!/usr/bin/env python3
"""How far two float32 training runs of the port drift apart in three
AdamW steps when their gradients differ only by rounding, on the CPU.

    PYTHONPATH=src python3 scripts/train_drift.py [--threads N]

For each reduced config of ``chip_smoke.py`` phase 18c (and qwen3's) it
trains 3 steps of ``repro_torch.train.loop.train`` at 18c's schedule (lr
1e-3 from the first step, batch 4 × 64 of ``LmTokenStream``, weights
from seed 0), then again with the gradients disturbed each step, and
prints, over the parameter leaves, the worst and the median of

- ``||diff|| / ||move||``: the leaf's L2 difference from the undisturbed
  run over its own L2 move ``p3 - p0`` (what 18c bounds);
- ``max|diff| / max|move|`` and ``max|diff| / max|leaf|``.

The disturbances: every gradient element times ``1 + 1e-6·N(0, 1)``
(``rel``); ``1e-6·max|g|·N(0, 1)`` added to every nonzero element of a
leaf (``abs``: an error of the size the card's gradients show against
the CPU's, about 2e-6 of the leaf's max|g| at worst, on every element,
so that small elements, whose AdamW steps are normalised by their own
size, take it as a large relative error); and, as a fault of the size a
check must still catch, the learning rate 5 % high (``lr+5%``). Imports
neither JAX nor the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import LmTokenStream
from repro_torch.models.model import Model
from repro_torch.train import loop
from repro_torch.train.optimizer import AdamWConfig, map_tree, unique_leaves

CONFIGS = ("qwen3-0.6b-reduced", "deepseek-v2-lite-16b-reduced",
           "gemma3-27b-reduced", "whisper-large-v3-reduced")
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)


def batch(cfg, seed: int, B: int = 4, S: int = 64) -> dict:
    """``chip_smoke.py``'s training batch: ``LmTokenStream`` at ``seed``,
    and for whisper frames from ``default_rng(seed)``."""
    out = LmTokenStream(cfg.vocab_size, S, B, seed).batch(0)
    if cfg.arch_type == "audio":
        out["audio_frames"] = np.random.default_rng(seed).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def disturbed(kind: str, seed: int):
    """``loop.loss_and_grads`` with its gradients disturbed as ``kind``
    says, from a generator seeded with ``seed``."""
    base = loop.loss_and_grads
    gen = torch.Generator().manual_seed(seed)

    def loss_and_grads(*args, **kwargs):
        loss, metrics, grads = base(*args, **kwargs)
        out = {}
        for key, g in grads.items():
            n = torch.randn(g.shape, generator=gen)
            out[key] = (g * (1 + 1e-6 * n) if kind == "rel"
                        else g + (g != 0) * 1e-6 * g.abs().max() * n)
        return loss, metrics, out
    return loss_and_grads


def run(cfg, init, opt: AdamWConfig = OPT, grads_fn=None) -> list:
    """The leaves after 3 steps of ``train`` from a copy of ``init``."""
    model = Model(cfg, device="cpu")
    params = map_tree(lambda t: t.clone(), init)
    base = loop.loss_and_grads
    loop.loss_and_grads = grads_fn or base
    try:
        params, _, _ = loop.train(model, loop.TrainConfig(opt=opt),
                                  (batch(cfg, i) for i in range(3)), 3,
                                  params=params)
    finally:
        loop.loss_and_grads = base
    return [t.detach().clone() for t in unique_leaves(params)]


def drift(got: list, want: list, init: list) -> dict:
    """Worst and median over the leaves of the three ratios."""
    def ratio(a, b):
        return float(a) / max(float(b), 1e-30)
    cols = {"||diff||/||move||": [], "max|diff|/max|move|": [],
            "max|diff|/max|leaf|": []}
    for a, b, z in zip(got, want, init):
        d, mv = a - b, b - z
        cols["||diff||/||move||"].append(ratio(d.norm(), mv.norm()))
        cols["max|diff|/max|move|"].append(ratio(d.abs().max(),
                                                 mv.abs().max()))
        cols["max|diff|/max|leaf|"].append(ratio(d.abs().max(),
                                                 b.abs().max()))
    return {k: (max(v), statistics.median(v)) for k, v in cols.items()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for name in CONFIGS:
        cfg = get_config(name)
        if cfg.is_moe and not cfg.router_aux_loss_coef:
            cfg = dataclasses.replace(cfg, router_aux_loss_coef=0.003)
        init = Model(cfg, device="cpu").init(seed=0)
        want = run(cfg, init)
        for label, kw in (("rel", {"grads_fn": disturbed("rel", 1)}),
                          ("abs", {"grads_fn": disturbed("abs", 2)}),
                          ("lr+5%", {"opt": dataclasses.replace(
                              OPT, lr=OPT.lr * 1.05)})):
            res = drift(run(cfg, init, **kw), want, unique_leaves(init))
            cells = "; ".join(f"{k} worst {w:.3e} median {m:.3e}"
                              for k, (w, m) in res.items())
            print(f"{name} {label}: {cells}", flush=True)


if __name__ == "__main__":
    main()

"""Training launcher of the port: one model on one device (the
counterpart of ``repro.launch.train``, its flags plus ``--device``; no
mesh: one card).

Configs are full width unless ``--reduced``; weights are random,
``Model.init(seed=0)`` in float32, and the data is the synthetic
``LmTokenStream``. The launcher runs on the card unless given ``--device
cpu``; on the card every attention and norm runs forward and backward as
a hand-written kernel, and it prints their launches last.

    python -m repro_torch.launch.train --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 3
"""
from __future__ import annotations

import argparse
import json
import time


def _parser(arch_names) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=arch_names)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale variant of the architecture")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Train as the flags say; print a line every 5 steps and at the last,
    then the kernel launches. Returns a report: the config's name and
    parameter count, each step's loss and wall seconds (ending in a read
    of its loss), the launches, and on the card the peak
    ``memory_allocated``."""
    from repro_torch.configs.registry import ARCH_NAMES, get_config

    args = _parser(ARCH_NAMES).parse_args(argv)

    import torch

    from repro_torch.data.pipeline import LmTokenStream
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.params import to_numpy
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    model = Model(cfg, device=args.device)
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"device={model.device}", flush=True)
    tcfg = TrainConfig(opt=AdamWConfig(lr=args.lr, warmup_steps=10,
                                       total_steps=args.steps),
                       remat=args.remat, microbatches=args.microbatches)
    params = model.init(seed=0)
    step_fn = make_train_step(model, tcfg, params)
    opt_state = init_opt_state(params)
    stream = LmTokenStream(cfg.vocab_size, seq_len=args.seq,
                           batch_size=args.batch)
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.device)
    losses, walls = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             stream.batch(step))
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - ts)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if args.save:
        checkpoint.save(args.save, to_numpy(cfg, params),
                        meta={"steps": args.steps, "arch": cfg.name})
        print("checkpoint:", args.save)
    launches = ops.launch_counts()
    print(f"kernel launches: {json.dumps(launches)}", flush=True)
    return {"arch": cfg.name, "params": cfg.param_count(), "loss": losses,
            "step_s": walls, "launches": launches,
            "peak_bytes": (torch.cuda.max_memory_allocated(model.device)
                           if cuda else None)}


if __name__ == "__main__":
    main()

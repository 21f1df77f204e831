"""The port's quickstart (``examples/quickstart.py`` on PyTorch): build an
architecture, train it a few steps, then serve it.

    python examples/torch_quickstart.py                     # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --reduced \\
        --device cpu

Full width on the card (float32: the card trains float32 parameters);
``--reduced`` takes the registry's reduced config for the CPU, where the
plain kernel versions run. The trained parameters then serve a few
requests through one ``ServingEngine`` with continuous batching.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv: list[str] | None = None) -> dict:
    from repro_torch.configs.registry import ARCH_NAMES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import LmTokenStream
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    # 1. an architecture of the registry, at full width or reduced
    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    model = Model(cfg, device=args.device)
    print(f"arch={cfg.name}  params={cfg.param_count():,}  "
          f"device={model.device}")

    # 2. a short training run on the synthetic LM stream
    stream = LmTokenStream(cfg.vocab_size, seq_len=32, batch_size=8)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=args.steps))
    params, _, hist = train(model, tcfg, stream.batches(),
                            n_steps=args.steps, log_every=10,
                            logger=lambda s, m: print(
                                f"  step {s:3d}  loss {m['loss']:.3f}",
                                flush=True))
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit("training did not improve")

    # 3. serve a few requests with continuous batching on the trained
    # weights
    eng = ServingEngine(model, params, EngineConfig(n_slots=2, max_len=64,
                                                    dtype=torch.float32),
                        device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(4):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab_size, (8,),
                                               dtype=np.int32),
                           max_new_tokens=8))
    done = sorted(eng.run(), key=lambda c: c.rid)
    for c in done:
        print(f"  request {c.rid}: generated {c.tokens}")
    if [len(c.tokens) for c in done] != [8] * 4:
        raise SystemExit("a request was not served in full")
    return {"history": hist, "completions": [c.tokens for c in done],
            "chunk_tokens": eng.chunk_tokens}


if __name__ == "__main__":
    main()

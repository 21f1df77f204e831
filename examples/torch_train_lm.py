"""The port's training example (``examples/train_lm.py`` on PyTorch): a
~100M-parameter qwen3-family LM trained on the synthetic stream, with a
checkpoint in the reference's format.

    python examples/torch_train_lm.py --steps 300          # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --reduced \\
        --device cpu --steps 20

The 100M config is the qwen3 block structure (GQA + qk_norm + SwiGLU) at
d_model 640, full width on the card; ``--reduced`` cuts it to the
registry's reduced shape (2 layers, d 256) for the CPU, where the plain
kernel versions run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ArchConfig, reduce_config  # noqa: E402

LM100M = ArchConfig(
    name="lm100m",
    arch_type="dense",
    source="qwen3 family, scaled to ~100M for the example",
    n_layers=10,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    head_dim=64,
    d_ff=1792,
    vocab_size=50_304,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("build", "lm100m"))
    args = ap.parse_args(argv)

    from repro_torch.data.pipeline import LmTokenStream
    from repro_torch.models.model import Model
    from repro_torch.params import to_numpy
    from repro_torch.train import checkpoint
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    cfg = reduce_config(LM100M) if args.reduced else LM100M
    model = Model(cfg, device=args.device)
    print(f"{cfg.name}: params {cfg.param_count():,} on {model.device}")
    stream = LmTokenStream(cfg.vocab_size, seq_len=args.seq,
                           batch_size=args.batch)
    tcfg = TrainConfig(opt=AdamWConfig(
        lr=args.lr, warmup_steps=min(20, args.steps), total_steps=args.steps,
        weight_decay=0.1, grad_clip=1.0))

    def log(step, m):
        print(f"step {step:4d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}  "
              f"{m['wall_s']:.0f}s", flush=True)

    t0 = time.time()
    params, _, hist = train(model, tcfg, stream.batches(), n_steps=args.steps,
                            log_every=10, logger=log)
    os.makedirs(args.out, exist_ok=True)
    checkpoint.save(os.path.join(args.out, "final"), to_numpy(cfg, params),
                    meta={"steps": args.steps,
                          "final_loss": hist[-1]["loss"]})
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(hist, f, indent=2)
    print(f"done in {time.time() - t0:.0f}s; loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f}; checkpoint at {args.out}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit("training did not improve")
    return {"history": hist}


if __name__ == "__main__":
    main()

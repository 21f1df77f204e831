"""The port's serving example (``examples/serve_requests.py`` on
PyTorch): continuous batching and the divide-and-save container pool.

Serves the same request set with 1, 2 and 4 containers (each container a
ServingEngine given an equal share of the requests, the paper's split),
one container after another and concurrently, checks that the
completions are identical at every count, and reports the wall time and
the ``EnergyProxy`` joules of each.

    python examples/torch_serve_requests.py                 # on the card
    PYTHONPATH=src python examples/torch_serve_requests.py --reduced \\
        --device cpu

Full width (random bf16 weights from seed 0) on the card; ``--reduced``
takes the registry's reduced config in float32 for the CPU, where the
plain kernel versions run. Each pool serves the set once before it is
timed (the engines capture their step graphs there).
"""
from __future__ import annotations

import argparse
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

COUNTS = (1, 2, 4)


def main(argv: list[str] | None = None) -> dict:
    from repro_torch.configs.registry import ARCH_NAMES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2,
                    help="decode rows a container")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.pool import ContainerServingPool

    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    dtype = torch.float32 if args.reduced else torch.bfloat16
    model = Model(cfg, device=args.device)
    params = model.init(seed=0, dtype=dtype)
    config = EngineConfig(n_slots=args.slots, max_len=args.max_len,
                          dtype=dtype)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (int(rng.integers(4, 12)),),
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    print(f"{cfg.name} on {model.device}: {args.requests} requests, "
          f"max_new {args.max_new}, {args.slots} slots a container")

    reference, rows = None, []
    for n in COUNTS:
        pool = ContainerServingPool(model, params, n, config,
                                    device=args.device)
        try:
            with warnings.catch_warnings():
                # the wave shim's deprecation note: a wave is what this
                # example measures
                warnings.simplefilter("ignore", DeprecationWarning)
                pool.serve(list(reqs), concurrent=False)      # warm-up
                _, _, w_seq, e_seq = pool.serve_timed(list(reqs),
                                                      concurrent=False)
                ordered, per, w_con, e_con = pool.serve_timed(
                    list(reqs), concurrent=True)
            chunk = pool.backend.engines[0].chunk_tokens
        finally:
            pool.close()
        outs = [tuple(c.tokens) for c in ordered]
        if reference is None:
            reference = outs
        same = outs == reference
        sizes = [r.n_requests for r in per]
        rows.append({"n": n, "wall_seq_s": w_seq, "energy_seq_j": e_seq,
                     "wall_conc_s": w_con, "energy_conc_j": e_con,
                     "split": sizes, "chunk_tokens": chunk,
                     "identical": same})
        print(f"n={n}: seq {w_seq:8.4f}s ~{e_seq:6.2f}J | "
              f"conc {w_con:8.4f}s ~{e_con:6.2f}J "
              f"({w_seq / w_con:.2f}x)  split {sizes}  chunk {chunk}  "
              f"outputs {'identical' if same else 'MISMATCH'}",
              flush=True)
    print(f"{len(reference)} requests served; sample completion "
          f"(rid=0): {list(reference[0])}")
    if not all(r["identical"] for r in rows):
        raise SystemExit("completions differ between container counts")
    return {"rows": rows, "completions": reference}


if __name__ == "__main__":
    main()

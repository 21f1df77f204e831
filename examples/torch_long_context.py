"""The port's long-context example (``examples/long_context.py`` on
PyTorch): what one sequence's cache or state costs as its context grows,
one model per family.

For each family it allocates one sequence's decode cache at growing
horizons (``Model.init_cache(1, ctx)``) and prints its bytes and bytes
per context token beside the block-budget figure
(``core/containers.kv_cache_bytes_per_token``): an SSM's state is
constant in the context, a sliding window stops growing at its window,
MLA grows linearly but several times slimmer than a GQA cache, full
attention grows linearly at full width. Then it decodes a stream on the
SSM model and checks that its state's bytes never move.

    python examples/torch_long_context.py                   # on the card
    PYTHONPATH=src python examples/torch_long_context.py --reduced \\
        --device cpu

Full-width configs (bf16 caches, random weights from seed 0 for the
decode) on the card; ``--reduced`` takes the registry's reduced configs
in float32 for the CPU, at shorter horizons.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

FAMILIES = [
    ("mamba2-2.7b", "SSM: O(1) state"),
    ("zamba2-7b", "hybrid: SSM state + shared-attention cache"),
    ("gemma3-27b", "5:1 local:global sliding window"),
    ("deepseek-v2-lite-16b", "MLA latent cache"),
    ("qwen3-0.6b", "full attention"),
]


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict/list cache."""
    import torch
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--contexts", default=None,
                    help="comma-separated horizons (default 2048,8192,32768 "
                         "full width; 64,256,1024 reduced)")
    ap.add_argument("--tokens", type=int, default=64,
                    help="decode steps of the SSM stream")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.containers import kv_cache_bytes_per_token
    from repro_torch.models.model import Model

    suffix = "-reduced" if args.reduced else ""
    dtype = torch.float32 if args.reduced else torch.bfloat16
    contexts = [int(c) for c in (args.contexts or (
        "64,256,1024" if args.reduced else "2048,8192,32768")).split(",")]
    print(f"{'architecture':28s} {'family':44s} "
          + " ".join(f"{'@' + str(c):>12s}" for c in contexts)
          + "  B/token (last step)  block budget B/token")
    rows = {}
    for arch, family in FAMILIES:
        cfg = get_config(arch + suffix)
        model = Model(cfg, device=args.device)
        sizes = []
        for ctx in contexts:
            sizes.append(tree_bytes(model.init_cache(1, ctx, dtype)))
            if model.device.type == "cuda":
                torch.cuda.empty_cache()
        per_tok = (sizes[-1] - sizes[-2]) / (contexts[-1] - contexts[-2])
        budget = kv_cache_bytes_per_token(
            cfg, max_len=contexts[-1], dtype_bytes=dtype.itemsize)
        rows[cfg.name] = {"bytes": sizes, "per_token": per_tok,
                          "budget_per_token": budget}
        print(f"{cfg.name:28s} {family:44s} "
              + " ".join(f"{s / 1e6:9.2f} MB" for s in sizes)
              + f"  {per_tok:19,.1f}  {budget:20,.1f}", flush=True)

    # a live stream: the SSM model decodes with a state of constant bytes
    cfg = get_config("mamba2-2.7b" + suffix)
    model = Model(cfg, device=args.device)
    params = model.init(seed=0, dtype=dtype)
    cache = model.init_cache(1, args.tokens + 8, dtype)
    base = tree_bytes(cache)
    rng = np.random.default_rng(0)
    tok = torch.tensor([[int(rng.integers(0, cfg.vocab_size))]],
                       dtype=torch.int32, device=model.device)
    print(f"\n{cfg.name}, decoding a growing context on {model.device}:")
    for t in range(args.tokens):
        logits = model.decode_step(params, tok, cache, torch.tensor(
            [t], dtype=torch.int32, device=model.device))
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        if tree_bytes(cache) != base:
            raise SystemExit("the SSM state's bytes moved with the context")
        if t in (0, args.tokens // 2, args.tokens - 1):
            print(f"  t={t:4d}: state {base / 1e3:.1f} kB (constant), "
                  f"next token {int(tok[0, 0])}", flush=True)
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("the SSM stream's logits are not finite")
    print("state footprint constant over the whole stream")
    return {"rows": rows, "state_bytes": base}


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Phase 4's and phase 6c's bf16 serving walls from two or more checkouts of
the port, read in turns on one NVIDIA card.

    python3 scripts/prefill_turns.py --srcs PARENT/src src [--reps N]
    python3 scripts/prefill_turns.py --src DIR [--reps N]     # one turn

With ``--srcs A B`` it runs one turn a process in the order A, B, B, A
(with three checkouts A, B, C, C, B, A), so a drift of the card over the
run falls on every side, and prints
each turn's readings, then one JSON summary (each side's median,
quartiles, least and most wall over its two turns). A turn imports the port
from its ``--src`` (each checkout builds its kernels into its own
``build/``, before anything is timed), builds qwen3-0.6b at full width
(28 layers, bf16, random weights from seed 0) and reads, ``--reps``
times each:

- phase 4, ``chip_smoke.py``'s main path: ``Router(ThreadBackend(2))``
  over dense engines (n_slots=4, max_len=2048, chunk_tokens=32), its
  8 requests of 16-512 prompt tokens, max_new=32, after a two-request
  warm-up that captures both engines' step graphs: wall, tok/s, ttfc p50;
- phase 6c, the sharing gate's engines: one paged engine (block_size 16,
  max_seqs 8) with prefix sharing and one without, each fresh and warmed
  by one unrelated request, through phase 6's two waves (a 256-token
  system prompt ahead of 16-256-token tails; 2 then 14 requests,
  max_new=32), drained between: wall and ttfc p50 (submission to first
  chunk) of the two waves.

The requests are made here from fixed seeds, identical for every
checkout; only the port's public entry points are called, so any
checkout since the Router's ThreadBackend can be read. Needs a CUDA
device; the card's name and power limit are printed beside the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLENS = [16, 512, 37, 200, 96, 333, 64, 480]       # chip_smoke.py phase 4
SYSTEM_PROMPT, TAILS, WAVES = 256, (16, 256), (2, 14)   # phase 6
MAX_NEW = 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def shared_prefix_requests(vocab: int, np) -> list:
    """Phase 6's two waves (``chip_smoke.shared_prefix_requests``)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, (SYSTEM_PROMPT,), dtype=np.int32)
    waves, rid = [], 0
    for n in WAVES:
        wave = []
        for _ in range(n):
            tail = rng.integers(0, vocab, (int(rng.integers(
                TAILS[0], TAILS[1] + 1)),), dtype=np.int32)
            wave.append((rid, np.concatenate([prefix, tail])))
            rid += 1
        waves.append(wave)
    return waves


def phase4(model, params, reps: int, np, torch) -> list:
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    vocab = model.cfg.vocab_size
    config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                          chunk_tokens=32)
    rng = np.random.default_rng(1)
    out = []
    backend = ThreadBackend(model, params, 2, config=config,
                            device=model.device)
    with Router(backend, device=model.device) as router:
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, vocab, (n,), dtype=np.int32), 4))
                for i, n in enumerate((20, 300))]:
            h.result()
        torch.cuda.synchronize()
        for rep in range(reps):
            reqs = [Request(100 * rep + i, rng.integers(
                0, vocab, (n,), dtype=np.int32), MAX_NEW)
                for i, n in enumerate(PLENS)]
            t0 = time.perf_counter()
            handles = [router.submit(r) for r in reqs]
            comps = [h.result() for h in handles]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_tok = sum(len(c.tokens) for c in comps)
            out.append({"wall_s": wall, "tok_per_s": n_tok / wall,
                        "ttfc_p50_s": float(np.percentile(
                            [h.ttfc_s for h in handles], 50))})
    return out


def phase6c(model, params, share: bool, reps: int, np, torch) -> list:
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    from repro_torch.serving.events import ChunkEvent

    vocab = model.cfg.vocab_size
    config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                          chunk_tokens=32, cache="paged", block_size=16,
                          max_seqs=8, prefix_cache=share)
    waves = shared_prefix_requests(vocab, np)
    rng = np.random.default_rng(4)
    out = []
    for _ in range(reps):
        eng = ServingEngine(model, params, config, device=model.device)
        eng.submit(Request(10_000, rng.integers(0, vocab, (40,),
                                                dtype=np.int32), 4))
        eng.run()
        first: dict = {}
        eng.on_event = lambda ev: (isinstance(ev, ChunkEvent)
                                   and first.setdefault(ev.rid, ev.time_s))
        torch.cuda.synchronize()
        ttfc = []
        t0 = time.perf_counter()
        for wave in waves:
            t_sub = time.perf_counter()
            eng.submit_many([Request(rid, prompt, MAX_NEW)
                             for rid, prompt in wave])
            eng.run()
            ttfc += [first[rid] - t_sub for rid, _ in wave]
        torch.cuda.synchronize()
        out.append({"wall_s": time.perf_counter() - t0,
                    "ttfc_p50_s": float(np.percentile(ttfc, 50)),
                    "hit_tokens": eng.prefix_hit_tokens_total})
        del eng
        torch.cuda.empty_cache()
    return out


def one_turn(src: str, reps: int) -> dict:
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.build import extension
    from repro_torch.models.model import Model

    extension()
    model = Model(get_config("qwen3-0.6b"))
    params = model.init(seed=0, dtype=torch.bfloat16)
    return {"src": src,
            "phase4": phase4(model, params, reps, np, torch),
            "phase6c_on": phase6c(model, params, True, reps, np, torch),
            "phase6c_off": phase6c(model, params, False, reps, np, torch)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--srcs", nargs="+", metavar="SRC")
    ap.add_argument("--src")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.src:
        print(json.dumps(one_turn(args.src, args.reps)), flush=True)
        return 0
    if not args.srcs or len(args.srcs) < 2:
        ap.error("give --srcs A B [C ...] or --src DIR")
    card = card_line()
    turns = []
    for src in args.srcs + args.srcs[::-1]:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, __file__, "--src", src, "--reps",
             str(args.reps)], capture_output=True, text=True,
            cwd=ROOT, env=dict(os.environ), timeout=1200)
        if run.returncode:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-8000:])
            return run.returncode
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        turn["turn_s"] = time.perf_counter() - t0
        turns.append(turn)
        for key in ("phase4", "phase6c_on", "phase6c_off"):
            walls = " ".join(f"{r['wall_s']:.4f}" for r in turn[key])
            ttfc = " ".join(f"{r['ttfc_p50_s']:.4f}" for r in turn[key])
            print(f"turn {len(turns)} {src} {key}: wall_s {walls}; "
                  f"ttfc_p50_s {ttfc} [card: {card}]", flush=True)
    summary = {}
    for key in ("phase4", "phase6c_on", "phase6c_off"):
        for src in args.srcs:
            walls = [r["wall_s"] for t in turns if t["src"] == src
                     for r in t[key]]
            q1, median, q3 = statistics.quantiles(walls, n=4)
            summary[f"{key} {src}"] = {
                "median_wall_s": median, "q1_wall_s": q1, "q3_wall_s": q3,
                "min_wall_s": min(walls), "max_wall_s": max(walls)}
    print(json.dumps({"card": card, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

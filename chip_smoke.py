#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits nonzero):

1. Card: the device's name and the ``nvidia-smi`` name/power-limit line;
   build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed).
2. Kernels: each kernel's wrapper against its plain PyTorch version on the
   same CUDA tensors, at qwen3-0.6b's attention widths (H=16, Hkv=8,
   K=128), float32 and bfloat16, at the tolerances of
   tests/test_kernels.py: |kernel - plain| <= tol + tol*|plain| with
   tol 2e-5 (float32) and 2e-2 (bfloat16). The paged kernels are also
   held bitwise to their dense siblings over the gathered view, and must
   ignore NaN in every page (and int8 scale page) no row owns; rows end
   on both sides of the split body's 64-position edges, and the same live
   prefix must give the same bits at horizons 512 and 2048 (dense W,
   paged nblk * bs). The int8
   kernels take int8 K/V quantised by the model's own quantiser, with
   float32 or bfloat16 queries, at the same split edges and horizons,
   over a ring whose live and dead splits alternate, with NaN scales and
   codes of +-127 in every dead slot (of live splits too). Times each
   (CUDA events) beside the plain
   version and ``scaled_dot_product_attention`` (a yardstick the port
   never calls; over the dequantised view for the int8 kernels); the
   prefill kernel, the four decode kernels, MLA decode and sdpa beside
   each, and the SSD scan, also as device time (calls replayed from a
   CUDA graph). The SSD
   scan at mamba2-2.7b's widths (nh=80, hd=64, ds=128, chunk 256):
   S = 512 and 2048, B = 2, a ragged one-chunk prompt, ng = 2, float32
   and bfloat16, |kernel - plain| <= tol * max|plain| (tol 5e-5 and
   2e-2: the kernel cuts the sequence into 64-position tiles where the
   plain version cuts it at ``chunk``) and, wherever 64 divides S,
   element by element within tol abs + tol rel against the plain version
   cut at 64, timed beside the plain version (no PyTorch call computes
   the scan; one ng = 2 case at nh = 80, and S = 2048 timed beside the
   plain version too). The prefill kernel at the other shapes it takes (K
   = 5, 72, 192, 256, Kv = 16 to 256, Hkv = 1, Sq = 1, queries against
   longer and shorter key runs, whose rows that see no key must read 0),
   and bit for bit the suffix's rows over [context | suffix] against the
   whole prompt's at contexts 256 and 272; at MLA's widths (K = 192, Kv
   = 128, H = Hkv = 16), timed beside the plain version and
   ``scaled_dot_product_attention``. The MLA decode kernel at deepseek-v2-lite's widths
   (H = 16, r = 512, dr = 64): the 4-slot main shape, a ragged S = 1000
   with an all-dead row that must read 0 and whose bits must not move
   with NaN in every dead position, rows live to the 64-position splits'
   edges (1, 63, 64, 65, 127, 128, 129, 2048), and the view gathered from
   16-token latent pages, which must ignore NaN in unowned pages; timed
   beside the plain version and ``scaled_dot_product_attention`` over
   [q_lat | q_rope] and [ckv | k_rope]. RMSNorm at every width the
   port's norms see (D = 128, 512, 1024, 2048, 2560, 5120) and those of
   the families still to come (4096 to 7168), 1 / 37 / 4099 rows, the
   MLA latent slice dkv[..., :512] of 576-wide rows read in place, a
   float32 scale under bfloat16 rows, and widths the 16-byte path does
   not take (1020 / 1022, 20000); bit for bit, a row alone, inside 4099
   rows and in a pair launch, the one-element path (a base or scale off
   16 bytes, a row stride of D + 1) against the 16-byte one, and the q/k
   pair (one launch) against two launches; timed at the block norm of a
   512-token qwen3 prefill beside the plain version and
   ``torch.nn.functional.rms_norm`` (a yardstick the port never calls),
   and at a 4-slot decode step's norms beside ``rms_norm`` and the
   launch floor (an empty kernel), all as device time.
3. Model: qwen3-0.6b at full width cut to 2 layers, the 2-layer
   mamba2-2.7b-reduced and the 2-layer deepseek-v2-lite-16b-reduced,
   float32, the port's seeded init: prefill + 8 greedy decode steps on
   the card against the same parameters on the CPU plain path.
4. Main path of the dense cache: ``Router(ThreadBackend(n_containers=2))``
   over full-width qwen3-0.6b (28 layers, bfloat16, random weights from a
   seed), n_slots=4, max_len=2048, 8 requests with ragged 16-512 token
   prompts and max_new=32; the prefill and dense decode kernels must
   launch, and rmsnorm a multiple of the 85 launches of a forward (113
   norms, a layer's q and k norms one pair launch; as on every later
   path, with that model's count). Every engine of every phase serves
   its chunks by replaying a CUDA graph of one chunk step captured on its
   first chunk: the warm-up must leave both engines captured, so the
   timed window only replays; reports each engine's capture seconds and
   pool bytes. Then one engine alone: ``graph_vs_eager`` (a replayed
   chunk against ``Model.decode_chunk`` run eagerly on a clone of the
   cache: tokens, emitted counts, every cache leaf's bytes and the launch
   counts equal), and one steady-state chunk under the profiler, which
   must show no kernel launch, one graph launch a step and two copies.
   Reports one 4-slot decode step's host time, launches, device time and
   the decode attention kernels' part of it, with the norms in plain
   tensor code and through the rmsnorm kernel, and the same step
   replayed from a graph: its wall, the launch calls the profiler sees,
   the host µs to enqueue it and the graph's node count.
5. Dense vs paged: one dense and one paged ``ServingEngine`` (block_size
   16, max_seqs = n_slots = 4, so both decode the same rows) serve the
   same same-bucket request groups; their greedy streams must be
   identical. Each engine then passes ``graph_vs_eager`` on one more
   group (as in 7a and 9b).
6. Main path of the paged cache with prefix sharing:
   ``Router(ThreadBackend(2))`` over paged engines (block_size 16,
   max_seqs 8, the dense footprint of 512 blocks, prefix_cache=True);
   16 requests of a 256-token shared prompt + 16-256-token tail,
   max_new=32, in two waves (2, then 14). Every request completes; wave 2
   hits the prefix; some container has more than n_slots requests in
   flight; the paged and prefill kernels launch, the dense decode kernel
   does not. One engine passes ``graph_vs_eager`` on wave 2's prompts
   again (admissions that hit the shared pages). Wave 2 is also served
   without sharing on one engine and its token agreement printed
   (reported, not checked: other batch shapes).
   c. The sharing gate in the form of JAX's ``_serve_phases``: one paged
      engine with sharing and one without, same block budget, each
      through phase 6's two waves in turn, draining between them. The
      greedy streams and every request's prefill logits must be
      identical bit for bit, and wave 2 must hit the shared prompt (a
      difference fails with a bisect: the prefill kernel over [context |
      suffix] against the whole prompt, one projection at the two modes'
      row counts). Reports what padding prefill batches to 128 token rows
      costs the sharing engine (wall, ttfc p50, peak memory), in turns
      with and without it. Then the same gate in float32 at full width
      (the same seed's weights in float32, phase 6's whole two waves, 16
      requests): float32 projections run in fixed 128-row slices on the
      card, so streams and prefill logits must agree bit for bit too.
7. The int8 KV cache (``kv_cache_dtype="int8"``), same weights:
   a. dense vs paged as in phase 5, on int8 caches: identical greedy
      streams, through the two int8 decode kernels only;
   b. ``Router(ThreadBackend(2))`` over paged int8 engines as in phase 6
      (prefix_cache=True, which an int8 cache ignores) serving phase 6's
      14 wave-2 requests: each completes with max_new tokens and no hit
      tokens; the paged int8 kernel launches, no bfloat16 decode kernel
      does. Reports the KV pool's bytes against phase 6's bfloat16 pool
      and the greedy tokens that agree with phase 6 (not checked).
8. The SSM family: ``Router(ThreadBackend(2))`` over full-width
   mamba2-2.7b (64 layers, bfloat16, random weights from a seed),
   n_slots=4, max_len=2048, 8 requests with 64-1024-token prompts,
   max_new=32, each prompt prefilled unpadded through the CUDA SSD scan.
   Every request completes; one request's stream equals that request run
   alone on the model; the scan launches once per layer per prefill; no
   attention kernel launches; one engine passes ``graph_vs_eager`` over
   its state rows. Reports wall, tok/s, ttfc p50, the state
   cache's bytes, and one decode step's host time, kernel launches and
   device time with the norms in plain tensor code and through the
   rmsnorm kernel, in turns.
   b. The paged cache over mamba2's state rows, same weights: one dense
      (n_slots 4) and one paged engine (block_size 16, max_seqs 8) over
      phase 5's groups at lengths the scan's chunk divides; the tree has
      no paged group (the rows stay dense, sized by max_seqs) and the
      block budget bounds admission. Identical greedy streams, the paged
      engine's ``peak_active`` above the dense engine's slots,
      ``graph_vs_eager`` on both; reports the SSM row bytes a sequence.
9. The MoE family with latent attention: ``Router(ThreadBackend(2))``
   over full-width deepseek-v2-lite-16b (27 layers, MLA, 64 routed
   experts top-6 + 2 shared, bfloat16, random weights from a seed, one
   copy for both engines), dense latent cache, n_slots=4, max_len=2048,
   phase 4's 8 requests. Every request completes; the MLA decode and the
   prefill kernel launch a multiple of 27 times, no other kernel does;
   the one request alone in its prefill bucket equals that request run
   alone at the engine's shapes (expert drops depend on the batch).
   Reports wall, tok/s, ttfc p50, the latent cache's bytes and one
   decode step's host time and launches.
   b. Dense vs paged latent caches as in phase 5, same weights: identical
      greedy streams, the MLA decode kernel launching in both engines.

10. Process containers on phase 4's model and requests: 2 threaded
    containers, the same 2 polled in turn, ``Router(ProcessBackend(2))``
    and ``ProcessBackend(1)`` (one pinned process each, the weights
    shared with the children over CUDA IPC). The 2 process containers'
    greedy streams must equal the threaded ones; each child must launch
    the prefill, dense decode and rmsnorm kernels, hold less device
    memory after taking the weights than their bytes, and have imported
    torch only after pinning itself; a kill fault in container 1 after 2
    steps must give a ContainerFailure, RetryEvents, a respawn and the
    fault-free streams; no child outlives the phase. Reports wall, tok/s
    and ttfc p50 of the four, each child's step-graph capture seconds and
    pool bytes (the respawned child's once it has served), and whether
    an MPS control daemon runs.

11. The request contract of the fixed-count path on phase 4's model
    (bf16, n_slots=4, max_len=2048, chunk_tokens=32):
    a. Sampling inside the step graph: ``Router(ThreadBackend(2))`` with
       ``greedy=False, seed=7`` serves 8 requests, each complete; the
       same seed again gives identical streams, seed 8 differs; one
       sampling engine passes ``graph_vs_eager`` (its random stream's
       state cloned; the state after the chunk equal too), and two
       consecutive replays from one slot state sample other tokens while
       the restored stream state gives the first tokens again; a
       per-token engine (``chunked=False``) with the same seed gives the
       chunked engine's sampled streams; the sampler alone, one 16-way
       row repeated 20,000 times in one call, passes chi-square against
       ``softmax`` at p > 1e-3. Reports a 4-row step's replayed device
       time greedy against sampling, in turns, and the sampler's alone.
    b. The per-token baseline, greedy, on one engine: its streams equal
       the chunked engine's; reports wall, tok/s, host reads and kernel
       launches of both.
    c. Deadlines and shedding: ``request_deadline_s=1e-4`` over a paged
       engine fails with kind ``"deadline"``, then an undeadlined request
       completes and every block is back in the pool; ``deadline_s=0.35``
       with max_new=500 fails ``"mid-decode"`` and frees its slot;
       ``max_queue=4`` over 8 submissions gives 4 ``RejectedEvent``s with
       ``retry_after_s`` 0.25 and 4 completions; one capture an engine.
    d. ``ThreadBackend`` supervision: after one warm-up step an engine,
       an ``"error"`` fault in container 1 two steps into phase 10's
       requests gives one ``ContainerFailure(kind="error")``,
       ``RetryEvent``s and a rebuilt engine that captures its own graph,
       with the fault-free streams; ``memory_allocated`` must fall by
       the dead engine's dense cache between the failure and the new
       engine's build, and rise by less than half of it over the run; a
       fault in
       every incarnation trips the breaker and the Router serves on
       container 0 alone. Reports the rebuild's seconds and memory.

12. The online container-count loop on phase 4's model (bf16, n_slots=4,
    max_len=2048, chunk_tokens=32, one request a prefill so a request's
    bits do not depend on its container or batch). Each count's backend
    or pool serves a warm-up request a container first.
    a. ``Router(backend_factory=n -> ThreadBackend(n), feasible_counts=
       card_feasible_counts(..., max_containers=4), window=8,
       epsilon=0.0, objective="energy")`` serves 6 windows of phase 4's
       traffic, drained window by window; per window n, wall,
       ``EnergyProxy`` J, the card's measured J (mean ``nvidia-smi
       power.draw`` sampled every 100 ms by a helper thread, times the
       wall; read and printed only), tok/s and ttfc p50/p95; then the
       scheduler's ``summary()`` and ``choice``. Gates: the bootstrap
       visits every feasible count, each count's backend is built once,
       and every request's greedy tokens equal a fixed
       ``Router(ThreadBackend(1))``'s.
    b. ``AdaptiveServingPool`` (threads) over the same traffic as 6
       waves: the same tokens; its history printed.
    c. One wave through ``ProcessContainerPool(2)`` against
       ``ContainerServingPool(2)``: identical ordered completions; both
       walls and proxy energies printed. No child outlives the phase.

Then a JSON line with each kernel's launches (from the phase of the path
it serves, and by phase), error and times (eight kernels), the card's
``nvidia-smi`` line, and the result line ``{"ok": true, "device":
{...}}``.

It needs the checkout's ``src/`` and a CUDA device; without either it
exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import time

# numpy and torch are imported in main(): phase 10's children are spawned,
# and spawn re-imports this script in each child before the child pins
# itself to its cores, so nothing heavy may load at module scope
np = torch = None

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: dense peaks at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 outside tensor cores
PEAK_BYTES_S = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H, HKV, K = 16, 8, 128
# live depths of the 8 decode rows at the paged main-path shape
PAGED_MAIN_LENGTHS = [280, 300, 330, 360, 400, 440, 480, 520]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, reps: int = 100) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph
    and replayed, so the host's launch rate does not pace a call that is
    shorter than its own Python overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def check_close(got, want, dtype_name: str, what: str) -> float:
    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: kernel output is not finite")
    err = (g - w).abs()
    if bool((err > tol + tol * w.abs()).any()):
        fail(f"{what}: max abs error {float(err.max()):.3e} over "
             f"tolerance {tol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def prefill_bound(B, Sq, Skv, mask, dtype_name, itemsize):
    pairs = int(mask.sum())
    flops = 2 * B * H * pairs * K * 2            # QK^T and PV
    nbytes = (2 * B * Sq * H * K + 2 * B * Skv * HKV * K) * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def decode_bound(B, W, valid, dtype_name, itemsize, row_bytes=None):
    """Each live key and value row once (``row_bytes`` each: K * itemsize,
    or K + 4 for int8 codes and their scale), q/out and the mask once."""
    live = int(valid.sum())
    row = K * itemsize if row_bytes is None else row_bytes
    nbytes = 2 * live * HKV * row + 2 * B * H * K * itemsize + B * W
    flops = 2 * 2 * live * H * K
    if row_bytes is not None:
        flops += 2 * live * HKV * K              # the dequantising multiplies
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_bound(B, nblk, lengths, dtype_name, itemsize, row_bytes=None):
    """Each live key and value row once, the table and q/out once."""
    live = int(lengths.sum())
    row = K * itemsize if row_bytes is None else row_bytes
    nbytes = (2 * live * HKV * row + 2 * B * H * K * itemsize
              + B * nblk * 4)
    flops = 2 * 2 * live * H * K
    if row_bytes is not None:
        flops += 2 * live * HKV * K
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_case(gen, lengths, *, h, hkv, k, bs, nblk, dtype, share=0):
    """q, a page pool and a block table for rows of ``lengths``: each row
    owns ceil(len / bs) pages drawn at random from a pool twice the
    needed size (so its pages sit between other rows' and unowned ones),
    the rest of its table points at the scratch page (the pool's last),
    and with ``share`` row 1 maps its first ``share`` blocks onto row 0's
    pages, as a prefix hit does. Returns the tensors and the bool mask of
    pages no row owns (scratch included)."""
    dev = torch.device("cuda")
    B = len(lengths)
    n_pages = 2 * B * nblk
    q = torch.randn(B, h, k, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages + 1, bs, hkv, k, generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn(n_pages + 1, bs, hkv, k, generator=gen,
                     device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    table = perm[:B * nblk].reshape(B, nblk).to(torch.int32)
    owned = torch.arange(nblk, device=dev)[None, :] < (
        (torch.tensor(lengths, device=dev)[:, None] + bs - 1) // bs)
    table[~owned] = n_pages
    if share:
        table[1, :share] = table[0, :share]
    unowned = torch.ones(n_pages + 1, dtype=torch.bool, device=dev)
    unowned[table[owned].long()] = False
    return (q, kp, vp, table.contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device=dev), unowned)


def gathered(kp, vp, table, lengths):
    """The dense (B, nblk*bs, Hkv, K) view of a paged cache, and its
    valid mask ``arange < lengths``."""
    B, nblk = table.shape
    W = nblk * kp.shape[1]
    k = kp[table.long()].reshape(B, W, *kp.shape[2:]).contiguous()
    v = vp[table.long()].reshape(B, W, *vp.shape[2:]).contiguous()
    valid = torch.arange(W, device=kp.device)[None, :] < lengths[:, None]
    return k, v, valid


def paged_checks(gen):
    """The paged kernel against its plain version; bitwise against the
    dense kernel over the gathered view; unchanged (and finite) with every
    unowned page and the scratch page filled with NaN. Rows end around
    the split body's split edges too. Then the same live prefix at
    horizons 512 and 2048 (dense W, paged nblk * bs) gives the same bits."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    # (lengths, H, Hkv, K, bs, nblk, softcap, share)
    cases = [([48, 160, 300, 544], H, HKV, K, 16, 128, 0.0, 0),
             ([700, 33, 0, 2048, 17, 1, 1024, 255], H, HKV, K, 16, 128,
              0.0, 2),
             ([48, 160, 300, 544], H, HKV, K, 16, 128, 30.0, 0),
             ([90, 7, 500], 8, 8, 64, 16, 32, 0.0, 0),      # G = 1
             ([90, 7, 500], 16, 4, 64, 16, 32, 0.0, 0),     # G = 4
             ([90, 250, 500], 16, 2, 64, 16, 32, 0.0, 2),   # G = 8
             # rows ending at a 64-position split's edges, both sides
             ([63, 64, 65, 0, 2048, 127, 128, 129], H, HKV, K, 16, 128,
              0.0, 0),
             ([300, 64, 129], 8, 8, 256, 16, 32, 30.0, 0),  # G = 1, K = 256
             ([300, 64, 129], 16, 2, 32, 16, 32, 30.0, 0)]  # G = 8, K = 32
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for lengths, h, hkv, k, bs, nblk, softcap, share in cases:
            q, kp, vp, table, lens, unowned = paged_case(
                gen, lengths, h=h, hkv=hkv, k=k, bs=bs, nblk=nblk,
                dtype=dtype, share=share)
            what = (f"paged_decode_attention {dn} lengths={lengths} H={h} "
                    f"Hkv={hkv} K={k} bs={bs} nblk={nblk} softcap={softcap}")
            got = pa.paged_decode_attention(q, kp, vp, table, lens,
                                            softcap=softcap)
            torch.cuda.synchronize()
            want = ref.paged_decode_attention(q, kp, vp, table, lens,
                                              softcap=softcap)
            err = check_close(got, want, dn, what)
            for b, n in enumerate(lengths):
                if n == 0 and bool(got[b].ne(0).any()):
                    fail(f"{what}: length-0 row {b} is not 0")
            kd, vd, valid = gathered(kp, vp, table, lens)
            dense = da.decode_attention(q, kd, vd, valid, softcap=softcap)
            if not torch.equal(got, dense):
                fail(f"{what}: not bitwise equal to decode_attention over "
                     f"the gathered view (max diff "
                     f"{float((got.float() - dense.float()).abs().max()):.3e})")
            kp[unowned] = float("nan")
            vp[unowned] = float("nan")
            poisoned = pa.paged_decode_attention(q, kp, vp, table, lens,
                                                 softcap=softcap)
            if not (torch.equal(poisoned, got)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"{what}: output moved with NaN in unowned pages")
            print(f"{what}: max_abs_err={err:.3e}, bitwise equal to the "
                  "dense kernel, NaN unowned pages ignored", flush=True)
        lengths = [48, 160, 300, 512, 0]
        q, kp, vp, table, lens, _ = paged_case(
            gen, lengths, h=H, hkv=HKV, k=K, bs=16, nblk=128, dtype=dtype)
        kd, vd, valid = gathered(kp, vp, table, lens)
        outs = [pa.paged_decode_attention(q, kp, vp, table, lens),
                pa.paged_decode_attention(q, kp, vp,
                                          table[:, :32].contiguous(), lens),
                da.decode_attention(q, kd, vd, valid),
                da.decode_attention(q, kd[:, :512].contiguous(),
                                    vd[:, :512].contiguous(),
                                    valid[:, :512].contiguous())]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            fail(f"decode {dn}: the live prefix {lengths} gives other bits "
                 "at horizon 512 than at 2048")
        print(f"decode {dn} live {lengths}: paged nblk 128 / 32 and dense W "
              "2048 / 512 bit for bit", flush=True)


def quant(x):
    """int8 codes and float32 scales of x, by the model's quantiser."""
    from repro_torch.models.attention import _quant_kv
    return _quant_kv(x)


def int8_checks(gen):
    """The int8 kernels against their plain versions (f32 and bf16 q); the
    paged one bitwise against the dense one over the gathered view, a
    length-0 row 0, and unchanged with NaN in every unowned page, scale
    page and the scratch page (and NaN scales with codes of +-127 in dense
    slots no row reads, the dead slots of live splits included); rows end
    on both sides of the 64-position split edges, and the same live
    prefix gives the same bits at horizons 512 and 2048."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # (B, W, softcap, scattered): scattered rings leave every other
        # 64-position split without a live slot
        for B, W, softcap, scattered in ((4, 2048, 0.0, False),
                                         (3, 300, 30.0, False),
                                         (3, 1000, 0.0, True)):
            q = torch.randn(B, H, K, generator=gen, device=dev).to(dtype)
            kq, ks = quant(torch.randn(B, W, HKV, K, generator=gen,
                                       device=dev))
            vq, vs = quant(torch.randn(B, W, HKV, K, generator=gen,
                                       device=dev))
            valid = torch.rand(B, W, generator=gen, device=dev) < (
                0.3 if scattered else 0.7)
            if scattered:
                valid &= (torch.arange(W, device=dev) // 64 % 2 == 0)[None]
            valid[-1] = False                    # a row with no live slot
            what = (f"decode_attention_int8 {dn} B={B} W={W} "
                    f"softcap={softcap} scattered={scattered}")
            got = da.decode_attention_int8(q, kq, vq, valid, ks, vs,
                                           softcap=softcap)
            torch.cuda.synchronize()
            err = check_close(got, ref.decode_attention(
                q, kq, vq, valid, softcap=softcap, k_scale=ks, v_scale=vs),
                dn, what)
            if bool(got[-1].ne(0).any()):
                fail(f"{what}: all-invalid row is not 0")
            ks[~valid], vs[~valid] = float("nan"), float("nan")
            kq[~valid], vq[~valid] = 127, -127
            poisoned = da.decode_attention_int8(q, kq, vq, valid, ks, vs,
                                                softcap=softcap)
            if not (torch.equal(got, poisoned)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"{what}: output moved with NaN scales in dead slots")
            print(f"{what}: max_abs_err={err:.3e}, dead slots' NaN scales "
                  "ignored", flush=True)
        # (lengths, softcap, share): the main-path shape, the phase-2
        # scattered/shared tables with a length-0 row, softcap, and rows
        # ending at a 64-position split's edges, both sides
        for lengths, softcap, share in (
                (PAGED_MAIN_LENGTHS, 0.0, 0),
                ([700, 33, 0, 2048, 17, 1, 1024, 255], 0.0, 2),
                ([48, 160, 300, 544], 30.0, 0),
                ([63, 64, 65, 0, 2048, 127, 128, 129], 0.0, 0),
                ([1, 2047, 191, 192, 193], 30.0, 0)):
            q, kp, vp, table, lens, unowned = paged_case(
                gen, lengths, h=H, hkv=HKV, k=K, bs=16, nblk=128,
                dtype=torch.float32, share=share)
            q = q.to(dtype)
            kq, ks = quant(kp)
            vq, vs = quant(vp)
            what = (f"paged_decode_attention_int8 {dn} lengths={lengths} "
                    f"softcap={softcap}")
            got = pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table,
                                                 lens, softcap=softcap)
            torch.cuda.synchronize()
            err = check_close(got, ref.paged_decode_attention(
                q, kq, vq, table, lens, softcap=softcap, k_scale_pages=ks,
                v_scale_pages=vs), dn, what)
            for b, n in enumerate(lengths):
                if n == 0 and bool(got[b].ne(0).any()):
                    fail(f"{what}: length-0 row {b} is not 0")
            kd, vd, valid = gathered(kq, vq, table, lens)
            ksd, vsd, _ = gathered(ks, vs, table, lens)
            dense = da.decode_attention_int8(q, kd, vd, valid, ksd, vsd,
                                             softcap=softcap)
            if not torch.equal(got, dense):
                fail(f"{what}: not bitwise equal to decode_attention_int8 "
                     f"over the gathered view (max diff "
                     f"{float((got.float() - dense.float()).abs().max()):.3e})")
            ks[unowned], vs[unowned] = float("nan"), float("nan")
            kq[unowned], vq[unowned] = 127, -127
            poisoned = pa.paged_decode_attention_int8(
                q, kq, vq, ks, vs, table, lens, softcap=softcap)
            if not (torch.equal(poisoned, got)
                    and bool(torch.isfinite(poisoned).all())):
                fail(f"{what}: output moved with NaN in unowned pages or "
                     "scale pages")
            print(f"{what}: max_abs_err={err:.3e}, bitwise equal to the "
                  "dense int8 kernel, NaN unowned pages and scale pages "
                  "ignored", flush=True)
        lengths = [48, 160, 300, 512, 0]
        q, kp, vp, table, lens, _ = paged_case(
            gen, lengths, h=H, hkv=HKV, k=K, bs=16, nblk=128,
            dtype=torch.float32)
        q = q.to(dtype)
        kq, ks = quant(kp)
        vq, vs = quant(vp)
        kd, vd, valid = gathered(kq, vq, table, lens)
        ksd, vsd, _ = gathered(ks, vs, table, lens)
        short = table[:, :32].contiguous()
        outs = [pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table,
                                               lens),
                pa.paged_decode_attention_int8(q, kq, vq, ks, vs, short,
                                               lens),
                da.decode_attention_int8(q, kd, vd, valid, ksd, vsd),
                da.decode_attention_int8(
                    q, *(t[:, :512].contiguous()
                         for t in (kd, vd, valid, ksd, vsd)))]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            fail(f"int8 decode {dn}: the live prefix {lengths} gives other "
                 "bits at horizon 512 than at 2048")
        print(f"int8 decode {dn} live {lengths}: paged nblk 128 / 32 and "
              "dense W 2048 / 512 bit for bit", flush=True)


# the Mamba2 scan: mamba2-2.7b's widths, and the main path's longest
# distinct prefill that fits in one engine's bucket table
SSD_MAIN = dict(B=1, S=512, nh=80, hd=64, ng=1, ds=128, chunk=256)
# |kernel - plain| <= tol * max|plain|: the kernel tiles the sequence by
# 64 where the plain version cuts it at ``chunk``, and the running sums of
# dt*A that set the decays round differently with the cut (~1e-5 of the
# largest output in float32)
SSD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
SSD_TILE = 64   # where the kernel cuts the sequence


def ssd_inputs(gen, B, S, nh, hd, ng, ds, dtype, *, model_like=True):
    """Scan inputs on the card. ``model_like``: as mamba2's init feeds the
    scan — dt = softplus(N(0, 1) + dt_bias) with the init's dt_bias (dt
    0.001-0.1 at 0) and A = -exp(U(0, log 16)); otherwise the JAX suite's
    draw (dt = softplus(N(0, 1)), A = -exp(N(0, 1))). x, B, C ~ N(0, 1),
    D = 1; A and D float32, the rest in ``dtype``."""
    import math

    import torch.nn.functional as F

    from repro_torch.models.ssm import softplus
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    if model_like:
        bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, nh,
                                                    device=dev)))
        dt = softplus(randn(B, S, nh) + bias)
        A = -torch.exp(torch.rand(nh, generator=gen, device=dev)
                       * math.log(16.0))
    else:
        dt, A = F.softplus(randn(B, S, nh)), -torch.exp(randn(nh))
    return (randn(B, S, nh, hd).to(dtype), dt.to(dtype), A,
            randn(B, S, ng, ds).to(dtype), randn(B, S, ng, ds).to(dtype),
            torch.ones(nh, device=dev))


def ssd_bound(B, S, nh, hd, ng, ds, chunk, dtype_name, itemsize):
    """Inputs and outputs once each; operations of the chunked form on its
    lower triangles (C.B^T once per group, the quadratic term per head),
    the carried-state term and the state update."""
    nbytes = ((2 * B * S * nh * hd + B * S * nh + 2 * B * S * ng * ds
               + B * nh * hd * ds) * itemsize + 2 * nh * 4)
    pairs = (S // chunk) * chunk * (chunk + 1) // 2
    flops = 2 * B * pairs * (ng * ds + nh * hd) + 2 * 2 * B * S * nh * hd * ds
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_checks(gen):
    """The scan kernel against its plain version: the main-path shape in
    float32 and bfloat16, 8 chunks (S = 2048), B = 2, a ragged one-chunk
    prompt, ng = 2 heads-to-groups, and the JAX suite's harsher draw.
    Relative to max|plain| at the caller's chunk, and element by element
    (tol abs + tol rel) against the plain version cut where the kernel
    cuts, at 64 positions, wherever 64 divides S. Returns the largest
    error relative to max|plain| per dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    worst = {}
    m = SSD_MAIN
    cases = [  # (B, S, nh, hd, ng, ds, chunk, model_like)
        (m["B"], m["S"], m["nh"], m["hd"], m["ng"], m["ds"], m["chunk"],
         True),
        (1, 2048, 80, 64, 1, 128, 256, True),
        (2, 512, 80, 64, 1, 128, 256, True),
        (1, 200, 80, 64, 1, 128, 200, True),
        (2, 256, 8, 64, 2, 128, 256, True),
        (1, 512, 80, 64, 2, 128, 256, True),
        (2, 128, 4, 16, 2, 16, 32, False),
        (1, 512, 80, 64, 1, 128, 256, False)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, S, nh, hd, ng, ds, chunk, model_like in cases:
            args = ssd_inputs(gen, B, S, nh, hd, ng, ds, dtype,
                              model_like=model_like)
            what = (f"ssd_scan {dn} B={B} S={S} nh={nh} hd={hd} ng={ng} "
                    f"ds={ds} chunk={chunk} "
                    f"{'model-like' if model_like else 'JAX-suite'} inputs")
            got = ssd.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            want = ref.ssd_scan(*args, chunk=chunk)
            rel = max(ssd_close(g, w, dn, f"{what} {name}")
                      for name, g, w in zip(("y", "state"), got, want))
            worst[dn] = max(worst.get(dn, 0.0), rel)
            tol = SSD_TOL[dn]
            cut = ""
            if S % SSD_TILE == 0:
                want = ref.ssd_scan(*args, chunk=SSD_TILE)
                err = max(ssd_elementwise(g, w, dn, f"{what} {name}")
                          for name, g, w in zip(("y", "state"), got, want))
                cut = (f"; element by element at chunk {SSD_TILE}: max "
                       f"abs error {err:.3e} within {tol} abs + rel")
            ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk), reps=5)
            plain = ""
            if S >= 512:
                plain = " plain_ms={:.4f}".format(time_ms(
                    lambda: ref.ssd_scan(*args, chunk=chunk), reps=3))
            print(f"{what}: max |kernel - plain| / max|plain| = {rel:.3e} "
                  f"(y and state; tolerance {tol}){cut}; kernel_ms="
                  f"{ms:.4f}{plain}", flush=True)
    return worst


def ssd_elementwise(got, want, dtype_name: str, what: str) -> float:
    """|got - want| <= SSD_TOL * (1 + |want|) element by element, against
    the plain version cut at SSD_TILE; returns the max abs error."""
    tol = SSD_TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    over = int((err > tol + tol * w.abs()).sum())
    if over:
        fail(f"{what}: {over} of {w.numel()} elements differ from the plain "
             f"version at chunk {SSD_TILE} by more than {tol} abs + rel "
             f"(max {float(err.max()):.3e})")
    return float(err.max())


def ssd_close(got, want, dtype_name: str, what: str) -> float:
    """|got - want| <= SSD_TOL * max|want|, finite; returns that ratio."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: kernel output is not finite")
    scale = float(w.abs().max())
    rel = float((g - w).abs().max()) / max(scale, 1e-30)
    if rel > SSD_TOL[dtype_name]:
        fail(f"{what}: max |kernel - plain| is {rel:.3e} of max|plain| "
             f"{scale:.3e}, over {SSD_TOL[dtype_name]}")
    return rel


# the bf16 scan's CUDA kernels a call: chunk states, the pass over them,
# the outputs
SSD_KERNELS_PER_CALL = 3


def ssd_call_footprint(call) -> tuple[list, int]:
    """What one ``ssd_scan`` call does on the card, read in this run: the
    CUDA kernels it launches (name, count), from ``torch.profiler``, and
    the scratch it allocates beyond its outputs, the peak of
    ``memory_allocated`` during the call less what stays after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out
    return kernels, scratch


# absorbed-MLA decode at deepseek-v2-lite's widths: a 4-slot decode step
# over the 2048-position latent cache, rows live to phase 2's depths
MLA_MAIN = dict(B=4, S=2048, H=16, r=512, dr=64)
MLA_DEPTHS = [48, 160, 300, 544]
MLA_SCALE = 192 ** -0.5          # (qk_nope + qk_rope) ** -0.5


def mla_inputs(gen, B, S, dtype, H=16, r=512, dr=64):
    """q_lat, q_rope, ckv, k_rope ~ N(0, 1) on the card, in ``dtype``."""
    return tuple(torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, H, r), (B, H, dr), (B, S, r), (B, S, dr)))


def mla_bound(valid, H, r, dr, dtype_name, itemsize):
    """Each live latent and rope row read once, q, the mask and the
    output once; 2 * H * (2r + dr) operations per live position."""
    B, S = valid.shape
    live = int(valid.sum())
    nbytes = ((live + B * H) * (r + dr) * itemsize + B * S
              + B * H * r * itemsize)
    flops = 2 * H * live * (2 * r + dr)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mla_checks(gen):
    """The MLA decode kernel against its plain version, float32 and
    bfloat16, each shape timed beside its plain version and its bound:
    the main shape; a ragged S = 1000 with one all-dead row, which must
    read 0 and keep its bits with NaN in every dead position; rows live
    to the split edges; and the logical view gathered from 16-token
    latent pages (the paged cache's path), which must also ignore NaN in
    every page no row owns."""
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    m = MLA_MAIN

    def held(what, dn, args, valid):
        """The kernel against its plain version on ``args``; prints the
        error, the kernel's and the plain version's ms and the bound."""
        got = mla.mla_decode_ctx(*args, valid, scale=MLA_SCALE)
        torch.cuda.synchronize()
        err = check_close(got, ref.mla_decode_ctx(*args, valid,
                                                  scale=MLA_SCALE), dn, what)
        bound, by = mla_bound(valid, m["H"], m["r"], m["dr"], dn,
                              args[0].element_size())
        print(f"{what}: max_abs_err={err:.3e} kernel_ms="
              f"{time_ms(lambda: mla.mla_decode_ctx(*args, valid, scale=MLA_SCALE)):.4f}"
              f" plain_ms="
              f"{time_ms(lambda: ref.mla_decode_ctx(*args, valid, scale=MLA_SCALE), reps=5):.4f}"
              f" bound_ms={bound:.6f} ({by})", flush=True)
        return got

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        valid = (torch.arange(m["S"], device=dev)[None, :]
                 < torch.tensor(MLA_DEPTHS, device=dev)[:, None])
        held(f"mla_decode_ctx {dn} B={m['B']} S={m['S']} live={MLA_DEPTHS}",
             dn, mla_inputs(gen, m["B"], m["S"], dtype), valid)

        B, S = 3, 1000
        valid = torch.rand(B, S, generator=gen, device=dev) < 0.7
        valid[-1] = False                    # a row with no live position
        what = f"mla_decode_ctx {dn} B={B} S={S} ragged, row {B - 1} dead"
        args = mla_inputs(gen, B, S, dtype)
        got = held(what, dn, args, valid)
        if bool(got[-1].ne(0).any()):
            fail(f"{what}: the all-dead row is not 0")
        # dead positions inside live splits are never read
        args[2][~valid] = float("nan")
        args[3][~valid] = float("nan")
        if not torch.equal(mla.mla_decode_ctx(*args, valid,
                                              scale=MLA_SCALE), got):
            fail(f"{what}: output moved with NaN in dead positions")
        print(f"{what}: NaN in dead positions of live splits ignored",
              flush=True)

        # rows live to the 64-position splits' edges and the whole horizon
        edges = [1, 63, 64, 65, 127, 128, 129, m["S"]]
        valid = (torch.arange(m["S"], device=dev)[None, :]
                 < torch.tensor(edges, device=dev)[:, None])
        held(f"mla_decode_ctx {dn} S={m['S']} live={edges}", dn,
             mla_inputs(gen, len(edges), m["S"], dtype), valid)

        # the paged path: pages drawn at random from a pool twice the
        # needed size, the rest of each table on the scratch page
        bs, nblk = 16, m["S"] // 16
        B, n_pages = m["B"], 2 * m["B"] * nblk
        ql, qr, _, _ = mla_inputs(gen, B, 1, dtype)
        ckv_p = torch.randn(n_pages + 1, bs, m["r"], generator=gen,
                            device=dev).to(dtype)
        kr_p = torch.randn(n_pages + 1, bs, m["dr"], generator=gen,
                           device=dev).to(dtype)
        lengths = torch.tensor(MLA_DEPTHS, device=dev)
        table = torch.randperm(n_pages, generator=gen, device=dev)[
            :B * nblk].reshape(B, nblk)
        owned = torch.arange(nblk, device=dev)[None, :] < (
            (lengths[:, None] + bs - 1) // bs)
        table[~owned] = n_pages
        unowned = torch.ones(n_pages + 1, dtype=torch.bool, device=dev)
        unowned[table[owned]] = False
        valid = (torch.arange(m["S"], device=dev)[None, :]
                 < lengths[:, None])

        def view(pages):
            return pages[table].reshape(B, m["S"], pages.shape[-1])
        what = (f"mla_decode_ctx {dn} over 16-token pages, live="
                f"{MLA_DEPTHS}")
        got = held(what, dn, (ql, qr, view(ckv_p), view(kr_p)), valid)
        ckv_p[unowned] = float("nan")
        kr_p[unowned] = float("nan")
        poisoned = mla.mla_decode_ctx(ql, qr, view(ckv_p), view(kr_p),
                                      valid, scale=MLA_SCALE)
        if not (torch.equal(poisoned, got)
                and bool(torch.isfinite(poisoned).all())):
            fail(f"{what}: output moved with NaN in unowned pages")
        print(f"{what}: NaN in unowned pages ignored", flush=True)


def flash_mla_checks(gen):
    """The prefill kernel at MLA's widths (K = 192, Kv = 128, H = Hkv =
    16, causal), float32 and bfloat16; returns the bfloat16 numbers: ms,
    the plain version's, one sdpa call's (never called by the port) and
    the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        q, k = (torch.randn(1, 512, 16, 192, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        v = torch.randn(1, 512, 16, 128, generator=gen,
                        device="cuda").to(dtype)
        what = f"flash_attention {dn} B=1 Sq=Skv=512 H=Hkv=16 K=192 Kv=128"
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = check_close(got, ref.flash_attention(q, k, v), dn, what)
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms:.4f}",
              flush=True)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = ref.attention_mask(512, 512, causal=True, window=0,
                              device=q.device)
    pairs = int(mask.sum())
    flops = 2 * 16 * pairs * (192 + 128)
    nbytes = 512 * 16 * (2 * 192 + 2 * 128) * 2    # q, k, v, out once
    t_ops, t_bytes = flops / PEAK_FLOPS[dn], nbytes / PEAK_BYTES_S
    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    return {"ms": ms, "max_abs_err": err,
            "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v),
                                reps=5),
            "library_ms": time_ms(library),
            "graph_ms": time_graph_ms(lambda: fa.flash_attention(q, k, v)),
            "library_graph_ms": time_graph_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "shape": "B=1 Sq=Skv=512 H=Hkv=16 K=192 Kv=128 bf16 causal"}


# the prefill kernel at the other shapes it takes: K padded to the MMA
# depth (72, 5 with rows off 16 bytes), K = 192 / 256, Kv from 16 to 256,
# one KV head, Sq = 1, queries right-aligned against longer and shorter
# key runs (rows that see no key give 0), a window and a softcap
FLASH_SHAPES = [  # (B, Sq, Skv, H, Hkv, K, Kv, window, softcap)
    (1, 100, 100, 4, 2, 72, 64, 0, 0.0),
    (1, 130, 130, 4, 2, 192, 128, 0, 0.0),
    (1, 77, 77, 4, 2, 5, 32, 0, 0.0),
    (2, 70, 70, 4, 2, 64, 16, 0, 0.0),
    (1, 90, 90, 4, 1, 128, 256, 0, 0.0),
    (1, 40, 40, 4, 2, 256, 256, 0, 0.0),
    (1, 96, 96, 8, 1, 128, 128, 0, 0.0),
    (2, 1, 50, 4, 2, 128, 128, 0, 0.0),
    (1, 40, 150, 4, 2, 64, 64, 0, 0.0),
    (1, 80, 50, 4, 2, 64, 64, 0, 0.0),
    (1, 200, 200, 4, 2, 64, 64, 100, 0.0),
    (1, 300, 300, 2, 2, 32, 32, 0, 30.0)]


def flash_shape_checks(gen):
    """The prefill kernel against its plain version at FLASH_SHAPES in
    float32 and bfloat16, and the prefix-sharing property bit for bit: the
    suffix's rows over [context | suffix] equal the whole prompt's, at a
    context of 256 and of 272 (a row at another place in its query
    tile)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, Sq, Skv, h, hkv, k_, kv, window, softcap in FLASH_SHAPES:
            q = randn(B, Sq, h, k_, dtype=dtype)
            k = randn(B, Skv, hkv, k_, dtype=dtype)
            v = randn(B, Skv, hkv, kv, dtype=dtype)
            kw = dict(causal=True, window=window, softcap=softcap)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            what = (f"flash_attention {dn} B={B} Sq={Sq} Skv={Skv} H={h} "
                    f"Hkv={hkv} K={k_} Kv={kv} window={window} "
                    f"softcap={softcap}")
            err = check_close(got, ref.flash_attention(q, k, v, **kw), dn,
                              what)
            if bool(got[:, :max(Sq - Skv, 0)].ne(0).any()):
                fail(f"{what}: a row that sees no key is not 0")
            print(f"{what}: max_abs_err={err:.3e}", flush=True)
        for ctx in (256, 272):
            q, k, v = (randn(2, 512, n, K, dtype=dtype) for n in (H, HKV, HKV))
            full = fa.flash_attention(q, k, v)
            part = fa.flash_attention(q[:, ctx:ctx + 128].contiguous(),
                                      k[:, :ctx + 128].contiguous(),
                                      v[:, :ctx + 128].contiguous())
            if not torch.equal(part[:, :100], full[:, ctx:ctx + 100]):
                fail(f"flash_attention {dn}: the suffix over [context {ctx} "
                     "| suffix] is not the whole prompt's rows bit for bit")
        print(f"flash_attention {dn}: suffix rows over [context | suffix] "
              "equal the whole prompt's bit for bit at contexts 256 and 272",
              flush=True)


# RMSNorm at every width the port's norms see: 128 (qwen3 q/k norms, rows
# B*S*H), 512 (the deepseek latent norm), 1024 / 2048 / 2560 (block norms)
# and 5120 (the mamba2 gated norm), and those of the families still to
# come (4096 to 7168); the main shape is the block norm of a 512-token
# qwen3 prefill
RMS_WIDTHS = (128, 512, 1024, 2048, 2560, 5120)
RMS_LATER = (4096, 5376, 6144, 7168)
RMS_ROWS = (1, 37, 4099)      # no multiple of the kernel's rows a block
RMS_MAIN = dict(rows=512, D=1024)
RMS_EPS = 1e-6
# widths the 16-byte path does not take (V = 8 bf16 / 4 f32 elements does
# not divide them), and one wider than the registers hold
RMS_ODD = {"float32": (1022, 20000), "bfloat16": (1020, 20000)}
# a 4-slot decode step's norms, bf16: (shape, width read of it)
RMS_DECODE = {"qwen3 block": ((4, 1, 1024), None),
              "mamba2 block": ((4, 1, 2560), None),
              "mamba2 gated": ((4, 1, 5120), None),
              "deepseek block": ((4, 1, 2048), None),
              "deepseek latent": ((4, 1, 576), 512)}
QK_DECODE = ((4, 1, 16, 128), (4, 1, 8, 128))    # qwen3's q and k


def rmsnorm_bound(shapes, dtype_name, itemsize, scale_itemsize):
    """x read once, y written once, scale read once, for each (rows, D) of
    ``shapes`` (one launch may normalise two tensors); ~4 flops an element
    (square, sum, two products)."""
    nbytes = sum(2 * rows * D * itemsize + D * scale_itemsize
                 for rows, D in shapes)
    ops = sum(4 * rows * D for rows, D in shapes)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _copy_at(t, offset=0, pad=0):
    """t (rows, D)'s values in a fresh buffer: ``offset`` elements past its
    16-byte aligned base, and with rows ``pad`` elements wider than t's."""
    rows, D = t.shape
    buf = torch.empty(offset + rows * (D + pad), dtype=t.dtype,
                      device=t.device)
    view = buf[offset:].view(rows, D + pad)[:, :D]
    view.copy_(t)
    return view


def rmsnorm_checks(gen):
    """rmsnorm against its plain version: every width, float32 and
    bfloat16, 1 / 37 / 4099 rows, the MLA latent slice dkv[..., :512] of
    576-wide rows read in place, a float32 scale under bfloat16 rows, and
    widths the 16-byte path does not take. Then bit for bit: a row alone,
    inside 4099 rows and in a pair launch; the same rows with a base one
    element off 16 bytes, a row stride of D + 1 and a scale off 16 bytes
    (the one-element path) as the aligned ones; and a pair launch as two
    single ones, counted once. Returns the worst error by dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        widths = RMS_WIDTHS + RMS_LATER + RMS_ODD[dn]
        cases = [(randn(rows, D).mul_(2).to(dtype),
                  (1 + 0.1 * randn(D)).to(dtype), f"rows={rows} D={D}")
                 for D in widths for rows in RMS_ROWS]
        dkv = randn(4, 512, 576).to(dtype)
        cases.append((dkv[..., :512], (1 + 0.1 * randn(512)).to(dtype),
                      "strided dkv[..., :512] of (4, 512, 576)"))
        cases.append((randn(37, 2048).to(dtype), 1 + 0.1 * randn(2048),
                      "rows=37 D=2048 float32 scale"))
        errs = []
        for x, scale, what in cases:
            got = rn.rmsnorm(x, scale, RMS_EPS)
            torch.cuda.synchronize()
            errs.append(check_close(got, ref.rmsnorm(x, scale, RMS_EPS), dn,
                                    f"rmsnorm {dn} {what}"))
            if x.shape[0] != RMS_ROWS[-1]:
                continue
            # bits: a row alone, inside the rows, in a pair (either side);
            # the one-element path on the same rows
            D = x.shape[-1]
            y, y_scale = randn(37, D).to(dtype), scale.flip(0)
            for r in (0, 5, 2048, x.shape[0] - 1):
                if not torch.equal(rn.rmsnorm(x[r:r + 1], scale,
                                              RMS_EPS)[0], got[r]):
                    fail(f"rmsnorm {dn} D={D}: row {r} alone has other "
                         "bits than inside 4099 rows")
            a, b = rn.rmsnorm_pair(x, scale, y, y_scale, RMS_EPS)
            c, d = rn.rmsnorm_pair(y, y_scale, x[5:6], scale, RMS_EPS)
            if not (torch.equal(a, got) and torch.equal(d[0], got[5])
                    and torch.equal(b, c)
                    and torch.equal(b, rn.rmsnorm(y, y_scale, RMS_EPS))):
                fail(f"rmsnorm {dn} D={D}: rows in a pair launch have "
                     "other bits than alone")
            head = x[:37]
            off_scale = _copy_at(scale[None], offset=1)[0]
            for other, how in ((rn.rmsnorm(_copy_at(head, offset=1), scale,
                                           RMS_EPS), "a base off 16 bytes"),
                               (rn.rmsnorm(_copy_at(head, pad=1), scale,
                                           RMS_EPS), f"row stride {D + 1}"),
                               (rn.rmsnorm(head, off_scale, RMS_EPS),
                                "a scale off 16 bytes")):
                if not torch.equal(other, got[:37]):
                    fail(f"rmsnorm {dn} D={D}: {how} (one element at a "
                         "time) gives other bits than the aligned rows")
        worst[dn] = max(errs)
        # a layer's q and k norms: one launch, the bits of two
        q, k = (randn(*shape).to(dtype) for shape in QK_DECODE)
        qs, ks = ((1 + 0.1 * randn(128)).to(dtype) for _ in range(2))
        before = rn.launches.value
        gq, gk = rn.rmsnorm_pair(q, qs, k, ks, RMS_EPS)
        torch.cuda.synchronize()
        if rn.launches.value != before + 1:
            fail(f"rmsnorm {dn}: a pair took {rn.launches.value - before} "
                 "launches")
        if not (torch.equal(gq, rn.rmsnorm(q, qs, RMS_EPS))
                and torch.equal(gk, rn.rmsnorm(k, ks, RMS_EPS))):
            fail(f"rmsnorm {dn}: the q/k pair is not two single launches "
                 "bit for bit")
        print(f"rmsnorm {dn}: {len(cases)} cases (D {list(widths)} x rows "
              f"{list(RMS_ROWS)}, a strided latent slice, a float32 scale) "
              f"within {TOL[dn]} abs + rel of the plain version, "
              f"max_abs_err={worst[dn]:.3e}; bit for bit: a row alone = "
              "inside 4099 rows = in a pair, one element at a time (base "
              "or scale off 16 bytes, row stride D + 1) = 16-byte loads, "
              "the q/k pair (one launch) = two launches", flush=True)
    return worst


def rmsnorm_decode_calls(gen) -> dict:
    """The norms of a 4-slot decode step at their shapes, bf16: {name:
    {"kernel", "library": zero-argument calls, "bound": (ms, by)}}. The
    q/k norms as two single launches and, where the port has it, as one
    pair launch. The library call is ``torch.nn.functional.rms_norm``
    (one a tensor), which the port never makes."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    dtype = torch.bfloat16

    def case(shape, width=None):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        x = x if width is None else x[..., :width]
        D = x.shape[-1]
        return x, (1 + 0.1 * torch.randn(D, generator=gen,
                                          device=dev)).to(dtype)

    def rows_d(x):
        return x.numel() // x.shape[-1], x.shape[-1]

    calls = {}
    for name, (shape, width) in RMS_DECODE.items():
        x, s = case(shape, width)
        calls[f"{name} {shape}" + (f"[..., :{width}]" if width else "")] = {
            "kernel": lambda x=x, s=s: rn.rmsnorm(x, s, RMS_EPS),
            "library": lambda x=x, s=s: F.rms_norm(x, (x.shape[-1],),
                                                   weight=s, eps=RMS_EPS),
            "bound": rmsnorm_bound([rows_d(x)], "bfloat16", 2, 2)}
    (q, qs), (k, ks) = (case(shape) for shape in QK_DECODE)

    def library():
        return (F.rms_norm(q, (128,), weight=qs, eps=RMS_EPS),
                F.rms_norm(k, (128,), weight=ks, eps=RMS_EPS))
    bound = rmsnorm_bound([rows_d(q), rows_d(k)], "bfloat16", 2, 2)
    qk = f"qwen3 q/k {QK_DECODE[0]} + {QK_DECODE[1]}"
    calls[f"{qk} as two launches"] = {
        "kernel": lambda: (rn.rmsnorm(q, qs, RMS_EPS),
                           rn.rmsnorm(k, ks, RMS_EPS)),
        "library": library, "bound": bound}
    if hasattr(rn, "rmsnorm_pair"):
        calls[f"{qk} as one pair launch"] = {
            "kernel": lambda: rn.rmsnorm_pair(q, qs, k, ks, RMS_EPS),
            "library": library, "bound": bound}
    return calls


def launch_floor_ms() -> float:
    """Device time of an empty kernel (``torch.cuda._sleep(0)``) replayed
    from a CUDA graph: the least any launch takes on this card."""
    return time_graph_ms(lambda: torch.cuda._sleep(0))


def decode_main_calls(gen) -> dict:
    """The four decode kernels and MLA decode at their main-path shapes,
    bfloat16: {name: {"kernel", "plain", "library": zero-argument calls,
    "bound": (ms, by), "shape": text}}. Dense decode: a 4-slot step over
    the 2048-slot ring with rows live to phase 4's depths; paged: phase
    6's 8 rows of 16-token pages
    live to 280-520; int8 at those shapes (int8 K/V from the model's
    quantiser, bf16 queries); MLA at deepseek-v2-lite's widths. The
    library call is one ``scaled_dot_product_attention`` the port never
    makes: masked, over the pre-gathered dense view (paged), over the
    dequantised bf16 view (int8), and over [q_lat | q_rope] against
    [ckv | k_rope] (MLA); gathers, dequantisation and concatenation are
    not timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    dtype, dn, isz = torch.bfloat16, "bfloat16", 2

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, valid, **kw):
        """(B, H, K) queries against (B, W, Hkv, K) keys/values."""
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask4 = valid[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, enable_gqa=True, **kw)

    def dequant(codes, scale):
        return (codes.float() * scale[..., None]).to(dtype)

    calls = {}
    B, W = 4, 2048
    depth = torch.tensor([48, 160, 300, 544], device=dev)
    valid = torch.arange(W, device=dev)[None, :] < depth[:, None]
    q, k, v = randn(B, H, K), randn(B, W, HKV, K), randn(B, W, HKV, K)
    calls["decode_attention"] = {
        "kernel": lambda: da.decode_attention(q, k, v, valid),
        "plain": lambda: ref.decode_attention(q, k, v, valid),
        "library": sdpa(q, k, v, valid),
        "bound": decode_bound(B, W, valid, dn, isz),
        "shape": f"B={B} W={W} H={H} Hkv={HKV} K={K} bf16 live="
                 f"{depth.tolist()}"}

    lengths, bs, nblk = PAGED_MAIN_LENGTHS, 16, 128
    pq, kp, vp, table, lens, _ = paged_case(gen, lengths, h=H, hkv=HKV, k=K,
                                            bs=bs, nblk=nblk, dtype=dtype)
    kd, vd, pvalid = gathered(kp, vp, table, lens)
    calls["paged_decode_attention"] = {
        "kernel": lambda: pa.paged_decode_attention(pq, kp, vp, table, lens),
        "plain": lambda: ref.paged_decode_attention(pq, kp, vp, table, lens),
        "library": sdpa(pq, kd, vd, pvalid),
        "bound": paged_bound(len(lengths), nblk, lens, dn, isz),
        "shape": f"B={len(lengths)} bs={bs} nblk={nblk} H={H} Hkv={HKV} "
                 f"K={K} bf16 live={lengths}; library_ms is sdpa over the "
                 "pre-gathered dense view (gather not counted)"}

    qi = randn(B, H, K)
    kq, ks = quant(torch.randn(B, W, HKV, K, generator=gen, device=dev))
    vq, vs = quant(torch.randn(B, W, HKV, K, generator=gen, device=dev))
    calls["decode_attention_int8"] = {
        "kernel": lambda: da.decode_attention_int8(qi, kq, vq, valid, ks, vs),
        "plain": lambda: ref.decode_attention(qi, kq, vq, valid, k_scale=ks,
                                              v_scale=vs),
        "library": sdpa(qi, dequant(kq, ks), dequant(vq, vs), valid),
        "bound": decode_bound(B, W, valid, dn, isz, row_bytes=K + 4),
        "shape": f"B={B} W={W} H={H} Hkv={HKV} K={K} bf16 q, int8 K/V + "
                 f"f32 scales, live={depth.tolist()}; library_ms is sdpa "
                 "over the dequantised bf16 view (dequant not counted)"}

    iq, ikp, ivp, itable, ilens, _ = paged_case(
        gen, lengths, h=H, hkv=HKV, k=K, bs=bs, nblk=nblk,
        dtype=torch.float32)
    iq = iq.to(dtype)
    ikq, iks = quant(ikp)
    ivq, ivs = quant(ivp)
    ikd, ivd, ivalid = gathered(ikq, ivq, itable, ilens)
    iksd, ivsd, _ = gathered(iks, ivs, itable, ilens)
    calls["paged_decode_attention_int8"] = {
        "kernel": lambda: pa.paged_decode_attention_int8(
            iq, ikq, ivq, iks, ivs, itable, ilens),
        "plain": lambda: ref.paged_decode_attention(
            iq, ikq, ivq, itable, ilens, k_scale_pages=iks,
            v_scale_pages=ivs),
        "library": sdpa(iq, dequant(ikd, iksd), dequant(ivd, ivsd), ivalid),
        "bound": paged_bound(len(lengths), nblk, ilens, dn, isz,
                             row_bytes=K + 4),
        "shape": f"B={len(lengths)} bs={bs} nblk={nblk} H={H} Hkv={HKV} "
                 f"K={K} bf16 q, int8 pages + f32 scale pages, live="
                 f"{lengths}; library_ms is sdpa over the pre-gathered, "
                 "dequantised bf16 view (gather and dequant not counted)"}

    m = MLA_MAIN
    args = mla_inputs(gen, m["B"], m["S"], dtype)
    mvalid = (torch.arange(m["S"], device=dev)[None, :]
              < torch.tensor(MLA_DEPTHS, device=dev)[:, None])
    ql, qr, ckv, kr = args
    q4 = torch.cat([ql, qr], dim=-1)[:, :, None]
    k4 = torch.cat([ckv, kr], dim=-1)[:, None]
    mask4 = mvalid[:, None, None, :]
    calls["mla_decode_ctx"] = {
        "kernel": lambda: mla.mla_decode_ctx(*args, mvalid, scale=MLA_SCALE),
        "plain": lambda: ref.mla_decode_ctx(*args, mvalid, scale=MLA_SCALE),
        "library": lambda: F.scaled_dot_product_attention(
            q4, k4, ckv[:, None], attn_mask=mask4, scale=MLA_SCALE,
            enable_gqa=True),
        "bound": mla_bound(mvalid, m["H"], m["r"], m["dr"], dn, isz),
        "shape": f"B={m['B']} S={m['S']} H={m['H']} r={m['r']} "
                 f"dr={m['dr']} bf16 live={MLA_DEPTHS}; library_ms is sdpa "
                 "over q=[q_lat|q_rope], k=[ckv|k_rope] (one kv head), "
                 "v=ckv (concatenation not counted)"}
    return calls


def kernel_phase():
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # (B, Sq, Skv, window, softcap)
        for B, Sq, Skv, window, softcap in [
                (1, 16, 16, 0, 0.0), (2, 100, 100, 0, 0.0),
                (1, 512, 512, 0, 0.0), (1, 2048, 2048, 0, 0.0),
                (1, 128, 640, 0, 0.0), (1, 512, 512, 128, 0.0),
                (1, 512, 512, 0, 30.0)]:
            q = randn(B, Sq, H, K, dtype=dtype)
            k = randn(B, Skv, HKV, K, dtype=dtype)
            v = randn(B, Skv, HKV, K, dtype=dtype)
            kw = dict(causal=True, window=window, softcap=softcap)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, **kw)
            what = (f"flash_attention {dn} B={B} Sq={Sq} Skv={Skv} "
                    f"window={window} softcap={softcap}")
            err = check_close(got, want, dn, what)
            ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, **kw),
                               reps=5)
            print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}", flush=True)
        for B in (1, 4):
            W = 2048
            q = randn(B, H, K, dtype=dtype)
            k = randn(B, W, HKV, K, dtype=dtype)
            v = randn(B, W, HKV, K, dtype=dtype)
            valid = torch.rand(B, W, generator=gen, device=dev) < 0.7
            if B > 1:
                valid[-1] = False            # a row with no live slot
            got = da.decode_attention(q, k, v, valid)
            torch.cuda.synchronize()
            want = ref.decode_attention(q, k, v, valid)
            what = f"decode_attention {dn} B={B} W={W}"
            err = check_close(got, want, dn, what)
            if B > 1 and bool(got[-1].ne(0).any()):
                fail(f"{what}: all-invalid row is not 0")
            ms = time_ms(lambda: da.decode_attention(q, k, v, valid))
            plain_ms = time_ms(
                lambda: ref.decode_attention(q, k, v, valid), reps=5)
            print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}", flush=True)

    flash_shape_checks(gen)
    paged_checks(gen)

    # the line's numbers: one main-path shape per kernel, bfloat16 —
    # the largest prefill bucket the main path admits (one 512-token
    # prompt) and a 4-slot decode over the 2048-slot ring with each row
    # live up to a main-path depth
    dtype, dn, isz = torch.bfloat16, "bfloat16", 2
    B, S = 1, 512
    q = randn(B, S, H, K, dtype=dtype)
    k = randn(B, S, HKV, K, dtype=dtype)
    v = randn(B, S, HKV, K, dtype=dtype)
    err = check_close(fa.flash_attention(q, k, v),
                      ref.flash_attention(q, k, v), dn, "flash main shape")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, by = prefill_bound(
        B, S, S, ref.attention_mask(S, S, causal=True, window=0,
                                    device=dev), dn, isz)
    def kernel():
        return fa.flash_attention(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    results["flash_attention"] = {
        "max_abs_err": err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v), reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(library),
        # device time: 100 calls replayed from a CUDA graph, so the host's
        # launch rate does not pace them
        "graph_ms": time_graph_ms(kernel),
        "library_graph_ms": time_graph_ms(library),
        "shape": f"B={B} Sq=Skv={S} H={H} Hkv={HKV} K={K} bf16 causal; ms "
                 "and library_ms launched one by one (CUDA events), "
                 "graph_ms and library_graph_ms replayed from a CUDA graph"}

    # the decode kernels and MLA decode at their main-path shapes: checked
    # against their plain versions first, then one row each
    int8_checks(gen)
    mla_checks(gen)
    for name, row in decode_main_calls(gen).items():
        results[name] = {
            "max_abs_err": check_close(row["kernel"](), row["plain"](), dn,
                                       f"{name} main shape"),
            "ms": time_ms(row["kernel"]),
            "plain_ms": time_ms(row["plain"], reps=5),
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": time_ms(row["library"]),
            # device time, as for the prefill kernel
            "graph_ms": time_graph_ms(row["kernel"]),
            "library_graph_ms": time_graph_ms(row["library"]),
            "shape": row["shape"] + "; ms and library_ms launched one by "
                     "one (CUDA events), graph_ms and library_graph_ms "
                     "replayed from a CUDA graph"}
        print(f"{name} main shape: {results[name]}", flush=True)

    # the SSD scan at the main path's 512-token prefill, bf16; no PyTorch
    # call computes the scan, so there is no library yardstick
    from repro_torch.kernels import ssd_scan as ssd
    worst = ssd_checks(gen)
    m = SSD_MAIN
    args = ssd_inputs(gen, m["B"], m["S"], m["nh"], m["hd"], m["ng"],
                      m["ds"], dtype)
    got = ssd.ssd_scan(*args, chunk=m["chunk"])
    want = ref.ssd_scan(*args, chunk=m["chunk"])
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    rel = max(ssd_close(g, w, dn, "ssd main shape")
              for g, w in zip(got, want))
    bound, by = ssd_bound(*(m[k] for k in ("B", "S", "nh", "hd", "ng", "ds",
                                           "chunk")), dn, isz)
    launched, scratch = ssd_call_footprint(
        lambda: ssd.ssd_scan(*args, chunk=m["chunk"]))
    n_launched = sum(c for _, c in launched)
    if n_launched != SSD_KERNELS_PER_CALL:
        fail(f"ssd_scan: one bf16 call launched {n_launched} CUDA kernels "
             f"({launched}), not {SSD_KERNELS_PER_CALL}")
    results["ssd_scan"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk=m["chunk"])),
        "graph_ms": time_graph_ms(lambda: ssd.ssd_scan(*args,
                                                       chunk=m["chunk"])),
        "plain_ms": time_ms(lambda: ref.ssd_scan(*args, chunk=m["chunk"]),
                            reps=5),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        # one bf16 call's CUDA kernels and float32 scratch, read on the card
        "cuda_kernels_per_call": n_launched,
        "cuda_kernels": launched,
        "scratch_bytes": scratch,
        "shape": f"B={m['B']} S={m['S']} nh={m['nh']} hd={m['hd']} "
                 f"ng={m['ng']} ds={m['ds']} chunk={m['chunk']} bf16 "
                 f"(model-like dt, A); max |err| / max|plain| {rel:.3e}, "
                 f"worst over the phase-2 cases f32 {worst['float32']:.3e} "
                 f"bf16 {worst['bfloat16']:.3e}; library_ms null: no "
                 "PyTorch call computes the SSD scan"}
    args = ssd_inputs(gen, 1, 2048, m["nh"], m["hd"], m["ng"], m["ds"],
                      dtype)
    bound, by = ssd_bound(1, 2048, *(m[k] for k in ("nh", "hd", "ng", "ds",
                                                   "chunk")), dn, isz)
    results["ssd_scan"]["s2048"] = {
        "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk=m["chunk"])),
        "graph_ms": time_graph_ms(lambda: ssd.ssd_scan(*args,
                                                       chunk=m["chunk"])),
        "plain_ms": time_ms(lambda: ref.ssd_scan(*args, chunk=m["chunk"]),
                            reps=3),
        "bound_ms": bound, "bound_by": by}
    print(f"ssd_scan main shape: {results['ssd_scan']}", flush=True)

    # MLA prefill's shape of the flash kernel
    results["flash_attention"]["mla_prefill_shape"] = flash_mla_checks(gen)

    # RMSNorm at the block norm of a 512-token qwen3 prefill (bf16 rows
    # and scale); the yardstick is torch.nn.functional.rms_norm, which the
    # port never calls
    from repro_torch.kernels import rmsnorm as rn
    worst = rmsnorm_checks(gen)
    rows, D = RMS_MAIN["rows"], RMS_MAIN["D"]
    x = randn(1, rows, D, dtype=dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dtype)
    err = check_close(rn.rmsnorm(x, scale, RMS_EPS),
                      ref.rmsnorm(x, scale, RMS_EPS), dn, "rmsnorm main shape")
    bound, by = rmsnorm_bound([(rows, D)], dn, isz, isz)

    def kernel():
        return rn.rmsnorm(x, scale, RMS_EPS)

    def plain():
        return ref.rmsnorm(x, scale, RMS_EPS)

    def library():
        return F.rms_norm(x, (D,), weight=scale, eps=RMS_EPS)
    results["rmsnorm"] = {
        "max_abs_err": err,
        "ms": time_graph_ms(kernel),
        "plain_ms": time_graph_ms(plain),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_graph_ms(library),
        "eager_ms": {"kernel": time_ms(kernel, reps=100),
                     "plain": time_ms(plain, reps=20),
                     "library": time_ms(library, reps=100)},
        "decode_shapes": {
            name: {"ms": time_graph_ms(c["kernel"]),
                   "library_ms": time_graph_ms(c["library"]),
                   "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
            for name, c in rmsnorm_decode_calls(gen).items()},
        "launch_floor_ms": launch_floor_ms(),
        "shape": f"x=(1, {rows}, {D}) bf16, scale ({D},) bf16; worst over "
                 f"the phase-2 cases f32 {worst['float32']:.3e} bf16 "
                 f"{worst['bfloat16']:.3e}; library_ms is "
                 "torch.nn.functional.rms_norm; ms, plain_ms and "
                 "library_ms replay 100 calls captured in a CUDA graph "
                 "(device time), eager_ms times them launched one by one; "
                 "decode_shapes are a 4-slot decode step's norms (graph); "
                 "launch_floor_ms is torch.cuda._sleep(0) (graph)"}
    print(f"rmsnorm main shape: {results['rmsnorm']}", flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 3: the model on the card against the CPU plain path
# ---------------------------------------------------------------------------
LOGIT_TOL = 1e-3


def model_phase(cfg, last: list[int]):
    """``cfg`` on the card against the CPU plain path: a 2-row, 64-token
    prefill with logits at ``last`` per row, then 8 greedy decode steps."""
    from repro_torch.models.model import Model

    cpu_model = Model(cfg, device="cpu")
    gpu_model = Model(cfg, device="cuda")
    cpu_params = cpu_model.init(seed=0)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.to("cuda")
    gpu_params = to_cuda(cpu_params)

    rng = np.random.default_rng(0)
    B, S, max_len = 2, 64, 128
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32))
    last = torch.tensor(last)
    cc, gc = cpu_model.init_cache(B, max_len), gpu_model.init_cache(B, max_len)
    worst, agree, steps = 0.0, 0, 0
    cl = cpu_model.prefill(cpu_params, toks, cc, logits_at=last)
    gl = gpu_model.prefill(gpu_params, toks.cuda(), gc,
                           logits_at=last.cuda()).cpu()
    pos = last + 1
    for step in range(9):
        err = float((gl - cl).abs().max())
        worst = max(worst, err)
        if err > LOGIT_TOL + LOGIT_TOL * float(cl.abs().max()):
            fail(f"model: step {step} logits differ by {err:.3e}")
        nxt = cl.argmax(-1)
        agree += int((gl.argmax(-1) == nxt).sum())
        steps += B
        if step == 8:
            break
        tok = nxt.to(torch.int32)[:, None]
        cl = cpu_model.decode_step(cpu_params, tok, cc, pos)
        gl = gpu_model.decode_step(gpu_params, tok.cuda(), gc,
                                   pos.cuda()).cpu()
        pos = pos + 1
    if not np.isfinite(cl.numpy()).all():
        fail("model: CPU logits are not finite")
    print(f"model {cfg.name} ({cfg.n_layers} layers, f32): prefill + 8 "
          f"greedy decode steps, max |logit diff| card vs CPU = "
          f"{worst:.3e} (tolerance {LOGIT_TOL} abs + rel), token "
          f"agreement {agree}/{steps}", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def main_path_phase(card: str):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("qwen3-0.6b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                          chunk_tokens=32)
    rng = np.random.default_rng(1)
    plens = [16, 512, 37, 200, 96, 333, 64, 480]
    max_new = 32
    backend = ThreadBackend(model, params, 2, config=config)
    engines = list(backend.engines)
    with Router(backend) as router:
        # warm-up: first cuBLAS handles and allocations, not counted; it
        # leaves both engines' step graphs captured
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((20, 300))]:
            h.result()
        torch.cuda.synchronize()
        if any(e.graph_capture_s is None for e in engines):
            fail("main path: the warm-up left an engine without its step "
                 "graph")
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
                for i, n in enumerate(plens)]
        ops.reset_launch_counts()
        replays = [(e.graph_replays, e.chunks) for e in engines]
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        replays = [(e.graph_replays - r, e.chunks - c)
                   for e, (r, c) in zip(engines, replays)]
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != max_new:
            fail(f"main path: request {r.rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"main path: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"main path: request {r.rid} has no first chunk")
    for name in ("flash_attention", "decode_attention"):
        if launches[name] <= 0:
            fail(f"main path: kernel {name} was never launched")
    check_norm_launches(cfg, launches, "main path")
    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"main path: qwen3-0.6b 28 layers bf16, Router(ThreadBackend(2)) "
          f"n_slots=4 max_len=2048, 8 requests prompts {plens} "
          f"max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} launches="
          f"{launches} [card: {card}]", flush=True)
    print(f"main path, the engines' step graphs (captured in the warm-up's "
          f"first chunks, not timed): capture_s="
          f"{[round(e.graph_capture_s, 4) for e in engines]} pool_bytes="
          f"{[e.graph_pool_bytes for e in engines]}; in the timed window "
          f"(replays, chunks) per engine {replays} [card: {card}]",
          flush=True)

    # one engine alone: a replayed chunk against the eager chunk, then
    # one chunk's host calls (no kernel launched from Python)
    eng = engines[0]
    eng.on_event = None
    eng.submit_many([Request(2000 + i, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32), 80)
        for i, n in enumerate((48, 160, 300, 544))])
    eng.step()
    graph_vs_eager(eng, "phase 4, dense bf16 cache", card)
    prof = chunk_launch_profile(eng)
    if (prof["kernel_launches"] or prof["memcpy_calls"] != 2
            or prof["graph_launches"] != prof["n_tokens"]):
        fail(f"main path: a steady-state chunk made {prof}; want no "
             "kernel launch, one graph launch a step and two copies")
    eng.run()
    print(f"main path, one steady-state chunk of a 4-row engine under the "
          f"profiler: {prof['n_tokens']} steps, {prof['graph_launches']} "
          f"graph launches, {prof['kernel_launches']} kernel launches, "
          f"{prof['memcpy_calls']} copies, wall_ms={prof['wall_ms']:.3f} "
          f"(profiled) [card: {card}]", flush=True)
    del eng, engines, backend

    # one 4-slot decode step at main-path depths, its norms through the
    # plain version (as before the rmsnorm kernel) and through the kernel
    cache = model.init_cache(4, config.max_len, config.dtype)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor([48, 160, 300, 544], dtype=torch.int32,
                       device="cuda")
    ops.reset_launch_counts()
    model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    norms = ops.launch_counts()["rmsnorm"]
    turns = norms_in_turns(
        lambda: decode_step_profile(model, params, tok, cache, pos))
    fmt = STEP_FMT
    print(f"main path, one 4-slot decode step (rows live to 48/160/300/544), "
          f"in turns plain, kernel, kernel, plain: norms in plain tensor "
          f"code {fmt(*turns[0])} / {fmt(*turns[3])}; norms through the "
          f"rmsnorm kernel ({norms} a step) {fmt(*turns[1])} / "
          f"{fmt(*turns[2])} [card: {card}]", flush=True)
    del cache
    return launches


def norms_in_turns(step) -> list:
    """``step()`` four times, in turns with the models' norms in plain
    tensor code on the card tensors (what they ran before the rmsnorm
    kernel: ``ops.rmsnorm`` and ``ops.rmsnorm_pair`` patched) and through
    the kernel: plain, kernel, kernel, plain (the decode-step readings of
    phases 4, 8 and 9 only)."""
    from repro_torch.kernels import ops, ref
    kernel = ops.rmsnorm, ops.rmsnorm_pair
    plain = ref.rmsnorm, lambda x, xs, y, ys, eps=1e-6: (
        ref.rmsnorm(x, xs, eps), ref.rmsnorm(y, ys, eps))
    turns = []
    for use_kernel in (False, True, True, False):
        ops.rmsnorm, ops.rmsnorm_pair = kernel if use_kernel else plain
        try:
            turns.append(step())
        finally:
            ops.rmsnorm, ops.rmsnorm_pair = kernel
    return turns


def norms_per_forward(cfg) -> int:
    """rmsnorm launches in one forward (a prefill batch or a decode step):
    per layer the block norms (two, one for an SSM block) plus the q/k
    norms (one pair launch), the MLA latent norm or the mamba2 gated norm;
    then the final norm."""
    if cfg.is_ssm:
        per_layer = 2
    else:
        per_layer = 2 + (1 if cfg.qk_norm else 0) + (1 if cfg.mla else 0)
    return cfg.n_layers * per_layer + 1


def check_norm_launches(cfg, launches: dict, what: str) -> None:
    """Every norm of the model runs the rmsnorm kernel: a positive
    multiple of the norms of one forward."""
    n, per = launches["rmsnorm"], norms_per_forward(cfg)
    if n <= 0 or n % per:
        fail(f"{what}: {n} rmsnorm launches; need a positive multiple of "
             f"{per} (the norms of one {cfg.name} forward)")


# ---------------------------------------------------------------------------
# the decode chunk as a captured CUDA graph, on every engine
# ---------------------------------------------------------------------------
def graph_vs_eager(engine, what: str, card: str) -> int:
    """The engine's next chunk, replayed from its captured step graph,
    against ``Model.decode_chunk`` run eagerly from the same slot state on
    a clone of its cache taken just before: the token block, the emitted
    counts, every cache leaf's bytes and the kernel launch counts must be
    equal. Needs requests admitted and the graph captured; the engine's
    own bookkeeping runs as in any chunk, so it serves on afterwards.
    Returns the chunk's steps."""
    from repro_torch.kernels import ops

    active = [i for i, s in enumerate(engine.slots) if s.active]
    if not active or engine.graph_capture_s is None:
        fail(f"graph vs eager ({what}): {len(active)} active rows, capture "
             f"{engine.graph_capture_s}")
    torch.cuda.synchronize()
    clone = [{k: t.clone() for k, t in g.items()}
             for g in engine.cache_backend.tree]
    seen = {}
    run = engine._run_chunk

    def spy(state, n):
        seen["state"], seen["n"] = state.copy(), n
        seen["draw"] = engine.draws
        seen["out"] = run(state, n)
        return seen["out"]
    engine._run_chunk = spy
    replays = engine.graph_replays
    before = ops.launch_counts()
    try:
        with engine._on_stream():
            engine._decode_chunk(active)
    finally:
        del engine._run_chunk
    torch.cuda.synchronize()
    mid = ops.launch_counts()
    n = seen["n"]
    if engine.graph_replays != replays + n:
        fail(f"graph vs eager ({what}): {engine.graph_replays - replays} "
             f"replays for a {n}-step chunk")
    st = torch.from_numpy(seen["state"]).cuda()
    state = {"tokens": st[0], "pos": st[1], "remaining": st[2],
             "active": st[3].bool()}
    kw, key = {}, ""
    if not engine.greedy:
        # the random stream's state as the chunk found it, cloned
        from repro_torch.models.sampling import new_key
        state["key"], kw["greedy"] = new_key(
            engine.config.seed, seen["draw"], "cuda"), False
    block, emitted, new = engine.model.decode_chunk(
        engine.params, clone, state, n, max_len=engine.max_len, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    if not (np.array_equal(block.cpu().numpy(), seen["out"][0])
            and np.array_equal(emitted.cpu().numpy(), seen["out"][1])):
        fail(f"graph vs eager ({what}): tokens or emitted counts differ")
    if not engine.greedy:
        want = new_key(engine.config.seed, seen["draw"] + n).tolist()
        got = engine._buf["key"].tolist()
        if new["key"].tolist() != want or got != want or \
                engine.draws != want[1]:
            fail(f"graph vs eager ({what}): the random stream after the "
                 f"chunk: replayed {got}, eager {new['key'].tolist()}, "
                 f"want {want}, engine draws {engine.draws}")
        key = f", the random stream [seed, draw] {want} after both"
    leaves = 0
    for j, (g, c) in enumerate(zip(engine.cache_backend.tree, clone)):
        for k, t in g.items():
            leaves += 1
            if not torch.equal(t.view(torch.uint8), c[k].view(torch.uint8)):
                fail(f"graph vs eager ({what}): layer {j} {k} differs")
    replayed = {k: mid[k] - before[k] for k in mid}
    eager = {k: after[k] - mid[k] for k in mid}
    if replayed != eager or not sum(replayed.values()):
        fail(f"graph vs eager ({what}): launches replayed {replayed}, eager "
             f"{eager}")
    print(f"graph vs eager ({what}): a {n}-step chunk over {len(active)} "
          f"active rows replayed from the engine's step graph equals "
          f"Model.decode_chunk run eagerly on a clone of its cache: tokens, "
          f"emitted counts, {leaves} cache leaves bit for bit{key}, "
          f"launches { {k: v for k, v in replayed.items() if v} }; the "
          f"engine's "
          f"capture {engine.graph_capture_s:.4f} s, pool "
          f"{engine.graph_pool_bytes} B, replays {engine.graph_replays} "
          f"[card: {card}]", flush=True)
    return n


def engine_graph_check(engine, reqs, what: str, card: str) -> None:
    """Serve ``reqs`` on ``engine`` alone (its stream events dropped):
    admission and a chunk, then ``graph_vs_eager``, then to completion."""
    engine.on_event = None
    engine.submit_many(reqs)
    engine.step()
    graph_vs_eager(engine, what, card)
    engine.run()


KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx")


def chunk_launch_profile(engine) -> dict:
    """One chunk of ``engine`` (requests admitted, its graph captured, the
    queue empty) under ``torch.profiler``: the host calls it makes, by
    kind. In steady state a chunk launches no kernel from Python: one
    state copy in, ``n_tokens`` graph launches, one copy out."""
    from torch.profiler import ProfilerActivity, profile
    if engine.queue or engine.graph_capture_s is None:
        fail("chunk profile: needs an empty queue and a captured graph")
    replays = engine.graph_replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()

    def calls(*keys):
        return sum(e.count for e in events if e.key in keys)
    return {"n_tokens": engine.graph_replays - replays,
            "kernel_launches": calls(*KERNEL_LAUNCH_CALLS),
            "graph_launches": calls("cudaGraphLaunch", "cuGraphLaunch"),
            "memcpy_calls": calls("cudaMemcpyAsync", "cudaMemcpy",
                                  "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2",
                                  "cuMemcpyDtoHAsync_v2"),
            "wall_ms": wall * 1e3}


def graph_nodes(graph):
    """Nodes of a captured graph kept with ``keep_graph=True``, from
    ``libcuda``'s ``cuGraphGetNodes``; None where ``libcuda`` cannot be
    loaded or refuses."""
    import ctypes
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(n))
    return n.value if err == 0 else None


STEP_FMT = ("host_ms={:.3f} kernel_launches={} device_ms={:.3f} "
            "attention_device_ms={:.4f}; replayed from a graph: wall_ms={:.3f} "
            "profiler_launches={} enqueue_us={:.1f} graph_nodes={}").format


def replayed_step_profile(model, params, tok, cache, pos) -> tuple:
    """The decode step as a serving engine replays it: one
    ``decode_chunk_step`` over the rows of ``tok`` / ``pos`` (inactive, so
    their positions hold) captured on a side stream after one eager step
    there, then: the wall of one replay ending in a synchronize (mean of
    10), the launch calls the profiler sees in one replay, the host µs
    that enqueuing one replay onto an idle card takes (mean of 10; replays
    enqueued back to back wait for room in the card's launch queue), and
    the graph's node count (None where it cannot be read). A checkout
    whose model has no chunk step gives Nones."""
    from torch.profiler import ProfilerActivity, profile
    if not hasattr(model, "decode_chunk_step"):
        return None, None, None, None
    from repro_torch.kernels.build import capture_tally
    buf = model.chunk_buffers(tok.shape[0], 16)
    buf["tokens"].copy_(tok[:, 0])
    buf["pos"].copy_(pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def step():   # no row is active, so the horizon gates nothing
        model.decode_chunk_step(params, cache, buf, max_len=2048)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        step()
        with capture_tally():
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                step()
    nodes = graph_nodes(graph)
    graph.instantiate()
    torch.cuda.current_stream().wait_stream(side)

    def replays(n):
        buf["col"].zero_()
        for _ in range(n):
            graph.replay()
    replays(3)
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        replays(1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    buf["col"].zero_()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        *KERNEL_LAUNCH_CALLS, "cudaGraphLaunch", "cuGraphLaunch"))
    enqueue = []
    buf["col"].zero_()
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return (sum(walls) / len(walls) * 1e3, launches,
            sum(enqueue) / len(enqueue) * 1e6, nodes)


# ---------------------------------------------------------------------------
# phase 5: dense vs paged greedy streams on the card
# ---------------------------------------------------------------------------
# same-bucket groups of at most n_slots, in queue order, one budget per
# group: the dense engine (head + same-bucket requests) and the paged one
# (run of consecutive heads with one key) then admit the same prefill
# batches, and max_seqs = n_slots gives both decodes the same rows
PARITY_GROUPS = [((150, 200, 256, 180), 24), ((40, 50, 64, 33), 32),
                 ((300, 400, 512), 16)]


def parity_phase(model, params, config, card: str, groups=PARITY_GROUPS,
                 peaks: list | None = None):
    """Serve the same requests through one dense and one paged engine
    (``config`` with cache="paged"); their greedy streams must be
    identical. Then each engine serves one more group with a chunk held to
    the eager chunk (``engine_graph_check``). Returns each engine's kernel
    launches of the compared streams (dense, paged); each engine's
    ``peak_active`` over them goes into ``peaks`` when given."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(5)
    reqs = []
    for plens, max_new in groups:
        for n in plens:
            reqs.append(Request(len(reqs), rng.integers(
                0, model.cfg.vocab_size, (n,), dtype=np.int32), max_new))
    streams, walls, launches = [], [], []
    for cache in ("dense", "paged"):
        eng = ServingEngine(model, params,
                            dataclasses.replace(config, cache=cache),
                            device=model.device)
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        before = ops.launch_counts()
        t0 = time.perf_counter()
        comps = eng.run()
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append({k: n - before[k]
                         for k, n in ops.launch_counts().items()})
        streams.append({c.rid: list(c.tokens) for c in comps})
        if peaks is not None:
            peaks.append(eng.peak_active)
        if model.device.type == "cuda":
            engine_graph_check(eng, [
                Request(1000 + j, rng.integers(0, model.cfg.vocab_size, (n,),
                                               dtype=np.int32), 40)
                for j, n in enumerate(groups[0][0])],
                f"{model.cfg.name} kv_cache_dtype={model.cfg.kv_cache_dtype}"
                f" {cache} cache", card)
        del eng
    dense, paged = streams
    if len(dense) != len(reqs):
        fail(f"dense vs paged: {len(dense)} of {len(reqs)} completed")
    for r in reqs:
        if dense[r.rid] != paged.get(r.rid):
            fail(f"dense vs paged: request {r.rid} streams differ: "
                 f"{dense[r.rid][:8]}... vs {paged.get(r.rid, [])[:8]}...")
    n_tok = sum(len(t) for t in dense.values())
    print(f"dense vs paged: {model.cfg.name} {model.cfg.n_layers} layers "
          f"{str(config.dtype).split('.')[1]}, kv_cache_dtype="
          f"{model.cfg.kv_cache_dtype}, n_slots={config.n_slots} "
          f"max_seqs={config.max_seqs} block_size={config.block_size} "
          f"max_len={config.max_len}, {len(reqs)} requests in groups "
          f"{[list(g) for g, _ in groups]}: {n_tok} greedy tokens "
          f"identical; wall_s dense={walls[0]:.4f} paged={walls[1]:.4f} "
          f"[card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: this slice's main path — paged cache with prefix sharing
# ---------------------------------------------------------------------------
SYSTEM_PROMPT = 256
TAILS = (16, 256)
WAVES = (2, 14)


def shared_prefix_requests(cfg, seed=3):
    """Two waves of requests that share one SYSTEM_PROMPT-token prefix
    (16 full blocks) followed by a 16-256-token private tail."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (SYSTEM_PROMPT,), dtype=np.int32)
    waves, rid = [], 0
    for n in WAVES:
        wave = []
        for _ in range(n):
            tail = rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(TAILS[0], TAILS[1] + 1)),),
                                dtype=np.int32)
            wave.append((rid, np.concatenate([prefix, tail])))
            rid += 1
        waves.append(wave)
    return waves


def prefix_phase(model, params, config, card: str, n_containers: int = 2,
                 max_new: int = 32):
    """Router(ThreadBackend) over paged, prefix-sharing engines: wave 1
    seeds the prefix index, wave 2 must hit it; more sequences than
    n_slots must be in flight at once in the dense footprint; the paged
    kernel and the prefill kernel must launch, the dense decode kernel
    must not. Returns the launch counts of this phase, the wave-2 tokens
    by request and one engine's KV pool bytes."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import Router

    cfg, dev = model.cfg, model.device
    waves = shared_prefix_requests(cfg)
    results, per_wave = {}, []
    backend = ThreadBackend(model, params, n_containers, config=config,
                            device=dev)
    engines = list(backend.engines)
    with Router(backend, device=dev) as router:
        ops.reset_launch_counts()
        for wave in waves:
            engines = backend.engines
            pre0 = sum(e.prefill_tokens_executed for e in engines)
            t0 = time.perf_counter()
            handles = [router.submit(Request(rid, prompt, max_new))
                       for rid, prompt in wave]
            comps = [h.result() for h in handles]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_wave.append({
                "wall": wall,
                "tokens": sum(len(c.tokens) for c in comps),
                "ttfc_p50": float(np.percentile([h.ttfc_s for h in handles],
                                                50)),
                "hits": sum(c.prefix_hit_tokens for c in comps),
                "prefill": sum(e.prefill_tokens_executed for e in engines)
                - pre0})
            for c in comps:
                results[c.rid] = c
        launches = ops.launch_counts()
        peak = [e.peak_active for e in backend.engines]
        pool = kv_pool_bytes(backend.engines[0])
    for wave in waves:
        for rid, _ in wave:
            c = results.get(rid)
            if c is None or len(c.tokens) != max_new:
                fail(f"prefix path: request {rid} gave "
                     f"{None if c is None else len(c.tokens)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in c.tokens):
                fail(f"prefix path: request {rid} has out-of-range tokens")
    if per_wave[1]["hits"] <= 0:
        fail("prefix path: wave 2 had no prefix hits")
    if max(peak) <= config.n_slots:
        fail(f"prefix path: peak in-flight {peak} never exceeded "
             f"n_slots={config.n_slots}")
    if dev.type == "cuda":
        for name in ("paged_decode_attention", "flash_attention"):
            if launches[name] <= 0:
                fail(f"prefix path: kernel {name} was never launched")
        check_norm_launches(cfg, launches, "prefix path")
        if launches["decode_attention"] != 0:
            fail(f"prefix path: the dense decode kernel launched "
                 f"{launches['decode_attention']} times")
    for i, w in enumerate(per_wave, 1):
        print(f"prefix path wave {i}: {cfg.name} {cfg.n_layers} layers, "
              f"Router(ThreadBackend({n_containers})) paged block_size="
              f"{config.block_size} max_seqs={config.max_seqs} "
              f"max_len={config.max_len} prefix_cache=True, "
              f"{len(waves[i - 1])} requests ({SYSTEM_PROMPT}-token shared "
              f"prompt + {TAILS[0]}-{TAILS[1]}-token tails) max_new="
              f"{max_new}: wall_s={w['wall']:.4f} tok_per_s="
              f"{w['tokens'] / w['wall']:.2f} ttfc_p50_s={w['ttfc_p50']:.4f} "
              f"hit_tokens={w['hits']} prefill_tokens_executed="
              f"{w['prefill']} [card: {card}]", flush=True)
    print(f"prefix path: peak_active per container {peak} (n_slots="
          f"{config.n_slots}), launches={launches} [card: {card}]",
          flush=True)
    if dev.type == "cuda":
        # wave 2's first prompts again on one engine: admissions that hit
        # the shared prompt's pages and rewrite the block table
        hits = engines[0].prefix_hit_tokens_total
        engine_graph_check(engines[0], [
            Request(3000 + rid, prompt, max_new)
            for rid, prompt in waves[1][:4]],
            "phase 6, paged cache with prefix sharing", card)
        if engines[0].prefix_hit_tokens_total <= hits:
            fail("prefix path: the graph check's admissions hit nothing")
    del engines

    # report only: wave 2 again on one engine without sharing (other
    # batch shapes, so the card need not give the same bits)
    eng = ServingEngine(model, params,
                        dataclasses.replace(config, prefix_cache=False),
                        device=dev)
    eng.submit_many([Request(rid, prompt, max_new)
                     for rid, prompt in waves[0]])
    eng.run()
    pre0 = eng.prefill_tokens_executed
    eng.submit_many([Request(rid, prompt, max_new)
                     for rid, prompt in waves[1]])
    off = {c.rid: list(c.tokens) for c in eng.run()}
    agree = sum(int(a == b) for rid, _ in waves[1]
                for a, b in zip(off[rid], results[rid].tokens))
    print(f"prefix path, wave 2 with prefix_cache=False on one engine: "
          f"prefill_tokens_executed={eng.prefill_tokens_executed - pre0} "
          f"(with sharing {per_wave[1]['prefill']}), token agreement with "
          f"the sharing run {agree}/{len(waves[1]) * max_new} "
          f"[card: {card}]", flush=True)
    del eng
    return launches, {rid: results[rid].tokens for rid, _ in waves[1]}, pool


# ---------------------------------------------------------------------------
# phase 6c: prefix sharing on == off at equal phases (JAX's _serve_phases)
# ---------------------------------------------------------------------------
class PrefillLogits:
    """While open, records the prefill logits row (float32, on the host) of
    every request ``engine`` admits, by request id: a tap on the engine's
    admission and on its model's two prefill calls, removed on exit."""

    def __init__(self, engine):
        self.engine, self.rows = engine, {}

    def __enter__(self):
        eng, model = self.engine, self.engine.model
        admit, cur = eng._admit_batch, []

        def tapped_admit(slot_ids, reqs, plans=None):
            cur[:] = [r.rid for r in reqs]
            return admit(slot_ids, reqs, plans)

        def tap(fn):
            def call(*args, **kw):
                logits = fn(*args, **kw)
                for rid, row in zip(cur, logits.float().cpu()):
                    self.rows[rid] = row
                return logits
            return call
        eng._admit_batch = tapped_admit
        model.prefill = tap(model.prefill)
        model.prefill_suffix = tap(model.prefill_suffix)
        return self

    def __exit__(self, *exc):
        del self.engine._admit_batch
        del self.engine.model.prefill
        del self.engine.model.prefill_suffix


def sharing_bisect(model, params):
    """Where sharing on and off can part in the last bits: (a) the prefill
    kernel over [cached context | suffix] against the whole prompt on the
    same keys and values (bitwise: the kernel walks keys in the same tiles
    from position 0), and (b) one q projection of the same rows at the two
    row counts the two modes prefill (a 128-token suffix batch against
    eight 512-token prompts; cuBLAS picks its algorithm by shape). Returns
    (flash_bitwise, projection_bitwise)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import project

    dev, dt = model.device, params["embed"]["table"].dtype
    gen = torch.Generator(device=dev).manual_seed(6)
    ctx, sb, whole, n = SYSTEM_PROMPT, 128, 512, 100
    q, k, v = (torch.randn(2, whole, h, K, generator=gen, device=dev).to(dt)
               for h in (H, HKV, HKV))
    full = ops.flash_attention(q, k, v)
    part = ops.flash_attention(q[:, ctx:ctx + sb].contiguous(),
                               k[:, :ctx + sb].contiguous(),
                               v[:, :ctx + sb].contiguous())
    flash_bitwise = torch.equal(part[:, :n], full[:, ctx:ctx + n])
    w = params["layers"][0]["attn"]["wq"]
    w = w.reshape(w.shape[0], -1)
    x = torch.randn(8 * whole, w.shape[0], generator=gen, device=dev).to(dt)
    proj_bitwise = torch.equal(project(x[:sb], w), project(x, w)[:sb])
    return flash_bitwise, proj_bitwise


def sharing_gate_phase(model, params, config, card: str, max_new: int = 32,
                       padding: bool = True):
    """6c: one paged engine with prefix sharing and one without, at the
    same block budget, each driven through phase 6's two waves in turn,
    draining between them. Wave 2 must hit the shared prompt, the greedy
    streams must be identical and each request's prefill logits equal bit
    for bit between the modes. On a difference the failure carries the
    bisect: the prefill kernel over [context | suffix] against the whole
    prompt, and a q projection at the two modes' row counts. Then, with
    ``padding``, what the engine's prefill padding costs. Returns the
    launch counts of the two engines' runs."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    waves = shared_prefix_requests(model.cfg)
    streams, logits, hits, prefill = [], [], [], []
    ops.reset_launch_counts()
    for share in (True, False):
        eng = ServingEngine(model, params,
                            dataclasses.replace(config, prefix_cache=share),
                            device=model.device)
        got = {}
        with PrefillLogits(eng) as tap:
            for wave in waves:
                eng.submit_many([Request(rid, prompt, max_new)
                                 for rid, prompt in wave])
                for c in eng.run():
                    got[c.rid] = list(c.tokens)
        streams.append(got)
        logits.append(tap.rows)
        hits.append(eng.prefix_hit_tokens_total)
        prefill.append(eng.prefill_tokens_executed)
        del eng
    launches = ops.launch_counts()
    on, off = streams
    rids = [rid for wave in waves for rid, _ in wave]
    if sorted(on) != rids or sorted(off) != rids:
        fail(f"sharing gate: completed {len(on)} / {len(off)} of {len(rids)}")
    wave2 = [rid for rid, _ in waves[1]]
    if hits[0] != SYSTEM_PROMPT * len(wave2) or hits[1] != 0:
        fail(f"sharing gate: hit tokens {hits}, want "
             f"{SYSTEM_PROMPT * len(wave2)} with sharing and 0 without")
    differ = [rid for rid in rids if on[rid] != off[rid]]
    unequal = [rid for rid in rids
               if not torch.equal(logits[0][rid], logits[1][rid])]
    if differ or unequal:
        worst = max(float((logits[0][r] - logits[1][r]).abs().max())
                    for r in unequal) if unequal else 0.0
        flash_bitwise, proj_bitwise = sharing_bisect(model, params)
        fail(f"sharing gate: greedy streams differ for {differ}, prefill "
             f"logits of {unequal} (max {worst:.3e}); bisect: prefill "
             f"kernel over [context | suffix] bitwise={flash_bitwise}, q "
             f"projection at 128 vs 4096 rows bitwise={proj_bitwise}")
    print(f"sharing gate (6c): {model.cfg.name} {model.cfg.n_layers} layers "
          f"{str(config.dtype).split('.')[1]}, paged block_size="
          f"{config.block_size} max_seqs={config.max_seqs} max_len="
          f"{config.max_len} max_blocks={config.resolved_max_blocks}, "
          f"phase 6's waves {[len(w) for w in waves]} through one engine "
          f"per mode, drained between: "
          f"{sum(len(t) for t in on.values())} greedy tokens and "
          f"{len(rids)} prefill logit rows identical bit for bit with "
          f"sharing on and off; hit_tokens on={hits[0]} off={hits[1]} "
          f"prefill_tokens_executed on={prefill[0]} off={prefill[1]}; "
          f"launches={launches} [card: {card}]", flush=True)
    if padding:
        padding_cost(model, params, dataclasses.replace(config,
                                                        prefix_cache=True),
                     waves, max_new, card)
    return launches


def padding_cost(model, params, config, waves, max_new: int, card: str):
    """What the padding of prefill batches to MIN_PREFILL_ROWS token rows
    costs a sharing engine: phase 6's two waves through one engine with
    and without it, in turns padded, unpadded, unpadded, padded. Reports
    wall, ttfc p50 (submission to first chunk) and the peak device memory
    above what the engine held before serving (prefill mini-caches and
    activations)."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.events import ChunkEvent

    rows = engine_mod.MIN_PREFILL_ROWS
    turns = []
    for pad in (True, False, False, True):
        engine_mod.MIN_PREFILL_ROWS = rows if pad else 1
        try:
            eng = ServingEngine(model, params, config, device=model.device)
            first: dict = {}
            eng.on_event = lambda ev: (isinstance(ev, ChunkEvent) and
                                       first.setdefault(ev.rid, ev.time_s))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            ttfc = []
            t0 = time.perf_counter()
            for wave in waves:
                t_sub = time.perf_counter()
                eng.submit_many([Request(rid, prompt, max_new)
                                 for rid, prompt in wave])
                eng.run()
                ttfc += [first[rid] - t_sub for rid, _ in wave]
            torch.cuda.synchronize()
            turns.append((time.perf_counter() - t0,
                          float(np.percentile(ttfc, 50)),
                          torch.cuda.max_memory_allocated() - held))
            del eng
        finally:
            engine_mod.MIN_PREFILL_ROWS = rows
    fmt = "wall_s={:.4f} ttfc_p50_s={:.4f} peak_bytes_above_engine={}".format
    print(f"sharing gate (6c), padding cost: phase 6's waves through one "
          f"sharing engine in turns padded, unpadded, unpadded, padded: "
          f"padded to {rows} token rows {fmt(*turns[0])} / "
          f"{fmt(*turns[3])}; unpadded {fmt(*turns[1])} / "
          f"{fmt(*turns[2])} [card: {card}]", flush=True)


def kv_pool_bytes(engine) -> int:
    """Bytes of an engine's KV cache tensors (pages and scale pages, or
    dense rows and scales; the block table left out)."""
    return sum(t.nbytes for g in engine.cache_backend.tree
               for name, t in g.items() if name != "table")


# ---------------------------------------------------------------------------
# phase 7: the int8 KV cache
# ---------------------------------------------------------------------------
def int8_path_phase(model, params, config, card: str, bf16_tokens: dict,
                    bf16_pool: int, n_containers: int = 2,
                    max_new: int = 32):
    """Router(ThreadBackend) over paged int8 engines serving phase 6's
    wave 2 (prefix_cache=True, which the int8 cache must ignore): every
    request completes with ``max_new`` tokens and no hit tokens, the paged
    int8 kernel launches and no bfloat16 decode kernel does. Returns the
    launch counts of this phase."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import Request
    from repro_torch.serving.router import Router

    cfg, dev = model.cfg, model.device
    wave = shared_prefix_requests(cfg)[1]
    backend = ThreadBackend(model, params, n_containers, config=config,
                            device=dev)
    with Router(backend, device=dev) as router:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(Request(rid, prompt, max_new))
                   for rid, prompt in wave]
        comps = {h.rid: h.result() for h in handles}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = [e.peak_active for e in backend.engines]
        hits = sum(e.prefix_hit_tokens_total for e in backend.engines)
        pool = kv_pool_bytes(backend.engines[0])
    for rid, _ in wave:
        c = comps[rid]
        if len(c.tokens) != max_new:
            fail(f"int8 path: request {rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"int8 path: request {rid} has out-of-range tokens")
    if hits != 0:
        fail(f"int8 path: {hits} prefix hit tokens on an int8 cache")
    if dev.type == "cuda" and launches["paged_decode_attention_int8"] <= 0:
        fail("int8 path: paged_decode_attention_int8 was never launched")
    if dev.type == "cuda":
        check_norm_launches(cfg, launches, "int8 path")
    bf16 = {k: launches[k] for k in ("decode_attention",
                                     "paged_decode_attention")}
    if any(bf16.values()):
        fail(f"int8 path: bfloat16 decode kernels launched {bf16}")
    n_tok = sum(len(c.tokens) for c in comps.values())
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    agree = sum(int(a == b) for rid, _ in wave
                for a, b in zip(comps[rid].tokens, bf16_tokens[rid]))
    wdt = str(params["embed"]["table"].dtype).split(".")[1]
    print(f"int8 path: {cfg.name} {cfg.n_layers} layers {wdt} weights, int8 "
          f"KV, Router(ThreadBackend({n_containers})) paged block_size="
          f"{config.block_size} max_seqs={config.max_seqs} max_len="
          f"{config.max_len} prefix_cache=True, phase 6 wave 2 ({len(wave)} "
          f"requests) max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} hit_tokens={hits} "
          f"peak_active={peak} kv_pool_bytes int8={pool} bf16={bf16_pool} "
          f"({pool / bf16_pool:.4f}x); greedy tokens agreeing with the "
          f"bf16 run (phase 6, not checked): {agree}/{n_tok}; launches="
          f"{launches} [card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the SSM family's main path — mamba2-2.7b
# ---------------------------------------------------------------------------
SSM_PLENS = [64, 64, 128, 200, 256, 256, 512, 1024]
ATTENTION_KERNELS = ("flash_attention", "decode_attention",
                     "paged_decode_attention", "decode_attention_int8",
                     "paged_decode_attention_int8")


def ssm_path_phase(model, params, card: str, n_containers: int = 2,
                   max_new: int = 32):
    """Router(ThreadBackend(2)) over full-width mamba2-2.7b (64 layers,
    bf16, random weights from seed 0: ``full_width_ssm``), n_slots=4,
    max_len=2048: 8
    requests with 64-1024-token prompts, each a length the scan's chunk
    (min(256, S)) divides. Every request completes with ``max_new``
    tokens; the 200-token request's stream equals that request run alone
    on the model; ``ssd_scan`` launches a multiple of 64 (one per layer per
    prefill) and at least once per layer per distinct length; no
    attention kernel launches. Returns the launch counts of the run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = model.cfg
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(SSM_PLENS)]
    backend = ThreadBackend(model, params, n_containers, config=config)
    engines = list(backend.engines)
    with Router(backend) as router:
        # warm-up: first cuBLAS handles and allocations, not counted
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((32, 256))]:
            h.result()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        state_bytes = sum(t.nbytes for g in backend.engines[0].cache_backend
                          .tree for t in g.values())
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != max_new:
            fail(f"ssm path: request {r.rid} gave {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"ssm path: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"ssm path: request {r.rid} has no first chunk")
    n_ssd = launches["ssd_scan"]
    if n_ssd % cfg.n_layers or n_ssd < cfg.n_layers * len(set(SSM_PLENS)):
        fail(f"ssm path: {n_ssd} ssd_scan launches; need a multiple of "
             f"{cfg.n_layers}, at least {cfg.n_layers * len(set(SSM_PLENS))}")
    if any(launches[k] for k in ATTENTION_KERNELS):
        fail(f"ssm path: attention kernels launched: {launches}")
    check_norm_launches(cfg, launches, "ssm path")
    engine_graph_check(engines[0], [
        Request(2000 + i, rng.integers(0, cfg.vocab_size, (n,),
                                       dtype=np.int32), 40)
        for i, n in enumerate((64, 128, 256, 512))],
        "phase 8, mamba2 state rows", card)
    del engines

    # the 200-token request alone: a one-row prefill, then decode steps in
    # a batch as wide as the engine's slots with the other rows empty, so
    # every product has the engine's shapes (a row's bits do not depend
    # on the other rows')
    rid = SSM_PLENS.index(200)
    prompt = torch.from_numpy(reqs[rid].prompt).cuda()[None]
    one = model.init_cache(1, config.max_len, config.dtype)
    logits = model.prefill(params, prompt, one)
    cache = model.init_cache(config.n_slots, config.max_len, config.dtype)
    for dst, src in zip(cache, one):
        for name, t in dst.items():
            t[:1].copy_(src[name])
    tok = torch.zeros((config.n_slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((config.n_slots,), dtype=torch.int32, device="cuda")
    alone = [int(torch.argmax(logits[0]))]
    for _ in range(max_new - 1):
        tok[0, 0] = alone[-1]
        logits = model.decode_step(params, tok, cache, pos)
        alone.append(int(torch.argmax(logits[0])))
    if alone != list(comps[rid].tokens):
        fail(f"ssm path: request {rid} served {list(comps[rid].tokens)[:8]}"
             f"... but alone gives {alone[:8]}...")

    # the decode step in turns plain, kernel, kernel, plain norms (as
    # phase 4's): what the rmsnorm kernel moves on this family's step
    turns = norms_in_turns(
        lambda: decode_step_profile(model, params, tok, cache, pos))
    fmt = STEP_FMT

    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"ssm path: {cfg.name} {cfg.n_layers} layers bf16, Router("
          f"ThreadBackend({n_containers})) n_slots={config.n_slots} max_len="
          f"{config.max_len} chunk_tokens={config.chunk_tokens}, 8 requests "
          f"prompts {SSM_PLENS} max_new={max_new}: wall_s={wall:.4f} "
          f"tok_per_s={n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} "
          f"state_cache_bytes={state_bytes} (one engine); request {rid}'s "
          f"stream equals the model run alone; one {config.n_slots}-slot "
          f"decode step in turns plain, kernel, kernel, plain: norms in "
          f"plain tensor code {fmt(*turns[0])} / {fmt(*turns[3])}; norms "
          f"through the rmsnorm kernel {fmt(*turns[1])} / {fmt(*turns[2])}"
          f"; launches={launches} [card: {card}]",
          flush=True)
    return launches


# the device-side kernels of the decode attention bodies (the bf16/f32
# split pass and the merge both split bodies share; the int8 split pass)
# and of MLA decode, by the profiler's kernel names
DECODE_KERNEL_NAMES = ("decode_split_detail::", "decode_int8_detail::",
                       "mla_partial_kernel", "mla_merge_kernel")


def decode_step_profile(model, params, tok, cache, pos):
    """One decode step's host wall (mean of 10, each ending in a
    synchronize, after 3 unmeasured), its kernel launches (profiler count
    of launch calls), its device ms (the profiler's self device time of
    every kernel and copy of the step; 0 where the profiler sees no
    device) and the
    part of it in the decode attention kernels (``DECODE_KERNEL_NAMES``);
    then the same step replayed from a CUDA graph as an engine replays it
    (``replayed_step_profile``: wall ms, the launch calls the profiler
    sees, host µs to enqueue a replay, graph nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, tok, cache, pos)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in KERNEL_LAUNCH_CALLS)
    # device-side entries only: a host operation's device column repeats
    # the time of the kernels it launched
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    attention_ms = sum(e.self_device_time_total for e in on_card
                       if any(n in e.key for n in DECODE_KERNEL_NAMES)) / 1e3
    return (step_ms, launches, device_ms, attention_ms,
            *replayed_step_profile(model, params, tok, cache, pos))


# ---------------------------------------------------------------------------
# phase 9: the MoE family with latent attention — deepseek-v2-lite-16b
# ---------------------------------------------------------------------------
MAIN_PLENS = [16, 512, 37, 200, 96, 333, 64, 480]   # phase 4's prompts


def deepseek_path_phase(card: str, n_containers: int = 2,
                        max_new: int = 32):
    """Router(ThreadBackend(2)) over full-width deepseek-v2-lite-16b (27
    layers: MLA + dense MLP, then 26 of MLA + 64 routed experts top-6 and
    2 shared; bf16, random weights from seed 0, one copy shared by both
    engines), dense latent cache, n_slots=4, max_len=2048: phase 4's 8
    requests. Every request completes with ``max_new`` in-range tokens
    and a first chunk; ``mla_decode_ctx`` and ``flash_attention`` launch
    a positive multiple of 27 times (once per layer per decode step or
    prefill), no other kernel launches. The 200-token request, alone in
    its 256-token bucket, equals that request run alone at the engine's
    shapes (expert capacity drops depend on the batch). Then phase 9b on
    the same weights. Returns the launch counts of the Router run and of
    9b's dense and paged engines."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request, _bucket
    from repro_torch.serving.router import Router

    cfg = get_config("deepseek-v2-lite-16b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    backend = ThreadBackend(model, params, n_containers, config=config)
    with Router(backend) as router:
        # warm-up: first cuBLAS handles and allocations, not counted
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((20, 300))]:
            h.result()
        torch.cuda.synchronize()
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
                for i, n in enumerate(MAIN_PLENS)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        cache_bytes = sum(t.nbytes for g in backend.engines[0].cache_backend
                          .tree for t in g.values())
    for r, c, h in zip(reqs, comps, handles):
        if c.rid != r.rid or len(c.tokens) != max_new:
            fail(f"deepseek path: request {r.rid} gave {len(c.tokens)} "
                 "tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            fail(f"deepseek path: request {r.rid} has out-of-range tokens")
        if h.ttfc_s is None:
            fail(f"deepseek path: request {r.rid} has no first chunk")
    for name in ("mla_decode_ctx", "flash_attention"):
        if launches[name] <= 0 or launches[name] % cfg.n_layers:
            fail(f"deepseek path: {launches[name]} {name} launches; need a "
                 f"positive multiple of {cfg.n_layers}")
    others = {k: n for k, n in launches.items()
              if k not in ("mla_decode_ctx", "flash_attention", "rmsnorm")
              and n}
    if others:
        fail(f"deepseek path: other kernels launched: {others}")
    check_norm_launches(cfg, launches, "deepseek path")

    # the 200-token request alone: a one-row prefill padded to its
    # bucket, then decode steps as wide as the engine's slots with the
    # other rows empty, so every product has the engine's shapes (the
    # expert groups of a decode step are one token each)
    rid = MAIN_PLENS.index(200)
    n = len(reqs[rid].prompt)
    padded = torch.zeros((1, _bucket(n)), dtype=torch.int32, device="cuda")
    padded[0, :n] = torch.from_numpy(reqs[rid].prompt).cuda()
    one = model.init_cache(1, config.max_len, config.dtype)
    logits = model.prefill(params, padded, one,
                           logits_at=torch.tensor([n - 1], device="cuda"))
    cache = model.init_cache(config.n_slots, config.max_len, config.dtype)
    for dst, src in zip(cache, one):
        for name, t in dst.items():
            t[:1].copy_(src[name])
    tok = torch.zeros((config.n_slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((config.n_slots,), dtype=torch.int32, device="cuda")
    alone = [int(torch.argmax(logits[0]))]
    for i in range(max_new - 1):
        tok[0, 0], pos[0] = alone[-1], n + i
        logits = model.decode_step(params, tok, cache, pos)
        alone.append(int(torch.argmax(logits[0])))
    if alone != list(comps[rid].tokens):
        fail(f"deepseek path: request {rid} served "
             f"{list(comps[rid].tokens)[:8]}... but alone gives "
             f"{alone[:8]}...")
    # the decode step in turns plain, kernel, kernel, plain norms (as
    # phase 4's): what the rmsnorm kernel moves on this family's step
    turns = norms_in_turns(
        lambda: decode_step_profile(model, params, tok, cache, pos))
    fmt = STEP_FMT
    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"deepseek path: {cfg.name} {cfg.n_layers} layers bf16, Router("
          f"ThreadBackend({n_containers})) dense latent cache n_slots="
          f"{config.n_slots} max_len={config.max_len} chunk_tokens="
          f"{config.chunk_tokens}, 8 requests prompts {MAIN_PLENS} "
          f"max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} "
          f"latent_cache_bytes={cache_bytes} (one engine); request {rid}'s "
          f"stream equals the model run alone; one {config.n_slots}-slot "
          f"decode step in turns plain, kernel, kernel, plain: norms in "
          f"plain tensor code {fmt(*turns[0])} / {fmt(*turns[3])}; norms "
          f"through the rmsnorm kernel {fmt(*turns[1])} / {fmt(*turns[2])}"
          f"; launches={launches} [card: {card}]",
          flush=True)
    del one, cache, backend
    torch.cuda.empty_cache()

    # 9b: dense against paged latent caches, phase 5's form
    paged = dataclasses.replace(config, cache="paged", block_size=16,
                                max_seqs=4)
    parity = parity_phase(model, params, paged, card)
    for which, counts in zip(("dense", "paged"), parity):
        if counts["mla_decode_ctx"] <= 0:
            fail(f"deepseek dense vs paged: mla_decode_ctx never launched "
                 f"on the {which} engine: {counts}")
    print(f"deepseek dense vs paged: launches dense={parity[0]} "
          f"paged={parity[1]} [card: {card}]", flush=True)
    return launches, parity


# ---------------------------------------------------------------------------
# phase 10: process containers — Router(ProcessBackend) on one card
# ---------------------------------------------------------------------------
def mps_running() -> bool:
    """Whether an MPS control daemon runs on this host (without it, the
    children's CUDA contexts time-slice the card)."""
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open(f"/proc/{pid}/comm") as f:
                    if f.read().startswith("nvidia-cuda-mps"):
                        return True
            except OSError:
                continue
    return False


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.nbytes


def serve_timed(router, reqs):
    """Submit every request before the first poll, wait for all; (tokens by
    rid, (wall s, tok/s, ttfc p50 s), events by rid)."""
    t0 = time.perf_counter()
    handles = [router.submit(dataclasses.replace(r)) for r in reqs]
    events = {h.rid: list(h.stream()) for h in handles}
    if router.backend.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = {h.rid: list(h.completion.tokens) for h in handles}
    n_tok = sum(len(t) for t in tokens.values())
    ttfc = float(np.percentile([h.ttfc_s for h in handles], 50))
    return tokens, (wall, n_tok / wall, ttfc), events


def warm_up(router, cfg, rng):
    """First cuBLAS handles, allocations and kernel loads: two requests,
    not counted."""
    from repro_torch.serving.engine import Request
    for h in [router.submit(Request(1000 + i, rng.integers(
            0, cfg.vocab_size, (n,), dtype=np.int32), 4))
            for i, n in enumerate((20, 300))]:
        h.result()
    if router.backend.device.type == "cuda":
        torch.cuda.synchronize()


def process_phase(model, params, card: str, max_new: int = 32):
    """Phase 4's 8 requests on full-width qwen3-0.6b (bf16, n_slots=4,
    max_len=2048, chunk_tokens=32) served four ways: 2 threaded
    containers, the same 2 polled in turn, 2 process containers and 1
    process container (Router(ProcessBackend), the weights shared with
    the children over CUDA IPC). Gates: every request completes; the 2
    process containers' greedy streams equal the 2 threaded containers'
    (all requests submitted before the first poll); each child launched
    flash_attention, decode_attention and rmsnorm; each child's
    memory_allocated after taking the weights is below their bytes (one
    copy on the card) and it imported torch only after pinning itself; a
    kill fault in container 1 after 2 steps gives a ContainerFailure
    with the kill's exit code, RetryEvents for its requests, a respawn,
    and streams equal to the fault-free run. Returns the children's
    summed launch counts of the 2-process run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ProcessBackend, ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.events import RetryEvent
    from repro_torch.serving.faults import EXIT_FAULT_KILL, Fault, FaultPlan
    from repro_torch.serving.router import Router

    cfg, dev = model.cfg, model.device
    on_card = dev.type == "cuda"
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=params["embed"]["table"].dtype)
    rng = np.random.default_rng(10)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(MAIN_PLENS)]
    weights = tree_bytes(params)
    readings, streams = {}, {}

    for name, concurrent in (("2 threaded", True), ("2 in turn", False)):
        with Router(ThreadBackend(model, params, 2, config,
                                  concurrent=concurrent, device=dev),
                    device=dev) as router:
            warm_up(router, cfg, rng)
            ops.reset_launch_counts()
            streams[name], readings[name], _ = serve_timed(router, reqs)
            if on_card:
                check_norm_launches(cfg, ops.launch_counts(),
                                    f"phase 10 {name}")

    children = {}
    for n in (2, 1):
        name = f"{n} process"
        backend = ProcessBackend(cfg, n, config, params=params,
                                 device=dev, allow_shared_cores=True,
                                 start_timeout_s=300)
        with Router(backend, device=dev) as router:
            t0 = time.perf_counter()
            backend.warm()
            start_s = time.perf_counter() - t0
            warm_up(router, cfg, rng)
            backend.child_stats(reset=True)
            streams[name], readings[name], _ = serve_timed(router, reqs)
            stats = backend.child_stats()
            for cid, (info, (counts, memory)) in enumerate(
                    zip(backend.child_info, stats)):
                if info["torch_preloaded"]:
                    fail(f"phase 10: child {cid} had torch imported "
                         "before it pinned itself")
                if info["weight_bytes"] != weights:
                    fail(f"phase 10: child {cid} took {info['weight_bytes']}"
                         f" weight bytes of {weights}")
                if info["memory_allocated"] >= weights:
                    fail(f"phase 10: child {cid} allocated "
                         f"{info['memory_allocated']} B after taking the "
                         f"weights ({weights} B): a copy of its own")
                if not on_card:
                    continue
                for k in ("flash_attention", "decode_attention", "rmsnorm"):
                    if counts.get(k, 0) <= 0:
                        fail(f"phase 10: child {cid} never launched {k}: "
                             f"{counts}")
                check_norm_launches(cfg, counts, f"phase 10 child {cid}")
            children[name] = (stats, [i["memory_allocated"]
                                      for i in backend.child_info],
                              backend.reported_core_sets, start_s)
    for name, got in streams.items():
        if sorted(got) != [r.rid for r in reqs] or any(
                len(t) != max_new for t in got.values()):
            fail(f"phase 10 {name}: not every request completed")
    for name in ("2 in turn", "2 process"):
        if streams[name] != streams["2 threaded"]:
            bad = [r for r in streams[name]
                   if streams[name][r] != streams["2 threaded"][r]]
            fail(f"phase 10: {name} streams differ from the threaded "
                 f"containers' for requests {bad}")

    # a kill fault in container 1 after 2 steps, mid-stream
    plan = FaultPlan((Fault("kill", container_id=1, after_steps=2),))
    backend = ProcessBackend(cfg, 2, config, params=params, device=dev,
                             allow_shared_cores=True, start_timeout_s=300,
                             fault_plan=plan, respawn_backoff_s=0.05)
    with Router(backend, max_retries=2, device=dev) as router:
        backend.warm()
        got, (kill_wall, _, _), events = serve_timed(router, reqs)
        fails = router.container_failures
        if len(fails) != 1 or fails[0].container_id != 1 \
                or fails[0].exitcode != EXIT_FAULT_KILL:
            fail(f"phase 10 kill: failures {fails}")
        retried = {rid for rid, evs in events.items()
                   if any(isinstance(e, RetryEvent) for e in evs)}
        if not retried or retried != set(fails[0].lost_rids):
            fail(f"phase 10 kill: retried {sorted(retried)}, lost "
                 f"{fails[0].lost_rids}")
        if got != streams["2 process"]:
            bad = [r for r in got if got[r] != streams["2 process"][r]]
            fail(f"phase 10 kill: retried streams differ for {bad}")
        t0 = time.perf_counter()
        while not backend.alive(1):
            if time.perf_counter() - t0 > 300:
                fail("phase 10 kill: the respawn never landed")
            router.poll()
            time.sleep(0.02)
        respawn_s = time.perf_counter() - fails[0].time_s
        info = backend.child_info[1]
        if info["torch_preloaded"] or info["memory_allocated"] >= weights:
            fail(f"phase 10 kill: respawned child {info}")
        # the respawned child captures its step graph at its first chunk
        for h in [router.submit(dataclasses.replace(r, rid=5000 + r.rid))
                  for r in reqs[:4]]:
            h.result()
        respawned = backend.child_stats()[1][1]

    dn = str(config.dtype).split(".")[1]
    for name, (wall, tok_s, ttfc) in readings.items():
        print(f"process containers (10): {cfg.name} {cfg.n_layers} layers "
              f"{dn} n_slots={config.n_slots} max_len={config.max_len} "
              f"chunk_tokens={config.chunk_tokens}, 8 requests prompts "
              f"{MAIN_PLENS} max_new={max_new}, {name}: wall_s={wall:.4f} "
              f"tok_per_s={tok_s:.2f} ttfc_p50_s={ttfc:.4f} [card: {card}]",
              flush=True)
    for name, (stats, mem, cores, start_s) in children.items():
        print(f"process containers (10), {name}: spawn + handshake "
              f"{start_s:.2f} s, cores {[sorted(c) for c in cores]}, "
              f"memory_allocated after taking the weights {mem} B (weights "
              f"{weights} B), per child launches "
              f"{[c for c, _ in stats]}, memory {[m for _, m in stats]} "
              f"[card: {card}]", flush=True)
    first_line = fails[0].message.splitlines()[0]
    print(f"process containers (10): streams of 2 process containers == 2 "
          f"threaded == 2 in turn, bit for bit; kill fault in container 1 "
          f"after 2 steps: {fails[0].kind} ({first_line}), "
          f"{len(retried)} requests retried with a RetryEvent, streams "
          f"equal to the fault-free run, wall_s={kill_wall:.4f}, respawn landed "
          f"{respawn_s:.2f} s after the failure (the respawned child "
          f"captures its step graph at its first chunk, after that: "
          f"capture_s={respawned.get('graph_capture_s')} pool_bytes="
          f"{respawned.get('graph_pool_bytes')}); MPS control daemon "
          f"running: {mps_running()} [card: {card}]", flush=True)
    total: dict = {}
    for counts, _ in children["2 process"][0]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# phase 11: the request contract of the fixed-count serving path
# ---------------------------------------------------------------------------
# one fixed 16-way logits row, the sampler's chi-square gate
LOGITS16 = [2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25,
            3.0, -2.0, 0.75, -0.25, 1.25, 0.1, -1.5, 2.5]
CACHE_BYTES = 28 * 2 * 4 * 2048 * 8 * 128 * 2   # qwen3's dense bf16 cache


def noise_advances(engine) -> int:
    """The step graph of a sampling engine (captured, requests active)
    replayed three times from the same slot state: the second replay
    keeps the random stream as the first replay advanced it and must
    sample another token in some active row; the third restores the
    first's stream and must give its tokens again. Each replay advances
    the draw by one. Returns the rows that differ. Leaves the engine
    unfit to serve on (its stream state on the card is rewritten)."""
    from repro_torch.models.sampling import new_key
    active = [i for i, s in enumerate(engine.slots) if s.active]
    if engine.greedy or engine._graph is None or not active:
        fail("noise check: needs a sampling engine with its graph and "
             "active rows")
    B = len(engine.slots)
    head = np.zeros(5 * B + 6, np.int32)
    for i in active:
        s = engine.slots[i]
        head[[i, B + i, 2 * B + i, 3 * B + i]] = (
            s.generated[-1], s.pos, s.remaining, 1)
    draw = engine.draws
    head[4 * B + 2:4 * B + 6].view(np.int64)[:] = new_key(
        engine.config.seed, draw).numpy()
    buf = engine._buf
    picks, keys = [], []
    with engine._on_stream():
        for restore_key in (True, False, True):
            part = head if restore_key else head[:4 * B + 2]
            buf["head"][:len(part)].copy_(torch.from_numpy(part))
            engine._graph.replay()
            picks.append(buf["block"][:, 0].cpu().numpy()[active])
            keys.append(buf["key"].tolist()[1])
    torch.cuda.synchronize()
    if keys != [draw + 1, draw + 2, draw + 1]:
        fail(f"noise check: draws after each replay {keys}, want "
             f"{[draw + 1, draw + 2, draw + 1]}")
    if not np.array_equal(picks[0], picks[2]):
        fail("noise check: the same stream state sampled other tokens")
    differ = int((picks[0] != picks[1]).sum())
    if not differ:
        fail("noise check: two consecutive replays drew the same tokens "
             "in every active row (the noise did not advance)")
    return differ


def step_replay_ms(model, params, greedy: bool, reps: int = 50) -> float:
    """Device ms of one 4-row qwen3 chunk step replayed from a CUDA graph
    (rows live to 48/160/300/544 and inactive, so their positions hold),
    greedy or sampling: ``reps`` replays back to back between two CUDA
    events."""
    cache = model.init_cache(4, 2048, torch.bfloat16)
    buf = model.chunk_buffers(4, reps + 8)   # a block column a step run
    buf["pos"].copy_(torch.tensor([48, 160, 300, 544], dtype=torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def step():
        model.decode_chunk_step(params, cache, buf, max_len=2048,
                                greedy=greedy)
    from repro_torch.kernels.build import capture_tally
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        with capture_tally():
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, cache, buf
    return start.elapsed_time(end) / reps


def watch_rebuilds(backend) -> list:
    """Wrap a ThreadBackend's failure handling: for each rebuild from now
    on, ``(cid, incarnation, memory_allocated as the failure is handled,
    once the dead engine is dropped, once the new engine is built)``.
    Taken there, no other allocation falls between the readings; over a
    longer window cuBLAS adds a 32 MiB workspace for each new pair of a
    worker thread's handle and an engine's stream."""
    seen, entry = [], []
    fail, build = backend._fail_container, backend._build_engine

    def fail_container(cid, message):
        entry.append(torch.cuda.memory_allocated())
        fail(cid, message)

    def build_engine(cid, incarnation):
        dropped = torch.cuda.memory_allocated()
        eng = build(cid, incarnation)
        seen.append((cid, incarnation, entry[-1], dropped,
                     torch.cuda.memory_allocated()))
        return eng
    backend._fail_container = fail_container
    backend._build_engine = build_engine
    return seen


def count_captures(backend) -> list:
    """Wrap each engine's capture so the calls are counted per engine."""
    counts = []
    for eng in backend.engines:
        n = [0]
        real = eng._capture

        def capture(real=real, n=n):
            n[0] += 1
            real()
        eng._capture = capture
        counts.append(n)
    return counts


def request_contract_phase(model, params, card: str, max_new: int = 32):
    """Phase 11 on full-width qwen3-0.6b (bf16, phase 4's seeded weights,
    n_slots=4, max_len=2048, chunk_tokens=32): sampling inside the step
    graph (11a), the per-token baseline (11b), deadlines and shedding
    (11c) and ThreadBackend supervision (11d). Returns the phase's kernel
    launch counts."""
    import scipy.stats

    from repro_torch.kernels import ops
    from repro_torch.models.sampling import gumbel_argmax, new_key
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    from repro_torch.serving.events import (ContainerFailure, FailedEvent,
                                            RejectedEvent, RetryEvent)
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.router import (RequestFailed, RequestRejected,
                                            Router)

    cfg = model.cfg
    base = dict(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                chunk_tokens=32)
    rng = np.random.default_rng(11)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(MAIN_PLENS)]
    phase_t0 = time.perf_counter()
    ops.reset_launch_counts()
    parts = {}

    def complete(tokens, what):
        if sorted(tokens) != [r.rid for r in reqs] or any(
                len(t) != max_new or not all(0 <= x < cfg.vocab_size
                                             for x in t)
                for t in tokens.values()):
            fail(f"phase 11 {what}: not every request completed with "
                 f"{max_new} tokens")

    # -- 11a: sampling inside the step graph ---------------------------
    t0 = time.perf_counter()
    sampled = {}
    for seed in (7, 7, 8):
        config = EngineConfig(greedy=False, seed=seed, **base)
        with Router(ThreadBackend(model, params, 2, config)) as router:
            tokens, _, _ = serve_timed(router, reqs)
        complete(tokens, f"11a seed {seed}")
        sampled.setdefault(seed, []).append(tokens)
    if sampled[7][0] != sampled[7][1]:
        fail("phase 11a: the same seed sampled other streams")
    if sampled[8][0] == sampled[7][0]:
        fail("phase 11a: seed 8 sampled seed 7's streams")
    n_diff = sum(a != b for r in sampled[7][0] for a, b in
                 zip(sampled[7][0][r], sampled[8][0][r]))
    # one sampling engine: the replayed chunk against the eager chunk,
    # then consecutive replays against each other
    eng = ServingEngine(model, params,
                        EngineConfig(greedy=False, seed=7, **base))
    eng.submit_many([dataclasses.replace(r) for r in reqs[:4]])
    eng.step()
    graph_vs_eager(eng, "phase 11a, sampling, dense bf16 cache", card)
    differ = noise_advances(eng)
    del eng
    # chunked and per-token engines with one seed, one engine each
    streams = {}
    for chunked in (True, False):
        eng = ServingEngine(model, params, EngineConfig(
            greedy=False, seed=7, chunked=chunked, **base))
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        streams[chunked] = {c.rid: list(c.tokens) for c in eng.run()}
        complete(streams[chunked], f"11a chunked={chunked}")
        if chunked:
            draws = eng.draws
        elif eng.draws != draws:
            fail(f"phase 11a: per-token engine took {eng.draws} draws, "
                 f"the chunked one {draws}")
        del eng
    if streams[True] != streams[False]:
        bad = [r for r in streams[True] if streams[True][r] !=
               streams[False][r]]
        fail(f"phase 11a: sampled per-token streams differ from the "
             f"chunked engine's for requests {bad}")
    # the sampler alone: one 16-way row repeated 20,000 times, one call
    n = 20_000
    row = torch.tensor(LOGITS16, dtype=torch.float64)
    p = torch.softmax(row, 0).numpy()
    logits = row.float().cuda().repeat(n, 1)
    picks = gumbel_argmax(logits, new_key(7, 0, "cuda")).cpu().numpy()
    chi = scipy.stats.chisquare(np.bincount(picks, minlength=16), p * n)
    if not chi.pvalue > 1e-3:
        fail(f"phase 11a: sampler frequencies fail chi-square against "
             f"softmax (p = {chi.pvalue:.3e})")
    # a 4-row step replayed, greedy against sampling, in turns; and the
    # sampler alone over a step's logits
    walls = [step_replay_ms(model, params, g)
             for g in (True, False, False, True)]
    step_logits = torch.randn(4, cfg.vocab_size, device="cuda").to(
        torch.bfloat16)
    key = new_key(7, 0, "cuda")
    sampler_ms = time_graph_ms(lambda: gumbel_argmax(step_logits, key))
    parts["11a"] = time.perf_counter() - t0
    print(f"request contract (11a), sampling: Router(ThreadBackend(2)) "
          f"greedy=False seed=7 served {len(reqs)} requests prompts "
          f"{MAIN_PLENS} max_new={max_new}, every request complete; seed 7 "
          f"twice gives identical streams, seed 8 differs in {n_diff} of "
          f"{len(reqs) * max_new} tokens; per-token (chunked=False) == "
          f"chunked sampled streams ({draws} draws each); two consecutive "
          f"replays from one slot state sampled other tokens in {differ} "
          f"of 4 rows, the restored stream state the same tokens; sampler "
          f"chi-square over {n} draws of a 16-way row p={chi.pvalue:.4f} "
          f"[card: {card}]", flush=True)
    print(f"request contract (11a), a 4-row qwen3 step replayed from a "
          f"graph (rows live to 48/160/300/544), device ms in turns greedy "
          f"{walls[0]:.4f} / sampling {walls[1]:.4f} / sampling "
          f"{walls[2]:.4f} / greedy {walls[3]:.4f}; the sampler alone over "
          f"4 x {cfg.vocab_size} bf16 logits {sampler_ms:.5f} ms (graph "
          f"replay) [card: {card}]", flush=True)

    # -- 11b: the per-token baseline -----------------------------------
    t0 = time.perf_counter()
    readings, greedy = {}, {}
    for chunked in (True, False):
        eng = ServingEngine(model, params,
                            EngineConfig(chunked=chunked, **base))
        eng.submit_many([Request(900, reqs[0].prompt, 4)])
        eng.run()                      # warm-up (and the capture)
        torch.cuda.synchronize()
        reads, before = eng.host_reads, ops.launch_counts()
        t1 = time.perf_counter()
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        greedy[chunked] = {c.rid: list(c.tokens) for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        after = ops.launch_counts()
        complete(greedy[chunked], f"11b chunked={chunked}")
        n_tok = sum(len(t) for t in greedy[chunked].values())
        readings[chunked] = (wall, n_tok / wall, eng.host_reads - reads,
                             sum(after.values()) - sum(before.values()))
        del eng
    if greedy[True] != greedy[False]:
        bad = [r for r in greedy[True] if greedy[True][r] != greedy[False][r]]
        fail(f"phase 11b: per-token greedy streams differ from the chunked "
             f"engine's for requests {bad}")
    parts["11b"] = time.perf_counter() - t0
    fmt = "wall_s={:.4f} tok_per_s={:.2f} host_reads={} kernel_launches={}"
    print(f"request contract (11b), one engine, {len(reqs)} requests "
          f"prompts {MAIN_PLENS} max_new={max_new}, greedy: per-token "
          f"(chunked=False) {fmt.format(*readings[False])}; chunked "
          f"{fmt.format(*readings[True])}; speedup "
          f"{readings[True][1] / readings[False][1]:.2f}x; streams equal "
          f"[card: {card}]", flush=True)

    # -- 11c: deadlines and shedding -----------------------------------
    t0 = time.perf_counter()
    paged = EngineConfig(cache="paged", block_size=16, max_seqs=4, **base)
    backend = ThreadBackend(model, params, 1, paged)
    captures = count_captures(backend)
    with Router(backend, request_deadline_s=1e-4) as router:
        h = router.submit(Request(0, reqs[1].prompt, 300))
        try:
            h.result()
            fail("phase 11c: a 1e-4 s deadline did not fail")
        except RequestFailed as e:
            if not isinstance(e.event, FailedEvent) or \
                    e.event.kind != "deadline":
                fail(f"phase 11c: deadline failure {e.event}")
            first_reason = e.event.reason
        router.request_deadline_s = None
        ok = router.submit(Request(1, reqs[1].prompt, max_new)).tokens()
        eng = backend.engines[0]
        cb = eng.cache_backend
        cb.flush()
        if len(ok) != max_new or eng.has_work or cb.n_live_blocks or \
                cb.allocator.n_free != cb.layout.max_blocks:
            fail(f"phase 11c: after the deadline, {len(ok)} tokens, work "
                 f"{eng.has_work}, {cb.n_live_blocks} live blocks, "
                 f"{cb.allocator.n_free} of {cb.layout.max_blocks} free")
        paged_replays = eng.graph_replays
    backend = ThreadBackend(model, params, 1, EngineConfig(**base))
    captures += count_captures(backend)
    with Router(backend, deadline_grace_s=60.0, max_queue=4) as router:
        eng = backend.engines[0]
        h = router.submit(Request(2, reqs[0].prompt, 500, deadline_s=0.35))
        t1 = time.perf_counter()
        try:
            h.result()
            fail("phase 11c: the mid-decode deadline did not fail")
        except RequestFailed as e:
            if e.event.kind != "deadline" or \
                    "mid-decode" not in e.event.reason:
                fail(f"phase 11c: mid-decode failure {e.event}")
            mid_reason, mid_s = e.event.reason, time.perf_counter() - t1
        if eng.has_work:
            fail("phase 11c: the expired request kept its slot")
        replays0 = eng.graph_replays
        handles = [router.submit(dataclasses.replace(r, rid=100 + r.rid))
                   for r in reqs]
        rejected = [h for h in handles if isinstance(h.failure,
                                                     RejectedEvent)]
        hints = {h.failure.retry_after_s for h in rejected}
        for h in rejected:
            try:
                h.result()
                fail("phase 11c: a shed request completed")
            except RequestRejected:
                pass
        served = [h for h in handles if h not in rejected]
        lens = [len(h.tokens()) for h in served]
        if len(rejected) != 4 or hints != {0.25} or \
                router.shed_total != 4 or lens != [max_new] * 4:
            fail(f"phase 11c: max_queue=4 over 8 submissions: "
                 f"{len(rejected)} rejected, hints {hints}, shed_total "
                 f"{router.shed_total}, served lengths {lens}")
        if eng.graph_replays <= replays0:
            fail("phase 11c: the served requests replayed no graph")
    if [c[0] for c in captures] != [1, 1]:
        fail(f"phase 11c: captures per engine {[c[0] for c in captures]}")
    parts["11c"] = time.perf_counter() - t0
    print(f"request contract (11c): request_deadline_s=1e-4 over a paged "
          f"engine fails typed ('{first_reason}'), then an undeadlined "
          f"request completes and all blocks are back in the pool "
          f"({paged_replays} replays); deadline_s=0.35 max_new=500 fails "
          f"after {mid_s:.3f} s ('{mid_reason}') and frees its slot; "
          f"max_queue=4 over 8 submissions: 4 RejectedEvent (retry_after_s "
          f"0.25), 4 complete; one capture an engine [card: {card}]",
          flush=True)

    # -- 11d: ThreadBackend supervision --------------------------------
    t0 = time.perf_counter()
    rng10 = np.random.default_rng(10)      # phase 10's requests
    reqs10 = [Request(i, rng10.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
              for i, n in enumerate(MAIN_PLENS)]
    config = EngineConfig(**base)
    with Router(ThreadBackend(model, params, 2, config)) as router:
        want, _, _ = serve_timed(router, reqs10)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # one warm-up step an engine (its graph, its stream's cuBLAS
    # workspace), then the error two steps into phase 10's requests
    plan = FaultPlan((Fault("error", container_id=1, after_steps=3),))
    backend = ThreadBackend(model, params, 2, config, fault_plan=plan)
    with Router(backend, max_retries=2) as router:
        for h in [router.submit(Request(1000 + i, reqs10[i].prompt, 2))
                  for i in range(2)]:
            h.result()
        if any(e._graph is None for e in backend.engines):
            fail("phase 11d: the warm-up left an engine without its graph")
        rebuilds = watch_rebuilds(backend)
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        got, (fault_wall, _, _), events = serve_timed(router, reqs10)
        fails = router.container_failures
        if len(fails) != 1 or not isinstance(fails[0], ContainerFailure) \
                or fails[0].kind != "error" or fails[0].container_id != 1:
            fail(f"phase 11d: failures {fails}")
        retried = {rid for rid, evs in events.items()
                   if any(isinstance(e, RetryEvent) for e in evs)}
        if not retried or retried != set(fails[0].lost_rids):
            fail(f"phase 11d: retried {sorted(retried)}, lost "
                 f"{fails[0].lost_rids}")
        if got != want:
            bad = [r for r in got if got[r] != want[r]]
            fail(f"phase 11d: streams after the rebuild differ from the "
                 f"fault-free run for {bad}")
        new = backend.engines[1]
        if new.graph_capture_s is None:
            # the rebuilt engine captures at its first chunk
            for h in [router.submit(dataclasses.replace(r, rid=500 + r.rid))
                      for r in reqs10[:2]]:
                h.result()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        rebuild_s, capture_s = backend.rebuild_s[1], new.graph_capture_s
        if capture_s is None or not backend.alive(1):
            fail("phase 11d: the rebuilt engine never captured its graph")
        if len(rebuilds) != 1:
            fail(f"phase 11d: rebuilds {rebuilds}")
        _, _, mem_failed, mem_dropped, mem_built = rebuilds[0]
        # the dead engine's cache is gone before the new one allocates;
        # over the whole run only cuBLAS workspaces may add
        if mem_failed - mem_dropped < CACHE_BYTES or \
                mem_after - mem_before >= CACHE_BYTES // 2:
            fail(f"phase 11d: memory_allocated {mem_before} B before the "
                 f"run, {mem_failed} B at the failure, {mem_dropped} B once "
                 f"the dead engine was dropped, {mem_after} B after the "
                 f"rebuild: the dead engine's {CACHE_BYTES} B cache stayed "
                 f"allocated")
    del backend, new
    torch.cuda.empty_cache()
    plan = FaultPlan((Fault("error", container_id=1, after_steps=1,
                            incarnation=None),))
    backend = ThreadBackend(model, params, 2, config, fault_plan=plan,
                            max_respawns=1)
    with Router(backend, max_retries=3) as router:
        broken, _, _ = serve_timed(router, reqs10)
        complete(broken, "11d breaker")
        if backend.alive(1) or len(router.container_failures) != 2:
            fail(f"phase 11d: breaker: alive {backend.alive(1)}, failures "
                 f"{len(router.container_failures)}")
        after = [router.submit(dataclasses.replace(r, rid=700 + r.rid))
                 for r in reqs10[:4]]
        if any(h.container_id != 0 for h in after) or any(
                len(h.tokens()) != max_new for h in after):
            fail("phase 11d: after the breaker the Router did not serve "
                 "on container 0 alone")
    del backend
    torch.cuda.empty_cache()
    parts["11d"] = time.perf_counter() - t0
    print(f"request contract (11d): an error fault in container 1 two "
          f"steps into the run (after a warm-up step): one "
          f"ContainerFailure(kind='error'), {len(retried)} "
          f"requests retried with a RetryEvent, streams equal to the "
          f"fault-free run (wall_s={fault_wall:.4f}); the rebuild took "
          f"{rebuild_s:.4f} s (engine and cache) + {capture_s:.4f} s (its "
          f"graph capture at its first chunk); memory_allocated "
          f"{mem_before} B before the run, {mem_failed} B at the failure, "
          f"{mem_dropped} B once the dead engine was dropped, {mem_built} B "
          f"with the new engine built, {mem_after} B after the rebuild "
          f"served (the dead engine's cache is {CACHE_BYTES} B); a fault "
          f"in every incarnation trips the breaker after 1 respawn and "
          f"the Router serves on container 0 alone [card: {card}]",
          flush=True)
    launches = ops.launch_counts()
    print(f"request contract (11): parts in s "
          f"{ {k: round(v, 2) for k, v in parts.items()} }, whole phase "
          f"{time.perf_counter() - phase_t0:.2f} s, launches {launches} "
          f"[card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8b: the paged cache over mamba2's state rows
# ---------------------------------------------------------------------------
# phase 5's groups at lengths mamba2's scan chunk (min(256, S)) divides:
# every prompt of at most 256 tokens, then multiples of 256
SSM_PARITY_GROUPS = [((150, 200, 256, 180), 24), ((40, 50, 64, 33), 32),
                     ((512, 768, 1024), 16)]


def full_width_ssm():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("mamba2-2.7b"))
    return model, model.init(seed=0, dtype=torch.bfloat16)


def ssm_paged_phase(model, params, card: str):
    """Phase 8b: one dense (n_slots 4) and one paged engine (block_size 16,
    max_seqs 8, the dense footprint of 512 blocks) over full-width
    mamba2-2.7b serve ``SSM_PARITY_GROUPS``: identical greedy streams, the
    paged engine with more sequences in flight than the dense one has
    slots, and ``graph_vs_eager`` on both (``parity_phase``). The paged
    tree has no paged group: the conv and state rows stay dense, sized by
    max_seqs. Returns the two engines' summed launches."""
    from repro_torch.serving.engine import EngineConfig

    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16, block_size=16, max_seqs=8)
    peaks: list[int] = []
    dense, paged = parity_phase(model, params, config, card,
                                groups=SSM_PARITY_GROUPS, peaks=peaks)
    if peaks[1] <= config.n_slots:
        fail(f"phase 8b: the paged engine peaked at {peaks[1]} sequences, "
             f"not more than the dense engine's {config.n_slots} slots")
    if dense["ssd_scan"] <= 0 or paged["ssd_scan"] != dense["ssd_scan"]:
        fail(f"phase 8b: ssd_scan launches dense {dense['ssd_scan']}, "
             f"paged {paged['ssd_scan']}")
    if any(dense[k] or paged[k] for k in ATTENTION_KERNELS):
        fail(f"phase 8b: attention kernels launched: {dense} {paged}")
    row = tree_bytes(model.init_cache(1, config.max_len, config.dtype))
    print(f"paged ssm (8b): peak_active dense {peaks[0]}, paged {peaks[1]} "
          f"(max_seqs {config.max_seqs}, max_blocks "
          f"{config.resolved_max_blocks}); SSM row bytes per sequence "
          f"{row} (conv tails + states, {model.cfg.n_layers} layers), "
          f"{row * config.max_seqs} B for the paged engine's rows "
          f"[card: {card}]", flush=True)
    return {k: n + paged[k] for k, n in dense.items()}


# ---------------------------------------------------------------------------
# phase 12: the online container-count loop
# ---------------------------------------------------------------------------
ONLINE_WINDOWS = 6


class PowerMeter:
    """The card's draw from ``nvidia-smi --query-gpu=power.draw`` every
    100 ms, read by a helper thread: ``joules(t0, t1, wall)`` is the mean
    draw of the samples stamped in [t0, t1] times ``wall``. Read and
    printed only; nothing steers by it."""

    def __init__(self):
        import threading

        self.samples: list[tuple[float, float]] = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                watts = float(line.strip())
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), watts))

    def joules(self, t0: float, t1: float, wall: float):
        """(joules, samples), or (None, 0) with no sample in [t0, t1]."""
        got = [w for t, w in list(self.samples) if t0 <= t <= t1]
        if not got:
            return None, 0
        return sum(got) / len(got) * wall, len(got)

    def close(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.thread.join(timeout=10)


def measured(meter, t0, t1, wall) -> str:
    joules, n = meter.joules(t0, t1, wall)
    if joules is None:
        return "measured_j=not measured (no power.draw sample)"
    return f"measured_j={joules:.4f} ({n} power.draw samples)"


def online_requests(cfg, seed: int, max_new: int = 32) -> list:
    """ONLINE_WINDOWS windows of phase 4's 8 prompt lengths, each with
    tokens of its own, max_new 32."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [[Request(w * 8 + i, rng.integers(0, cfg.vocab_size, (n,),
                                             dtype=np.int32), max_new)
             for i, n in enumerate(MAIN_PLENS)]
            for w in range(ONLINE_WINDOWS)]


def warm_backend(backend, cfg, rng) -> None:
    """Every container of ``backend`` admits a request and decodes: its
    first cuBLAS calls, its allocations and its graph capture, before any
    window's clock."""
    from repro_torch.serving.engine import Request

    for cid in range(backend.capacity):
        backend.submit(cid, Request(9000 + cid, rng.integers(
            0, cfg.vocab_size, (20,), dtype=np.int32), 4))
    while any(backend.load(cid) for cid in range(backend.capacity)):
        backend.poll()
    backend.poll()
    torch.cuda.synchronize()


def online_loop_phase(model, params, card: str):
    """Phase 12 on full-width qwen3-0.6b (bf16, phase 4's seeded weights,
    n_slots=4, max_len=2048, chunk_tokens=32, one request a prefill so a
    request's bits do not depend on which container, or which batch, it
    landed in: cuBLAS gives a bf16 prefill row other bits below 128 rows
    a batch, see ``MIN_PREFILL_ROWS`` in ``serving/engine.py``):

    a. ``Router(backend_factory=n -> ThreadBackend(n), feasible_counts=
       card_feasible_counts(..., max_containers=4), window=8, epsilon=0,
       objective="energy")`` serves 6 windows of phase 4's traffic,
       drained window by window. Per window: n, wall, EnergyProxy J, the
       card's measured J, tok/s, ttfc p50/p95. Gates: the bootstrap visits
       every feasible count, each count's backend is built once, and every
       request's greedy tokens equal a fixed Router(ThreadBackend(1))'s.
    b. ``AdaptiveServingPool`` (threads) over the same traffic as 6 waves:
       the same tokens, its history printed.
    c. One wave through ``ProcessContainerPool(2)`` (pinned children, the
       weights over CUDA IPC) against ``ContainerServingPool(2)``:
       identical ordered completions; walls and proxy energies printed.

    Each count's backend or pool serves a warm-up request a container
    before the loop, so no window pays a graph capture. Returns 12a's
    kernel launches."""
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.kernels import ops
    from repro_torch.serving.adaptive import AdaptiveServingPool
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.pool import ContainerServingPool
    from repro_torch.serving.process_pool import ProcessContainerPool
    from repro_torch.serving.router import Router

    cfg = model.cfg
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16, batch_admit=False)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    counts = card_feasible_counts(cfg, config, card_bytes=card_bytes,
                                  max_containers=4)
    if len(counts) < 2:
        fail(f"phase 12: feasible counts {counts} on {card_bytes} B")
    windows = online_requests(cfg, seed=12)
    flat = [r for w in windows for r in w]
    rng = np.random.default_rng(13)
    phase_t0 = time.perf_counter()

    # the reference: one container, fixed
    with Router(ThreadBackend(model, params, 1, config)) as fixed:
        warm_backend(fixed.backend, cfg, rng)
        want = {h.rid: h.tokens() for h in [
            fixed.submit(dataclasses.replace(r)) for r in flat]}

    meter = PowerMeter()
    try:
        # 12a: the adaptive Router
        warm = {}
        for n in counts:
            warm[n] = ThreadBackend(model, params, n, config)
            warm_backend(warm[n], cfg, rng)
        built: list[int] = []

        def factory(n):
            built.append(n)
            return warm[n]
        got = {}
        ops.reset_launch_counts()
        with Router(backend_factory=factory, feasible_counts=counts,
                    window=8, epsilon=0.0, objective="energy") as router:
            for w, reqs in enumerate(windows):
                t0 = time.perf_counter()
                handles = [router.submit(dataclasses.replace(r))
                           for r in reqs]
                router.drain()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got.update({h.rid: list(h.completion.tokens)
                            for h in handles})
                if len(router.history) != w + 1:
                    fail(f"phase 12a: {len(router.history)} windows after "
                         f"{w + 1} drained")
                ws = router.history[-1]
                print(f"online loop (12a) window {w}: n={ws.n_containers} "
                      f"wall_s={ws.wall_s:.4f} proxy_j={ws.energy_j:.4f} "
                      f"{measured(meter, t0, t1, ws.wall_s)} "
                      f"tok_per_s={ws.tokens_per_s:.2f} ttfc_p50_s="
                      f"{ws.ttfc_p50_s:.4f} ttfc_p95_s={ws.ttfc_p95_s:.4f} "
                      f"[card: {card}]", flush=True)
            launches = ops.launch_counts()
            summary, choice = router.scheduler.summary(), router.choice
            history = list(router.history)
        print(f"online loop (12a): feasible counts {counts} from "
              f"card_feasible_counts on {card_bytes} B, counts by window "
              f"{[w.n_containers for w in history]}, scheduler summary "
              f"{summary}, choice {choice}, backends built {built}; "
              f"launches {launches} [card: {card}]", flush=True)
        if {w.n_containers for w in history[:len(counts)]} != set(counts):
            fail(f"phase 12a: the bootstrap visited "
                 f"{[w.n_containers for w in history]}, not every count of "
                 f"{counts}")
        if len(built) != len(set(built)):
            fail(f"phase 12a: backends built {built}: a count twice")
        if got != want:
            bad = [rid for rid in want if got.get(rid) != want[rid]]
            fail(f"phase 12a: requests {bad} differ from the fixed "
                 "Router(ThreadBackend(1))'s greedy tokens")
        for k in ("flash_attention", "decode_attention"):
            if launches[k] <= 0:
                fail(f"phase 12a: {k} never launched: {launches}")
        check_norm_launches(cfg, launches, "phase 12a")
        del warm
        torch.cuda.empty_cache()

        # 12b: the adaptive pool over waves
        def pool_factory(n):
            pool = ContainerServingPool(model, params, n, config)
            warm_backend(pool.backend, cfg, rng)
            return pool
        apool = AdaptiveServingPool(model, params, counts,
                                    objective="energy", config=config,
                                    pool_factory=pool_factory)
        got = {}
        for w, reqs in enumerate(windows):
            t0 = time.perf_counter()
            out = apool.serve_wave([dataclasses.replace(r) for r in reqs])
            t1 = time.perf_counter()
            if [c.rid for c in out] != [r.rid for r in reqs]:
                fail(f"phase 12b: wave {w} came back out of order")
            got.update({c.rid: list(c.tokens) for c in out})
            h = apool.history[-1]
            print(f"adaptive pool (12b) wave {w}: n={h.n_containers} "
                  f"wall_s={h.wall_s:.4f} proxy_j={h.energy_j:.4f} "
                  f"{measured(meter, t0, t1, h.wall_s)} "
                  f"tok_per_s={h.tokens_per_s:.2f} latency_p50_s="
                  f"{h.latency_p50_s:.4f} latency_p95_s="
                  f"{h.latency_p95_s:.4f} [card: {card}]", flush=True)
        print(f"adaptive pool (12b): counts by wave "
              f"{[h.n_containers for h in apool.history]}, choice "
              f"{apool.choice} [card: {card}]", flush=True)
        apool.close()
        torch.cuda.empty_cache()
        if got != want:
            bad = [rid for rid in want if got.get(rid) != want[rid]]
            fail(f"phase 12b: requests {bad} differ from the fixed "
                 "Router(ThreadBackend(1))'s greedy tokens")

        # 12c: one wave in pinned processes against the same in threads
        wave = windows[0]
        out = {}
        for name, pool in (
                ("2 threaded", ContainerServingPool(model, params, 2,
                                                    config)),
                ("2 process", ProcessContainerPool(cfg, 2, config,
                                                   params=params,
                                                   allow_shared_cores=True,
                                                   start_timeout_s=300))):
            try:
                # warm-up wave: spawn, first cuBLAS calls, graph captures
                pool.serve_timed([dataclasses.replace(r, rid=r.rid + 500)
                                  for r in wave])
                t0 = time.perf_counter()
                ordered, _, wall, energy = pool.serve_timed(
                    [dataclasses.replace(r) for r in wave])
                t1 = time.perf_counter()
            finally:
                pool.close()
            out[name] = [(c.rid, list(c.tokens)) for c in ordered]
            print(f"process pool (12c) {name}: one wave of 8, wall_s="
                  f"{wall:.4f} proxy_j={energy:.4f} "
                  f"{measured(meter, t0, t1, wall)} [card: {card}]",
                  flush=True)
        if out["2 process"] != out["2 threaded"]:
            fail("phase 12c: the process pool's ordered completions differ "
                 "from the thread pool's")
        if [t for _, t in out["2 threaded"]] != [want[r.rid] for r in wave]:
            fail("phase 12c: the pools' tokens differ from the fixed "
                 "Router(ThreadBackend(1))'s")
    finally:
        meter.close()
    if multiprocessing.active_children():
        fail(f"phase 12 left processes running: "
             f"{multiprocessing.active_children()}")
    print(f"online loop (12): whole phase "
          f"{time.perf_counter() - phase_t0:.2f} s [card: {card}]",
          flush=True)
    return launches


def full_width_model(dtype):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("qwen3-0.6b"))
    return model, model.init(seed=0, dtype=dtype)


def main() -> int:
    global np, torch
    import numpy
    import torch as _torch
    np, torch = numpy, _torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import ops
    from repro_torch.kernels.build import extension
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig

    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}", flush=True)
    t0 = time.perf_counter()
    extension()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernel_phase()
    from repro_torch.configs.registry import get_config
    model_phase(dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2),
                [63, 40])
    model_phase(get_config("mamba2-2.7b-reduced"), [63, 63])
    model_phase(get_config("deepseek-v2-lite-16b-reduced"), [63, 40])
    launches = main_path_phase(card)

    model, params = full_width_model(torch.bfloat16)
    base = dict(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                chunk_tokens=32, cache="paged", block_size=16)
    parity_phase(model, params, EngineConfig(max_seqs=4, **base), card)
    torch.cuda.empty_cache()
    paged_launches, bf16_tokens, bf16_pool = prefix_phase(
        model, params, EngineConfig(max_seqs=8, prefix_cache=True, **base),
        card)
    torch.cuda.empty_cache()
    sharing_launches = sharing_gate_phase(
        model, params, EngineConfig(max_seqs=8, **base), card)
    # 6c again in float32 at full width (its own weights from the same
    # seed), phase 6's whole two waves: the float32 projections run in
    # fixed 128-row slices on the card, so sharing on == off bit for bit
    torch.cuda.empty_cache()
    model32, params32 = full_width_model(torch.float32)
    sharing_launches_f32 = sharing_gate_phase(
        model32, params32,
        EngineConfig(max_seqs=8, **{**base, "dtype": torch.float32}), card,
        padding=False)
    del model32, params32

    # the same weights over int8 caches
    torch.cuda.empty_cache()
    model8 = Model(dataclasses.replace(model.cfg, kv_cache_dtype="int8"))
    dense8, paged8 = parity_phase(model8, params,
                                  EngineConfig(max_seqs=4, **base), card)
    parity8 = {k: n + paged8[k] for k, n in dense8.items()}
    for k in ("decode_attention", "paged_decode_attention"):
        if parity8[k] or not parity8[f"{k}_int8"]:
            fail(f"int8 dense vs paged: launches {parity8}")
    torch.cuda.empty_cache()
    int8_launches = int8_path_phase(
        model8, params, EngineConfig(max_seqs=8, prefix_cache=True, **base),
        card, bf16_tokens, bf16_pool)

    # process containers on the same weights
    torch.cuda.empty_cache()
    process_launches = process_phase(model, params, card)
    if multiprocessing.active_children():
        fail(f"phase 10 left processes running: "
             f"{multiprocessing.active_children()}")

    # the request contract of the fixed-count path on the same weights
    torch.cuda.empty_cache()
    contract_launches = request_contract_phase(model, params, card)

    # the online container-count loop on the same weights
    torch.cuda.empty_cache()
    online_launches = online_loop_phase(model, params, card)

    # the SSM family, once the qwen3 weights and caches are released, on
    # the dense and on the paged cache
    del model, model8, params
    torch.cuda.empty_cache()
    ssm_model, ssm_params = full_width_ssm()
    ssm_launches = ssm_path_phase(ssm_model, ssm_params, card)
    torch.cuda.empty_cache()
    ssm_paged_launches = ssm_paged_phase(ssm_model, ssm_params, card)
    del ssm_model, ssm_params

    # the MoE family with latent attention, once mamba2's weights are
    # released
    torch.cuda.empty_cache()
    mla_launches, mla_parity = deepseek_path_phase(card)

    # each kernel's launches come from the path it serves: phase 4 (dense
    # cache) for the prefill and dense decode kernels, phase 6 (paged
    # cache with prefix sharing) for the paged decode kernel, phase 7a
    # (dense and paged int8 engines) for the dense int8 kernel, 7b
    # (the int8 Router path) for the paged int8 kernel, 8 (mamba2) for
    # the SSD scan and 9 (deepseek) for the MLA decode kernel; rmsnorm
    # runs on every path, counted from phase 4; phase 10 sums the process
    # containers' own counts; phase 8b sums mamba2's dense and paged
    # engines, phase 12 is the adaptive Router's run (12a)
    by_phase = {"phase4": launches, "phase6": paged_launches,
                "phase6c": sharing_launches,
                "phase6c_f32": sharing_launches_f32,
                "phase7a": parity8, "phase7b": int8_launches,
                "phase8": ssm_launches, "phase9": mla_launches,
                "phase9b_dense": mla_parity[0],
                "phase9b_paged": mla_parity[1],
                "phase8b": ssm_paged_launches,
                "phase10": process_launches,
                "phase11": contract_launches,
                "phase12": online_launches}
    main_phase = {"flash_attention": "phase4", "decode_attention": "phase4",
                  "paged_decode_attention": "phase6",
                  "decode_attention_int8": "phase7a",
                  "paged_decode_attention_int8": "phase7b",
                  "ssd_scan": "phase8", "mla_decode_ctx": "phase9",
                  "rmsnorm": "phase4"}
    replaces = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:98"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:167"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:156"),
        "decode_attention_int8": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:124"),
        "paged_decode_attention_int8": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:211"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:100"),
        "mla_decode_ctx": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                           "src/repro/kernels/mla_decode.py:77"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:33"),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1],
         "launches": by_phase[main_phase[k]][k],
         "launches_by_phase": {ph: c.get(k, 0) for ph, c in by_phase.items()},
         **{f: v for f, v in kernels[k].items()}}
        for k in replaces]}
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

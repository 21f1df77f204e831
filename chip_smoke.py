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
   ignore NaN in every page (and int8 scale page) no row owns. The int8
   kernels take int8 K/V quantised by the model's own quantiser, with
   float32 or bfloat16 queries. Times each (CUDA events) beside the plain
   version and ``scaled_dot_product_attention`` (a yardstick the port
   never calls; over the dequantised view for the int8 kernels). The SSD
   scan at mamba2-2.7b's widths (nh=80, hd=64, ds=128, chunk 256):
   S = 512 and 2048, B = 2, a ragged one-chunk prompt, ng = 2, float32
   and bfloat16, |kernel - plain| <= tol * max|plain| (tol 5e-5 and
   2e-2: the kernel cuts the sequence into 64-position tiles where the
   plain version cuts it at ``chunk``) and, wherever 64 divides S,
   element by element within tol abs + tol rel against the plain version
   cut at 64, timed beside the plain version (no PyTorch call computes
   the scan). The prefill kernel at MLA's widths (K = 192, Kv = 128,
   H = Hkv = 16). The MLA decode kernel at deepseek-v2-lite's widths
   (H = 16, r = 512, dr = 64): the 4-slot main shape, a ragged S = 1000
   with an all-dead row that must read 0, and the view gathered from
   16-token latent pages, which must ignore NaN in unowned pages; timed
   beside the plain version and ``scaled_dot_product_attention`` over
   [q_lat | q_rope] and [ckv | k_rope].
3. Model: qwen3-0.6b at full width cut to 2 layers, the 2-layer
   mamba2-2.7b-reduced and the 2-layer deepseek-v2-lite-16b-reduced,
   float32, the port's seeded init: prefill + 8 greedy decode steps on
   the card against the same parameters on the CPU plain path.
4. Main path of the dense cache: ``Router(ThreadBackend(n_containers=2))``
   over full-width qwen3-0.6b (28 layers, bfloat16, random weights from a
   seed), n_slots=4, max_len=2048, 8 requests with ragged 16-512 token
   prompts and max_new=32; the prefill and dense decode kernels must
   launch.
5. Dense vs paged: one dense and one paged ``ServingEngine`` (block_size
   16, max_seqs = n_slots = 4, so both decode the same rows) serve the
   same same-bucket request groups; their greedy streams must be
   identical.
6. Main path of the paged cache with prefix sharing:
   ``Router(ThreadBackend(2))`` over paged engines (block_size 16,
   max_seqs 8, the dense footprint of 512 blocks, prefix_cache=True);
   16 requests of a 256-token shared prompt + 16-256-token tail,
   max_new=32, in two waves (2, then 14). Every request completes; wave 2
   hits the prefix; some container has more than n_slots requests in
   flight; the paged and prefill kernels launch, the dense decode kernel
   does not. Wave 2 is also served without sharing on one engine and its
   token agreement printed (reported, not checked: other batch shapes).
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
   attention kernel launches. Reports wall, tok/s, ttfc p50, the state
   cache's bytes, and one decode step's host time and kernel launches.
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

Then a JSON line with each kernel's launches (from the phase of the path
it serves), error and times (seven kernels), the card's ``nvidia-smi``
line, and the result line ``{"ok": true, "device": {...}}``.

It needs the checkout's ``src/`` and a CUDA device; without either it
exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

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
    unowned page and the scratch page filled with NaN."""
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
             ([90, 250, 500], 16, 2, 64, 16, 32, 0.0, 2)]   # G = 8
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


def quant(x):
    """int8 codes and float32 scales of x, by the model's quantiser."""
    from repro_torch.models.attention import _quant_kv
    return _quant_kv(x)


def int8_checks(gen):
    """The int8 kernels against their plain versions (f32 and bf16 q); the
    paged one bitwise against the dense one over the gathered view, a
    length-0 row 0, and unchanged with NaN in every unowned page, scale
    page and the scratch page (and in dense slots no row reads)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, W, softcap in ((4, 2048, 0.0), (3, 300, 30.0)):
            q = torch.randn(B, H, K, generator=gen, device=dev).to(dtype)
            kq, ks = quant(torch.randn(B, W, HKV, K, generator=gen,
                                       device=dev))
            vq, vs = quant(torch.randn(B, W, HKV, K, generator=gen,
                                       device=dev))
            valid = torch.rand(B, W, generator=gen, device=dev) < 0.7
            valid[-1] = False                    # a row with no live slot
            what = f"decode_attention_int8 {dn} B={B} W={W} softcap={softcap}"
            got = da.decode_attention_int8(q, kq, vq, valid, ks, vs,
                                           softcap=softcap)
            torch.cuda.synchronize()
            err = check_close(got, ref.decode_attention(
                q, kq, vq, valid, softcap=softcap, k_scale=ks, v_scale=vs),
                dn, what)
            if bool(got[-1].ne(0).any()):
                fail(f"{what}: all-invalid row is not 0")
            ks[~valid], vs[~valid] = float("nan"), float("nan")
            if not torch.equal(got, da.decode_attention_int8(
                    q, kq, vq, valid, ks, vs, softcap=softcap)):
                fail(f"{what}: output moved with NaN scales in dead slots")
            print(f"{what}: max_abs_err={err:.3e}, dead slots' NaN scales "
                  "ignored", flush=True)
        # (lengths, softcap, share): the main-path shape, the phase-2
        # scattered/shared tables with a length-0 row, softcap
        for lengths, softcap, share in (
                (PAGED_MAIN_LENGTHS, 0.0, 0),
                ([700, 33, 0, 2048, 17, 1, 1024, 255], 0.0, 2),
                ([48, 160, 300, 544], 30.0, 0)):
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
            print(f"{what}: max |kernel - plain| / max|plain| = {rel:.3e} "
                  f"(y and state; tolerance {tol}){cut}; kernel_ms="
                  f"{ms:.4f}", flush=True)
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
    read 0; and the logical view gathered from 16-token latent pages (the
    paged cache's path), which must also ignore NaN in every page no row
    owns."""
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
        got = held(what, dn, mla_inputs(gen, B, S, dtype), valid)
        if bool(got[-1].ne(0).any()):
            fail(f"{what}: the all-dead row is not 0")

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
    16, causal), float32 and bfloat16; returns the bfloat16 ms."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    ms = {}
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
        ms[dn] = time_ms(lambda: fa.flash_attention(q, k, v))
        print(f"{what}: max_abs_err={err:.3e} kernel_ms={ms[dn]:.4f}",
              flush=True)
    return ms["bfloat16"]


def kernel_phase():
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
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
    results["flash_attention"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v), reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "shape": f"B={B} Sq=Skv={S} H={H} Hkv={HKV} K={K} bf16 causal"}

    B, W = 4, 2048
    q = randn(B, H, K, dtype=dtype)
    k = randn(B, W, HKV, K, dtype=dtype)
    v = randn(B, W, HKV, K, dtype=dtype)
    depth = torch.tensor([48, 160, 300, 544], device=dev)
    valid = torch.arange(W, device=dev)[None, :] < depth[:, None]
    err = check_close(da.decode_attention(q, k, v, valid),
                      ref.decode_attention(q, k, v, valid), dn,
                      "decode main shape")
    bound, by = decode_bound(B, W, valid, dn, isz)
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask4 = valid[:, None, None, :]
    results["decode_attention"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: da.decode_attention(q, k, v, valid)),
        "plain_ms": time_ms(lambda: ref.decode_attention(q, k, v, valid),
                            reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, enable_gqa=True)),
        "shape": f"B={B} W={W} H={H} Hkv={HKV} K={K} bf16 live="
                 f"{depth.tolist()}"}

    # paged decode at the phase-6 shape: 8 rows (max_seqs) of a 2048-token
    # horizon in 16-token pages, live to depths in the range its requests
    # reach (256-token prompt prefix + tail + decoded tokens)
    lengths, bs, nblk = PAGED_MAIN_LENGTHS, 16, 128
    q, kp, vp, table, lens, _ = paged_case(gen, lengths, h=H, hkv=HKV, k=K,
                                           bs=bs, nblk=nblk, dtype=dtype)
    err = check_close(pa.paged_decode_attention(q, kp, vp, table, lens),
                      ref.paged_decode_attention(q, kp, vp, table, lens), dn,
                      "paged main shape")
    bound, by = paged_bound(len(lengths), nblk, lens, dn, isz)
    kd, vd, valid = gathered(kp, vp, table, lens)
    q4, k4, v4 = q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    mask4 = valid[:, None, None, :]
    results["paged_decode_attention"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: pa.paged_decode_attention(q, kp, vp, table,
                                                        lens)),
        "plain_ms": time_ms(lambda: ref.paged_decode_attention(
            q, kp, vp, table, lens), reps=5),
        "bound_ms": bound, "bound_by": by,
        # a yardstick that leaves out the gather: sdpa over the dense view
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, enable_gqa=True)),
        "shape": f"B={len(lengths)} bs={bs} nblk={nblk} H={H} Hkv={HKV} "
                 f"K={K} bf16 live={lengths}; library_ms is sdpa over the "
                 "pre-gathered dense view (gather not counted)"}

    # the int8 kernels at the same two decode shapes, bf16 queries over
    # int8 K/V; the yardstick is sdpa over the dequantised bf16 view
    # (dequantisation not counted: no PyTorch call attends over int8)
    int8_checks(gen)
    B, W = 4, 2048
    q = randn(B, H, K, dtype=dtype)
    kq, ks = quant(torch.randn(B, W, HKV, K, generator=gen, device=dev))
    vq, vs = quant(torch.randn(B, W, HKV, K, generator=gen, device=dev))
    depth = torch.tensor([48, 160, 300, 544], device=dev)
    valid = torch.arange(W, device=dev)[None, :] < depth[:, None]
    err = check_close(
        da.decode_attention_int8(q, kq, vq, valid, ks, vs),
        ref.decode_attention(q, kq, vq, valid, k_scale=ks, v_scale=vs), dn,
        "int8 decode main shape")
    bound, by = decode_bound(B, W, valid, dn, isz, row_bytes=K + 4)
    k4 = (kq.float() * ks[..., None]).to(dtype).transpose(1, 2)
    v4 = (vq.float() * vs[..., None]).to(dtype).transpose(1, 2)
    mask4 = valid[:, None, None, :]
    results["decode_attention_int8"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: da.decode_attention_int8(q, kq, vq, valid, ks,
                                                       vs)),
        "plain_ms": time_ms(lambda: ref.decode_attention(
            q, kq, vq, valid, k_scale=ks, v_scale=vs), reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k4, v4, attn_mask=mask4, enable_gqa=True)),
        "shape": f"B={B} W={W} H={H} Hkv={HKV} K={K} bf16 q, int8 K/V + "
                 f"f32 scales, live={depth.tolist()}; library_ms is sdpa "
                 "over the dequantised bf16 view (dequant not counted)"}

    lengths = PAGED_MAIN_LENGTHS
    q, kp, vp, table, lens, _ = paged_case(gen, lengths, h=H, hkv=HKV, k=K,
                                           bs=bs, nblk=nblk,
                                           dtype=torch.float32)
    q = q.to(dtype)
    kq, ks = quant(kp)
    vq, vs = quant(vp)
    err = check_close(
        pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table, lens),
        ref.paged_decode_attention(q, kq, vq, table, lens, k_scale_pages=ks,
                                   v_scale_pages=vs), dn,
        "int8 paged main shape")
    bound, by = paged_bound(len(lengths), nblk, lens, dn, isz,
                            row_bytes=K + 4)
    kd, vd, valid = gathered(kq, vq, table, lens)
    ksd, vsd, _ = gathered(ks, vs, table, lens)
    k4 = (kd.float() * ksd[..., None]).to(dtype).transpose(1, 2)
    v4 = (vd.float() * vsd[..., None]).to(dtype).transpose(1, 2)
    mask4 = valid[:, None, None, :]
    results["paged_decode_attention_int8"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: pa.paged_decode_attention_int8(
            q, kq, vq, ks, vs, table, lens)),
        "plain_ms": time_ms(lambda: ref.paged_decode_attention(
            q, kq, vq, table, lens, k_scale_pages=ks, v_scale_pages=vs),
            reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k4, v4, attn_mask=mask4, enable_gqa=True)),
        "shape": f"B={len(lengths)} bs={bs} nblk={nblk} H={H} Hkv={HKV} "
                 f"K={K} bf16 q, int8 pages + f32 scale pages, live="
                 f"{lengths}; library_ms is sdpa over the pre-gathered, "
                 "dequantised bf16 view (gather and dequant not counted)"}

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
    results["ssd_scan"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk=m["chunk"])),
        "plain_ms": time_ms(lambda: ref.ssd_scan(*args, chunk=m["chunk"]),
                            reps=5),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": f"B={m['B']} S={m['S']} nh={m['nh']} hd={m['hd']} "
                 f"ng={m['ng']} ds={m['ds']} chunk={m['chunk']} bf16 "
                 f"(model-like dt, A); max |err| / max|plain| {rel:.3e}, "
                 f"worst over the phase-2 cases f32 {worst['float32']:.3e} "
                 f"bf16 {worst['bfloat16']:.3e}; library_ms null: no "
                 "PyTorch call computes the SSD scan"}
    print(f"ssd_scan main shape: {results['ssd_scan']}", flush=True)

    # MLA prefill's shape of the flash kernel, and the MLA decode kernel
    # at its main shape (bf16); the yardstick is one sdpa call over
    # q = [q_lat | q_rope], k = [ckv | k_rope] (one kv head) and v = ckv
    # (the concatenation not timed)
    results["flash_attention"]["ms_mla_prefill_shape"] = flash_mla_checks(
        gen)
    from repro_torch.kernels import mla_decode as mla
    mla_checks(gen)
    m = MLA_MAIN
    args = mla_inputs(gen, m["B"], m["S"], dtype)
    valid = (torch.arange(m["S"], device=dev)[None, :]
             < torch.tensor(MLA_DEPTHS, device=dev)[:, None])
    err = check_close(mla.mla_decode_ctx(*args, valid, scale=MLA_SCALE),
                      ref.mla_decode_ctx(*args, valid, scale=MLA_SCALE), dn,
                      "mla main shape")
    bound, by = mla_bound(valid, m["H"], m["r"], m["dr"], dn, isz)
    ql, qr, ckv, kr = args
    q4 = torch.cat([ql, qr], dim=-1)[:, :, None]
    k4 = torch.cat([ckv, kr], dim=-1)[:, None]
    v4 = ckv[:, None]
    mask4 = valid[:, None, None, :]
    results["mla_decode_ctx"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: mla.mla_decode_ctx(*args, valid,
                                                 scale=MLA_SCALE)),
        "plain_ms": time_ms(lambda: ref.mla_decode_ctx(
            *args, valid, scale=MLA_SCALE), reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, scale=MLA_SCALE, enable_gqa=True)),
        "shape": f"B={m['B']} S={m['S']} H={m['H']} r={m['r']} "
                 f"dr={m['dr']} bf16 live={MLA_DEPTHS}; library_ms is sdpa "
                 "over q=[q_lat|q_rope], k=[ckv|k_rope] (one kv head), "
                 "v=ckv (concatenation not counted)"}
    print(f"mla_decode_ctx main shape: {results['mla_decode_ctx']}",
          flush=True)
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
    with Router(ThreadBackend(model, params, 2, config=config)) as router:
        # warm-up: first cuBLAS handles and allocations, not counted
        for h in [router.submit(Request(1000 + i, rng.integers(
                0, cfg.vocab_size, (n,), dtype=np.int32), 4))
                for i, n in enumerate((20, 300))]:
            h.result()
        torch.cuda.synchronize()
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                        dtype=np.int32), max_new)
                for i, n in enumerate(plens)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
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
    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"main path: qwen3-0.6b 28 layers bf16, Router(ThreadBackend(2)) "
          f"n_slots=4 max_len=2048, 8 requests prompts {plens} "
          f"max_new={max_new}: wall_s={wall:.4f} tok_per_s="
          f"{n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} launches="
          f"{launches} [card: {card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 5: dense vs paged greedy streams on the card
# ---------------------------------------------------------------------------
# same-bucket groups of at most n_slots, in queue order, one budget per
# group: the dense engine (head + same-bucket requests) and the paged one
# (run of consecutive heads with one key) then admit the same prefill
# batches, and max_seqs = n_slots gives both decodes the same rows
PARITY_GROUPS = [((150, 200, 256, 180), 24), ((40, 50, 64, 33), 32),
                 ((300, 400, 512), 16)]


def parity_phase(model, params, config, card: str, groups=PARITY_GROUPS):
    """Serve the same requests through one dense and one paged engine
    (``config`` with cache="paged"); their greedy streams must be
    identical. Returns each engine's kernel launches (dense, paged)."""
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


def ssm_path_phase(card: str, n_containers: int = 2, max_new: int = 32):
    """Router(ThreadBackend(2)) over full-width mamba2-2.7b (64 layers,
    bf16, random weights from seed 0), n_slots=4, max_len=2048: 8
    requests with 64-1024-token prompts, each a length the scan's chunk
    (min(256, S)) divides. Every request completes with ``max_new``
    tokens; the 200-token request's stream equals that request run alone
    on the model; ``ssd_scan`` launches a multiple of 64 (one per layer per
    prefill) and at least once per layer per distinct length; no
    attention kernel launches. Returns the launch counts of the run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("mamba2-2.7b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=2048, chunk_tokens=32,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (n,),
                                    dtype=np.int32), max_new)
            for i, n in enumerate(SSM_PLENS)]
    backend = ThreadBackend(model, params, n_containers, config=config)
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

    step_ms, step_launches, step_dev_ms = decode_step_profile(
        model, params, tok, cache, pos)

    n_tok = sum(len(c.tokens) for c in comps)
    ttfc_p50 = float(np.percentile([h.ttfc_s for h in handles], 50))
    print(f"ssm path: {cfg.name} {cfg.n_layers} layers bf16, Router("
          f"ThreadBackend({n_containers})) n_slots={config.n_slots} max_len="
          f"{config.max_len} chunk_tokens={config.chunk_tokens}, 8 requests "
          f"prompts {SSM_PLENS} max_new={max_new}: wall_s={wall:.4f} "
          f"tok_per_s={n_tok / wall:.2f} ttfc_p50_s={ttfc_p50:.4f} "
          f"state_cache_bytes={state_bytes} (one engine); request {rid}'s "
          f"stream equals the model run alone; one {config.n_slots}-slot "
          f"decode step: host_ms={step_ms:.3f} kernel_launches="
          f"{step_launches} device_ms={step_dev_ms:.3f}; launches="
          f"{launches} [card: {card}]",
          flush=True)
    return launches


def decode_step_profile(model, params, tok, cache, pos):
    """One decode step's host wall (mean of 10, each ending in a
    synchronize, after 3 unmeasured), its kernel launches (profiler count
    of launch calls) and its device ms (the profiler's self device time
    of every kernel of the step; 0 where the profiler sees no device)."""
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
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))
    device_ms = sum(getattr(e, "self_device_time_total", 0)
                    for e in events) / 1e3
    return step_ms, launches, device_ms


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
              if k not in ("mla_decode_ctx", "flash_attention") and n}
    if others:
        fail(f"deepseek path: other kernels launched: {others}")

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
    step_ms, step_launches, step_dev_ms = decode_step_profile(
        model, params, tok, cache, pos)
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
          f"decode step: host_ms={step_ms:.3f} kernel_launches="
          f"{step_launches} device_ms={step_dev_ms:.3f}; launches="
          f"{launches} [card: {card}]",
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


def full_width_model(dtype):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("qwen3-0.6b"))
    return model, model.init(seed=0, dtype=dtype)


def main() -> int:
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

    # the same weights over int8 caches
    torch.cuda.empty_cache()
    model8 = Model(dataclasses.replace(model.cfg, kv_cache_dtype="int8"))
    ops.reset_launch_counts()
    parity_phase(model8, params, EngineConfig(max_seqs=4, **base), card)
    parity8 = ops.launch_counts()
    for k in ("decode_attention", "paged_decode_attention"):
        if parity8[k] or not parity8[f"{k}_int8"]:
            fail(f"int8 dense vs paged: launches {parity8}")
    torch.cuda.empty_cache()
    int8_launches = int8_path_phase(
        model8, params, EngineConfig(max_seqs=8, prefix_cache=True, **base),
        card, bf16_tokens, bf16_pool)

    # the SSM family, once the qwen3 weights and caches are released
    del model, model8, params
    torch.cuda.empty_cache()
    ssm_launches = ssm_path_phase(card)

    # the MoE family with latent attention, once mamba2's weights are
    # released
    torch.cuda.empty_cache()
    mla_launches, mla_parity = deepseek_path_phase(card)

    # each kernel's launches come from the path it serves: phase 4 (dense
    # cache) for the prefill and dense decode kernels, phase 6 (paged
    # cache with prefix sharing) for the paged decode kernel, phase 7a
    # (dense and paged int8 engines) for the dense int8 kernel, 7b
    # (the int8 Router path) for the paged int8 kernel, 8 (mamba2) for
    # the SSD scan and 9 (deepseek) for the MLA decode kernel
    by_phase = {"phase4": launches, "phase6": paged_launches,
                "phase7a": parity8, "phase7b": int8_launches,
                "phase8": ssm_launches, "phase9": mla_launches,
                "phase9b_dense": mla_parity[0],
                "phase9b_paged": mla_parity[1]}
    main_phase = {"flash_attention": "phase4", "decode_attention": "phase4",
                  "paged_decode_attention": "phase6",
                  "decode_attention_int8": "phase7a",
                  "paged_decode_attention_int8": "phase7b",
                  "ssd_scan": "phase8", "mla_decode_ctx": "phase9"}
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
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1],
         "launches": by_phase[main_phase[k]][k],
         "launches_by_phase": {ph: c[k] for ph, c in by_phase.items()},
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

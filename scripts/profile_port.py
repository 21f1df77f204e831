#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one NVIDIA card.

    python3 scripts/profile_port.py [--src DIR] [--out FILE]
    python3 scripts/profile_port.py --prefill [--src DIR] [--out FILE]
    python3 scripts/profile_port.py --decode [--src DIR] [--out FILE]
    python3 scripts/profile_port.py --chunk [--src DIR] [--out FILE]

Serves the ``chip_smoke.py`` phase-4 request set (qwen3-0.6b at full
width, 28 layers, bf16, random weights from seed 0; n_slots=4,
max_len=2048; 8 requests with 16-512 token prompts, max_new=32) three
ways through the Router — two containers polled in threads (the main
path), two polled one after the other, and one container — and reports
wall time, generated tok/s and ttfc p50 for each. Then it times one
4-slot decode step (host wall with a synchronize, and the device time
of its kernels from ``torch.profiler``) and profiles one engine serving
four of the requests: device-busy share of the wall time, kernel
launches per decode step, and the operations with the most host time.

``--prefill`` profiles one 512-token prefill of qwen3-0.6b and of
mamba2-2.7b instead (full width, bf16, seed 0, one dense engine each):
the device time of all its kernels and of the prefill kernel
(``flash_attention``; ``ssd_scan``'s kernels for mamba2) with their
launches, by kernel name, and the median time from submission to the
first streamed chunk of five fresh 512-token prompts (max_new=32).

``--decode`` reads the decode kernels' device time: each of the four
decode kernels and ``mla_decode_ctx`` at ``chip_smoke.py`` phase 2's
main shapes (bf16; its ``decode_main_calls``), 100 calls replayed from a
CUDA graph, beside one ``scaled_dot_product_attention`` call's; the
dense and paged kernels' (bf16 and int8) and ``mla_decode_ctx``'s
(deepseek-v2-lite's widths) device time against the live depth (4 rows
all live to 1, 64, 256, 544, 1024 or 2048 of the 2048 positions), which
separates a call's fixed cost from its cost a position; the device time
of each CUDA kernel of each of the five at the main shape
(``torch.profiler``) and digests of their float32- and bfloat16-query
outputs on fixed inputs, so that two checkouts read in turns show
whether a kernel's bits moved; ``rmsnorm`` at its main shape (the block
norm of a 512-token qwen3 prefill) and at a 4-slot decode step's norms
(``chip_smoke.py``'s ``rmsnorm_decode_calls``: qwen3's q/k norms as two
launches and, where the checkout has it, as one pair launch) from a
graph beside ``torch.nn.functional.rms_norm``, digests of its float32
and bfloat16 outputs, the launch floor (``torch.cuda._sleep(0)`` from a
graph) and the wrapper's host µs a call, launched one by one; then one
4-slot qwen3 decode step (rows live to 48/160/300/544) over a bfloat16
and over an int8 KV cache: its host ms, kernel launches, device ms, and
the device ms and launches of the decode attention kernels by name; and
the same step of mamba2-2.7b and deepseek-v2-lite-16b (bf16): host ms,
launches, device ms and the rmsnorm kernels' device ms.

``--chunk`` reads the serving engine's decode chunk: for qwen3-0.6b,
mamba2-2.7b and deepseek-v2-lite-16b (full width, bf16, seed 0; one
dense engine, n_slots=4, max_len=2048, chunk_tokens=32; four requests of
64-512 prompt tokens, so four rows decode 32-step chunks), the wall of a
chunk per token step (host clock, each chunk ending in its one
device-to-host read), a chunk's device ms per step and the host calls
it makes (``torch.profiler``: kernel launches, graph launches, copies),
and where the engine captures a step graph its capture seconds, pool
bytes and replays; then the device time of the 4-slot decode step alone
(``chip_smoke.py``'s ``decode_step_profile``, eager and replayed). Read
against ``--src`` of a parent whose engine decodes eagerly, it compares
eager dispatch with graph replay on one card.

``--src`` imports the port from another checkout's ``src`` (for example
a parent commit unpacked beside this one), so two versions can be read
in turns on one card; each builds its kernels into its own checkout.
Needs a CUDA device; prints a JSON summary and writes it to ``--out``
(default ``build/profile_port.json``, or ``build/profile_prefill.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLENS = [16, 512, 37, 200, 96, 333, 64, 480]
MAX_NEW = 32
PROMPT = 512
TTFC_REPS = 5
DEPTHS = (1, 64, 256, 544, 1024, 2048)   # live positions of every row
PREFILL_KERNELS = {"qwen3-0.6b": ("flash_attention",),
                   "mamba2-2.7b": ("ssd_",)}


def _device_us(evt) -> float:
    """Device time of a device-side entry (a kernel, memcpy or memset);
    0 for a host operation, whose own device column repeats the time of
    the kernels it launched."""
    from torch.autograd import DeviceType
    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def serve(model, params, config, n, concurrent, reqs_fn):
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.router import Router
    with Router(ThreadBackend(model, params, n, config=config,
                              concurrent=concurrent)) as router:
        for h in [router.submit(r) for r in reqs_fn(1000)[:2]]:
            h.result()                                  # warm-up
        torch.cuda.synchronize()
        reqs = reqs_fn(0)
        t0 = time.perf_counter()
        handles = [router.submit(r) for r in reqs]
        comps = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    return {"containers": n, "concurrent": concurrent, "wall_s": wall,
            "tok_per_s": n_tok / wall,
            "ttfc_p50_s": float(np.percentile([h.ttfc_s for h in handles],
                                              50))}


def profile_prefill(name: str) -> dict:
    """One 512-token prefill of ``name`` under ``torch.profiler``, then
    the time to first chunk of fresh prompts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    from repro_torch.serving.events import ChunkEvent

    cfg = get_config(name)
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    eng = ServingEngine(model, params, EngineConfig(
        n_slots=4, max_len=2048, dtype=torch.bfloat16, chunk_tokens=32))
    rng = np.random.default_rng(7)

    def prompt():
        return rng.integers(0, cfg.vocab_size, (PROMPT,), dtype=np.int32)

    for rid in range(2):                                  # warm-up
        eng.submit_many([Request(rid, prompt(), 1)])
        eng.run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.submit_many([Request(10, prompt(), 1)])
        eng.run()
        torch.cuda.synchronize()
    evts = prof.key_averages()
    kernel = [e for e in evts if _device_us(e) > 0 and any(
        k in e.key for k in PREFILL_KERNELS[name])]
    first: dict = {}
    eng.on_event = lambda ev: (isinstance(ev, ChunkEvent)
                               and first.setdefault(ev.rid, ev.time_s))
    ttfc = []
    for rid in range(100, 100 + TTFC_REPS):
        torch.cuda.synchronize()
        t_sub = time.perf_counter()
        eng.submit_many([Request(rid, prompt(), 32)])
        eng.run()
        ttfc.append(first[rid] - t_sub)
    out = {"model": name, "prompt_tokens": PROMPT,
           "prefill_device_ms": sum(_device_us(e) for e in evts) / 1e3,
           "prefill_kernel_device_ms": sum(_device_us(e)
                                           for e in kernel) / 1e3,
           "prefill_kernel_launches": sum(e.count for e in kernel),
           "prefill_kernels": {e.key[:80]: [e.count, _device_us(e) / 1e3]
                               for e in kernel},
           "ttfc_s": ttfc, "ttfc_median_s": statistics.median(ttfc)}
    del eng, params, model
    torch.cuda.empty_cache()
    return out


def profile_decode() -> dict:
    """The decode kernels' graph-replayed device time at phase 2's main
    shapes, and one qwen3 decode step's kernels."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    cs.np, cs.torch = np, torch      # its main() binds these
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {}
    calls = cs.decode_main_calls(gen)
    for name, row in calls.items():
        kernels[name] = {"graph_ms": cs.time_graph_ms(row["kernel"]),
                         "library_graph_ms": cs.time_graph_ms(
                             row["library"]),
                         "bound_ms": row["bound"][0]}
        # its CUDA kernels at the main shape, device ms a launch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                row["kernel"]()
            torch.cuda.synchronize()
        kernels[name]["kernel_ms"] = {
            e.key[:100]: _device_us(e) / e.count / 1e3
            for e in prof.key_averages() if _device_us(e) > 0}
    for name, digests in output_digests().items():
        kernels[name]["digests"] = digests

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import paged_attention as pa
    depths = {}
    mla_args = cs.mla_inputs(gen, 4, 2048, torch.bfloat16)
    for depth in DEPTHS:
        lengths = [depth] * 4
        q, kp, vp, table, lens, _ = cs.paged_case(
            gen, lengths, h=cs.H, hkv=cs.HKV, k=cs.K, bs=16, nblk=128,
            dtype=torch.bfloat16)
        kd, vd, valid = cs.gathered(kp, vp, table, lens)
        kq, ks = cs.quant(kp.float())
        vq, vs = cs.quant(vp.float())
        kqd, vqd, _ = cs.gathered(kq, vq, table, lens)
        ksd, vsd, _ = cs.gathered(ks, vs, table, lens)
        depths[depth] = {
            "decode_attention": cs.time_graph_ms(
                lambda: da.decode_attention(q, kd, vd, valid)),
            "paged_decode_attention": cs.time_graph_ms(
                lambda: pa.paged_decode_attention(q, kp, vp, table, lens)),
            "decode_attention_int8": cs.time_graph_ms(
                lambda: da.decode_attention_int8(q, kqd, vqd, valid, ksd,
                                                 vsd)),
            "paged_decode_attention_int8": cs.time_graph_ms(
                lambda: pa.paged_decode_attention_int8(q, kq, vq, ks, vs,
                                                       table, lens)),
            "mla_decode_ctx": cs.time_graph_ms(
                lambda: mla.mla_decode_ctx(*mla_args, valid,
                                           scale=cs.MLA_SCALE))}
        del q, kp, vp, kd, vd, kq, vq, kqd, vqd

    norms = profile_norms(gen)

    base = get_config("qwen3-0.6b")
    steps = {}
    for kv in ("model", "int8"):
        model = Model(dataclasses.replace(base, kv_cache_dtype=kv))
        if kv == "model":
            params = model.init(seed=0, dtype=torch.bfloat16)
        cache = model.init_cache(4, 2048, torch.bfloat16)
        tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
        pos = torch.tensor([48, 160, 300, 544], dtype=torch.int32,
                           device="cuda")
        step_ms, launches, device_ms = cs.decode_step_profile(
            model, params, tok, cache, pos)[:3]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, tok, cache, pos)
            torch.cuda.synchronize()
        attention = {e.key[:100]: [e.count, _device_us(e) / 1e3]
                     for e in prof.key_averages()
                     if _device_us(e) > 0 and any(
                         n in e.key for n in cs.DECODE_KERNEL_NAMES)}
        steps["decode_step" if kv == "model" else "decode_step_int8"] = {
            "host_ms": step_ms, "kernel_launches": launches,
            "device_ms": device_ms,
            "attention_device_ms": sum(ms for _, ms in attention.values()),
            "attention_kernels": attention}
        del cache, model
    del params
    torch.cuda.empty_cache()
    for name in ("mamba2-2.7b", "deepseek-v2-lite-16b"):
        model = Model(get_config(name))
        params = model.init(seed=0, dtype=torch.bfloat16)
        cache = model.init_cache(4, 2048, torch.bfloat16)
        tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
        pos = torch.tensor([48, 160, 300, 544], dtype=torch.int32,
                           device="cuda")
        step_ms, launches, device_ms = cs.decode_step_profile(
            model, params, tok, cache, pos)[:3]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, tok, cache, pos)
            torch.cuda.synchronize()
        norm = [e for e in prof.key_averages()
                if _device_us(e) > 0 and "rmsnorm" in e.key]
        steps[f"decode_step {name}"] = {
            "host_ms": step_ms, "kernel_launches": launches,
            "device_ms": device_ms,
            "rmsnorm_launches": sum(e.count for e in norm),
            "rmsnorm_device_ms": sum(_device_us(e) for e in norm) / 1e3}
        del cache, params, model
        torch.cuda.empty_cache()
    return {"kernels": kernels, "depth_graph_ms": depths, "rmsnorm": norms,
            **steps}


CHUNK_MODELS = ("qwen3-0.6b", "mamba2-2.7b", "deepseek-v2-lite-16b")
CHUNK_PLENS = (64, 128, 256, 512)   # lengths mamba2's scan chunk divides
TIMED_CHUNKS = 3


def profile_chunks(name: str) -> dict:
    """One dense engine of ``name`` decoding four rows in 32-step chunks:
    the wall of a chunk per token step (``TIMED_CHUNKS`` chunks, after the
    admission's chunk), then one chunk under the profiler (device ms per
    step, host calls by kind), and the engine's step graph where it has
    one; then the 4-slot decode step alone, eager and replayed."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    cs.np, cs.torch = np, torch      # its main() binds these
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)

    model = Model(get_config(name))
    params = model.init(seed=0, dtype=torch.bfloat16)
    chunk = 32
    eng = ServingEngine(model, params, EngineConfig(
        n_slots=4, max_len=2048, dtype=torch.bfloat16, chunk_tokens=chunk))
    rng = np.random.default_rng(11)
    eng.submit_many([Request(i, rng.integers(
        0, model.cfg.vocab_size, (n,), dtype=np.int32),
        1 + chunk * (TIMED_CHUNKS + 2)) for i, n in enumerate(CHUNK_PLENS)])
    eng.step()                        # admission + the first chunk
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED_CHUNKS):
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) / chunk * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    evts = prof.key_averages()

    def calls(*keys):
        return sum(e.count for e in evts if e.key in keys)
    out = {"model": name, "rows": len(CHUNK_PLENS), "chunk_steps": chunk,
           "step_wall_ms": walls,
           "step_device_ms": sum(_device_us(e) for e in evts) / 1e3 / chunk,
           "chunk_kernel_launches": calls(*cs.KERNEL_LAUNCH_CALLS),
           "chunk_graph_launches": calls("cudaGraphLaunch",
                                         "cuGraphLaunch"),
           "chunk_memcpy_calls": calls("cudaMemcpyAsync", "cudaMemcpy"),
           "graph_capture_s": getattr(eng, "graph_capture_s", None),
           "graph_pool_bytes": getattr(eng, "graph_pool_bytes", None),
           "graph_replays": getattr(eng, "graph_replays", None),
           "chunks": eng.chunks}
    eng.run()
    del eng
    cache = model.init_cache(4, 2048, torch.bfloat16)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor([48, 160, 300, 544], dtype=torch.int32,
                       device="cuda")
    step = cs.decode_step_profile(model, params, tok, cache, pos)
    out["decode_step"] = dict(zip(
        ("host_ms", "kernel_launches", "device_ms", "attention_device_ms",
         "replayed_wall_ms", "replayed_profiler_launches",
         "replay_enqueue_us", "graph_nodes"), step))
    del cache, params, model
    torch.cuda.empty_cache()
    return out


HOST_REPS = 2000


def host_us(fn) -> float:
    """Host µs a call launched one by one: ``HOST_REPS`` calls on the host
    clock, after a warm-up, ending in a synchronize (the host, not the
    card, paces calls this short)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_REPS * 1e6


def profile_norms(gen) -> dict:
    """``rmsnorm``'s device time (graph) at the main shape and at a decode
    step's norms beside ``F.rms_norm``'s, its bound, the launch floor, the
    wrapper's host µs a call, and digests of its outputs."""
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as rn
    rows, D = cs.RMS_MAIN["rows"], cs.RMS_MAIN["D"]
    x = torch.randn(1, rows, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    s = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(
        torch.bfloat16)
    out = {"main (1, 512, 1024)": {
        "graph_ms": cs.time_graph_ms(lambda: rn.rmsnorm(x, s, cs.RMS_EPS)),
        "library_graph_ms": cs.time_graph_ms(
            lambda: F.rms_norm(x, (D,), weight=s, eps=cs.RMS_EPS)),
        "bound_ms": cs.rmsnorm_bound([(rows, D)], "bfloat16", 2, 2)[0]}}
    for name, c in cs.rmsnorm_decode_calls(gen).items():
        out[name] = {"graph_ms": cs.time_graph_ms(c["kernel"]),
                     "library_graph_ms": cs.time_graph_ms(c["library"]),
                     "bound_ms": c["bound"][0],
                     "host_us": host_us(c["kernel"])}
    out["launch_floor_graph_ms"] = cs.launch_floor_ms()
    out["digests"] = norm_digests()
    return out


def norm_digests() -> dict:
    """Digests of ``rmsnorm``'s output on fixed inputs at every width of
    the port's norms (and the latent slice), float32 and bfloat16, so that
    two checkouts read in turns show whether its bits moved."""
    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as rn
    out: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(4)
        ys = []
        for D in cs.RMS_WIDTHS:
            x = torch.randn(37, D, generator=g, device="cuda").to(dtype)
            s = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(
                dtype)
            ys.append(rn.rmsnorm(x, s, cs.RMS_EPS))
        dkv = torch.randn(4, 9, 576, generator=g, device="cuda").to(dtype)
        s = (1 + 0.1 * torch.randn(512, generator=g, device="cuda")).to(
            dtype)
        ys.append(rn.rmsnorm(dkv[..., :512], s, cs.RMS_EPS))
        out[str(dtype)] = _digest(torch.cat([y.flatten() for y in ys]))
    return out


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def output_digests() -> dict:
    """Digests of each decode kernel's output on fixed inputs (rows with
    holes, ragged page tables), float32 and bfloat16 queries: {kernel:
    {dtype: digest}}. The inputs come from seeded generators only, so two
    checkouts read in turns get the same inputs."""
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mla_decode as mla
    from repro_torch.kernels import paged_attention as pa
    out: dict = {}

    def put(name, dtype, t):
        out.setdefault(name, {})[str(dtype)] = _digest(t)

    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(1)
        args = cs.mla_inputs(g, 4, 2048, dtype)
        valid = torch.rand(4, 2048, generator=g, device="cuda") < 0.3
        put("mla_decode_ctx", dtype,
            mla.mla_decode_ctx(*args, valid, scale=cs.MLA_SCALE))

        g = torch.Generator(device="cuda").manual_seed(2)
        q = torch.randn(4, cs.H, cs.K, generator=g, device="cuda")
        k, v = (torch.randn(4, 2048, cs.HKV, cs.K, generator=g,
                            device="cuda") for _ in range(2))
        valid = torch.rand(4, 2048, generator=g, device="cuda") < 0.3
        put("decode_attention", dtype, da.decode_attention(
            q.to(dtype), k.to(dtype), v.to(dtype), valid))
        (kq, ks), (vq, vs) = cs.quant(k), cs.quant(v)
        put("decode_attention_int8", dtype, da.decode_attention_int8(
            q.to(dtype), kq, vq, valid, ks, vs))

        g = torch.Generator(device="cuda").manual_seed(3)
        q, kp, vp, table, lens, _ = cs.paged_case(
            g, [700, 33, 0, 2048, 17, 1, 1024, 255], h=cs.H, hkv=cs.HKV,
            k=cs.K, bs=16, nblk=128, dtype=torch.float32, share=2)
        put("paged_decode_attention", dtype, pa.paged_decode_attention(
            q.to(dtype), kp.to(dtype), vp.to(dtype), table, lens))
        (kq, ks), (vq, vs) = cs.quant(kp), cs.quant(vp)
        put("paged_decode_attention_int8", dtype,
            pa.paged_decode_attention_int8(q.to(dtype), kq, vq, ks, vs,
                                           table, lens))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--chunk", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.build import extension
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    extension()
    if args.prefill:
        return _report({"src": args.src, "card": card,
                        "models": [profile_prefill(n)
                                   for n in PREFILL_KERNELS]},
                       args.out or ROOT / "build" / "profile_prefill.json")
    if args.decode:
        return _report({"src": args.src, "card": card, **profile_decode()},
                       args.out or ROOT / "build" / "profile_decode.json")
    if args.chunk:
        return _report({"src": args.src, "card": card,
                        "models": [profile_chunks(n) for n in CHUNK_MODELS]},
                       args.out or ROOT / "build" / "profile_chunk.json")
    cfg = get_config("qwen3-0.6b")
    model = Model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                          chunk_tokens=32)

    def reqs_fn(base):
        rng = np.random.default_rng(1 + base)
        return [Request(base + i, rng.integers(0, cfg.vocab_size, (n,),
                                               dtype=np.int32), MAX_NEW)
                for i, n in enumerate(PLENS)]

    out = {"src": args.src, "card": card, "runs": [serve(model, params, config, n, c, reqs_fn)
                                  for n, c in ((2, True), (2, False),
                                               (1, False))]}

    # one 4-slot decode step at main-path depths
    B, W = 4, 2048
    cache = model.init_cache(B, W, torch.bfloat16)
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor([48, 160, 300, 544], dtype=torch.int32,
                       device="cuda")
    for _ in range(3):
        model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, tok, cache, pos)
        torch.cuda.synchronize()
    evts = prof.key_averages()
    launches = sum(e.count for e in evts if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))
    step_device_us = sum(_device_us(e) for e in evts)
    out["decode_step"] = {"wall_ms": step_wall * 1e3,
                          "device_ms": step_device_us / 1e3,
                          "kernel_launches": launches}

    # one engine serving four requests, profiled
    eng = ServingEngine(model, params, config)
    eng.submit_many(reqs_fn(2000)[:4])
    eng.run()                                           # warm-up
    eng.submit_many(reqs_fn(3000)[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evts = prof.key_averages()
    device_us = sum(_device_us(e) for e in evts)
    top_host = sorted(evts, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:12]
    top_dev = sorted(evts, key=_device_us, reverse=True)[:10]
    out["engine_run"] = {
        "wall_s": wall, "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "top_host_ops": [{"op": e.key, "calls": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3}
                         for e in top_host],
        "top_kernels": [{"kernel": e.key[:120], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3}
                        for e in top_dev]}
    return _report(out, args.out or ROOT / "build" / "profile_port.json")


def _report(out: dict, path) -> int:
    text = json.dumps(out, indent=1)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

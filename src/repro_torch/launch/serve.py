"""Serving launcher of the port: the request-level streaming Router over
containers on one card, with the online divide-and-save scheduler (the
counterpart of ``repro.launch.serve``, the same flags and modes).

The serving surface is the ``Router`` (serving/router.py): requests are
admitted one at a time (least-loaded + bucket-aware dispatch across the
containers), completions stream back as typed per-chunk events, and —
when the container count is left to the scheduler (``--containers 0``) —
the ``DivideAndSaveScheduler`` observes windows of (time, energy,
tokens/s, time-to-first-chunk) stats and resizes the container count
between windows. ``--no-stream`` serves the same traffic through the
wave shim (``Router.serve_wave`` / ``ContainerServingPool`` /
``ProcessContainerPool`` / ``AdaptiveServingPool``) instead. ``--trace``
replays a workload trace open-loop (``workload.replay``), under SLO
classes with ``--priority-classes`` or ``--slo-ttfc-p95``.

Container isolation: the default is a ``ThreadBackend`` (engines as
threads of this process, each on its own CUDA stream of the card);
``--isolation process`` runs one pinned OS process per container (the
paper's ``docker run --cpus=C/n``), the weights mapped over CUDA IPC.
There is no ``--submesh``: one card is not carved into device meshes,
so ``card_feasible_counts`` budgets the containers on it instead. There
is no ``--prefix-cached-blocks``: the port's prefix cache keeps its pages
inside each container's block pool, which that budget already counts.

Configs are full width unless ``--reduced`` (which JAX's launcher always
uses); weights are random, ``Model.init(seed=0, dtype=bfloat16)``. The
launcher runs on the card unless given ``--device cpu``.

    python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --containers 4 --requests 16
    python -m repro_torch.launch.serve --waves 8 --objective time
    python -m repro_torch.launch.serve --trace bursty --time-scale 10 \\
        --priority-classes interactive:0.5,batch:8.0 --tenant-quota 8 \\
        --containers 2 --cache paged --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --containers 2 --requests 4 --max-new 4
"""
from __future__ import annotations

import argparse
import json
import os


def _engine_config(args):
    """The per-container engine configuration the flags describe, one
    frozen EngineConfig for every backend flavour."""
    import torch

    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(n_slots=args.slots, cache=args.cache,
                        block_size=args.block_size,
                        max_blocks=args.max_blocks,
                        prefix_cache=args.prefix_cache,
                        dtype=torch.bfloat16)


def _make_backend(args, cfg, model, params, n, units):
    """One container backend per isolation flavour; the Router takes
    either."""
    from repro_torch.serving.backend import ProcessBackend, ThreadBackend
    engine_cfg = _engine_config(args)
    if args.isolation == "process":
        return ProcessBackend(cfg, n, engine_cfg, params=params,
                              total_cores=units, device=args.device,
                              max_respawns=args.max_respawns)
    return ThreadBackend(model, params, n, engine_cfg,
                         concurrent=not args.sequential,
                         max_respawns=args.max_respawns,
                         device=args.device)


def _device_bytes(device: str) -> int:
    """The memory the containers are budgeted in: the card's, or the
    host's on the CPU."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _feasible(args, cfg, units) -> list[int]:
    """The container counts the scheduler may search: the power-of-two
    counts up to ``units`` whose engines fit beside one weight copy."""
    from repro_torch.core.containers import card_feasible_counts
    return card_feasible_counts(cfg, _engine_config(args),
                                card_bytes=_device_bytes(args.device),
                                max_containers=units) or [1]


def _router_fault_kw(args) -> dict:
    """The Router's fault-tolerance knobs from the serving flags."""
    return dict(max_retries=args.max_retries,
                request_deadline_s=args.deadline_s,
                max_queue=args.max_queue,
                shed_p95_s=args.shed_p95_s,
                device=args.device)


def _stream_requests(router, requests, verbose_chunks: bool):
    """Continuous admission: submit everything, then consume the streams,
    printing chunk arrivals as they land."""
    from repro_torch.serving.events import ChunkEvent
    handles = [router.submit(r) for r in requests]
    for h in handles:
        parts = []
        for ev in h.stream():
            if isinstance(ev, ChunkEvent):
                parts.append(list(ev.tokens))
        if verbose_chunks:
            chunks = " | ".join(" ".join(map(str, p)) for p in parts)
            ttfc = (f"{h.ttfc_s * 1e3:6.1f}ms" if h.ttfc_s is not None
                    else "   n/a")        # zero-budget: DoneEvent only
            print(f"  rid {h.rid} [container {h.container_id}] "
                  f"ttfc {ttfc}  chunks: {chunks}")
    return handles


def _parser(arch_names) -> argparse.ArgumentParser:
    from repro_torch.workload.traces import PRESETS
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=arch_names)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's -reduced config (a few narrow "
                         "layers) instead of its full width")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run (default the card; no "
                         "fallback to the CPU)")
    ap.add_argument("--containers", type=int, default=0,
                    help="0 = let the scheduler choose online")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--cache", default="dense", choices=("dense", "paged"),
                    help="KV cache layout: dense n_slots rows (baseline) "
                         "or the paged block cache (in-flight bounded by "
                         "the block budget, not --slots)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged cache)")
    ap.add_argument("--max-blocks", type=int, default=None,
                    help="physical KV blocks per container (paged; "
                         "default: the dense footprint "
                         "slots*max_len/block_size)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="copy-on-write prefix sharing in the paged "
                         "cache (requires --cache paged)")
    ap.add_argument("--waves", type=int, default=6,
                    help="traffic waves (adaptive: scheduler windows)")
    ap.add_argument("--objective", default="energy",
                    choices=("energy", "time"))
    ap.add_argument("--stream", action="store_true", default=True,
                    help="request-level streaming via the Router "
                         "(default)")
    ap.add_argument("--no-stream", dest="stream", action="store_false",
                    help="serve through the wave shim instead")
    ap.add_argument("--print-chunks", action="store_true",
                    help="print every request's chunk arrivals")
    ap.add_argument("--sequential", action="store_true",
                    help="disable container concurrency (baseline)")
    ap.add_argument("--units", type=int, default=8,
                    help="the most containers the scheduler may try "
                         "(process isolation: also at most the cores)")
    ap.add_argument("--isolation", default="thread",
                    choices=("thread", "process"),
                    help="thread: engines overlap in this process "
                         "(baseline); process: one pinned OS process per "
                         "container, the paper's --cpus shares")
    ap.add_argument("--total-cores", type=int, default=None,
                    help="CPU cores to carve among process containers "
                         "(default: all cores this process may use)")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="re-dispatches per request after a container "
                         "failure before it fails typed")
    ap.add_argument("--max-respawns", type=int, default=2,
                    help="automatic container respawns before the "
                         "circuit breaker leaves it dead")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (seconds, end-to-end "
                         "across retries; default none)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission bound: shed new requests once this "
                         "many are in flight (default unbounded)")
    ap.add_argument("--shed-p95-s", type=float, default=None,
                    help="shed new requests while the recent "
                         "time-to-first-chunk p95 exceeds this "
                         "(seconds; default never)")
    ap.add_argument("--trace", default=None,
                    help="replay a workload trace open-loop instead of "
                         "synthetic waves: a preset name "
                         f"({', '.join(sorted(PRESETS))}) or a trace "
                         "JSONL path")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="synthesis seed for a preset --trace")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress trace time (10 = a 600s trace "
                         "replays in 60s; arrival pattern preserved, "
                         "absolute rates scaled)")
    ap.add_argument("--slo-ttfc-p95", type=float, default=None,
                    help="single-class SLO: time-to-first-chunk p95 "
                         "target in seconds; switches the scheduler to "
                         "the energy_under_slo objective")
    ap.add_argument("--priority-classes", default=None,
                    help="multi-class SLO spec 'interactive:0.5,"
                         "batch:4.0[:queue_frac]' — rank follows the "
                         "listed order; implies energy_under_slo")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max in-flight requests per tenant (SLO mode)")
    return ap


def main(argv: list[str] | None = None) -> None:
    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_NAMES, get_config
    from repro_torch.core.testbed import available_cores
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request
    from repro_torch.workload.slo import SLOClass, SLOSpec

    args = _parser(ARCH_NAMES).parse_args(argv)
    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    model = Model(cfg, device=args.device)
    params = model.init(seed=0, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)

    units = args.units
    if args.isolation == "process":
        # the process containers carve real cpusets: the count budget is
        # the core budget
        avail = len(available_cores())
        units = min(units, args.total_cores or avail, avail)
        print(f"process isolation over {units} cores")

    # SLO vocabulary from the flags: a multi-class spec wins; a bare p95
    # target becomes a single-class spec. Either switches the scheduler
    # to energy_under_slo (the Router reads the constraint off the spec)
    slo = None
    if args.priority_classes:
        slo = SLOSpec.parse(args.priority_classes)
    elif args.slo_ttfc_p95 is not None:
        slo = SLOSpec((SLOClass(ttfc_p95_s=args.slo_ttfc_p95),))

    def batch_of_requests(base):
        return [Request(rid=base + i,
                        prompt=rng.integers(0, cfg.vocab_size, (8,),
                                            dtype=np.int32),
                        max_new_tokens=args.max_new)
                for i in range(args.requests)]

    if args.trace is not None:
        _serve_trace(args, cfg, model, params, units, slo)
    elif args.containers:
        _serve_fixed(args, cfg, model, params, units, batch_of_requests)
    else:
        _serve_online(args, cfg, model, params, units, batch_of_requests)
    # the kernels this process launched (process containers count their
    # own); all zero on the CPU, where the plain versions run
    print(f"kernel launches: {json.dumps(ops.launch_counts())}")


def _serve_fixed(args, cfg, model, params, units, batch_of_requests):
    """A fixed container count: streamed through the Router, then one
    wave through its shim; or, with ``--no-stream``, a wave through the
    pool facade of the isolation flavour."""
    from repro_torch.serving.pool import ContainerServingPool
    from repro_torch.serving.process_pool import ProcessContainerPool
    from repro_torch.serving.router import Router

    n = args.containers
    backend = _make_backend(args, cfg, model, params, n, units)
    if args.stream:
        with Router(backend, **_router_fault_kw(args)) as router:
            handles = _stream_requests(router, batch_of_requests(0),
                                       args.print_chunks)
            # a second pass through the wave shim for the aggregate
            # accounting line (warm engines, captured graphs)
            done, per, wall, energy = router.serve_wave(
                batch_of_requests(len(handles)))
            ttfc = sorted(h.ttfc_s for h in handles
                          if h.ttfc_s is not None)
            if ttfc:
                print(f"streamed {len(handles)} requests: ttfc p50 "
                      f"{ttfc[len(ttfc) // 2] * 1e3:.1f}ms  max "
                      f"{ttfc[-1] * 1e3:.1f}ms")
            _print_wave(args, n, done, per, wall, energy, router.backend)
        return
    if args.isolation == "process":
        pool = ProcessContainerPool(cfg, n, backend=backend,
                                    device=args.device)
    else:
        pool = ContainerServingPool(model, params, n, backend=backend,
                                    device=args.device)
    try:
        done, per, wall, energy = pool.serve_timed(batch_of_requests(0))
        _print_wave(args, n, done, per, wall, energy, pool.backend)
    finally:
        pool.close()


def _serve_online(args, cfg, model, params, units, batch_of_requests):
    """The scheduler picks the count: windows of the streamed Router, or
    waves of the adaptive pool with ``--no-stream``."""
    from repro_torch.serving.adaptive import AdaptiveServingPool
    from repro_torch.serving.router import Router

    feasible = _feasible(args, cfg, units)
    if args.stream:
        # windowed adaptation: requests stream in, the scheduler observes
        # each window and resizes between windows
        router = Router(
            backend_factory=lambda n: _make_backend(args, cfg, model,
                                                    params, n, units),
            feasible_counts=feasible, objective=args.objective,
            epsilon=0.2, window=args.requests, **_router_fault_kw(args))
        with router:
            for wave in range(args.waves):
                _stream_requests(router, batch_of_requests(
                    wave * args.requests), args.print_chunks)
            _print_windows(router.history)
            print(f"feasible counts: {feasible}")
            print(f"converged choice: n={router.choice}")
            print("scheduler summary:", router.scheduler.summary())
        return
    apool = AdaptiveServingPool(model, params, feasible,
                                objective=args.objective, epsilon=0.2,
                                config=_engine_config(args),
                                concurrent=not args.sequential,
                                isolation=args.isolation,
                                device=args.device)
    try:
        for wave in range(args.waves):
            apool.serve_wave(batch_of_requests(wave * args.requests))
            w = apool.history[-1]
            print(f"wave {w.wave}: n={w.n_containers} wall "
                  f"{w.wall_s:.2f}s {w.tokens_per_s:.1f} tok/s energy "
                  f"{w.energy_j:.1f}J p50 {w.latency_p50_s:.3f}s p95 "
                  f"{w.latency_p95_s:.3f}s")
        print(f"feasible counts: {feasible}")
        print(f"converged choice: n={apool.choice}")
        print("scheduler summary:", apool.scheduler.summary())
    finally:
        apool.close()


def _class_line(name, cw) -> str:
    tgt = (f" target {cw.target_ttfc_p95_s:.3f}s "
           f"{'MET' if cw.attained else 'VIOLATED'}"
           if cw.attained is not None else "")
    return (f"[{name}] done {cw.n_done} shed {cw.n_shed} "
            f"failed {cw.n_failed} ttfc p95 {cw.ttfc_p95_s:.3f}s{tgt}")


def _print_windows(history) -> None:
    for w in history:
        print(f"window {w.window}: n={w.n_containers} "
              f"wall {w.wall_s:.2f}s {w.tokens_per_s:.1f} tok/s "
              f"energy {w.energy_j:.1f}J "
              f"ttfc p50 {w.ttfc_p50_s:.3f}s p95 {w.ttfc_p95_s:.3f}s "
              f"lat p50 {w.latency_p50_s:.3f}s"
              + (f" retries {w.n_retries} failed {w.n_failed} "
                 f"shed {w.n_shed}"
                 if w.n_retries or w.n_failed or w.n_shed else ""))
        for name, cw in sorted(w.per_class.items()):
            print(f"    {_class_line(name, cw)}")


def _serve_trace(args, cfg, model, params, units, slo) -> None:
    """Open-loop trace replay through the live Router, the launcher face
    of ``workload.replay``: online (scheduler-resized) with
    ``--containers 0``, a fixed count otherwise."""
    from repro_torch.serving.router import Router
    from repro_torch.workload.replay import replay
    from repro_torch.workload.traces import load_or_synthesize

    trace = load_or_synthesize(args.trace, seed=args.trace_seed)
    objective = "energy_under_slo" if slo is not None else args.objective
    router_kw = dict(**_router_fault_kw(args), slo=slo,
                     tenant_quota=args.tenant_quota,
                     window=args.requests, window_s=5.0)
    if args.containers:
        backend = _make_backend(args, cfg, model, params,
                                args.containers, units)
        router = Router(backend, **router_kw)
    else:
        router = Router(
            backend_factory=lambda n: _make_backend(args, cfg, model,
                                                    params, n, units),
            feasible_counts=_feasible(args, cfg, units),
            objective=objective, epsilon=0.1, **router_kw)
    with router:
        report = replay(trace, router, time_scale=args.time_scale,
                        vocab_size=cfg.vocab_size)
        _print_windows(router.history)
    print(f"trace {report.trace} (seed {report.seed}, "
          f"time_scale {report.time_scale:g}): "
          f"{report.n_done}/{report.n_requests} done, "
          f"{report.n_shed} shed, {report.n_failed} failed in "
          f"{report.duration_s:.1f}s")
    print(f"goodput {report.goodput_rps:.2f} rps  "
          f"ttfc p95 {report.ttfc_p95_s:.3f}s  "
          f"energy/done {report.energy_per_done_j:.2f}J  "
          f"counts {list(report.counts_visited)} -> n={report.final_n}")
    for name, cw in sorted(report.per_class.items()):
        print(f"  {_class_line(name, cw)}")


def _print_wave(args, n, done, per, wall, energy, backend) -> None:
    toks = sum(len(c.tokens) for c in done)
    mode = (args.isolation if args.isolation == "process" else
            ("sequential" if args.sequential else "concurrent"))
    if args.stream:
        mode += "+stream"
    print(f"n={n} ({mode}): {len(done)} requests, "
          f"{toks} tokens in {wall:.2f}s ({toks/wall:.1f} tok/s, "
          f"~{energy:.1f}J)")
    for r in per:
        cores = ""
        if args.isolation == "process" and backend is not None:
            cores = f" cores {sorted(backend.core_sets[r.container_id])}"
        print(f"  container {r.container_id}: {r.n_requests} reqs "
              f"wall {r.wall_s:.2f}s busy {r.busy_s:.2f}s "
              f"{r.tokens_per_s:.1f} tok/s ~{r.energy_j:.1f}J "
              f"p50 {r.latency_p50_s:.3f}s p95 {r.latency_p95_s:.3f}s"
              f"{cores}")


if __name__ == "__main__":
    main()

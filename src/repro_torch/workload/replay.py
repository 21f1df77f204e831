"""Open-loop trace replay — drive a live ``Router`` at trace timestamps
(the port's counterpart of ``repro.workload.replay``, over the port's
Router and ``Request``).

Closed-loop load generators (submit, wait, submit) hide overload: the
generator slows down with the system and the tail never materialises.
Replay here is **open-loop**: every ``TraceRequest`` is submitted at its
trace arrival time (scaled by ``time_scale``) whether or not earlier
requests finished, so queueing, shedding and tail latency appear exactly
as they would under the real arrival process. The replayer never blocks
on a handle — it pumps the router while waiting for the next arrival and
drains once the trace is exhausted.

The outcome is a ``ReplayReport``: goodput (completions whose ttfc met
their class target, per second), per-class tails + SLO attainment
(``workload.slo.ClassWindow``), shed/failed accounting and the energy
ledger summed over the router's observation windows. The report is a
frozen picklable dataclass with a ``to_dict`` for a benchmark's JSON.

Wall-clock replay is inherently non-reproducible bit-for-bit; the
deterministic virtual-time twin lives in ``workload/sim.py`` and returns
the SAME report type, so benchmarks can smoke-test live and commit
simulated numbers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.serving.events import RejectedEvent
from repro_torch.workload.slo import ClassWindow, SLOSpec, class_window
from repro_torch.workload.traces import Trace, TraceRequest, prompt_tokens

_POLL_SLEEP_S = 0.001


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    """Everything a replay (live or simulated) says about one trace run.
    ``goodput_rps`` counts only completions whose ttfc met their class
    target (all completions when no SLO is in force) — completing a
    request after blowing its target is not good throughput.
    ``energy_per_done_j`` is the ledger the paper's objective actually
    cares about: shed and failed requests still burned energy."""
    trace: str = ""
    seed: int = 0
    n_requests: int = 0
    n_done: int = 0
    n_shed: int = 0
    n_failed: int = 0
    duration_s: float = 0.0
    goodput_rps: float = 0.0
    energy_j: float = 0.0
    energy_per_done_j: float = 0.0
    ttfc_p50_s: float = 0.0
    ttfc_p95_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    slo_attained: bool | None = None   # every class met its target
    time_scale: float = 1.0
    counts_visited: tuple = ()         # container counts the run used
    final_n: int = 0
    per_class: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_class"] = {name: dataclasses.asdict(cw)
                          for name, cw in self.per_class.items()}
        return d


def build_request(tr: TraceRequest, *, vocab_size: int = 256,
                  deadline_s: float | None = None) -> Request:
    """Materialise one serving ``Request`` from a trace record (prompt
    ids regenerated from ``prompt_seed`` — traces store no token
    arrays)."""
    return Request(
        rid=tr.rid,
        prompt=np.asarray(prompt_tokens(tr, vocab_size), dtype=np.int32),
        max_new_tokens=tr.max_new_tokens,
        deadline_s=deadline_s,
        priority=tr.priority,
        tenant=tr.tenant,
    )


def assemble_report(trace: Trace, *, slo: SLOSpec | None,
                    done: list, shed: list, failed: list,
                    duration_s: float, energy_j: float,
                    time_scale: float = 1.0,
                    counts_visited: tuple = (),
                    final_n: int = 0) -> ReplayReport:
    """Shared report assembly for the live replayer AND the simulator.
    ``done`` holds (priority, ttfc_s, latency_s) triples; ``shed`` and
    ``failed`` hold priority names."""
    by_cls: dict[str, dict] = {}

    def acc(name: str) -> dict:
        return by_cls.setdefault(
            name, {"ttfc": [], "lat": [], "shed": 0, "failed": 0})

    for pri, ttfc, lat in done:
        a = acc(pri)
        if ttfc is not None:
            a["ttfc"].append(ttfc)
        a["lat"].append(lat)
    for pri in shed:
        acc(pri)["shed"] += 1
    for pri in failed:
        acc(pri)["failed"] += 1

    per_class: dict[str, ClassWindow] = {}
    for name, a in sorted(by_cls.items()):
        cls = slo.cls(name) if slo is not None else None
        per_class[name] = class_window(cls, name, a["ttfc"], a["lat"],
                                       a["shed"], a["failed"])

    good = 0
    for pri, ttfc, _ in done:
        target = slo.cls(pri).ttfc_p95_s if slo is not None else None
        if target is None or (ttfc is not None and ttfc <= target):
            good += 1
    ttfc_all = sorted(t for _, t, _ in done if t is not None)
    lat_all = sorted(l for _, _, l in done)
    p = (lambda v, q: float(np.percentile(v, q)) if v else 0.0)
    attained = None
    judged = [cw.attained for cw in per_class.values()
              if cw.attained is not None]
    if judged:
        attained = all(judged)
    n_done = len(done)
    return ReplayReport(
        trace=trace.name, seed=trace.seed,
        n_requests=len(trace.requests),
        n_done=n_done, n_shed=len(shed), n_failed=len(failed),
        duration_s=duration_s,
        goodput_rps=good / duration_s if duration_s > 0 else 0.0,
        energy_j=energy_j,
        energy_per_done_j=energy_j / n_done if n_done else 0.0,
        ttfc_p50_s=p(ttfc_all, 50), ttfc_p95_s=p(ttfc_all, 95),
        latency_p50_s=p(lat_all, 50), latency_p95_s=p(lat_all, 95),
        slo_attained=attained, time_scale=time_scale,
        counts_visited=tuple(counts_visited), final_n=final_n,
        per_class=per_class)


def replay(trace: Trace, router: Any, *, time_scale: float = 1.0,
           vocab_size: int = 256,
           max_requests: int | None = None) -> ReplayReport:
    """Replay ``trace`` against a live Router, open-loop. ``time_scale``
    compresses trace time (10.0 → a 600 s trace replays in 60 s — the
    arrival *pattern* is preserved, absolute rates are 10× — use for
    smoke runs only, and say so next to the numbers). Energy is the sum
    over the router's closed observation windows (scheduler mode); a
    fixed router without windows reports 0 and the caller should meter
    externally."""
    if time_scale <= 0:
        raise ValueError(f"time_scale must be positive, got {time_scale}")
    reqs = trace.requests[:max_requests] if max_requests else trace.requests
    slo = getattr(router, "slo", None)
    t0 = time.perf_counter()
    handles = []
    for tr in reqs:
        due = t0 + tr.arrival_s / time_scale
        while time.perf_counter() < due:
            router.poll()
            time.sleep(_POLL_SLEEP_S)
        handles.append((tr, router.submit(
            build_request(tr, vocab_size=vocab_size))))
    router.drain()
    duration = time.perf_counter() - t0

    done: list = []
    shed: list = []
    failed: list = []
    counts: list[int] = []
    for tr, h in handles:
        pri = (slo.cls(tr.priority).name if slo is not None
               else tr.priority)
        if h.completion is not None:
            lat = ((h.done_at - (t0 + tr.arrival_s / time_scale))
                   if h.done_at is not None else 0.0)
            done.append((pri, h.ttfc_s, lat))
        elif isinstance(h.failure, RejectedEvent):
            shed.append(pri)
        else:
            failed.append(pri)
    for w in getattr(router, "history", []):
        if w.n_containers not in counts:
            counts.append(w.n_containers)
    energy = sum(w.energy_j for w in getattr(router, "history", []))
    return assemble_report(
        trace, slo=slo, done=done, shed=shed, failed=failed,
        duration_s=duration, energy_j=energy, time_scale=time_scale,
        counts_visited=tuple(counts),
        final_n=getattr(router, "n_containers", 0))

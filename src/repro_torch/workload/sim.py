"""Deterministic virtual-time fleet simulator — the replayer's twin (the
port's copy of ``repro.workload.sim``: it touches no device, so for the
same trace and knobs its report equals JAX's bit for bit).

Wall-clock replay (``workload/replay.py``) can never reproduce a report
bit-for-bit: scheduler decisions depend on measured latencies, which
depend on the host's timing that run. This module removes the host: a
discrete-event simulation in **virtual time** where service and energy
come from an explicit ``FleetModel``, so the same (trace, seed, knobs)
always produces the identical ``ReplayReport`` — the property the
committed benchmark numbers rely on.

What is simulated vs real:

* **Real**: the ``DivideAndSaveScheduler`` (observations, convex fits,
  quantile model, ``energy_under_slo`` constraint, ε-greedy RNG) and the
  SLO policy arithmetic (``queue_limit`` / ``shed_ttfc_threshold`` /
  ``class_window`` from ``workload/slo.py``) — the exact objects the
  Router runs, so a scheduling claim proven here is about the real
  policy code, not a reimplementation.
* **Modelled**: container service and power. ``FleetModel`` splits a
  device of ``cores`` among ``n`` containers with Amdahl efficiency
  (the paper's observed divide-and-save effect: more containers extract
  more aggregate throughput from the same cores, sublinearly), burns
  static power per *provisioned* container plus idle floor, and dynamic
  power per actively-used core. That shape creates the paper's tension:
  calm traffic wants few containers (static power dominates), bursts
  want many (queueing blows the ttfc tail and sheds load).

The admission/dispatch policy mirrors the Router's SLO mode: per-class
queue shares and shed thresholds, rank-ordered backlog, windowed
scheduler observation (count- or virtual-time-closed, with the same
sparse-window normalisation), resize at window boundaries.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict, deque

import numpy as np

from repro_torch.core.scheduler import DivideAndSaveScheduler
from repro_torch.workload.replay import ReplayReport, assemble_report
from repro_torch.workload.slo import (SLOSpec, censored_ttfc_p95,
                                      queue_limit, shed_ttfc_threshold)
from repro_torch.workload.traces import Trace, TraceRequest


@dataclasses.dataclass(frozen=True)
class FleetModel:
    """Service + power model of one edge device split into containers.

    ``speed(c)`` is Amdahl speedup of one container on ``c`` cores
    relative to one core; a fleet of ``n`` containers each gets
    ``cores / n``. Aggregate fleet throughput ``n * rate(n)`` *rises*
    with ``n`` (splitting recovers parallelism a single container's
    serial fraction wastes) — the paper's central observation — while
    static power ``p_container_w * n`` rises linearly, which is what
    gives energy-vs-n its convex interior optimum.

    The defaults are the frozen BENCH_trace device: Amdahl f = 0.5
    puts the mean-energy optimum at n = 1 while splitting still buys
    real burst capacity (n·rate(n) at n = 2 is ~1.75× n = 1), so the
    mean-optimal and SLO-feasible container counts genuinely differ."""
    cores: float = 4.0
    parallel_frac: float = 0.5        # Amdahl f within one container
    tokens_per_s_core: float = 170.0  # one container, one core
    prompt_token_cost: float = 0.25   # prefill token vs decode token work
    p_idle_w: float = 2.5             # device floor, always on
    p_container_w: float = 1.4        # static, per provisioned container
    p_core_w: float = 2.0             # dynamic, per actively-used core

    def speed(self, c: float) -> float:
        f = self.parallel_frac
        return 1.0 / ((1.0 - f) + f / max(c, 1e-9))

    def rate(self, n: int) -> float:
        """One container's token rate when the device is split n ways."""
        return self.tokens_per_s_core * self.speed(self.cores / max(n, 1))

    def work_tokens(self, tr: TraceRequest) -> float:
        return self.prompt_token_cost * tr.prompt_len + tr.max_new_tokens

    def prefill_tokens(self, tr: TraceRequest) -> float:
        # first chunk lands after prefill + one decode token
        return self.prompt_token_cost * tr.prompt_len + 1.0

    def power_w(self, provisioned: int, busy: int) -> float:
        cores_per = self.cores / max(provisioned, 1)
        return (self.p_idle_w + self.p_container_w * provisioned
                + self.p_core_w * cores_per * min(busy, provisioned))


@dataclasses.dataclass
class _InFlight:
    tr: TraceRequest
    cls_name: str
    start_s: float
    finish_s: float
    ttfc_s: float                     # absolute virtual stamp


def simulate(trace: Trace, *,
             feasible_counts: list[int],
             objective: str = "energy",
             slo: SLOSpec | None = None,
             fleet: FleetModel | None = None,
             window: int = 32,
             window_s: float | None = None,
             max_queue: int | None = None,
             shed_p95_s: float | None = None,
             shed_window_s: float = 30.0,
             deadline_by_class: dict | None = None,
             epsilon: float = 0.1,
             seed: int = 0) -> ReplayReport:
    """Run ``trace`` through the modelled fleet under the REAL scheduler.
    ``objective="energy"`` is the mean-optimal baseline;
    ``objective="energy_under_slo"`` (needs ``slo``) adds the quantile
    constraint. ``deadline_by_class`` maps a priority name to the
    client-imposed end-to-end deadline: a request still queued when its
    deadline passes fails at dispatch time without consuming service
    (the engine's queue-expiry path) — deadlines apply identically with
    or without an SLOSpec, which is what makes the SLO-blind baseline
    comparable. Returns the same ``ReplayReport`` the live replayer
    produces — bit-for-bit identical across runs for identical
    inputs."""
    fleet = fleet or FleetModel()
    slo_kw = {}
    if objective == "energy_under_slo":
        if slo is None:
            raise ValueError("energy_under_slo needs an SLOSpec")
        slo_kw["slo_ttfc_p95_s"] = slo.constraint.ttfc_p95_s
    sched = DivideAndSaveScheduler(
        list(feasible_counts), objective=objective,
        epsilon=epsilon, seed=seed, **slo_kw)

    n = sched.pick()
    counts_visited = [n]
    now = 0.0
    energy_j = 0.0
    busy: list[tuple[float, int]] = []     # heap of (finish_s, idx)
    backlog: list[tuple[int, int, int]] = []  # (rank, seq, idx) heap
    inflight: dict[int, _InFlight] = {}
    done: list = []                         # (cls, ttfc, latency)
    shed: list = []                         # cls names
    failed: list = []                       # cls names (deadline expiry)
    recent: dict[str, deque] = defaultdict(lambda: deque(maxlen=64))
    win = {"done": [], "t0": 0.0, "work": 0.0, "warmup": False}
    win_cls: dict[str, dict] = defaultdict(
        lambda: {"ttfc": [], "lat": [], "shed": 0, "failed": 0})
    seq = 0

    def advance(to: float) -> None:
        nonlocal now, energy_j
        if to <= now:       # coincident events (window edge == finish)
            return
        provisioned = max(n, len(busy))
        energy_j += fleet.power_w(provisioned, len(busy)) * (to - now)
        now = to

    def cls_of(tr: TraceRequest):
        return slo.cls(tr.priority) if slo is not None else None

    def aged_p95(name: str) -> float | None:
        dq = recent[name]
        horizon = now - shed_window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()
        if len(dq) < 8:
            return None
        return float(np.percentile([v for _, v in dq], 95))

    def shed_reason(tr: TraceRequest) -> bool:
        cls = cls_of(tr)
        in_flight = len(inflight) + len(backlog)
        if max_queue is not None:
            limit = (queue_limit(cls, max_queue)
                     if cls is not None else max_queue)
            if in_flight >= limit:
                return True
        threshold = (shed_ttfc_threshold(cls, shed_p95_s)
                     if cls is not None else shed_p95_s)
        if threshold is not None:
            name = cls.name if cls is not None else "default"
            p95 = aged_p95(name)
            if p95 is not None and p95 > threshold:
                return True
        return False

    def start(idx: int) -> bool:
        """Dispatch (or expire) the backlog entry; False = it died at
        the deadline check and consumed no service."""
        tr = trace.requests[idx]
        cls = cls_of(tr)
        name = cls.name if cls is not None else tr.priority
        if deadline_by_class is not None:
            dl = deadline_by_class.get(name)
            if dl is not None and now - tr.arrival_s > dl:
                failed.append(name)
                win_cls[name]["failed"] += 1
                return False
        r = fleet.rate(n)
        ttfc_abs = now + fleet.prefill_tokens(tr) / r
        finish = now + fleet.work_tokens(tr) / r
        inflight[idx] = _InFlight(tr, name, now, finish, ttfc_abs)
        heapq.heappush(busy, (finish, idx))
        return True

    def drain_backlog() -> None:
        while backlog and len(busy) < n:
            _, _, idx = heapq.heappop(backlog)
            start(idx)

    def finish(idx: int) -> None:
        f = inflight.pop(idx)
        ttfc = f.ttfc_s - f.tr.arrival_s
        lat = f.finish_s - f.tr.arrival_s
        done.append((f.cls_name, ttfc, lat))
        recent[f.cls_name].append((f.ttfc_s, ttfc))
        win["done"].append(lat)
        win["work"] += fleet.work_tokens(f.tr)
        acc = win_cls[f.cls_name]
        acc["ttfc"].append(ttfc)
        acc["lat"].append(lat)

    def close_window() -> None:
        nonlocal n
        wall = now - win["t0"]
        n_done = len(win["done"])
        if n_done == 0 or wall <= 0:
            reset_window()
            return
        if win["warmup"]:
            # first window at a fresh count drains the PREVIOUS count's
            # backlog — it measures the transition, not the count, and
            # its (loss-censored) tail would brand the new count
            # infeasible before it ever ran clean
            win["warmup"] = False
            reset_window()
            return
        # the window's energy share: integrate-as-you-go already put it
        # in energy_j; re-derive the share for the scheduler from the
        # same power model over this window's span and busy work
        e_static = (fleet.p_idle_w + fleet.p_container_w * n) * wall
        busy_s = win["work"] / fleet.rate(n)
        e_dyn = fleet.p_core_w * (fleet.cores / n) * busy_s
        e_win = e_static + e_dyn
        scale = 1.0
        if window_s is not None and 0 < n_done < window:
            scale = window / n_done
        q95: float | None = None
        if slo is not None:
            cname = slo.constraint.name
            acc = win_cls.get(cname)
            if acc is not None:
                # loss-censored: admission keeps the admitted p95 pinned
                # at the threshold and deadline expiry removes the worst
                # waiters, so shed + failed arrivals must count as
                # violations or every count looks feasible
                q95 = censored_ttfc_p95(
                    acc["ttfc"], acc["shed"] + acc["failed"],
                    2.0 * slo.constraint.ttfc_p95_s)
        elif win_cls:
            all_ttfc = [t for a in win_cls.values() for t in a["ttfc"]]
            if all_ttfc:
                q95 = float(np.percentile(all_ttfc, 95))
        sched.observe(n, wall * scale, e_win * scale, ttfc_p95_s=q95)
        new_n = sched.pick()
        if new_n != n:
            n = new_n
            if n not in counts_visited:
                counts_visited.append(n)
            # the recent-ttfc tails described the OLD count's fleet; kept
            # across the resize they would shed (and loss-censor) the new
            # count's first windows and brand it infeasible forever
            recent.clear()
            win["warmup"] = True
        reset_window()

    def reset_window() -> None:
        win["done"] = []
        win["work"] = 0.0
        win["t0"] = now
        win_cls.clear()

    arrivals = list(trace.requests)
    ai = 0
    while ai < len(arrivals) or busy or backlog:
        next_arrival = (arrivals[ai].arrival_s if ai < len(arrivals)
                        else float("inf"))
        next_finish = busy[0][0] if busy else float("inf")
        next_window = (win["t0"] + window_s if window_s is not None
                       else float("inf"))
        t = min(next_arrival, next_finish, next_window)
        if t == float("inf"):
            break                      # backlog with n == 0 cannot happen
        advance(t)
        if t == next_window and t < next_arrival and t < next_finish:
            close_window()
            drain_backlog()
            continue
        if next_finish <= next_arrival:
            _, idx = heapq.heappop(busy)
            finish(idx)
            if len(win["done"]) >= window:
                close_window()
            drain_backlog()
        else:
            tr, idx = arrivals[ai], ai
            ai += 1
            cls = cls_of(tr)
            name = cls.name if cls is not None else tr.priority
            if shed_reason(tr):
                shed.append(name)
                win_cls[name]["shed"] += 1
                continue
            rank = cls.rank if cls is not None else 0
            heapq.heappush(backlog, (rank, seq, idx))
            seq += 1
            drain_backlog()

    duration = max(now, trace.spec.duration_s)
    advance(duration)   # idle tail power until the trace's nominal end
    return assemble_report(
        trace, slo=slo, done=done, shed=shed, failed=failed,
        duration_s=duration, energy_j=energy_j,
        counts_visited=tuple(counts_visited), final_n=n)

"""Request-level streaming Router over containers.

A port of ``repro.serving.router.Router``, in its fixed-count and its
adaptive mode::

    router = Router(ThreadBackend(model, params, n))   # or ProcessBackend
    handle = router.submit(Request(...))          # returns immediately
    for ev in handle.stream():                    # ChunkEvent... DoneEvent
        ...

    router = Router(backend_factory=lambda n: ThreadBackend(model, params,
                                                            n, config),
                    feasible_counts=[1, 2, 4], window=8)  # adaptive

Dispatch is least-loaded + bucket-aware over the containers the backend
reports ``alive``: a request goes to the container with the fewest
queued+active requests, ties broken toward a container already holding
requests in the same prompt-length bucket (those prefill together in one
call), then toward the lower container id. Time-to-first-chunk is
stamped router-side, from ``submit()`` to the arrival of the request's
first ``ChunkEvent``.

Recovery: a ``ContainerFailure`` from the backend's ``poll()`` carries
the rids lost with the container; each is re-dispatched to a healthy
container (at most ``max_retries`` times, with its remaining deadline)
with a ``RetryEvent`` in its stream, or ends with a terminal
``FailedEvent`` — ``kind="container"`` when no healthy container is left
or its retries are spent, ``kind="deadline"`` when its deadline passed
while it was lost; ``stream()`` then raises ``RequestFailed``. Events
that arrive from an abandoned attempt (chunks, terminals, failures) are
dropped. ``cancel(rid)`` ends a request with
``FailedEvent(kind="cancelled")`` and frees it in its container.

Deadlines: ``Request.deadline_s``, or ``request_deadline_s`` for a
request without one, rides into the engine, which expires it where its
slot and blocks live (``FailedEvent(kind="deadline")``). The Router keeps
its own clock as a backstop: ``deadline_grace_s`` past the deadline it
cancels the request in its container and fails it, so a dead or silent
container cannot outlive a deadline.

Load shedding: ``submit`` rejects — a handle born terminal with one
``RejectedEvent``, whose ``stream()`` raises ``RequestRejected`` — when
``max_queue`` requests are in flight (``kind="queue"``) or the p95 of
the time-to-first-chunk samples of the last ``shed_window_s`` seconds
is over ``shed_p95_s`` (``kind="slo"``; no verdict below 8 samples).
``retry_after_s`` is the last window's median request latency (at least
0.05 s), or 0.25 s while no window history exists, as in JAX.

Adaptive mode (``backend_factory`` + ``feasible_counts``, or a
``scheduler``) closes the paper's online loop at window granularity:
completions accumulate into a window of observed wall, ``EnergyProxy``
energy, tokens/s, time-to-first-chunk and latency (``WindowStats``); at
every ``window`` completions (or ``window_s`` seconds with at least one)
the ``DivideAndSaveScheduler`` observes the window and picks the next
count, and the Router swaps to that count's backend once the stream has
drained, so no request is stranded mid-decode. Backends are built once a
count, kept warm across resizes and closed by ``close()``. ``serve_wave``
is the wave shim over it: submit all, drain, ``pool.assemble_wave``'s
accounting.

Not in the port yet: SLO classes and their backlog, per-class window
stats, tenant quotas and ``dispatch_depth``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Any, Callable, Iterator, Sequence

import torch

from repro_torch.core.scheduler import DivideAndSaveScheduler
from repro_torch.device import resolve_device
from repro_torch.serving.engine import Completion, Request, _bucket
from repro_torch.serving.events import (ChunkEvent, ContainerFailure,
                                        DoneEvent, Event, FailedEvent,
                                        RejectedEvent, RetryEvent)
from repro_torch.serving.pool import (ContainerResult, EnergyProxy,
                                      _warn_wave_shim, assemble_wave,
                                      latency_percentiles, percentiles)

_IDLE_SLEEP_S = 0.002
# the shed hint while no window history exists (the fixed-count Router
# keeps none), as in JAX
_RETRY_AFTER_S = 0.25
# the least hint a window's median latency may give, so clients cannot
# hot-loop
_RETRY_AFTER_FLOOR_S = 0.05


class RequestFailed(RuntimeError):
    """Raised by ``stream()``/``result()`` after a terminal
    ``FailedEvent`` — retries exhausted, no healthy container, or
    cancellation. The event rides on ``.event``; the message embeds its
    reason (for container failures, the original traceback)."""

    def __init__(self, event):
        super().__init__(
            f"request {event.rid} failed ({event.kind}): {event.reason}")
        self.event = event


class RequestRejected(RequestFailed):
    """Raised after a terminal ``RejectedEvent`` (admission shed the
    request). ``event.retry_after_s`` is the backpressure hint."""

    def __init__(self, event):
        RuntimeError.__init__(
            self, f"request {event.rid} rejected: {event.reason} "
                  f"(retry after {event.retry_after_s:.2f}s)")
        self.event = event


@dataclasses.dataclass
class WindowStats:
    """One scheduler observation window of streamed serving, the
    request-level counterpart of ``adaptive.WaveResult``."""
    window: int
    n_containers: int
    wall_s: float
    energy_j: float
    n_requests: int
    n_tokens: int = 0
    tokens_per_s: float = 0.0
    ttfc_p50_s: float = 0.0       # time-to-first-chunk, median
    ttfc_p95_s: float = 0.0       # time-to-first-chunk, tail
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    n_retries: int = 0            # re-dispatches after container failures
    n_failed: int = 0             # terminal FailedEvents in the window
    n_shed: int = 0               # admission rejections in the window
    prefix_hit_tokens: int = 0    # prompt tokens served from the prefix
                                  # cache instead of prefill (paged only)


class CompletionHandle:
    """Live view of one submitted request. ``stream()`` yields its events
    as they arrive (pumping the router while it waits); ``result()``
    drains the stream and returns the Completion — or raises
    ``RequestFailed`` / ``RequestRejected`` if the request ended without
    one."""

    def __init__(self, rid: int, router: "Router"):
        self.rid = rid
        self._router = router
        self._pending: deque[Event] = deque()
        self.completion: Completion | None = None
        self.failure: Any = None        # terminal Failed/RejectedEvent
        self.attempts: int = 0                # retries so far
        self.ttfc_s: float | None = None      # submit → first ChunkEvent
        self.container_id: int | None = None
        self.done_at: float | None = None     # DoneEvent arrival stamp

    @property
    def done(self) -> bool:
        """The terminal event arrived at the router (it may still wait in
        this handle's queue for ``stream()`` to consume)."""
        return self.completion is not None or self.failure is not None

    def stream(self) -> Iterator[Event]:
        """Yield the request's ChunkEvents (and RetryEvents — discard the
        chunks accumulated so far at each one), then exactly one terminal
        event: after a DoneEvent it stops, after a FailedEvent or a
        RejectedEvent it raises ``RequestFailed`` / ``RequestRejected``
        (the event is yielded first). Raises RuntimeError if the router
        closes while the request is in flight."""
        while True:
            while self._pending:
                ev = self._pending.popleft()
                yield ev
                if isinstance(ev, DoneEvent):
                    return
                if isinstance(ev, RejectedEvent):
                    raise RequestRejected(ev)
                if isinstance(ev, FailedEvent):
                    raise RequestFailed(ev)
            if self.completion is not None:
                return                 # already fully consumed
            if isinstance(self.failure, RejectedEvent):
                raise RequestRejected(self.failure)
            if self.failure is not None:
                raise RequestFailed(self.failure)
            if self._router._closed:
                raise RuntimeError(f"router closed while request "
                                   f"{self.rid} was mid-stream")
            self._router._pump(block=True)

    def result(self) -> Completion:
        """Drain the stream; the Completion. Raises ``RequestFailed`` on a
        failed request (``RequestRejected`` on a shed one)."""
        for _ in self.stream():
            pass
        return self.completion

    def tokens(self) -> list[int]:
        return list(self.result().tokens)


class Router:
    """Continuous admission over a ``ThreadBackend`` or ``ProcessBackend``,
    with deadlines and load shedding.

    Fixed mode: pass ``backend``. Adaptive mode: pass ``backend_factory``
    (count -> backend on ``device``) plus ``feasible_counts`` (or a
    ``scheduler``; ``objective``, ``epsilon``, ``seed`` and ``deadline_s``,
    the scheduler's time bound, build one); the Router starts at the
    scheduler's pick and resizes between windows of ``window``
    completions (or ``window_s`` seconds)."""

    def __init__(self, backend=None, *,
                 backend_factory: Callable[[int], Any] | None = None,
                 feasible_counts: Sequence[int] | None = None,
                 scheduler: DivideAndSaveScheduler | None = None,
                 objective: str = "energy",
                 epsilon: float = 0.0, seed: int = 0,
                 deadline_s: float | None = None,
                 window: int = 16,
                 window_s: float | None = None,
                 energy: EnergyProxy | None = None,
                 max_retries: int = 1,
                 request_deadline_s: float | None = None,
                 deadline_grace_s: float = 0.5,
                 max_queue: int | None = None,
                 shed_p95_s: float | None = None,
                 shed_window_s: float = 30.0,
                 device: str | torch.device = "cuda"):
        if backend is None and backend_factory is None:
            raise ValueError("need a backend or a backend_factory")
        self.device = resolve_device(device)
        self.energy = energy or EnergyProxy()
        self.window = window
        # a time-closed window (None: completion count only), so sparse
        # traffic still gives the scheduler observations
        self.window_s = window_s
        self.scheduler = scheduler
        self._factory = backend_factory
        self._backends: dict[int, Any] = {}
        if backend_factory is not None:
            if scheduler is None:
                if not feasible_counts:
                    raise ValueError("adaptive mode needs feasible_counts "
                                     "(or an explicit scheduler)")
                self.scheduler = DivideAndSaveScheduler(
                    list(feasible_counts), objective=objective,
                    deadline_s=deadline_s, epsilon=epsilon, seed=seed)
            backend = self._backend_for(self.scheduler.pick())
        self._check_device(backend)
        self.backend = backend
        self.max_retries = max_retries
        self.request_deadline_s = request_deadline_s
        self.deadline_grace_s = deadline_grace_s
        self.max_queue = max_queue
        self.shed_p95_s = shed_p95_s
        self.shed_window_s = shed_window_s
        self._closed = False
        self._handles: dict[int, CompletionHandle] = {}
        self._requests: dict[int, Request] = {}
        self._rid_cid: dict[int, int] = {}
        self._submit_t: dict[int, float] = {}
        self._deadline_abs: dict[int, float] = {}  # the backstop's clock
        # per-container multiset of in-flight admission buckets
        self._cid_buckets = [Counter() for _ in range(backend.capacity)]
        self.container_failures: list[ContainerFailure] = []
        self.retry_total = 0
        self.failed_total = 0
        self.shed_total = 0
        # (stamp, seconds) ttfc samples for the shed threshold, aged out
        # past shed_window_s so a past spike stops shedding
        self._recent_ttfc: deque[tuple[float, float]] = deque(maxlen=64)
        self.history: list[WindowStats] = []
        self._target_n: int | None = None    # a resize awaiting a drain
        self._new_window()

    def _check_device(self, backend) -> None:
        if backend.device != self.device:
            raise ValueError(f"backend serves on {backend.device}, router "
                             f"asked for {self.device}")

    def _backend_for(self, n: int):
        """The count's backend, built by the factory at its first pick
        and cached warm."""
        if n not in self._backends:
            backend = self._factory(n)
            self._check_device(backend)
            self._backends[n] = backend
        return self._backends[n]

    def _new_window(self) -> None:
        """Open a window: its clock, the backend's counters (with a
        scheduler only; a fixed Router reads none) and its
        accumulators."""
        self._window_t0 = time.perf_counter()
        self._window_stats0 = (
            [self.backend.stats(cid) for cid in range(self.backend.capacity)]
            if self.scheduler is not None else [])
        self._window_done: list[Completion] = []
        self._window_ttfc: list[float] = []
        self._window_retries = 0
        self._window_failed = 0
        self._window_shed = 0

    @property
    def in_flight(self) -> int:
        return len(self._handles)

    @property
    def n_containers(self) -> int:
        return self.backend.capacity

    def _alive_cids(self) -> list[int]:
        """Containers the backend reports ``alive`` (a backend without a
        supervision surface counts as all-alive)."""
        alive = getattr(self.backend, "alive", None)
        return [cid for cid in range(self.backend.capacity)
                if alive is None or alive(cid)]

    def _dispatch(self, req: Request) -> int | None:
        """Least-loaded live container, ties toward a bucket hit; None if
        every container is dead, respawning or circuit-broken."""
        cids = self._alive_cids()
        if not cids:
            return None
        load = self.backend.load
        bucket = _bucket(len(req.prompt))
        cid = min(cids, key=lambda c: (
            load(c), 0 if self._cid_buckets[c][bucket] else 1, c))
        self._cid_buckets[cid][bucket] += 1
        return cid

    def note_ttfc(self, seconds: float, at: float | None = None) -> None:
        """Record one time-to-first-chunk sample for the shed threshold's
        p95 (stamped now unless ``at`` is given)."""
        stamp = time.perf_counter() if at is None else at
        self._recent_ttfc.append((stamp, seconds))

    @staticmethod
    def _aged_p95(samples: deque, horizon: float) -> float | None:
        """p95 of a (stamp, value) deque after dropping the entries older
        than ``horizon``; None below 8 samples (too noisy)."""
        while samples and samples[0][0] < horizon:
            samples.popleft()
        if len(samples) < 8:
            return None
        return percentiles([v for _, v in samples])[1]

    def _shed_reason(self) -> tuple[str, str] | None:
        """(kind, reason) when admission should shed now, else None."""
        if (self.max_queue is not None
                and len(self._handles) >= self.max_queue):
            return ("queue", f"queue full: {len(self._handles)} in flight "
                             f">= {self.max_queue}")
        if self.shed_p95_s is not None:
            p95 = self._aged_p95(self._recent_ttfc,
                                 time.perf_counter() - self.shed_window_s)
            if p95 is not None and p95 > self.shed_p95_s:
                return ("slo", f"ttfc p95 {p95:.3f}s over shed threshold "
                               f"{self.shed_p95_s:g}s")
        return None

    def _retry_after_hint(self) -> float:
        """The backpressure hint of a shed request: about one median
        request latency of the last window (the shortest wait after which
        the picture can have changed), floored so clients cannot
        hot-loop; 0.25 s while no window history exists."""
        if self.history and self.history[-1].latency_p50_s > 0:
            return max(_RETRY_AFTER_FLOOR_S, self.history[-1].latency_p50_s)
        return _RETRY_AFTER_S

    def _terminal_handle(self, req: Request, ev) -> CompletionHandle:
        """A handle born terminal (shed, or nowhere to dispatch): never
        registered, its single event already pending."""
        handle = CompletionHandle(req.rid, self)
        handle.failure = ev
        handle._pending.append(ev)
        return handle

    def submit(self, req: Request) -> CompletionHandle:
        """Dispatch one request now; returns its handle immediately. A
        shed request's handle is born rejected (its stream yields one
        ``RejectedEvent`` and raises ``RequestRejected``); with no healthy
        container the handle is born failed (one ``FailedEvent``, then
        ``RequestFailed``)."""
        if self._closed:
            raise RuntimeError("router is closed")
        if req.rid in self._handles:
            raise ValueError(f"request id {req.rid} is already in flight")
        now = time.perf_counter()
        shed = self._shed_reason()
        if shed is not None:
            self.shed_total += 1
            self._window_shed += 1
            return self._terminal_handle(req, RejectedEvent(
                req.rid, shed[1], self._retry_after_hint(), now,
                kind=shed[0]))
        if req.deadline_s is None and self.request_deadline_s is not None:
            req = dataclasses.replace(req,
                                      deadline_s=self.request_deadline_s)
        cid = self._dispatch(req)
        if cid is None:
            self.failed_total += 1
            self._window_failed += 1
            return self._terminal_handle(req, FailedEvent(
                req.rid, -1, "container",
                "no healthy container to dispatch to (all circuit-broken "
                "or respawning)", now))
        handle = CompletionHandle(req.rid, self)
        handle.container_id = cid
        self._handles[req.rid] = handle
        self._requests[req.rid] = req
        self._rid_cid[req.rid] = cid
        self._submit_t[req.rid] = now
        if req.deadline_s is not None:
            self._deadline_abs[req.rid] = now + req.deadline_s
        self.backend.submit(cid, req)
        return handle

    def _forget(self, rid: int) -> None:
        """Release every router-side record of ``rid`` (the handle's
        terminal state is the caller's to set)."""
        cid = self._rid_cid.pop(rid, None)
        req = self._requests.pop(rid, None)
        if cid is not None and req is not None:
            self._cid_buckets[cid][_bucket(len(req.prompt))] -= 1
        self._handles.pop(rid, None)
        self._submit_t.pop(rid, None)
        self._deadline_abs.pop(rid, None)

    def _fail_request(self, rid: int, kind: str, reason: str) -> None:
        """Terminal FailedEvent for an in-flight request (router-side
        origin: retries exhausted, no healthy container, the deadline
        backstop, cancel)."""
        handle = self._handles.get(rid)
        cid = self._rid_cid.get(rid, -1)
        self._forget(rid)
        if handle is None:
            return
        ev = FailedEvent(rid, cid, kind, reason, time.perf_counter())
        handle.failure = ev
        handle._pending.append(ev)
        self.failed_total += 1
        self._window_failed += 1

    def _expire_deadlines(self, now: float) -> None:
        """The deadline backstop: the engine expires deadlines itself (that
        frees slots and blocks where they live), but a dead, hung or
        reply-dropping container cannot, so ``deadline_grace_s`` past a
        deadline the Router cancels the request in its container and
        fails it here."""
        if not self._deadline_abs:
            return
        expired = [rid for rid, t in self._deadline_abs.items()
                   if now > t + self.deadline_grace_s]
        cancel = getattr(self.backend, "cancel", None)
        for rid in expired:
            cid = self._rid_cid.get(rid)
            if cancel is not None and cid is not None:
                cancel(cid, rid)
            self._fail_request(
                rid, "deadline",
                "deadline exceeded (router backstop, "
                f"{self.deadline_grace_s:g}s past the engine's own expiry)")

    def _on_container_failure(self, fail: ContainerFailure) -> None:
        """Re-dispatch (bounded) or fail every request lost with a
        container: each that still has deadline left goes to the
        least-loaded healthy container with a RetryEvent in its stream and
        its REMAINING deadline."""
        self.container_failures.append(fail)
        reason = fail.message.splitlines()[0]
        for rid in fail.lost_rids:
            handle = self._handles.get(rid)
            req = self._requests.get(rid)
            if handle is None or req is None:
                continue
            old = self._rid_cid.pop(rid, None)
            if old is not None:
                self._cid_buckets[old][_bucket(len(req.prompt))] -= 1
            now = time.perf_counter()
            deadline_abs = self._deadline_abs.get(rid)
            handle.attempts += 1
            if deadline_abs is not None and now >= deadline_abs:
                self._fail_request(rid, "deadline",
                                   f"deadline expired while lost to "
                                   f"{reason}")
                continue
            if handle.attempts > self.max_retries:
                self._fail_request(
                    rid, "container",
                    f"retries exhausted after {handle.attempts} attempts; "
                    f"last failure: {fail.message}")
                continue
            cid = self._dispatch(req)
            if cid is None:
                self._fail_request(
                    rid, "container",
                    "no healthy container left to retry on; last "
                    f"failure: {fail.message}")
                continue
            self._rid_cid[rid] = cid
            handle.container_id = cid
            if deadline_abs is not None:
                self._deadline_abs[rid] = deadline_abs   # the backstop's
            self.retry_total += 1
            self._window_retries += 1
            handle._pending.append(RetryEvent(
                rid, cid, handle.attempts, reason, now))
            resubmit = req
            if deadline_abs is not None:
                # the retry inherits the remaining budget: end to end
                # means across attempts
                resubmit = dataclasses.replace(
                    req, deadline_s=deadline_abs - now)
            try:
                self.backend.submit(cid, resubmit)
            except RuntimeError as e:
                self._fail_request(rid, "container",
                                   f"re-dispatch to container {cid} "
                                   f"failed: {e}")

    def _pump(self, block: bool = False) -> list[Event]:
        """Advance the backend and route its events to their handles —
        container failures included (retry or fail the lost requests) —
        then run the deadline backstop; with ``block`` and nothing routed,
        nap briefly."""
        events = self.backend.poll()
        now = time.perf_counter()
        for ev in events:
            if isinstance(ev, ContainerFailure):
                self._on_container_failure(ev)
                continue
            handle = self._handles.get(ev.rid)
            if handle is None:      # not submitted here, or already ended
                continue
            if ev.container_id != self._rid_cid.get(ev.rid):
                # a late event of an abandoned attempt: the request was
                # re-dispatched after its container failed
                continue
            handle._pending.append(ev)
            if isinstance(ev, ChunkEvent) and handle.ttfc_s is None:
                handle.ttfc_s = now - self._submit_t[ev.rid]
                self.note_ttfc(handle.ttfc_s, at=now)
            elif isinstance(ev, DoneEvent):
                self._on_done(handle, ev)
            elif isinstance(ev, FailedEvent):
                # an engine-side terminal (a deadline expired inside the
                # container, whose resources are already freed there)
                handle.failure = ev
                self._forget(ev.rid)
                self.failed_total += 1
                self._window_failed += 1
        self._expire_deadlines(now)
        if self.scheduler is not None:
            self._maybe_rotate_window()
        if block and not events:
            time.sleep(_IDLE_SLEEP_S)
        return events

    def poll(self) -> list[Event]:
        """Advance containers and route events; returns the routed batch."""
        return self._pump(block=False)

    def _on_done(self, handle: CompletionHandle, ev: DoneEvent) -> None:
        handle.completion = ev.completion
        handle.done_at = time.perf_counter()
        self._forget(handle.rid)
        if self.scheduler is not None:
            # the window's samples feed the scheduler only; a fixed Router
            # keeps no completion past its handle
            self._window_done.append(ev.completion)
            if handle.ttfc_s is not None:
                self._window_ttfc.append(handle.ttfc_s)

    def cancel(self, rid: int, reason: str = "cancelled by caller") -> bool:
        """Cancel an in-flight request: removed in its container (slot and
        cache freed through the engine's cancel), and a terminal
        ``FailedEvent(kind="cancelled")`` on its handle. Returns whether
        the request was still in flight."""
        if rid not in self._handles:
            return False
        cid = self._rid_cid.get(rid)
        cancel = getattr(self.backend, "cancel", None)
        if cancel is not None and cid is not None:
            cancel(cid, rid)
        self._fail_request(rid, "cancelled", reason)
        return True

    def drain(self) -> None:
        """Pump until every in-flight request reached its terminal event
        (unconsumed events stay on their handles)."""
        while self._handles:
            self._pump(block=True)

    # -- windowed adaptation --------------------------------------------
    def _maybe_rotate_window(self) -> None:
        """The window closes on its completion count, or with
        ``window_s`` on elapsed time once it holds a completion (an idle
        time-expired window only restarts its clock); the backend swap it
        asks for waits until nothing is in flight, since a resize under a
        live request would strand its slot. At the swap the outgoing
        backend's partial window is observed first (without a repick),
        the bucket counters start over for the new containers and the
        shed tail is cleared: it described the outgoing count."""
        time_up = (self.window_s is not None
                   and time.perf_counter() - self._window_t0
                   >= self.window_s)
        if len(self._window_done) >= self.window:
            self._observe_window()
        elif time_up:
            if self._window_done:
                self._observe_window()
            else:
                self._new_window()
        if self._target_n is None or self._handles:
            return
        if (self._target_n != self.backend.capacity
                and self._factory is not None):
            if self._window_done:
                self._observe_window(repick=False)
            self.backend = self._backend_for(self._target_n)
            self._cid_buckets = [Counter()
                                 for _ in range(self.backend.capacity)]
            self._recent_ttfc.clear()
            self._new_window()
        self._target_n = None

    def _observe_window(self, repick: bool = True) -> None:
        """Record the window's ``WindowStats``, feed the scheduler its
        (n, wall, energy, ttfc p95) and, with ``repick``, ask for the next
        count. A time-closed window of fewer than ``window`` completions
        is scaled up to the window's size, so observations stay
        comparable (the fit models a per-request cost)."""
        n = self.backend.capacity
        wall = time.perf_counter() - self._window_t0
        now = [self.backend.stats(cid) for cid in range(n)]
        busy = [b - b0 for (b, _), (b0, _) in zip(now, self._window_stats0)]
        toks = sum(t - t0 for (_, t), (_, t0) in zip(now,
                                                     self._window_stats0))
        energy_j = sum(self.energy.container_energy(wall, b, n)
                       for b in busy)
        ttfc50, ttfc95 = percentiles(self._window_ttfc)
        lat50, lat95 = latency_percentiles(self._window_done)
        self.history.append(WindowStats(
            len(self.history), n, wall, energy_j, len(self._window_done),
            toks, toks / wall if wall > 0 else 0.0, ttfc50, ttfc95,
            lat50, lat95, n_retries=self._window_retries,
            n_failed=self._window_failed, n_shed=self._window_shed,
            prefix_hit_tokens=sum(c.prefix_hit_tokens
                                  for c in self._window_done)))
        done = len(self._window_done)
        scale = 1.0
        if self.window_s is not None and 0 < done < self.window:
            scale = self.window / done
        self.scheduler.observe(n, wall * scale, energy_j * scale,
                               ttfc_p95_s=ttfc95 if self._window_ttfc
                               else None)
        if repick:
            self._target_n = self.scheduler.pick()
        self._new_window()

    @property
    def choice(self) -> int:
        """The exploitation-only container count (what a converged
        deployment runs); adaptive mode only."""
        if self.scheduler is None:
            raise RuntimeError("a fixed-count Router has no scheduler")
        return self.scheduler.best()

    # -- wave shim -------------------------------------------------------
    def serve_wave(self, requests: list[Request]
                   ) -> tuple[list[Completion], list[ContainerResult],
                              float, float]:
        """The wave API over streaming: submit all, drain, and rebuild the
        per-container accounting with ``assemble_wave``. Completions come
        back in submission order; a request that ends without one fails
        the wave."""
        _warn_wave_shim("Router.serve_wave")
        # pinned for the wave: a window boundary inside drain() may swap
        # self.backend, and the wave's counters are the serving backend's
        backend = self.backend
        stats0 = [backend.stats(cid) for cid in range(backend.capacity)]
        t0 = time.perf_counter()
        handles = [self.submit(r) for r in requests]
        self.drain()
        wall = time.perf_counter() - t0
        failed = [h.rid for h in handles if h.completion is None]
        if failed:
            raise RuntimeError(
                f"wave failed: requests {failed} ended without a "
                "completion (see router.container_failures)")
        capacity = backend.capacity
        segments: list[list[Request]] = [[] for _ in range(capacity)]
        comps: list[list[Completion]] = [[] for _ in range(capacity)]
        # a container's wall runs from submit to its last DoneEvent
        last = [0.0] * capacity
        for r, h in zip(requests, handles):
            segments[h.container_id].append(r)
            comps[h.container_id].append(h.completion)
            last[h.container_id] = max(last[h.container_id],
                                       h.done_at - t0)
        now = [backend.stats(cid) for cid in range(capacity)]
        out = [(comps[cid], last[cid], now[cid][0] - stats0[cid][0],
                now[cid][1] - stats0[cid][1]) for cid in range(capacity)]
        _, results, energy = assemble_wave(out, segments, wall, self.energy)
        return [h.completion for h in handles], results, wall, energy

    def serve(self, requests: list[Request]
              ) -> tuple[list[Completion], list[ContainerResult]]:
        ordered, results, _, _ = self.serve_wave(requests)
        return ordered, results

    def close(self) -> None:
        """Close the backend, and every cached backend of adaptive mode;
        handles still mid-stream raise rather than hang."""
        if self._closed:
            return
        self._closed = True
        backends = {id(b): b for b in self._backends.values()}
        backends[id(self.backend)] = self.backend
        for b in backends.values():
            b.close()
        self._backends = {}

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

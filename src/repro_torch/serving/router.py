"""Request-level streaming Router over a fixed set of containers.

A port of the fixed-count path of ``repro.serving.router.Router``::

    router = Router(ThreadBackend(model, params, n))   # or ProcessBackend
    handle = router.submit(Request(...))          # returns immediately
    for ev in handle.stream():                    # ChunkEvent... DoneEvent
        ...

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
``retry_after_s`` is 0.25 s, JAX's hint while no window history exists.

Not in the port yet: adaptive container counts and windows, SLO classes
and their backlog, tenant quotas and ``dispatch_depth``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Any, Iterator

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.engine import Completion, Request, _bucket
from repro_torch.serving.events import (ChunkEvent, ContainerFailure,
                                        DoneEvent, Event, FailedEvent,
                                        RejectedEvent, RetryEvent)
from repro_torch.serving.pool import percentiles

_IDLE_SLEEP_S = 0.002
# the shed hint while no window history exists (the fixed-count Router
# keeps none), as in JAX
_RETRY_AFTER_S = 0.25


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
    """Continuous admission over one fixed-count backend (``ThreadBackend``
    or ``ProcessBackend``), with deadlines and load shedding."""

    def __init__(self, backend, *, max_retries: int = 1,
                 request_deadline_s: float | None = None,
                 deadline_grace_s: float = 0.5,
                 max_queue: int | None = None,
                 shed_p95_s: float | None = None,
                 shed_window_s: float = 30.0,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        if backend.device != dev:
            raise ValueError(f"backend serves on {backend.device}, router "
                             f"asked for {dev}")
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

    @property
    def in_flight(self) -> int:
        return len(self._handles)

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
            return self._terminal_handle(req, RejectedEvent(
                req.rid, shed[1], _RETRY_AFTER_S, now, kind=shed[0]))
        if req.deadline_s is None and self.request_deadline_s is not None:
            req = dataclasses.replace(req,
                                      deadline_s=self.request_deadline_s)
        cid = self._dispatch(req)
        if cid is None:
            self.failed_total += 1
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
                handle.completion = ev.completion
                self._forget(ev.rid)
            elif isinstance(ev, FailedEvent):
                # an engine-side terminal (a deadline expired inside the
                # container, whose resources are already freed there)
                handle.failure = ev
                self._forget(ev.rid)
                self.failed_total += 1
        self._expire_deadlines(now)
        if block and not events:
            time.sleep(_IDLE_SLEEP_S)
        return events

    def poll(self) -> list[Event]:
        """Advance containers and route events; returns the routed batch."""
        return self._pump(block=False)

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

    def close(self) -> None:
        """Close the backend; handles still mid-stream raise rather than
        hang."""
        if self._closed:
            return
        self._closed = True
        self.backend.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

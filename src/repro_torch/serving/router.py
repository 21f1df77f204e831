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
container (at most ``max_retries`` times) with a ``RetryEvent`` in its
stream, or ends with a terminal ``FailedEvent(kind="container")`` when
no healthy container is left or its retries are spent; ``stream()`` then
raises ``RequestFailed``. ``cancel(rid)`` ends a request with
``FailedEvent(kind="cancelled")`` and frees it in its container.

Not in the port yet: adaptive container counts and windows, SLO classes
and backlog, deadlines and the router-side backstop, load shedding.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from typing import Iterator

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.engine import Completion, Request, _bucket
from repro_torch.serving.events import (ChunkEvent, ContainerFailure,
                                        DoneEvent, Event, FailedEvent,
                                        RetryEvent)

_IDLE_SLEEP_S = 0.002


class RequestFailed(RuntimeError):
    """Raised by ``stream()``/``result()`` after a terminal
    ``FailedEvent`` — retries exhausted, no healthy container, or
    cancellation. The event rides on ``.event``; the message embeds its
    reason (for container failures, the original traceback)."""

    def __init__(self, event):
        super().__init__(
            f"request {event.rid} failed ({event.kind}): {event.reason}")
        self.event = event


class CompletionHandle:
    """Live view of one submitted request. ``stream()`` yields its events
    as they arrive (pumping the router while it waits); ``result()``
    drains the stream and returns the Completion — or raises
    ``RequestFailed`` if the request ended without one."""

    def __init__(self, rid: int, router: "Router"):
        self.rid = rid
        self._router = router
        self._pending: deque[Event] = deque()
        self.completion: Completion | None = None
        self.failure: FailedEvent | None = None   # terminal FailedEvent
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
        event: after a DoneEvent it stops, after a FailedEvent it raises
        ``RequestFailed`` (the event is yielded first). Raises
        RuntimeError if the router closes while the request is in
        flight."""
        while True:
            while self._pending:
                ev = self._pending.popleft()
                yield ev
                if isinstance(ev, DoneEvent):
                    return
                if isinstance(ev, FailedEvent):
                    raise RequestFailed(ev)
            if self.completion is not None:
                return                 # already fully consumed
            if self.failure is not None:
                raise RequestFailed(self.failure)
            if self._router._closed:
                raise RuntimeError(f"router closed while request "
                                   f"{self.rid} was mid-stream")
            self._router._pump(block=True)

    def result(self) -> Completion:
        """Drain the stream; the Completion. Raises ``RequestFailed`` on a
        failed request."""
        for _ in self.stream():
            pass
        return self.completion

    def tokens(self) -> list[int]:
        return list(self.result().tokens)


class Router:
    """Continuous admission over one fixed-count backend (``ThreadBackend``
    or ``ProcessBackend``)."""

    def __init__(self, backend, *, max_retries: int = 1,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        if backend.device != dev:
            raise ValueError(f"backend serves on {backend.device}, router "
                             f"asked for {dev}")
        self.backend = backend
        self.max_retries = max_retries
        self._closed = False
        self._handles: dict[int, CompletionHandle] = {}
        self._requests: dict[int, Request] = {}
        self._rid_cid: dict[int, int] = {}
        self._submit_t: dict[int, float] = {}
        # per-container multiset of in-flight admission buckets
        self._cid_buckets = [Counter() for _ in range(backend.capacity)]
        self.container_failures: list[ContainerFailure] = []
        self.retry_total = 0
        self.failed_total = 0

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

    def submit(self, req: Request) -> CompletionHandle:
        """Dispatch one request now; returns its handle immediately. With
        no healthy container the handle is born failed (its stream yields
        one ``FailedEvent`` and raises ``RequestFailed``)."""
        if self._closed:
            raise RuntimeError("router is closed")
        if req.rid in self._handles:
            raise ValueError(f"request id {req.rid} is already in flight")
        handle = CompletionHandle(req.rid, self)
        cid = self._dispatch(req)
        if cid is None:
            ev = FailedEvent(req.rid, -1, "container",
                             "no healthy container to dispatch to (all "
                             "circuit-broken or respawning)",
                             time.perf_counter())
            handle.failure = ev
            handle._pending.append(ev)
            self.failed_total += 1
            return handle
        handle.container_id = cid
        self._handles[req.rid] = handle
        self._requests[req.rid] = req
        self._rid_cid[req.rid] = cid
        self._submit_t[req.rid] = time.perf_counter()
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

    def _fail_request(self, rid: int, kind: str, reason: str) -> None:
        """Terminal FailedEvent for an in-flight request (router-side
        origin: retries exhausted, no healthy container, cancel)."""
        handle = self._handles.get(rid)
        cid = self._rid_cid.get(rid, -1)
        self._forget(rid)
        if handle is None:
            return
        ev = FailedEvent(rid, cid, kind, reason, time.perf_counter())
        handle.failure = ev
        handle._pending.append(ev)
        self.failed_total += 1

    def _on_container_failure(self, fail: ContainerFailure) -> None:
        """Re-dispatch (bounded) or fail every request lost with a
        container: each goes to the least-loaded healthy container with a
        RetryEvent in its stream."""
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
            handle.attempts += 1
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
            self.retry_total += 1
            handle._pending.append(RetryEvent(
                rid, cid, handle.attempts, reason, time.perf_counter()))
            try:
                self.backend.submit(cid, req)
            except RuntimeError as e:
                self._fail_request(rid, "container",
                                   f"re-dispatch to container {cid} "
                                   f"failed: {e}")

    def _pump(self, block: bool = False) -> list[Event]:
        """Advance the backend and route its events to their handles —
        container failures included (retry or fail the lost requests);
        with ``block`` and nothing routed, nap briefly."""
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
            elif isinstance(ev, DoneEvent):
                handle.completion = ev.completion
                self._forget(ev.rid)
            elif isinstance(ev, FailedEvent):
                handle.failure = ev
                self._forget(ev.rid)
                self.failed_total += 1
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

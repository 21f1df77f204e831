"""Request-level streaming Router over a fixed set of containers.

A port of the fixed-count path of ``repro.serving.router.Router``::

    router = Router(ThreadBackend(model, params, n))
    handle = router.submit(Request(...))          # returns immediately
    for ev in handle.stream():                    # ChunkEvent... DoneEvent
        ...

Dispatch is least-loaded + bucket-aware: a request goes to the container
with the fewest queued+active requests, ties broken toward a container
already holding requests in the same prompt-length bucket (those prefill
together in one call), then toward the lower container id.
Time-to-first-chunk is stamped router-side, from ``submit()`` to the
arrival of the request's first ``ChunkEvent``.

Not in this slice: adaptive container counts and windows, SLO classes and
backlog, load-shedding, retries and deadlines.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from typing import Iterator

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.engine import Completion, Request, _bucket
from repro_torch.serving.events import ChunkEvent, DoneEvent, Event

_IDLE_SLEEP_S = 0.002


class CompletionHandle:
    """Live view of one submitted request. ``stream()`` yields its events
    as they arrive (pumping the router while it waits); ``result()``
    drains the stream and returns the Completion."""

    def __init__(self, rid: int, router: "Router"):
        self.rid = rid
        self._router = router
        self._pending: deque[Event] = deque()
        self.completion: Completion | None = None
        self.ttfc_s: float | None = None      # submit → first ChunkEvent
        self.container_id: int | None = None

    def stream(self) -> Iterator[Event]:
        """Yield the request's ChunkEvents, then its DoneEvent. Raises
        RuntimeError if the router closes while the request is in
        flight."""
        while True:
            while self._pending:
                ev = self._pending.popleft()
                yield ev
                if isinstance(ev, DoneEvent):
                    return
            if self.completion is not None:
                return                 # already fully consumed
            if self._router._closed:
                raise RuntimeError(f"router closed while request "
                                   f"{self.rid} was mid-stream")
            self._router._pump(block=True)

    def result(self) -> Completion:
        """Drain the stream; the Completion."""
        for _ in self.stream():
            pass
        return self.completion

    def tokens(self) -> list[int]:
        return list(self.result().tokens)


class Router:
    """Continuous admission over one ``ThreadBackend``-style backend."""

    def __init__(self, backend, *, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        if backend.device != dev:
            raise ValueError(f"backend serves on {backend.device}, router "
                             f"asked for {dev}")
        self.backend = backend
        self._closed = False
        self._handles: dict[int, CompletionHandle] = {}
        self._rid_cid: dict[int, int] = {}
        self._prompt_len: dict[int, int] = {}
        self._submit_t: dict[int, float] = {}
        # per-container multiset of in-flight admission buckets
        self._cid_buckets = [Counter() for _ in range(backend.capacity)]

    @property
    def in_flight(self) -> int:
        return len(self._handles)

    def _dispatch(self, req: Request) -> int:
        """Least-loaded container, ties toward a bucket hit."""
        load = self.backend.load
        bucket = _bucket(len(req.prompt))
        cid = min(range(self.backend.capacity),
                  key=lambda c: (load(c),
                                 0 if self._cid_buckets[c][bucket] else 1, c))
        self._cid_buckets[cid][bucket] += 1
        return cid

    def submit(self, req: Request) -> CompletionHandle:
        """Dispatch one request now; returns its handle immediately."""
        if self._closed:
            raise RuntimeError("router is closed")
        if req.rid in self._handles:
            raise ValueError(f"request id {req.rid} is already in flight")
        handle = CompletionHandle(req.rid, self)
        handle.container_id = cid = self._dispatch(req)
        self._handles[req.rid] = handle
        self._rid_cid[req.rid] = cid
        self._prompt_len[req.rid] = len(req.prompt)
        self._submit_t[req.rid] = time.perf_counter()
        self.backend.submit(cid, req)
        return handle

    def _forget(self, rid: int) -> None:
        cid = self._rid_cid.pop(rid)
        self._cid_buckets[cid][_bucket(self._prompt_len.pop(rid))] -= 1
        self._handles.pop(rid)
        self._submit_t.pop(rid)

    def _pump(self, block: bool = False) -> list[Event]:
        """Advance the backend and route its events to their handles; with
        ``block`` and nothing routed, nap briefly."""
        events = self.backend.poll()
        now = time.perf_counter()
        for ev in events:
            handle = self._handles.get(ev.rid)
            if handle is None:          # not submitted through this router
                continue
            handle._pending.append(ev)
            if isinstance(ev, ChunkEvent) and handle.ttfc_s is None:
                handle.ttfc_s = now - self._submit_t[ev.rid]
            elif isinstance(ev, DoneEvent):
                handle.completion = ev.completion
                self._forget(ev.rid)
        if block and not events:
            time.sleep(_IDLE_SLEEP_S)
        return events

    def poll(self) -> list[Event]:
        """Advance containers and route events; returns the routed batch."""
        return self._pump(block=False)

    def drain(self) -> None:
        """Pump until every in-flight request is done (unconsumed events
        stay on their handles)."""
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

"""``ThreadBackend`` — a fixed number of containers, one ServingEngine each,
in this process.

A port of the fixed-count path of ``repro.serving.backend.ThreadBackend``,
against the same request-level protocol the Router is written for::

    capacity                       # number of containers
    submit(cid, req)               # enqueue one request on a container
    poll() -> list[Event]          # advance + drain streamed events
    load(cid) -> int               # queued+active requests (dispatch)
    stats(cid) -> (busy_s, tokens) # cumulative counters
    drain() -> [...]               # run every container to idle
    close()

``poll`` advances every engine that has work by one macro-step — in
worker threads when more than one has work and ``concurrent`` is set
(each engine issues on its own CUDA stream; the threads share the
interpreter lock between PyTorch operations) — and returns the events
that materialised. This slice has no supervision: an engine whose step raises
is not respawned; ``poll`` joins every step and then re-raises the first
error.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.engine import (Completion, EngineConfig, Request,
                                        ServingEngine)
from repro_torch.serving.events import Event


class ThreadBackend:
    def __init__(self, model, params: dict, n_containers: int,
                 config: EngineConfig | None = None, *,
                 concurrent: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.capacity = n_containers
        self.concurrent = concurrent
        self.config = config or EngineConfig()
        self._events: deque[Event] = deque()   # append is GIL-atomic
        self._executor: ThreadPoolExecutor | None = None
        self.engines: list[ServingEngine] = []
        for cid in range(n_containers):
            eng = ServingEngine(model, params, self.config,
                                device=self.device)
            eng.container_id = cid
            eng.on_event = self._events.append
            self.engines.append(eng)

    def submit(self, cid: int, req: Request) -> None:
        self.engines[cid].submit(req)

    def poll(self) -> list[Event]:
        active = [eng for eng in self.engines if eng.has_work]
        if self.concurrent and len(active) > 1:
            if self._executor is None:
                # persistent workers: a stream polls once per macro-step
                self._executor = ThreadPoolExecutor(
                    max_workers=self.capacity,
                    thread_name_prefix="container-step")
            futures = [self._executor.submit(eng.step) for eng in active]
            errors = [f.exception() for f in futures]   # joins every step
            for e in errors:
                if e is not None:
                    raise e
        else:
            for eng in active:
                eng.step()
        for eng in self.engines:
            # streamed completions travel in DoneEvents; drop the engines'
            # done lists or a long stream accumulates them
            eng.done.clear()
        out: list[Event] = []
        while self._events:
            out.append(self._events.popleft())
        return out

    def load(self, cid: int) -> int:
        eng = self.engines[cid]
        return len(eng.queue) + sum(1 for s in eng.slots if s.active)

    def stats(self, cid: int) -> tuple[float, int]:
        eng = self.engines[cid]
        return eng.busy_s, eng.tokens_generated

    def drain(self) -> list[tuple[list[Completion], float, float, int]]:
        """Run every container to idle (in threads when ``concurrent``);
        per container ``(completions, wall_s, busy_s, tokens)``. Events
        emitted meanwhile are dropped — drain callers take completions."""
        out: list[Any] = [None] * self.capacity

        def run_one(cid: int) -> None:
            try:
                eng = self.engines[cid]
                t0 = time.perf_counter()
                busy0, toks0 = eng.busy_s, eng.tokens_generated
                comps = eng.run()
                out[cid] = (comps, time.perf_counter() - t0,
                            eng.busy_s - busy0,
                            eng.tokens_generated - toks0)
            except BaseException as e:  # carried across the thread join
                out[cid] = e

        if self.concurrent and self.capacity > 1:
            workers = [threading.Thread(target=run_one, args=(cid,),
                                        daemon=True)
                       for cid in range(self.capacity)]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
        else:
            for cid in range(self.capacity):
                run_one(cid)
        self._events.clear()
        for e in out:
            if isinstance(e, BaseException):
                raise e
        return out

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._events.clear()
        self.engines = []
        self.capacity = 0

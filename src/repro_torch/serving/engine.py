"""Continuous-batching serving engine with fused greedy multi-token decode.

A port of the dense path of ``repro.serving.engine.ServingEngine``. The
engine owns a dense KV cache of ``n_slots`` rows. Each ``step()`` admits
queued requests and then runs one fused decode chunk:

* **Admission** pops the queue head plus every queued request in the same
  prompt-length bucket (``PROMPT_BUCKETS``), up to the free slots,
  right-pads them into one (n, bucket) batch and prefills it in one call;
  per-row ``logits_at`` picks each prompt's last real position. The
  prefill rows are copied into their slots, and the greedy prefill sample
  is each request's first streamed chunk.
* **Decode** runs ``Model.decode_chunk`` for every active slot in
  lockstep. The chunk length is ``EngineConfig.chunk_tokens``, clamped by
  the shortest remaining budget and ``max_len`` headroom among active
  slots and rounded down to a power of two, so no step is wasted on a
  finished slot. The chunk's tokens and emitted counts come to the host in
  exactly ONE device-to-host transfer.

Events (``serving/events.py``) are emitted as the JAX engine emits them:
one ``ChunkEvent`` per request per macro-step and a ``DoneEvent`` per
completion, built from data already on the host.

On a CUDA device each engine issues its work on its own CUDA stream, so
the kernels of a ``ThreadBackend``'s engines may overlap on one card —
the GPU form of splitting one device's work across containers. Their
host work still shares the interpreter lock, and eager decode is
host-bound (see PERF.md), so today two threaded engines are slower than
the same two stepped in turn.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.cache import DenseCache
from repro_torch.serving.events import ChunkEvent, DoneEvent


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list
    prompt_len: int
    latency_s: float = 0.0


# THE prompt-length bucket table: the engine's padded batch admission and
# the router's bucket-aware dispatch must agree on it
PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, buckets=PROMPT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    # past the table: the next power of two
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Configuration of one ServingEngine over the dense cache: ``n_slots``
    private ``(max_len, ...)`` cache rows in ``dtype``; decode chunks of
    up to ``chunk_tokens`` steps."""
    n_slots: int = 4
    max_len: int = 512
    dtype: torch.dtype = torch.float32
    chunk_tokens: int = 32

    def __post_init__(self):
        if self.n_slots < 1 or self.max_len < 2 or self.chunk_tokens < 1:
            raise ValueError(f"invalid EngineConfig {self}")


@dataclasses.dataclass
class _Slot:
    active: bool = False
    rid: int = -1
    pos: int = 0                  # next position to write
    prompt_len: int = 0
    remaining: int = 0
    generated: list = dataclasses.field(default_factory=list)
    started: float = 0.0          # perf_counter stamp


class ServingEngine:
    # streaming hook: a backend sets ``on_event`` to receive the events and
    # ``container_id`` to stamp them
    on_event: Callable[[Any], None] | None = None
    container_id: int = 0

    def __init__(self, model, params: dict,
                 config: EngineConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine "
                             f"asked for {self.device}")
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, engine "
                             f"asked for {self.device}")
        self.config = config = config or EngineConfig()
        self.model = model
        self.params = params
        self.n_slots = config.n_slots
        self.max_len = config.max_len
        self.chunk_tokens = config.chunk_tokens
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # params were written on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            tree = model.init_cache(config.n_slots, config.max_len,
                                    config.dtype)
        self.cache_backend = DenseCache(tree, config.n_slots)
        self.slots = [_Slot() for _ in range(config.n_slots)]
        self.queue: deque[Request] = deque()
        self.done: list[Completion] = []
        self.steps = 0                # step() calls that found work
        self.chunks = 0               # fused decode chunks run
        self.tokens_generated = 0     # tokens emitted (prefill + decode)
        self.prefill_tokens_executed = 0  # real prompt positions prefilled
        self.busy_s = 0.0             # wall time spent inside step()

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ------------------------------------------------------------------
    def _emit_chunk(self, rid: int, tokens, now: float) -> None:
        if self.on_event is not None:
            self.on_event(ChunkEvent(rid, self.container_id,
                                     tuple(tokens), now))

    def _emit_done(self, comp: Completion, now: float) -> None:
        if self.on_event is not None:
            self.on_event(DoneEvent(comp.rid, self.container_id, comp, now))

    def submit(self, req: Request) -> None:
        if req.max_new_tokens <= 0:
            # zero-budget requests complete empty without touching the
            # device (a slot would emit the prefill sample)
            comp = Completion(req.rid, [], len(req.prompt))
            self.done.append(comp)
            self._emit_done(comp, time.perf_counter())
            return
        self.queue.append(req)

    def submit_many(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    # ------------------------------------------------------------------
    def _take_bucket(self, n_free: int) -> list[Request]:
        """Pop the head request plus every queued request in its bucket
        (keeping the queue order of the rest), up to ``n_free``."""
        key = _bucket(len(self.queue[0].prompt))
        take: list[Request] = []
        rest: deque[Request] = deque()
        while self.queue and len(take) < n_free:
            r = self.queue.popleft()
            (take if _bucket(len(r.prompt)) == key else rest).append(r)
        rest.extend(self.queue)
        self.queue = rest
        return take

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if not s.active]
        while free and self.queue:
            reqs = self._take_bucket(len(free))
            self._admit_batch([free.pop(0) for _ in reqs], reqs)

    def _admit_batch(self, slot_ids: list[int], reqs: list[Request]) -> None:
        n = len(reqs)
        bl = _bucket(len(reqs[0].prompt))
        padded = np.zeros((n, bl), np.int32)
        logits_idx = np.zeros((n,), np.int64)
        for j, r in enumerate(reqs):
            plen = len(r.prompt)
            padded[j, :plen] = r.prompt   # right-pad into the bucket
            logits_idx[j] = plen - 1
        src = self.model.init_cache(n, self.max_len, self.config.dtype)
        logits = self.model.prefill(
            self.params, torch.from_numpy(padded).to(self.device), src,
            logits_at=torch.from_numpy(logits_idx).to(self.device))
        self.cache_backend.insert(src, slot_ids)
        self.prefill_tokens_executed += sum(len(r.prompt) for r in reqs)
        first = torch.argmax(logits, dim=-1).cpu().numpy()
        now = time.perf_counter()
        for j, (i, r) in enumerate(zip(slot_ids, reqs)):
            self.slots[i] = _Slot(
                active=True, rid=r.rid, pos=len(r.prompt),
                prompt_len=len(r.prompt), remaining=r.max_new_tokens - 1,
                generated=[int(first[j])], started=now)
            self.tokens_generated += 1
            # the prefill sample is the request's first streamed chunk
            self._emit_chunk(r.rid, (int(first[j]),), now)
        for i in slot_ids:
            if self.slots[i].remaining <= 0:
                self._finish(i)

    def _finish(self, i: int) -> None:
        s = self.slots[i]
        now = time.perf_counter()
        comp = Completion(s.rid, s.generated, s.prompt_len, now - s.started)
        self.done.append(comp)
        self._emit_done(comp, now)
        self.slots[i] = _Slot()

    # ------------------------------------------------------------------
    def _decode_chunk(self, active: list[int]) -> None:
        """One fused macro-step over every active slot, then a single
        device-to-host transfer of the token block and emitted counts."""
        exact = max(1, min(
            self.chunk_tokens,
            min(self.slots[i].remaining for i in active),
            min(self.max_len - 1 - self.slots[i].pos for i in active)))
        # round down to a power of two: never a step past the shortest
        # budget, and the same few chunk lengths recur
        n_tokens = 1 << (exact.bit_length() - 1)
        state = np.zeros((4, self.n_slots), np.int32)  # tok, pos, rem, act
        for i in active:
            s = self.slots[i]
            state[:, i] = (s.generated[-1], s.pos, s.remaining, 1)
        dev = torch.from_numpy(state).to(self.device)
        block, emitted, _ = self.model.decode_chunk(
            self.params, self.cache_backend.tree,
            {"tokens": dev[0], "pos": dev[1], "remaining": dev[2],
             "active": dev[3].bool()},
            n_tokens, max_len=self.max_len)
        host = torch.cat([block, emitted[:, None]], dim=1).cpu().numpy()
        block, emitted = host[:, :-1], host[:, -1]
        now = time.perf_counter()
        for i in active:
            s = self.slots[i]
            c = int(emitted[i])
            new = block[i, :c].tolist()
            s.generated.extend(new)
            s.pos += c
            s.remaining -= c
            self.tokens_generated += c
            if new:
                self._emit_chunk(s.rid, new, now)
            if s.remaining <= 0 or s.pos >= self.max_len - 1:
                self._finish(i)
        self.chunks += 1

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One macro-iteration: admit, then one decode chunk. Returns
        whether the engine still has work."""
        if not self.has_work:
            return False
        self.steps += 1
        t0 = time.perf_counter()
        with self._on_stream():
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s.active]
            if active:
                self._decode_chunk(active)
        self.busy_s += time.perf_counter() - t0
        return self.has_work

    def run(self, max_steps: int = 10_000) -> list[Completion]:
        """Drive until idle (or ``max_steps`` ``step()`` calls for this
        call) and return the finished completions; exhausting the budget
        with work left warns."""
        start = self.steps
        while self.has_work and self.steps - start < max_steps:
            self.step()
        if self.has_work:
            n_active = sum(1 for s in self.slots if s.active)
            warnings.warn(
                f"ServingEngine.run() exhausted max_steps={max_steps} with "
                f"{len(self.queue)} queued and {n_active} active requests "
                "remaining; returning partial completions", RuntimeWarning,
                stacklevel=2)
        out, self.done = self.done, []
        return out

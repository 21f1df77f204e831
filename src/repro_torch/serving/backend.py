"""Container backends: a fixed number of containers, one ServingEngine
each, in this process (``ThreadBackend``) or one pinned OS process each
(``ProcessBackend``).

Ports of ``repro.serving.backend.ThreadBackend`` (its fixed-count path)
and ``ProcessBackend``, against the same request-level protocol the
Router is written for::

    capacity                       # number of containers
    submit(cid, req)               # enqueue one request on a container
    poll() -> list[Event]          # advance + drain streamed events
    load(cid) -> int               # queued+active requests (dispatch)
    stats(cid) -> (busy_s, tokens) # cumulative counters
    drain() -> [...]               # run every container to idle
    close()

``ContainerBackend`` is that protocol, JAX's, as a runtime-checkable
``Protocol``; both backends satisfy it.

``ThreadBackend.poll`` advances every engine that has work by one
macro-step — in worker threads when more than one has work and
``concurrent`` is set (each engine issues on its own CUDA stream; the
threads share the interpreter lock between PyTorch operations) — and
returns the events that materialised. It supervises its engines: an
engine whose step raises becomes a ``ContainerFailure`` in ``poll()``
carrying its queued and active request ids, and is rebuilt in place
while the respawn budget lasts (a circuit breaker after
``max_respawns``).

``ProcessBackend`` runs each engine in its own spawned process, pinned to
its own cores before it imports torch (``core/testbed.spawn_pinned``,
``serving/child.py``), so the containers' host work no longer shares one
interpreter lock. It supervises them: a dead, erroring or silent child
becomes a ``ContainerFailure`` in ``poll()`` carrying its lost request
ids, and is respawned without blocking the others (exponential backoff,
a circuit breaker after ``max_respawns``). On the card every child maps
the parent's one copy of the weights (CUDA IPC).
"""
from __future__ import annotations

import dataclasses
import gc
import inspect
import multiprocessing as mp
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core.testbed import assign_core_sets, spawn_pinned
from repro_torch.device import resolve_device
from repro_torch.serving.child import _serving_child
from repro_torch.serving.engine import (_CAPTURE_LOCK, Completion,
                                        EngineConfig, Request, ServingEngine)
from repro_torch.serving.events import (ContainerFailure, DoneEvent, Event,
                                        FailedEvent)
from repro_torch.serving.faults import (EXIT_FAULT_KILL, FaultInjector,
                                        FaultPlan, describe_exitcode)

_READY_POLL_S = 0.05
_IDLE_POLL_S = 0.05
# how long the parent waits for a child that reported a step error to exit
# with its classified code before terminating it; the join returns at the
# exit, so only a child that hangs on its way out costs the whole bound
# (a loaded host can take over a second to tear a torch process down)
_ERROR_EXIT_WAIT_S = 10.0


@runtime_checkable
class ContainerBackend(Protocol):
    """The request-level serving protocol (see module docstring).

    Supervising backends additionally expose an *optional* fault-
    tolerance surface the Router discovers with ``getattr`` (so minimal
    structural backends — test substrates — keep satisfying the
    protocol): ``alive(cid) -> bool`` (dispatchable right now — dead and
    respawning containers are excluded), ``cancel(cid, rid)`` (remove a
    request wherever it is and free its cache reservation), and a
    ``failures`` list of every ``ContainerFailure`` surfaced so far.
    ``poll()`` may interleave ``ContainerFailure`` records with the
    request events — it must NOT raise for a container-scoped failure,
    only for backend-wide invariant violations."""

    capacity: int

    def submit(self, cid: int, req: Request) -> None: ...

    def poll(self) -> list[Event]: ...

    def load(self, cid: int) -> int: ...

    def stats(self, cid: int) -> tuple[float, int]: ...

    def drain(self, concurrent: bool = True
              ) -> list[tuple[list[Completion], float, float, int]]: ...

    def close(self) -> None: ...


class ThreadBackend:
    """One ServingEngine per container in this process.

    Supervision, as in JAX: an engine whose ``step()`` raises is failed,
    not propagated. ``poll()`` joins every step, then puts a
    ``ContainerFailure(kind="error")`` with the engine's queued and active
    request ids into the event stream and, while the respawn budget lasts,
    rebuilds the engine in place over the same model and weights
    (incarnation bumped, so a ``FaultPlan`` scoped to incarnation 0 does
    not fire again). The dead engine, with its cache, its decode graph and
    its stream, is dropped before the new one is built, and the new one
    captures its own graph at its first chunk (under the engine's capture
    lock) while the other containers keep serving. ``rebuild_s[cid]`` is
    the last rebuild's seconds (the cache allocated, no capture yet).
    After ``max_respawns`` rebuilds the circuit breaker trips: ``alive``
    is False and ``submit`` raises. ``drain`` keeps the wave contract: it
    raises on a circuit-broken container or a failed step."""

    def __init__(self, model, params: dict, n_containers: int,
                 config: EngineConfig | None = None, *,
                 concurrent: bool = True,
                 fault_plan: FaultPlan | None = None,
                 max_respawns: int = 2,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.capacity = n_containers
        self.concurrent = concurrent
        self.config = config or EngineConfig()
        self.model = model
        self.params = params
        self.fault_plan = fault_plan
        self.max_respawns = max_respawns
        self._events: deque[Event] = deque()   # append is GIL-atomic
        self._executor: ThreadPoolExecutor | None = None
        self.failures: list[ContainerFailure] = []
        self._alive = [True] * n_containers
        self._respawns = [0] * n_containers
        self._incarnation = [0] * n_containers
        # a dead engine's busy seconds and tokens: stats() adds them, so
        # the counters stay monotone across a rebuild
        self._stats_base = [(0.0, 0)] * n_containers
        self.rebuild_s: list[float | None] = [None] * n_containers
        self.engines: list[ServingEngine] = [
            self._build_engine(cid, 0) for cid in range(n_containers)]

    def _build_engine(self, cid: int, incarnation: int) -> ServingEngine:
        eng = ServingEngine(self.model, self.params, self.config,
                            device=self.device)
        eng.container_id = cid
        eng.on_event = self._events.append
        if self.fault_plan is not None:
            inj = FaultInjector(self.fault_plan, cid, incarnation)
            eng.fault = inj if inj.armed else None
        return eng

    def _fail_container(self, cid: int, message: str) -> None:
        """Turn a failed step into a ContainerFailure event and rebuild
        the engine (bounded) or trip the breaker."""
        eng = self.engines[cid]
        lost = tuple(r.rid for r in eng.queue) + tuple(
            s.rid for s in eng.slots if s.active)
        fail = ContainerFailure(
            container_id=cid, kind="error",
            message=f"engine step raised:\n{message}",
            time_s=time.perf_counter(), lost_rids=lost)
        self.failures.append(fail)
        self._events.append(fail)
        base_b, base_t = self._stats_base[cid]
        self._stats_base[cid] = (base_b + eng.busy_s,
                                 base_t + eng.tokens_generated)
        if self._respawns[cid] >= self.max_respawns:
            self._alive[cid] = False
            return
        self._respawns[cid] += 1
        self._incarnation[cid] += 1
        # drop the dead engine (its cache, graph and stream) before the
        # new one allocates: nothing else holds it once the step's
        # traceback is gone
        self.engines[cid] = None
        del eng
        gc.collect()
        if self.device.type == "cuda":
            with _CAPTURE_LOCK:      # never beside another thread's capture
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self.engines[cid] = self._build_engine(cid, self._incarnation[cid])
        self.rebuild_s[cid] = time.perf_counter() - t0

    # -- supervision surface -------------------------------------------
    def alive(self, cid: int) -> bool:
        return self._alive[cid]

    def submit(self, cid: int, req: Request) -> None:
        if not self._alive[cid]:
            raise RuntimeError(f"container {cid} is circuit-broken "
                               f"(after {self._respawns[cid]} respawns)")
        self.engines[cid].submit(req)

    def submit_many(self, cid: int, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(cid, r)

    def _step_all(self) -> list[tuple[int, str]]:
        """One step of every live engine with work (in worker threads when
        more than one has work and ``concurrent`` is set), every step
        joined; ``(cid, traceback text)`` of each step that raised. The
        exceptions and their frames end here, so none keeps a dead engine
        alive."""
        active = [eng for cid, eng in enumerate(self.engines)
                  if self._alive[cid] and eng.has_work]
        if self.concurrent and len(active) > 1:
            if self._executor is None:
                # persistent workers: a stream polls once per macro-step
                self._executor = ThreadPoolExecutor(
                    max_workers=self.capacity,
                    thread_name_prefix="container-step")
            futures = [self._executor.submit(eng.step) for eng in active]
            errors = [f.exception() for f in futures]
        else:
            errors = []
            for eng in active:
                try:
                    eng.step()
                    errors.append(None)
                except BaseException as e:
                    errors.append(e)
        failed = []
        for eng, e in zip(active, errors):
            if e is not None:
                failed.append((eng.container_id, "".join(
                    traceback.format_exception(type(e), e,
                                               e.__traceback__))))
                seen = set()
                while e is not None and id(e) not in seen:
                    seen.add(id(e))
                    traceback.clear_frames(e.__traceback__)
                    e.__traceback__ = None
                    e = e.__cause__ or e.__context__
        return failed

    def poll(self) -> list[Event]:
        for cid, message in self._step_all():
            self._fail_container(cid, message)
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

    def cancel(self, cid: int, rid: int) -> None:
        """Drop ``rid`` from container ``cid`` (queued or mid-decode); a
        finished request, or a circuit-broken container, is a no-op."""
        if self._alive[cid]:
            self.engines[cid].cancel(rid)

    def stats(self, cid: int) -> tuple[float, int]:
        eng = self.engines[cid]
        base_b, base_t = self._stats_base[cid]
        return base_b + eng.busy_s, base_t + eng.tokens_generated

    def drain(self, concurrent: bool | None = None
              ) -> list[tuple[list[Completion], float, float, int]]:
        """Run every container to idle (in threads when ``concurrent``,
        the backend's setting unless given); per container
        ``(completions, wall_s, busy_s, tokens)``. Events
        emitted meanwhile are dropped — drain callers take completions.
        Waves have no per-request recovery: a circuit-broken container or
        a failed step raises."""
        dead = [cid for cid in range(self.capacity)
                if not self._alive[cid]]
        if dead:
            raise RuntimeError(
                f"cannot drain a wave: containers {dead} are "
                "circuit-broken (see backend.failures)")
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

        if concurrent is None:
            concurrent = self.concurrent
        if concurrent and self.capacity > 1:
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


# ---------------------------------------------------------------------------
# process backend
# ---------------------------------------------------------------------------
def _engine_config_wire(config: EngineConfig) -> dict:
    """EngineConfig as a dict of picklable primitives. Pickling the
    dataclass itself would make the child unpickle (hence import
    ``serving.engine``, hence torch) at process bootstrap — BEFORE
    ``spawn_pinned`` applies the cpuset — so the config crosses as plain
    fields with the dtype by name instead."""
    kw = dataclasses.asdict(config)
    kw["dtype"] = str(config.dtype).split(".")[-1]
    return kw


class ProcessBackend:
    """One pinned OS process per container (the paper's ``--cpus``
    shares), behind the streaming backend protocol. Children spawn at the
    first submit (or ``warm()``) and stay warm until ``close()``.

    Weights: pass ``params`` (the tree on ``device``; the parent keeps it
    alive, and each child, respawns included, receives it over its pipe
    after it has pinned itself and imported torch: CUDA tensors as IPC
    handles, so the card holds one copy), ``params_path`` (a ``.npz``
    written by ``repro_torch.params.save_params``, which each child loads
    onto its device through ``params.load_params``: a copy a child; keep
    the file while the backend lives) or ``params_seed`` (each child
    draws ``Model.init(params_seed, config.dtype)`` itself). The kernels
    are built in the parent before the first spawn, so children only
    load them. ``total_cores`` carves the first that many of the cores
    this process may use (default all of them), as in JAX.

    Submissions travel at the next ``poll()``, one message per container
    holding every request submitted to it since the last poll, and the
    child takes every message already in its pipe before it steps: the
    requests a caller submits between two polls are admitted together,
    as ``ThreadBackend``'s engines admit them at their next step.

    Supervision: a child that dies (exit code decoded by
    ``faults.describe_exitcode``), reports a step error, or goes silent
    past ``heartbeat_timeout_s`` is *failed*, not raised — ``poll``
    surfaces a ``ContainerFailure`` carrying its in-flight rids, and
    while the respawn budget lasts a replacement child is launched
    without blocking (exponential backoff; its handshake is promoted
    from later polls, so healthy containers keep serving through a
    respawn's torch import and engine build). After ``max_respawns``
    replacements a container's circuit breaker trips: ``alive()`` stays
    False and the Router routes around it. ``drain`` keeps the wave
    contract — any failure tears the wave down with an exception."""

    def __init__(self, cfg, n_containers: int,
                 config: EngineConfig | None = None, *,
                 params: dict | None = None,
                 params_seed: int | None = None,
                 params_path: str | None = None,
                 device: str | torch.device = "cuda",
                 total_cores: int | None = None,
                 allow_shared_cores: bool = False,
                 start_timeout_s: float = 600.0,
                 fault_plan: FaultPlan | None = None,
                 max_respawns: int = 2,
                 respawn_backoff_s: float = 0.25,
                 heartbeat_s: float = 0.5,
                 heartbeat_timeout_s: float | None = 60.0):
        self.device = resolve_device(device)
        if params_path is not None and params is not None:
            raise ValueError("pass params_path or params, not both")
        if sum(x is not None for x in (params, params_seed,
                                       params_path)) != 1:
            raise ValueError("pass params or params_seed (or params_path): "
                             "exactly one")
        if params is not None:
            table = params["embed"]["table"]
            if table.device != self.device:
                raise ValueError(f"params live on {table.device}, backend "
                                 f"asked for {self.device}")
        self.cfg = cfg
        self.capacity = n_containers
        self.config = config or EngineConfig()
        self.params = params
        self.params_seed = params_seed
        self.params_path = (None if params_path is None
                            else str(params_path))
        self.start_timeout_s = start_timeout_s
        self.fault_plan = fault_plan
        self.max_respawns = max_respawns
        self.respawn_backoff_s = respawn_backoff_s
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = (
            heartbeat_timeout_s if heartbeat_s > 0 else None)
        # fail fast, before any spawn: more containers than cores cannot
        # be disjoint (see core/testbed.assign_core_sets)
        self.core_sets = assign_core_sets(n_containers, total_cores,
                                          allow_shared=allow_shared_cores)
        self.reported_core_sets: list[frozenset[int]] | None = None
        # per container: the handshake's info (weight bytes, the child's
        # device memory after taking them, torch imported before the pin)
        # and the launch counts of its latest flush
        self.child_info: list[dict | None] = [None] * n_containers
        self._launches: list[dict] = [{} for _ in range(n_containers)]
        # workers[cid] is (proc, conn) while serving, None while dead or
        # respawning (the pending handshake lives in _spawning[cid])
        self.workers: list[tuple[Any, Any] | None] | None = None
        self._events: deque[Event] = deque()
        self.failures: list[ContainerFailure] = []
        # rid-sets, not counts: a lost container must say WHICH requests
        # died with it, and cancel() must be race-safe against a
        # completion already in the pipe
        self._inflight: list[set[int]] = [set() for _ in range(n_containers)]
        self._instant: list[set[int]] = [set() for _ in range(n_containers)]
        self._outbox: list[list[Request]] = [[] for _ in range(n_containers)]
        self._stats_reply: list[tuple | None] = [None] * n_containers
        self._senders: list[threading.Thread | None] = [None] * n_containers
        # the CUDA weights sent to each container's current child
        self._sent: list[list[_SentWeight]] = [[] for _ in range(n_containers)]
        self._reset_supervision()

    def _reset_supervision(self) -> None:
        n = self.capacity
        self._alive = [True] * n
        self._respawns = [0] * n
        self._incarnation = [0] * n
        self._backoff = [self.respawn_backoff_s] * n
        self._next_spawn = [0.0] * n
        self._spawning: list[tuple[Any, Any] | None] = [None] * n
        self._last_msg = [0.0] * n
        # child counters restart at zero each incarnation; stats() adds
        # the accumulated pre-failure base so window deltas stay monotone
        self._stats_child = [(0.0, 0)] * n
        self._stats_base = [(0.0, 0)] * n

    # -- lifecycle ------------------------------------------------------
    def warm(self) -> None:
        """Spawn and handshake the children now, so a caller can pay the
        spawn, torch import and engine build outside its timed region."""
        self._ensure_workers()

    def _spawn_one(self, cid: int, incarnation: int) -> tuple[Any, Any]:
        ctx = mp.get_context("spawn")
        return spawn_pinned(
            _serving_child, self.core_sets[cid],
            args=(cid, self.cfg, self.device.type,
                  _engine_config_wire(self.config), incarnation,
                  self.fault_plan, self.heartbeat_s, self.params_seed,
                  self.params_path),
            ctx=ctx)

    def _send_params(self, cid: int, conn) -> None:
        """Hand the weights to a child that has just been spawned, from a
        thread: the send blocks until the child, after its torch import,
        reads it, and meanwhile the other children start and the healthy
        containers keep being served. A child that never reads is caught
        by its handshake's timeout."""
        if self.params is None:
            return
        sent: list[_SentWeight] = []
        msg = ("params", _sendable(self.params, sent))
        self._sent[cid] = sent

        def send() -> None:
            try:
                conn.send(msg)
            except (BrokenPipeError, OSError):
                pass                # the child died: its handshake says so
        t = threading.Thread(target=send, daemon=True,
                             name=f"params-{cid}")
        t.start()
        self._senders[cid] = t

    def _ensure_workers(self) -> None:
        """Spawn and handshake every child once. The INITIAL spawn is
        fail-fast (blocking handshake, raise on any startup error) —
        supervision begins once a container has served."""
        if self.workers is not None:
            return
        if self.device.type == "cuda":
            # build (or load) the kernels here, once: the build's lock
            # covers threads, not processes
            from repro_torch.kernels.build import extension
            extension()
        if self.params is not None and self.device.type == "cpu":
            # move CPU weights into shared memory once, here, rather than
            # in each send
            _share_cpu(self.params)
        workers = [self._spawn_one(cid, 0) for cid in range(self.capacity)]
        reported, infos = [], []
        try:
            for cid, (proc, conn) in enumerate(workers):
                self._send_params(cid, conn)
            for cid, (proc, conn) in enumerate(workers):
                msg = self._recv(proc, conn, self.start_timeout_s)
                if msg[0] != "ready":
                    raise RuntimeError(
                        f"container {cid} failed to start:\n{msg[1]}")
                reported.append(frozenset(msg[1]))
                infos.append(msg[2])
        except BaseException:
            for cid, (proc, conn) in enumerate(workers):
                proc.terminate()
                proc.join(timeout=5)
                conn.close()
                self._release_weights(cid, proc.exitcode)
            raise
        self.workers = list(workers)
        self.reported_core_sets = reported
        self.child_info = infos
        self._reset_supervision()
        self._last_msg = [time.perf_counter()] * self.capacity

    @staticmethod
    def _recv(proc, conn, timeout_s: float | None):
        """recv that notices a dead child instead of blocking forever."""
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        while not conn.poll(_READY_POLL_S):
            if not proc.is_alive():
                raise RuntimeError(
                    f"container process died "
                    f"({describe_exitcode(proc.exitcode)}) before replying")
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError("container start/serve timed out")
        return conn.recv()

    def close(self) -> None:
        """Shut the children down (idempotent), including any respawn
        still mid-handshake — nothing may orphan."""
        if self.workers is None:
            return
        workers, self.workers = self.workers, None
        spawning = self._spawning
        self._events.clear()
        self._inflight = [set() for _ in range(self.capacity)]
        self._instant = [set() for _ in range(self.capacity)]
        self._outbox = [[] for _ in range(self.capacity)]
        self._reset_supervision()
        for w in workers:
            if w is None:
                continue
            try:
                w[1].send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for cid, w in enumerate(workers):
            if w is None:
                continue
            proc, conn = w
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            conn.close()
            self._release_weights(cid, proc.exitcode)
        for cid, sp in enumerate(spawning):
            if sp is None:
                continue
            proc, conn = sp
            proc.terminate()
            proc.join(timeout=5)
            conn.close()
            self._release_weights(cid, proc.exitcode)
        for t in self._senders:
            if t is not None:
                t.join(timeout=5)
        self._senders = [None] * self.capacity

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _release_weights(self, cid: int, exitcode: int | None) -> None:
        """Give back the CUDA IPC references of the weights sent to
        container ``cid``'s last child, once that child is gone, if it
        ended without Python's own shutdown (a signal, our terminate, an
        injected kill): such a child never gave them back, and torch would
        keep the parent's weights allocated after the parent frees them,
        until this process exits (and warn then). A child that exited
        through Python gave back its own (``child.py`` frees its weights
        at close); giving one back twice could free weights a later child
        maps. ``tests/test_torch_gpu.py::
        test_children_leave_no_weights_parked_in_the_parent`` measures it."""
        sent, self._sent[cid] = self._sent[cid], []
        if (exitcode is not None and exitcode >= 0
                and exitcode != EXIT_FAULT_KILL):
            return
        for leaf in sent:
            leaf.release()
        if sent:
            torch.cuda.ipc_collect()

    # -- supervision ----------------------------------------------------
    def alive(self, cid: int) -> bool:
        """Dispatchable right now. True before the first spawn (children
        are lazy); False while dead, respawning, or circuit-broken."""
        return self._alive[cid]

    def cancel(self, cid: int, rid: int) -> None:
        """Forget ``rid`` parent-side and ask the child to drop it. Safe
        against the race where its DoneEvent is already in the pipe: the
        rid is discarded (not asserted present), the child's cancel of a
        finished request is a no-op, and the stale DoneEvent is still
        delivered (the canceller's event routing must tolerate it)."""
        self._inflight[cid].discard(rid)
        self._instant[cid].discard(rid)
        queued = self._outbox[cid]
        if any(r.rid == rid for r in queued):
            self._outbox[cid] = [r for r in queued if r.rid != rid]
            return
        w = self.workers[cid] if self.workers is not None else None
        if w is not None and self._alive[cid]:
            try:
                w[1].send(("cancel", rid))
            except (BrokenPipeError, OSError):
                pass                    # death is _pump's to notice

    def _fail(self, cid: int, kind: str, message: str,
              exitcode: int | None = None) -> None:
        """Record one container failure: reap the child (one that reported
        a step error gets a moment to exit with its classified code),
        emit the typed event (with the lost rids and the exit code), fold
        the dead incarnation's counters into the stats base, and schedule
        a bounded respawn."""
        now = time.perf_counter()
        w = self.workers[cid] if self.workers is not None else None
        if w is not None:
            proc, conn = w
            self.workers[cid] = None
            try:
                conn.close()
            except OSError:
                pass
            if kind == "error":
                # the child reported and is exiting by itself: let its
                # classified exit code land before reaping
                proc.join(timeout=_ERROR_EXIT_WAIT_S)
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=5)
            self._release_weights(cid, proc.exitcode)
            if exitcode is None and kind == "error":
                exitcode = proc.exitcode
        lost = tuple(sorted(self._inflight[cid]))
        self._inflight[cid] = set()
        self._instant[cid] = set()
        self._outbox[cid] = []
        base_b, base_t = self._stats_base[cid]
        child_b, child_t = self._stats_child[cid]
        self._stats_base[cid] = (base_b + child_b, base_t + child_t)
        self._stats_child[cid] = (0.0, 0)
        fail = ContainerFailure(
            container_id=cid, kind=kind,
            message=f"container {cid} {kind}: {message}",
            time_s=now, exitcode=exitcode, lost_rids=lost)
        self.failures.append(fail)
        self._events.append(fail)
        self._alive[cid] = False
        if self._respawns[cid] < self.max_respawns:
            self._next_spawn[cid] = now + self._backoff[cid]
            self._backoff[cid] = min(self._backoff[cid] * 2, 30.0)

    def _record_start_failure(self, cid: int, detail: str,
                              exitcode: int | None) -> None:
        now = time.perf_counter()
        fail = ContainerFailure(
            container_id=cid, kind="start",
            message=f"container {cid} respawn failed to start: {detail}",
            time_s=now, exitcode=exitcode, lost_rids=())
        self.failures.append(fail)
        self._events.append(fail)
        self._next_spawn[cid] = now + self._backoff[cid]
        self._backoff[cid] = min(self._backoff[cid] * 2, 30.0)

    def _service_respawns(self) -> None:
        """Non-blocking respawn driver, run on every pump: launch
        replacements whose backoff expired, promote pending handshakes
        that completed — healthy containers never wait on a respawning
        one's torch import and engine build."""
        if self.workers is None:
            return
        now = time.perf_counter()
        for cid in range(self.capacity):
            if self._alive[cid]:
                continue
            sp = self._spawning[cid]
            if sp is not None:
                proc, conn = sp
                msg = None
                try:
                    if conn.poll(0):
                        msg = conn.recv()
                except (EOFError, OSError):
                    msg = ("error", "handshake pipe closed")
                if msg is not None and msg[0] == "ready":
                    self._spawning[cid] = None
                    self.workers[cid] = (proc, conn)
                    if self.reported_core_sets is not None:
                        self.reported_core_sets[cid] = frozenset(msg[1])
                    self.child_info[cid] = msg[2]
                    self._alive[cid] = True
                    self._last_msg[cid] = now
                    self._backoff[cid] = self.respawn_backoff_s
                elif msg is not None or not proc.is_alive():
                    self._spawning[cid] = None
                    detail = (msg[1] if msg is not None
                              else describe_exitcode(proc.exitcode))
                    exitcode = proc.exitcode
                    if proc.is_alive():
                        proc.terminate()
                    proc.join(timeout=5)
                    try:
                        conn.close()
                    except OSError:
                        pass
                    self._release_weights(cid, proc.exitcode)
                    self._record_start_failure(cid, detail, exitcode)
                continue
            if (self._respawns[cid] >= self.max_respawns
                    or now < self._next_spawn[cid]):
                continue                # circuit-broken, or backing off
            self._respawns[cid] += 1
            self._incarnation[cid] += 1
            sp = self._spawn_one(cid, self._incarnation[cid])
            self._spawning[cid] = sp
            self._send_params(cid, sp[1])

    # -- streaming ------------------------------------------------------
    def submit(self, cid: int, req: Request) -> None:
        self.submit_many(cid, [req])

    def submit_many(self, cid: int, reqs: Sequence[Request]) -> None:
        """Queue requests for container ``cid``; they travel at the next
        ``poll()`` (or ``drain()``), together with every other request
        queued for it meanwhile, in one message."""
        if not reqs:
            return
        self._ensure_workers()
        if not self._alive[cid]:
            raise RuntimeError(
                f"container {cid} is not serving (dead, respawning or "
                "circuit-broken — check alive() before dispatch)")
        # inflight BEFORE send: if the pipe breaks the rids ride the
        # ContainerFailure's lost_rids and the Router's normal retry path
        # recovers them — no separate submit-error path
        self._inflight[cid].update(r.rid for r in reqs)
        # a zero-budget request completes at its engine's submit, never
        # queueing: it does not count toward load(), as in ThreadBackend
        self._instant[cid].update(r.rid for r in reqs
                                  if r.max_new_tokens <= 0)
        self._outbox[cid].extend(reqs)

    def _send_outbox(self) -> None:
        if self.workers is None:
            return
        for cid, reqs in enumerate(self._outbox):
            if not reqs:
                continue
            self._outbox[cid] = []
            w = self.workers[cid]
            if w is None or not self._alive[cid]:
                continue                # lost with the container already
            try:
                w[1].send(("submit", reqs))
            except (BrokenPipeError, OSError) as e:
                self._fail(cid, "dead", f"submit pipe broke: {e}")

    def _route_ready(self, cid: int, conn) -> bool:
        """Drain every buffered message from one serving child. Never
        raises: a closed pipe just ends the drain (death is the liveness
        scan's to classify, with the exit code in hand)."""
        got = False
        while True:
            try:
                if not conn.poll(0):
                    return got
                msg = conn.recv()
            except (EOFError, OSError):
                return got
            got = True
            self._last_msg[cid] = time.perf_counter()
            if msg[0] == "hb":
                continue
            if msg[0] == "error":
                self._fail(cid, "error",
                           f"engine step raised:\n{msg[1]}")
                return got
            if msg[0] == "stats":
                self._launches[cid] = msg[1]
                self._stats_reply[cid] = (msg[1], msg[2])
                continue
            _, events, busy, toks, launches = msg
            self._stats_child[cid] = (busy, toks)
            self._launches[cid] = launches
            for ev in events:
                if isinstance(ev, (DoneEvent, FailedEvent)):
                    self._inflight[cid].discard(ev.rid)
                    self._instant[cid].discard(ev.rid)
                self._events.append(ev)

    def _pump(self, block_s: float = 0.0) -> bool:
        """Send queued submissions, then drain every ready child message
        into the event buffer; with ``block_s`` wait up to that long for
        the first one. Container failures (death, step error, heartbeat
        silence) become ``ContainerFailure`` events in the buffer — never
        exceptions — and replacements are serviced, all without blocking
        healthy containers."""
        if self.workers is None:
            return False
        self._service_respawns()
        self._send_outbox()
        conn_map = {w[1]: cid for cid, w in enumerate(self.workers)
                    if w is not None and self._alive[cid]}
        if conn_map and block_s > 0:
            from multiprocessing.connection import wait as conn_wait
            conn_wait(list(conn_map), block_s)
        got = False
        for conn, cid in list(conn_map.items()):
            got |= self._route_ready(cid, conn)
        now = time.perf_counter()
        for cid in range(self.capacity):
            w = self.workers[cid]
            if w is None or not self._alive[cid]:
                continue
            proc, conn = w
            if not proc.is_alive():
                # the child may have flushed replies (even its "error"
                # report) right before dying — consume them first so no
                # completed request is counted lost
                self._route_ready(cid, conn)
                if self._alive[cid]:
                    self._fail(
                        cid, "dead",
                        "child process exited mid-serve "
                        f"({describe_exitcode(proc.exitcode)}) with "
                        f"{len(self._inflight[cid])} requests in flight",
                        exitcode=proc.exitcode)
            elif (self.heartbeat_timeout_s is not None
                  and now - self._last_msg[cid] > self.heartbeat_timeout_s):
                self._fail(
                    cid, "hung",
                    f"no message for {now - self._last_msg[cid]:.1f}s "
                    f"(heartbeat timeout {self.heartbeat_timeout_s:g}s)")
        return got

    def poll(self) -> list[Event]:
        self._pump()
        out = list(self._events)
        self._events.clear()
        return out

    def load(self, cid: int) -> int:
        """Requests queued or decoding in container ``cid`` (in flight,
        zero-budget ones left out), the Router's dispatch key."""
        return len(self._inflight[cid]) - len(self._instant[cid])

    def stats(self, cid: int) -> tuple[float, int]:
        base_b, base_t = self._stats_base[cid]
        child_b, child_t = self._stats_child[cid]
        return base_b + child_b, base_t + child_t

    def launch_counts(self, cid: int) -> dict:
        """Container ``cid``'s kernel launches, as its latest flush or
        stats reply reported them (its current incarnation's)."""
        return dict(self._launches[cid])

    def child_stats(self, reset: bool = False,
                    timeout_s: float = 60.0) -> list[tuple[dict, dict]]:
        """Ask every serving child for its ``(launch_counts, memory)`` now
        (after a synchronize on its device; ``memory`` also holds its
        engine's ``graph_capture_s`` and ``graph_pool_bytes``) and wait
        for the replies, routing any other message as ``poll`` would;
        with ``reset`` each child then sets its counts to 0. Raises if a
        child does not reply within ``timeout_s``."""
        self._ensure_workers()
        cids = [cid for cid in range(self.capacity) if self._alive[cid]]
        for cid in cids:
            self._stats_reply[cid] = None
            self.workers[cid][1].send(("stats", reset))
        deadline = time.perf_counter() + timeout_s
        while any(self._stats_reply[cid] is None and self._alive[cid]
                  for cid in cids):
            if time.perf_counter() > deadline:
                raise TimeoutError("a container did not answer a stats "
                                   "request")
            self._pump(block_s=_IDLE_POLL_S)
        out = []
        for cid in range(self.capacity):
            reply = self._stats_reply[cid] if cid in cids else None
            out.append(reply if reply is not None else ({}, {}))
            if reset and reply is not None:
                self._launches[cid] = {}
        return out

    @property
    def outstanding(self) -> int:
        return sum(len(s) for s in self._inflight)

    # -- wave shim ------------------------------------------------------
    def drain(self) -> list[tuple[list[Completion], float, float, int]]:
        """Pump until every in-flight request completed; per container
        ``(completions, wall_s, busy_s, tokens)`` measured from this
        call's entry. Waves have no per-request recovery: any
        ``ContainerFailure`` surfaced while draining tears the wave down
        with an exception (children closed) instead of hanging on
        requests that died with their container."""
        n_fail0 = len(self.failures)
        stats0 = [self.stats(cid) for cid in range(self.capacity)]
        t0 = time.perf_counter()
        comps: list[list[Completion]] = [[] for _ in range(self.capacity)]
        last = [t0] * self.capacity
        pending = list(self._events)
        self._events.clear()
        while True:
            for ev in pending:
                if isinstance(ev, DoneEvent):
                    comps[ev.container_id].append(ev.completion)
                    last[ev.container_id] = time.perf_counter()
            if len(self.failures) > n_fail0:
                fail = self.failures[-1]
                self.close()
                raise RuntimeError(f"wave failed: {fail.message}")
            if self.outstanding <= 0:
                break
            self._pump(block_s=_IDLE_POLL_S)
            pending = list(self._events)
            self._events.clear()
        return [(comps[cid], last[cid] - t0,
                 self.stats(cid)[0] - stats0[cid][0],
                 self.stats(cid)[1] - stats0[cid][1])
                for cid in range(self.capacity)]


class _SentWeight:
    """One CUDA weight as ``torch.multiprocessing`` reduces it for another
    process: pickling this object pickles that ``(rebuild, args)`` pair,
    so the child unpickles the tensor itself, mapped over a CUDA IPC
    handle. It keeps the share's reference counter, which the child gives
    back when it frees the tensor, for ``release`` when it cannot."""

    def __init__(self, tensor: torch.Tensor):
        from torch.multiprocessing.reductions import reduce_tensor
        self._reduced = reduce_tensor(tensor)

    def __reduce__(self):
        return self._reduced

    def release(self) -> None:
        rebuild, args = self._reduced
        a = inspect.signature(rebuild).bind(*args).arguments
        if a["ref_counter_handle"] is not None:
            a["storage_cls"]._release_ipc_counter(
                a["ref_counter_handle"], a["ref_counter_offset"],
                device=a["storage_device"])


def _sendable(tree, sent: list):
    """The weight tree as it goes to a child: CUDA leaves as
    ``_SentWeight`` (appended to ``sent``), CPU leaves as they are (in
    shared memory, see ``_share_cpu``)."""
    if isinstance(tree, dict):
        return {k: _sendable(v, sent) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sendable(v, sent) for v in tree]
    if tree.device.type != "cuda":
        return tree
    leaf = _SentWeight(tree)
    sent.append(leaf)
    return leaf


def _share_cpu(tree) -> None:
    """Move every CPU tensor of a weight tree into shared memory, in place
    (``Tensor.share_memory_``), so each send to a child only passes file
    descriptors."""
    if isinstance(tree, dict):
        for v in tree.values():
            _share_cpu(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _share_cpu(v)
    else:
        tree.share_memory_()

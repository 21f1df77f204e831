"""The port's process containers: ``Router`` → ``ProcessBackend`` → pinned
child → ``ServingEngine``, on the CPU, against the JAX package.

Weights come from the JAX model's seeded init through
``repro_torch.params.from_numpy`` (qwen3-0.6b-reduced, float32); requests
from a seeded numpy generator. The children run with ``device="cpu"``
and receive the weights over their pipe (CPU tensors in shared memory),
the path the card takes with CUDA IPC handles.

Mirrors, for the port: the process Router's greedy completions equal the
JAX Router's (tests/test_streaming.py), close mid-stream raises instead
of hanging, an injected kill is respawned and its requests retried
bit-correct, a step error reports a classified exit, the circuit breaker
trips to a typed ``FailedEvent`` (tests/test_chaos.py), the
``FaultPlan``/``FaultInjector`` units, the engine's cancel and fault
hooks, and the import closure of what a spawned child unpickles before it
pins itself (the counterpart of ``repro.analysis.wire``).

Every wait on a child is bounded (``_finish``, the backend's start
timeout), so a hang fails its own test instead of stalling the run.
"""
from __future__ import annotations

import dataclasses
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.testbed import (_pinned_main,  # noqa: E402
                                      assign_core_sets)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import (ProcessBackend,  # noqa: E402
                                         ThreadBackend, _engine_config_wire)
from repro_torch.serving.child import _serving_child  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.events import (ChunkEvent, ContainerFailure,  # noqa: E402
                                        DoneEvent, FailedEvent, RetryEvent)
from repro_torch.serving.faults import (EXIT_FAULT_KILL,  # noqa: E402
                                        EXIT_STEP_ERROR, Fault,
                                        FaultInjector, FaultPlan,
                                        InjectedFault, describe_exitcode)
from repro_torch.serving.router import RequestFailed, Router  # noqa: E402

ARCH = "qwen3-0.6b-reduced"
SLOTS, MAX_LEN, CHUNK = 2, 64, 4
TIMEOUT_S = 120.0          # any one wait on the children
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _specs(plens_max_new, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _config(**kw):
    return EngineConfig(n_slots=SLOTS, max_len=MAX_LEN,
                        chunk_tokens=kw.pop("chunk_tokens", CHUNK), **kw)


def _backend(pair, n, **kw):
    tm, tp = pair[2], pair[3]
    config = kw.pop("config", None) or _config()
    kw.setdefault("start_timeout_s", TIMEOUT_S)
    return ProcessBackend(tm.cfg, n, config, params=tp, device="cpu",
                          allow_shared_cores=True, **kw)


def _finish(router, handles, timeout_s=TIMEOUT_S):
    """Pump until every handle reached its terminal event, or fail."""
    deadline = time.perf_counter() + timeout_s
    while not all(h.done for h in handles):
        assert time.perf_counter() < deadline, "requests never finished"
        router._pump(block=True)


def _reaped(backend):
    """close() joins every child, respawns included."""
    backend.close()
    assert backend.workers is None


def _jax_tokens(pair, specs, n=2):
    jm, jp = pair[0], pair[1]
    with jrouter.Router(jbackend.ThreadBackend(
            jm, jp, n, config=jeng.EngineConfig(
                n_slots=SLOTS, max_len=MAX_LEN,
                chunk_tokens=CHUNK))) as jr:
        handles = [jr.submit(jeng.Request(i, p, mn)) for i, p, mn in specs]
        return ({h.rid: h.tokens() for h in handles},
                [h.container_id for h in handles])


SPECS = [(6, 3), (9, 4), (5, 2), (20, 7), (6, 1), (3, 0), (40, 5), (7, 6)]


# ---------------------------------------------------------------------------
# Router over process containers against the JAX Router
# ---------------------------------------------------------------------------
def test_process_router_matches_jax_router(pair):
    specs = _specs(SPECS, seed=1)
    want, want_cids = _jax_tokens(pair, specs)
    backend = _backend(pair, 2)
    with Router(backend, device="cpu") as router:
        handles = [router.submit(Request(i, p, mn)) for i, p, mn in specs]
        assert [h.container_id for h in handles] == want_cids
        _finish(router, handles)
        got = {h.rid: h.tokens() for h in handles}
        assert got == want
        # the children ran pinned to disjoint cores, torch imported after
        # the pin, and took the parent's weights
        sets = backend.reported_core_sets
        assert sets == backend.core_sets and not (sets[0] & sets[1])
        for info in backend.child_info:
            assert info["torch_preloaded"] is False
            assert info["weight_bytes"] == sum(
                t.nbytes for t in _leaves(pair[3]))
        # on the CPU no kernel launches, and the children say so
        for counts, memory in backend.child_stats():
            assert counts and not any(counts.values())
            assert memory["memory_allocated"] == 0
        # warm children: a second round matches too
        again = [router.submit(Request(i + 100, p, mn))
                 for i, p, mn in specs]
        _finish(router, again)
        assert {h.rid - 100: h.tokens() for h in again} == want
    _reaped(backend)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_process_router_streams_concatenate_and_equal_threads(pair):
    """Streamed chunks concatenate to the completion, and the process
    containers give the thread containers' streams at the same dispatch
    (all requests submitted before the first poll)."""
    specs = _specs([(6, 5), (9, 4), (5, 0), (12, 3), (7, 2)], seed=2)
    tm, tp = pair[2], pair[3]
    with Router(ThreadBackend(tm, tp, 2, _config(), device="cpu"),
                device="cpu") as tr:
        th = [tr.submit(Request(i, p, mn)) for i, p, mn in specs]
        want = {h.rid: h.tokens() for h in th}
    backend = _backend(pair, 2)
    with Router(backend, device="cpu") as router:
        handles = [router.submit(Request(i, p, mn)) for i, p, mn in specs]
        _finish(router, handles)
        for h, (_, _, mn) in zip(handles, specs):
            evs = list(h.stream())
            assert isinstance(evs[-1], DoneEvent)
            assert all(isinstance(e, ChunkEvent) for e in evs[:-1])
            streamed = [t for e in evs[:-1] for t in e.tokens]
            assert streamed == h.result().tokens == want[h.rid]
            assert len(streamed) == mn
        assert router.in_flight == 0
    _reaped(backend)


def test_params_seed_children_draw_the_ports_init(pair):
    """``params_seed``: each child runs ``Model.init(seed, dtype)``, so it
    serves what a ThreadBackend over that init serves."""
    tm = pair[2]
    params = tm.init(seed=3)
    specs = _specs([(6, 3), (11, 4)], seed=4)
    with Router(ThreadBackend(tm, params, 1, _config(), device="cpu"),
                device="cpu") as tr:
        want = {h.rid: h.tokens()
                for h in [tr.submit(Request(*s)) for s in specs]}
    backend = ProcessBackend(tm.cfg, 1, _config(), params_seed=3,
                             device="cpu", start_timeout_s=TIMEOUT_S)
    with Router(backend, device="cpu") as router:
        handles = [router.submit(Request(*s)) for s in specs]
        _finish(router, handles)
        assert {h.rid: h.tokens() for h in handles} == want
    _reaped(backend)


def test_process_backend_drain_stats_and_counts(pair):
    """The wave surface: requests submitted to given containers, drained
    to per-container completions with their busy time and tokens; the
    children's flushes carry their (here zero) launch counts."""
    specs = _specs([(6, 3), (9, 2), (5, 4)], seed=8)
    want, _ = _jax_tokens(pair, specs, n=1)
    backend = _backend(pair, 2)
    backend.warm()
    backend.submit(0, Request(*specs[0]))
    backend.submit_many(1, [Request(*s) for s in specs[1:]])
    assert (backend.load(0), backend.load(1)) == (1, 2)
    out = backend.drain()
    assert sorted(c.rid for c in out[1][0]) == [1, 2]
    got = {c.rid: list(c.tokens) for comps, *_ in out for c in comps}
    assert got == want
    assert out[1][3] == 6 and backend.stats(1)[1] == 6
    assert out[0][2] > 0 and backend.outstanding == 0
    counts = backend.launch_counts(1)
    assert "rmsnorm" in counts and not any(counts.values())
    _reaped(backend)


def test_close_mid_stream_raises_instead_of_hanging(pair):
    backend = _backend(pair, 1, config=_config(chunk_tokens=1))
    router = Router(backend, device="cpu")
    h = router.submit(Request(0, np.arange(6, dtype=np.int32), 40))
    stream = h.stream()
    assert isinstance(next(stream), ChunkEvent)
    procs = [proc for proc, _ in backend.workers]
    router.close()
    for proc in procs:
        proc.join(timeout=15)
        assert not proc.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        for _ in stream:
            pass


# ---------------------------------------------------------------------------
# supervision: kill / respawn / retry, step errors, the circuit breaker
# ---------------------------------------------------------------------------
def test_kill_fault_respawns_and_retries_bit_correct(pair):
    """Kill container 1 (incarnation 0 only) mid-stream: its requests ride
    a RetryEvent to container 0, every completion equals the fault-free
    run, the failure carries the injected exit code, and the respawned
    incarnation serves bit-correct."""
    specs = _specs([(6, 4), (9, 4), (5, 4), (7, 4)], seed=29)
    want, _ = _jax_tokens(pair, specs)
    plan = FaultPlan((Fault("kill", container_id=1, after_steps=1),))
    backend = _backend(pair, 2, config=_config(chunk_tokens=1),
                       fault_plan=plan, respawn_backoff_s=0.05)
    with Router(backend, max_retries=2, device="cpu") as router:
        handles = [router.submit(Request(i, p, mn)) for i, p, mn in specs]
        _finish(router, handles)
        events = {h.rid: list(h.stream()) for h in handles}
        assert {h.rid: list(h.completion.tokens) for h in handles} == want
        fails = [f for f in router.container_failures if f.kind == "dead"]
        assert len(fails) == 1 and fails[0].container_id == 1
        assert fails[0].exitcode == EXIT_FAULT_KILL
        assert "injected fault kill" in fails[0].message
        retried = {rid for rid, evs in events.items()
                   if any(isinstance(e, RetryEvent) for e in evs)}
        assert set(fails[0].lost_rids) == retried and retried
        for rid in retried:
            evs = events[rid]
            k = max(i for i, e in enumerate(evs)
                    if isinstance(e, RetryEvent))
            assert evs[k].container_id == 0 and evs[k].attempt == 1
            after = [t for e in evs[k + 1:-1] for t in e.tokens]
            assert after == want[rid]
        assert router.retry_total == len(retried)
        # the respawn lands without blocking, then serves (fault was inc 0)
        deadline = time.perf_counter() + TIMEOUT_S
        while not backend.alive(1):
            assert time.perf_counter() < deadline, "respawn never landed"
            router.poll()
            time.sleep(0.02)
        assert backend.child_info[1]["torch_preloaded"] is False
        rid, prompt, mn = specs[1]
        backend.submit(1, Request(50, prompt.copy(), mn))
        done = {}
        deadline = time.perf_counter() + TIMEOUT_S
        while 50 not in done:
            assert time.perf_counter() < deadline, "respawn never served"
            for ev in backend.poll():
                if isinstance(ev, DoneEvent):
                    done[ev.rid] = list(ev.completion.tokens)
            time.sleep(0.01)
        assert done[50] == want[rid]
    _reaped(backend)


def test_step_error_reports_a_classified_exit(pair):
    """An engine error in the child crosses the pipe as a typed 'error'
    failure, traceback included, and the child exits with the step-error
    code; with no respawn and no retry the request fails typed."""
    plan = FaultPlan((Fault("error", container_id=0),))
    backend = _backend(pair, 1, fault_plan=plan, max_respawns=0)
    with Router(backend, max_retries=0, device="cpu") as router:
        h = router.submit(Request(0, np.arange(6, dtype=np.int32), 4))
        _finish(router, [h])
        with pytest.raises(RequestFailed, match="injected fault: error"):
            h.result()
        fail = router.container_failures[0]
        assert fail.kind == "error" and fail.lost_rids == (0,)
        assert fail.exitcode == EXIT_STEP_ERROR
        assert "InjectedFault" in fail.message
        assert not backend.alive(0)
    _reaped(backend)


def test_circuit_breaker_trips_to_a_typed_failure(pair):
    """Kill every incarnation at its first step: the request fails typed
    once no healthy container is left, the one respawn is killed in turn,
    and then the breaker keeps the container out of dispatch for good."""
    plan = FaultPlan((Fault("kill", container_id=0, incarnation=None),))
    backend = _backend(pair, 1, fault_plan=plan, max_respawns=1,
                       respawn_backoff_s=0.05)
    prompt = np.arange(6, dtype=np.int32)
    with Router(backend, max_retries=3, device="cpu") as router:
        h = router.submit(Request(0, prompt, 4))
        _finish(router, [h])
        with pytest.raises(RequestFailed) as ei:
            h.result()
        assert ei.value.event.kind == "container"
        assert "no healthy container" in ei.value.event.reason
        deadline = time.perf_counter() + TIMEOUT_S
        while not backend.alive(0):
            assert time.perf_counter() < deadline, "respawn never landed"
            router.poll()
            time.sleep(0.02)
        h = router.submit(Request(1, prompt, 4))
        _finish(router, [h])
        with pytest.raises(RequestFailed):
            h.result()
        assert [f.kind for f in router.container_failures] == ["dead"] * 2
        for _ in range(20):            # no further respawn is scheduled
            router.poll()
            time.sleep(0.02)
        assert not backend.alive(0) and backend._spawning[0] is None
        h = router.submit(Request(2, prompt, 4))
        assert h.done and isinstance(h.failure, FailedEvent)
        with pytest.raises(RequestFailed, match="no healthy container"):
            h.result()
        with pytest.raises(RuntimeError, match="not serving"):
            backend.submit(0, Request(3, prompt, 4))
    _reaped(backend)


def test_router_cancel_frees_the_request_in_its_container(pair):
    specs = _specs([(6, 30), (7, 3)], seed=5)
    backend = _backend(pair, 1, config=_config(chunk_tokens=1))
    with Router(backend, device="cpu") as router:
        h0, h1 = (router.submit(Request(*s)) for s in specs)
        router.poll()                   # both sent: the child cancels
        assert router.cancel(0)
        assert not router.cancel(0)
        with pytest.raises(RequestFailed) as ei:
            h0.result()
        assert ei.value.event.kind == "cancelled"
        _finish(router, [h1])
        assert len(h1.result().tokens) == 3
        assert backend.load(0) == 0 and router.in_flight == 0
    _reaped(backend)


def test_router_drops_events_of_an_abandoned_attempt():
    """A late event from the container a request was retried away from
    never reaches the retried stream."""

    class Scripted:
        device = torch.device("cpu")
        capacity = 2

        def __init__(self):
            self.submitted, self.tape, self.dead = [], [], set()

        def alive(self, cid):
            return cid not in self.dead

        def submit(self, cid, req):
            self.submitted.append((cid, req.rid))

        def load(self, cid):
            return 0

        def poll(self):
            return self.tape.pop(0) if self.tape else []

        def close(self):
            pass

    be = Scripted()
    router = Router(be, device="cpu")
    h = router.submit(Request(7, np.arange(4, dtype=np.int32), 2))
    assert be.submitted == [(0, 7)]
    be.dead.add(0)
    be.tape = [[ContainerFailure(0, "dead", "container 0 dead: x", 0.0,
                                 lost_rids=(7,))],
               [ChunkEvent(7, 0, (1,), 0.0),
                DoneEvent(7, 0, "stale", 0.0)],
               [ChunkEvent(7, 1, (5,), 0.0),
                DoneEvent(7, 1, "fresh", 0.0)]]
    router.poll()
    assert be.submitted[-1] == (1, 7) and h.attempts == 1
    router.poll()
    assert h.completion is None
    router.poll()
    assert h.completion == "fresh"
    evs = list(h.stream())
    assert [type(e) for e in evs] == [RetryEvent, ChunkEvent, DoneEvent]
    assert evs[1].tokens == (5,)


def test_thread_backend_router_cancel(pair):
    tm, tp = pair[2], pair[3]
    specs = _specs([(6, 20), (9, 3)], seed=6)
    with Router(ThreadBackend(tm, tp, 1, _config(chunk_tokens=1),
                              device="cpu"), device="cpu") as router:
        h0, h1 = (router.submit(Request(*s)) for s in specs)
        router.poll()
        assert router.cancel(0)
        assert len(h1.result().tokens) == 3
        eng = router.backend.engines[0]
        assert not eng.has_work and router.backend.load(0) == 0


# ---------------------------------------------------------------------------
# the engine's cancel and fault hooks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_cancel_queued_and_mid_decode(pair, cache):
    tm, tp = pair[2], pair[3]
    eng = ServingEngine(tm, tp, _config(cache=cache, chunk_tokens=1),
                        device="cpu")
    specs = _specs([(6, 10), (7, 10), (8, 10)], seed=7)
    eng.submit_many([Request(*s) for s in specs])
    eng.step()                          # two admitted, one queued
    assert eng.cancel(2) and eng.cancel(0)
    assert not eng.cancel(0) and not eng.cancel(99)
    comps = eng.run()
    assert [c.rid for c in comps] == [1]
    if cache == "paged":
        cb = eng.cache_backend
        cb.flush()
        assert cb.allocator.n_free + cb.n_live_blocks \
            == cb.layout.max_blocks


def test_engine_fault_hooks(pair):
    tm, tp = pair[2], pair[3]
    eng = ServingEngine(tm, tp, _config(cache="paged"), device="cpu")
    plan = FaultPlan((Fault("refuse_blocks", container_id=0, count=2),
                      Fault("error", container_id=0, after_steps=3)))
    eng.fault = FaultInjector(plan, 0, 0)
    eng.submit(Request(0, np.arange(6, dtype=np.int32), 2))
    eng.step()
    eng.step()                          # two refused allocations
    assert eng.queue and not any(s.active for s in eng.slots)
    eng.step()                          # admitted and decoded
    assert not eng.has_work
    eng.submit(Request(1, np.arange(5, dtype=np.int32), 2))
    with pytest.raises(InjectedFault, match="error"):
        eng.step()


# ---------------------------------------------------------------------------
# FaultPlan / FaultInjector units (as tests/test_chaos.py)
# ---------------------------------------------------------------------------
def test_fault_plan_scopes_by_container_and_incarnation():
    plan = FaultPlan((Fault("kill", container_id=0, after_steps=2),
                      Fault("error", container_id=1, incarnation=None),
                      Fault("drop_replies", container_id=0,
                            incarnation=1, count=3)))
    assert len(plan.for_container(0, 0)) == 1
    assert len(plan.for_container(0, 1)) == 1
    assert len(plan.for_container(1, 0)) == 1
    assert len(plan.for_container(1, 5)) == 1
    assert plan.for_container(2, 0) == ()


def test_fault_injector_kill_fires_after_threshold():
    plan = FaultPlan((Fault("kill", container_id=0, after_steps=2),))
    inj = FaultInjector(plan, 0, 0)
    assert inj.armed
    inj.on_step(1)
    inj.on_step(2)
    with pytest.raises(InjectedFault) as ei:
        inj.on_step(3)
    assert ei.value.fault.kind == "kill"
    inj1 = FaultInjector(plan, 0, 1)
    assert not inj1.armed
    inj1.on_step(99)


def test_fault_injector_counted_hooks_drain():
    plan = FaultPlan((Fault("drop_replies", container_id=0, count=2),
                      Fault("delay_replies", container_id=0, count=1,
                            delay_s=0.25),
                      Fault("refuse_blocks", container_id=0, count=3)))
    inj = FaultInjector(plan, 0, 0)
    assert [inj.drop_reply() for _ in range(4)] == [True, True,
                                                   False, False]
    assert inj.reply_delay() == 0.25
    assert inj.reply_delay() == 0.0
    assert [inj.refuse_alloc() for _ in range(5)] == [True, True, True,
                                                      False, False]


def test_unknown_fault_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("segfault", container_id=0)


def test_describe_exitcode():
    assert "injected fault kill" in describe_exitcode(EXIT_FAULT_KILL)
    assert "engine step error" in describe_exitcode(EXIT_STEP_ERROR)
    assert "signal 9" in describe_exitcode(-9)
    assert "unknown" in describe_exitcode(None)


def test_faults_match_the_jax_package():
    from repro.serving import faults as jfaults
    from repro_torch.serving import faults
    for name in ("EXIT_STARTUP", "EXIT_PIPE_LOST", "EXIT_STEP_ERROR",
                 "EXIT_FAULT_KILL", "EXIT_CLASSES"):
        assert getattr(faults, name) == getattr(jfaults, name)
    assert ([f.name for f in dataclasses.fields(faults.Fault)]
            == [f.name for f in dataclasses.fields(jfaults.Fault)])


# ---------------------------------------------------------------------------
# the harness: core sets, the wire, the import closure
# ---------------------------------------------------------------------------
def test_core_sets_are_disjoint_and_refuse_overcommit():
    from repro.core.testbed import assign_core_sets as jassign
    for n in (1, 2, 3, 4):
        sets = assign_core_sets(n, avail=range(8))
        assert sets == jassign(n, avail=range(8))
        assert len(set().union(*sets)) == n * (8 // n)
    with pytest.raises(ValueError, match="pairwise-disjoint"):
        assign_core_sets(3, avail=[0, 1])
    assert assign_core_sets(3, avail=[0, 1], allow_shared=True) == [
        frozenset({0}), frozenset({1}), frozenset({0})]


def test_engine_config_wire_is_primitives_and_round_trips():
    config = EngineConfig(n_slots=3, max_len=128, cache="paged",
                          prefix_cache=True, dtype=torch.bfloat16,
                          chunk_tokens=8)
    wire = _engine_config_wire(config)
    assert wire["dtype"] == "bfloat16"
    assert all(v is None or type(v) in (int, str, bool, float)
               for v in wire.values())
    back = dict(wire, dtype=getattr(torch, wire["dtype"]))
    assert EngineConfig(**back) == config


def test_spawn_payload_unpickles_without_torch_jax_or_repro():
    """What a spawned child unpickles before ``_pinned_main`` pins it —
    the target, the child body, the ArchConfig, the engine-config wire
    and a FaultPlan — imports no torch (nor jax, nor repro), and neither
    do ``serving.child`` and ``core.testbed`` themselves."""
    cfg = get_config(ARCH)
    plan = FaultPlan((Fault("kill", container_id=1, after_steps=3),))
    payload = pickle.dumps((_pinned_main, [0, 1], _serving_child, (
        0, cfg, "cpu", _engine_config_wire(_config(dtype=torch.bfloat16)),
        0, plan, 0.5, None)))
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pickle, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("torch", "jax", "jaxlib",
                                          "repro", "numpy"):
                    raise ImportError(f"blocked import of {{name}}")
        sys.meta_path.insert(0, Blk())
        import repro_torch.serving.child, repro_torch.core.testbed
        target, cores, body, args = pickle.loads({payload!r})
        assert body.__module__ == "repro_torch.serving.child"
        assert args[1].name == {cfg.name!r} and args[5].faults
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro",
                                      "numpy")]
        assert not bad, bad
        print("closure ok", sorted(m for m in sys.modules
                                   if m.startswith("repro_torch")))
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "closure ok" in out.stdout
    for mod in ("repro_torch.serving.child", "repro_torch.core.testbed",
                "repro_torch.serving.faults", "repro_torch.configs.base"):
        assert mod in out.stdout


def test_process_backend_checks_its_arguments(pair):
    tm, tp = pair[2], pair[3]
    with pytest.raises(ValueError, match="params or params_seed"):
        ProcessBackend(tm.cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="params or params_seed"):
        ProcessBackend(tm.cfg, 1, params=tp, params_seed=0, device="cpu")
    meta = dict(tp, embed={"table": tp["embed"]["table"].to("meta")})
    with pytest.raises(ValueError, match="params live on"):
        ProcessBackend(tm.cfg, 1, params=meta, device="cpu")
    with pytest.raises(ValueError, match="pairwise-disjoint"):
        ProcessBackend(tm.cfg, 1000, params=tp, device="cpu")

"""The port's request guards against the JAX package's, on the same weights
and inputs: ``ThreadBackend`` supervision (kill, respawn, retry, circuit
breaker, ``refuse_blocks``), engine and Router deadlines with the
Router's backstop, load shedding (``max_queue`` and the ttfc p95 with its
aging window), and the new request and engine fields across the process
boundary (``_engine_config_wire``, the child pipe, ``params_path``).

Each scenario mirrors one of tests/test_chaos.py:127-387 and runs on both
packages: the event kinds, the reasons' key phrases, ``retry_after_s``,
the counters and the token streams must agree. Every wait is bounded."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import backend as tbackend  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import events as tev  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402

ARCH = "qwen3-0.6b-reduced"
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


class Side:
    """One package's serving stack, built the same way on both."""

    def __init__(self, name, pair):
        self.name = name
        jm, jp, tm, tp = pair
        if name == "jax":
            self.model, self.params = jm, jp
            self.eng, self.be, self.rt, self.ev, self.fl = (
                jeng, jbackend, jrouter, jev, jfaults)
            self.kw = {}
        else:
            self.model, self.params = tm, tp
            self.eng, self.be, self.rt, self.ev, self.fl = (
                teng, tbackend, trouter, tev, tfaults)
            self.kw = {"device": "cpu"}

    def config(self, **kw):
        return self.eng.EngineConfig(**kw)

    def backend(self, n, config, **kw):
        return self.be.ThreadBackend(self.model, self.params, n,
                                     config=config, **kw, **self.kw)

    def router(self, backend, **kw):
        return self.rt.Router(backend, **kw, **self.kw)

    def plan(self, *faults):
        return self.fl.FaultPlan(tuple(self.fl.Fault(*a, **k)
                                       for a, k in faults))

    def request(self, rid, prompt, max_new, **kw):
        return self.eng.Request(rid, np.array(prompt, np.int32), max_new,
                                **kw)


SIDES = ("jax", "port")


def _prompts(plens_max_new, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _blocking(side, specs):
    eng = side.eng.ServingEngine(side.model, side.params, side.config(
        n_slots=2, max_len=64), **side.kw)
    eng.submit_many([side.request(i, p, mn) for i, p, mn in specs])
    return {c.rid: list(c.tokens) for c in eng.run()}


def _conserved(engine) -> bool:
    cb = engine.cache_backend
    cb.flush()
    return cb.allocator.n_free + cb.n_live_blocks == cb.layout.max_blocks


def _both(pair, scenario):
    """``scenario(side)`` on the JAX stack and on the port's; both
    results."""
    return [scenario(Side(name, pair)) for name in SIDES]


# ---------------------------------------------------------------------------
# ThreadBackend supervision
# ---------------------------------------------------------------------------
def test_thread_kill_midstream_retries_bit_correct(pair):
    specs = _prompts([(6, 4), (9, 4), (5, 4), (7, 4)], seed=5)

    def scenario(side):
        want = _blocking(side, specs)
        backend = side.backend(2, side.config(n_slots=2, max_len=64,
                                              chunk_tokens=1),
                               fault_plan=side.plan(
                                   (("kill", 0), {"after_steps": 2})),
                               max_respawns=2)
        with side.router(backend, max_retries=2) as router:
            handles = [router.submit(side.request(i, p, mn))
                       for i, p, mn in specs]
            events = {h.rid: list(h.stream()) for h in handles}
            got = {h.rid: list(h.completion.tokens) for h in handles}
            fails = router.container_failures
            retried = set()
            for rid, evs in events.items():
                assert type(evs[-1]).__name__ == "DoneEvent"
                at = [i for i, e in enumerate(evs)
                      if type(e).__name__ == "RetryEvent"]
                if at:
                    retried.add(rid)
                    tail = [t for e in evs[at[-1] + 1:-1] for t in e.tokens]
                    assert tail == got[rid]
            assert got == want
            return (got, [(f.kind, f.container_id, "injected fault: kill"
                           in f.message, tuple(f.lost_rids)) for f in fails],
                    sorted(retried), router.retry_total, backend.alive(0),
                    backend.stats(0)[1] > 0)
    jax_side, port = _both(pair, scenario)
    assert port == jax_side
    got, fails, retried, retry_total, alive, _ = port
    assert fails == [("error", 0, True, fails[0][3])]
    assert retried == sorted(fails[0][3]) and retry_total == len(retried) > 0
    assert alive


def test_thread_circuit_breaker_trips_to_typed_failure(pair):
    specs = _prompts([(6, 4), (5, 2), (5, 2)], seed=7)

    def scenario(side):
        backend = side.backend(1, side.config(n_slots=2, max_len=64),
                               fault_plan=side.plan(
                                   (("kill", 0), {"incarnation": None})),
                               max_respawns=1)
        with side.router(backend, max_retries=5) as router:
            h = router.submit(side.request(*specs[0]))
            with pytest.raises(side.rt.RequestFailed) as ei:
                h.result()
            out = [ei.value.event.kind, h.completion is None,
                   backend.alive(0), len(router.container_failures)]
            with pytest.raises(RuntimeError, match="circuit-broken"):
                backend.submit(0, side.request(*specs[1]))
            with pytest.raises(RuntimeError, match="circuit-broken"):
                backend.drain()
            h2 = router.submit(side.request(*specs[2]))
            with pytest.raises(side.rt.RequestFailed,
                               match="no healthy container"):
                h2.result()
            return out + [router.failed_total]
    jax_side, port = _both(pair, scenario)
    assert port == jax_side == ["container", True, False, 2, 2]


def test_thread_refuse_blocks_stalls_then_serves(pair):
    specs = _prompts([(6, 3), (9, 4), (5, 2)], seed=11)

    def scenario(side):
        want = _blocking(side, specs)
        backend = side.backend(1, side.config(
            n_slots=2, max_len=64, cache="paged", block_size=8),
            fault_plan=side.plan((("refuse_blocks", 0), {"count": 4})))
        with side.router(backend) as router:
            handles = [router.submit(side.request(i, p, mn))
                       for i, p, mn in specs]
            got = {h.rid: h.tokens() for h in handles}
            assert got == want
            if side.name == "port":
                assert _conserved(backend.engines[0])
            return got
    jax_side, port = _both(pair, scenario)
    assert port == jax_side


def test_rebuilt_engine_keeps_stats_monotone_and_drops_the_dead_one(pair):
    """The dead engine's busy seconds and tokens stay in ``stats``, and
    nothing keeps the dead engine alive once it is replaced."""
    import gc
    import weakref
    side = Side("port", pair)
    backend = side.backend(1, side.config(n_slots=2, max_len=64,
                                          chunk_tokens=1),
                           fault_plan=side.plan(
                               (("error", 0), {"after_steps": 3})))
    dead = weakref.ref(backend.engines[0])
    with side.router(backend) as router:
        h = router.submit(side.request(0, np.arange(6), 8))
        before = []
        deadline = time.perf_counter() + TIMEOUT_S
        while not backend.failures:
            assert time.perf_counter() < deadline
            before.append(backend.stats(0))
            router.poll()
        assert backend.stats(0) >= before[-1]
        assert len(h.tokens()) == 8
        gc.collect()
        assert dead() is None
        assert backend.rebuild_s[0] is not None
        assert backend.failures[0].kind == "error"
        assert "injected fault: error" in backend.failures[0].message


# ---------------------------------------------------------------------------
# deadlines, cancellation, shedding
# ---------------------------------------------------------------------------
def test_deadline_expiry_fails_typed_and_conserves_blocks(pair):
    prompt = _prompts([(6, 30)], seed=13)[0][1]

    def scenario(side):
        backend = side.backend(1, side.config(
            n_slots=2, max_len=64, cache="paged", block_size=8))
        with side.router(backend, request_deadline_s=1e-4) as router:
            h = router.submit(side.request(0, prompt, 30))
            with pytest.raises(side.rt.RequestFailed) as ei:
                h.result()
            ev = ei.value.event
            ok = router.submit(side.request(100, prompt, 3,
                                            deadline_s=60.0))
            n = len(ok.tokens())
            eng = backend.engines[0]
            if side.name == "port":
                assert _conserved(eng)
            return (ev.kind, type(h.failure).__name__, n, eng.has_work,
                    router.failed_total)
    jax_side, port = _both(pair, scenario)
    assert port == jax_side == ("deadline", "FailedEvent", 3, False, 1)


def test_mid_decode_deadline_frees_slot(pair):
    def scenario(side):
        backend = side.backend(1, side.config(n_slots=2, max_len=512,
                                              chunk_tokens=4))
        # a huge grace keeps the Router's backstop out of the race
        with side.router(backend, deadline_grace_s=60.0) as router:
            h = router.submit(side.request(0, np.arange(6), 500,
                                           deadline_s=0.35))
            router.poll()
            with pytest.raises(side.rt.RequestFailed) as ei:
                h.result()
            ev = ei.value.event
            return (ev.kind, "mid-decode" in ev.reason,
                    backend.engines[0].has_work)
    jax_side, port = _both(pair, scenario)
    assert port == jax_side == ("deadline", True, False)


def test_router_cancel_frees_resources(pair):
    def scenario(side):
        backend = side.backend(1, side.config(n_slots=2, max_len=64))
        with side.router(backend) as router:
            h = router.submit(side.request(0, np.arange(6), 500))
            router.poll()
            out = [router.cancel(0, "user went away"), router.cancel(0)]
            with pytest.raises(side.rt.RequestFailed) as ei:
                h.result()
            out += [ei.value.event.kind, backend.engines[0].has_work]
            spec = _prompts([(6, 3)], seed=17)[0]
            out.append(router.submit(side.request(*spec)).tokens())
        return out + [router.failed_total]
    jax_side, port = _both(pair, scenario)
    assert port == jax_side
    assert port[:4] == [True, False, "cancelled", False]


def test_max_queue_sheds_with_retry_after(pair):
    specs = _prompts([(6, 6), (7, 6), (5, 3)], seed=19)

    def scenario(side):
        backend = side.backend(1, side.config(n_slots=2, max_len=64))
        with side.router(backend, max_queue=2) as router:
            keep = [router.submit(side.request(*s)) for s in specs[:2]]
            shed = router.submit(side.request(*specs[2]))
            evs = []
            with pytest.raises(side.rt.RequestRejected) as ei:
                for ev in shed.stream():
                    evs.append(ev)
            ev = ei.value.event
            assert isinstance(ei.value, side.rt.RequestFailed)
            out = [len(evs), type(evs[0]).__name__, ev.retry_after_s,
                   ev.kind, ev.container_id, "queue full" in ev.reason,
                   router.shed_total, [h.tokens() for h in keep]]
            retry = side.request(99, specs[2][1], 3)
            out.append(router.submit(retry).tokens())
            return out + [router.shed_total, router.in_flight]
    jax_side, port = _both(pair, scenario)
    assert port == jax_side
    assert port[:7] == [1, "RejectedEvent", 0.25, "queue", -1, True, 1]


def test_shed_p95_threshold_sheds_under_slow_ttfc(pair):
    spec = _prompts([(6, 2)], seed=23)[0]

    def scenario(side):
        backend = side.backend(1, side.config(n_slots=2, max_len=64))
        with side.router(backend, shed_p95_s=0.5) as router:
            for _ in range(7):           # below 8 samples: no verdict
                router.note_ttfc(2.0)
            first = router.submit(side.request(*spec)).tokens()
            for _ in range(9):
                router.note_ttfc(2.0)
            h = router.submit(side.request(1, spec[1], 2))
            with pytest.raises(side.rt.RequestRejected,
                               match="shed threshold") as ei:
                h.result()
            return (first, ei.value.event.kind, ei.value.event.retry_after_s,
                    router.shed_total)
    jax_side, port = _both(pair, scenario)
    assert port == jax_side
    assert port[1:] == ("slo", 0.25, 1)


def test_shed_p95_recovers_once_spike_leaves_window(pair):
    spec = _prompts([(6, 2)], seed=23)[0]

    def scenario(side):
        backend = side.backend(1, side.config(n_slots=2, max_len=64))
        with side.router(backend, shed_p95_s=0.5,
                         shed_window_s=0.25) as router:
            for _ in range(16):
                router.note_ttfc(2.0)
            shed = router.submit(side.request(*spec))
            with pytest.raises(side.rt.RequestRejected,
                               match="shed threshold"):
                shed.result()
            time.sleep(0.3)              # the spike leaves the window
            ok = router.submit(side.request(50, np.arange(6), 2))
            return len(ok.tokens()), router.shed_total
    jax_side, port = _both(pair, scenario)
    assert port == jax_side == (2, 1)


def test_first_chunks_feed_the_shed_threshold(pair):
    """Served requests' time-to-first-chunk samples are what the p95 reads:
    a threshold below every real ttfc sheds once 8 have been seen."""
    side = Side("port", pair)
    backend = side.backend(1, side.config(n_slots=4, max_len=64))
    with side.router(backend, shed_p95_s=1e-9) as router:
        handles = [router.submit(side.request(i, np.arange(6) + i, 2))
                   for i in range(8)]
        assert all(len(h.tokens()) == 2 for h in handles)
        assert len(router._recent_ttfc) == 8
        with pytest.raises(trouter.RequestRejected, match="ttfc p95"):
            router.submit(side.request(9, np.arange(6), 2)).result()


# ---------------------------------------------------------------------------
# stale events of an abandoned attempt, and the backstop after a retry
# ---------------------------------------------------------------------------
class _ScriptedBackend:
    """Replays a poll() tape (test_chaos.py's structural backend)."""

    def __init__(self, capacity, tape, device=None):
        self.capacity = capacity
        self._tape = list(tape)
        self.submitted: list[tuple[int, int]] = []
        self._load = [0] * capacity
        self.cancelled: list[tuple[int, int]] = []
        if device is not None:
            self.device = device

    def submit(self, cid, req):
        self.submitted.append((cid, req.rid))
        self._load[cid] += 1

    def poll(self):
        return self._tape.pop(0) if self._tape else []

    def load(self, cid):
        return self._load[cid]

    def stats(self, cid):
        return (0.0, 0)

    def cancel(self, cid, rid):
        self.cancelled.append((cid, rid))

    def close(self):
        pass


@pytest.mark.parametrize("stale", ["DoneEvent", "FailedEvent"])
def test_stale_terminal_after_retry_is_ignored_and_backstop_fires(stale):
    """A request retried off a hung container must not be ended by the old
    attempt's late terminal (a completion, or an engine-side deadline
    failure); with the new home silent, the re-armed backstop ends it."""
    out = []
    for ev, eng, rt, kw in ((jev, jeng, jrouter, {}),
                            (tev, teng, trouter, {"device": "cpu"})):
        req = eng.Request(rid=7, prompt=np.arange(6, dtype=np.int32),
                          max_new_tokens=4, deadline_s=0.2)
        late = (ev.DoneEvent(7, 0, eng.Completion(7, [1, 2, 3, 4], 6, 0.01),
                             0.0) if stale == "DoneEvent"
                else ev.FailedEvent(7, 0, "deadline", "expired", 0.0))
        tape = [[ev.ContainerFailure(0, "hung", "heartbeat timeout", 0.0,
                                     lost_rids=(7,))], [late]]
        backend = _ScriptedBackend(2, tape, device=torch.device("cpu"))
        with rt.Router(backend, deadline_grace_s=0.1, max_retries=2,
                       **kw) as router:
            h = router.submit(req)
            router.poll()                # failure -> retry onto c1
            router.poll()                # the stale terminal from c0
            assert h.completion is None and h.failure is None
            t0 = time.perf_counter()
            with pytest.raises(rt.RequestFailed) as ei:
                h.result()               # c1 stays silent: the backstop
            assert time.perf_counter() - t0 < 5
            e = ei.value.event
            out.append((backend.submitted, backend.cancelled, e.kind,
                        "backstop" in e.reason, e.container_id, h.attempts,
                        router.retry_total, router.failed_total))
    assert out[1] == out[0]
    assert out[1][2:] == ("deadline", True, 1, 1, 1, 1)


def test_retry_carries_the_remaining_deadline_or_fails_it():
    """A lost request is re-dispatched with what is left of its deadline,
    and one whose deadline passed while it was lost fails typed."""
    out = []
    for ev, eng, rt, kw in ((jev, jeng, jrouter, {}),
                            (tev, teng, trouter, {"device": "cpu"})):
        seen = []

        class Recording(_ScriptedBackend):
            def submit(self, cid, req):
                seen.append((cid, req.rid, req.deadline_s))
                super().submit(cid, req)
        tape = [[ev.ContainerFailure(0, "dead", "gone", 0.0,
                                     lost_rids=(1, 2))]]
        backend = Recording(2, tape, device=torch.device("cpu"))
        with rt.Router(backend, max_retries=1, **kw) as router:
            reqs = [eng.Request(1, np.arange(6, dtype=np.int32), 4,
                                deadline_s=30.0),
                    eng.Request(2, np.arange(6, dtype=np.int32), 4,
                                deadline_s=1e-4)]
            handles = [router.submit(r) for r in reqs]
            time.sleep(0.01)
            router.poll()
            with pytest.raises(rt.RequestFailed) as ei:
                handles[1].result()
            retry = seen[-1]
            out.append(([(c, r) for c, r, _ in seen],
                         0 < retry[2] < 30.0, ei.value.event.kind,
                         "while lost" in ei.value.event.reason,
                         router.retry_total))
    assert out[1] == out[0]
    assert out[1][0][-1] == (1, 1) and out[1][2:] == ("deadline", True, 1)


# ---------------------------------------------------------------------------
# the new fields across the process boundary
# ---------------------------------------------------------------------------
def test_engine_config_wire_carries_the_new_fields():
    config = teng.EngineConfig(n_slots=3, max_len=128, greedy=False,
                               seed=11, batch_admit=False, chunked=False,
                               dtype=torch.bfloat16, chunk_tokens=8)
    wire = tbackend._engine_config_wire(config)
    assert (wire["greedy"], wire["seed"], wire["batch_admit"],
            wire["chunked"]) == (False, 11, False, False)
    assert all(v is None or type(v) in (int, str, bool, float)
               for v in wire.values())
    back = dict(wire, dtype=getattr(torch, wire["dtype"]))
    assert teng.EngineConfig(**back) == config


def test_process_children_take_the_new_fields_and_params_path(pair,
                                                              tmp_path):
    """Process containers over weights from a ``save_params`` file serve
    what the weights over the pipe serve and what a ThreadBackend serves,
    under a sampling, per-token, one-at-a-time config (the config's
    fields cross the wire), with requests whose extras, priority, tenant
    and deadlines cross the pipe: a request with a spent deadline fails
    typed in the child."""
    side = Side("port", pair)
    tm, tp = pair[2], pair[3]
    path = bridge.save_params(tp, tmp_path / "weights.npz")
    config = side.config(n_slots=2, max_len=64, greedy=False, seed=3,
                         batch_admit=False, chunked=False)
    specs = _prompts([(6, 4), (9, 3), (7, 5)], seed=29)

    def reqs():
        return [side.request(i, p, mn, extras={"x": np.arange(i + 1)},
                             priority="batch", tenant=f"t{i}",
                             deadline_s=60.0) for i, p, mn in specs] + [
            side.request(9, specs[0][1], 4, deadline_s=1e-9)]

    def serve(backend):
        with trouter.Router(backend, device="cpu",
                            deadline_grace_s=60.0) as router:
            handles = [router.submit(r) for r in reqs()]
            deadline = time.perf_counter() + TIMEOUT_S
            while not all(h.done for h in handles):
                assert time.perf_counter() < deadline, "never finished"
                router._pump(block=True)
            got = {h.rid: list(h.completion.tokens) for h in handles[:-1]}
            fail = handles[-1].failure
            return got, (fail.kind, fail.reason, fail.container_id)
    want = serve(side.backend(1, config))
    with pytest.raises(ValueError, match="not both"):
        tbackend.ProcessBackend(tm.cfg, 1, config, params=tp,
                                params_path=path, device="cpu")
    for kw in ({"params_path": path}, {"params": tp}):
        backend = tbackend.ProcessBackend(tm.cfg, 1, config, device="cpu",
                                          allow_shared_cores=True,
                                          start_timeout_s=TIMEOUT_S, **kw)
        try:
            assert serve(backend) == want
        finally:
            backend.close()
    assert want[1] == ("deadline", "deadline expired while queued", 0)
    assert sorted(want[0]) == [0, 1, 2]

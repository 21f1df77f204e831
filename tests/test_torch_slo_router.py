"""The port's Router in SLO mode against the JAX package's.

Every scenario of tests/test_slo_router.py runs on both Routers, each
over a scripted in-memory backend of its own package that holds its
requests until the test releases them: rank-ordered dispatch from the
router-side backlog (interactive before batch, FIFO within a class, an
unknown priority at the worst class), the class queue share, per-class
shed tails, tenant quotas freed on completion, the non-SLO rejections,
a sparse window closed by ``window_s``, and per-class window stats with
attainment. The dispatch order, the rejections' kinds and classes and
the per-class window counts must agree. Then the deadline backstop and
``cancel`` on requests still in the backlog, the warm-up window after a
resize and the constraint class's censored tail as the scheduler sees
them in adaptive SLO mode, and a short trace replayed
open-loop through both packages' Routers over the same reduced qwen3
weights, which must give the same greedy tokens per request."""
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
from repro.serving import router as jrouter  # noqa: E402
from repro.workload import replay as jreplay  # noqa: E402
from repro.workload import slo as jslo  # noqa: E402
from repro.workload import traces as jtraces  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import backend as tbackend  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import events as tev  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.workload import replay as treplay  # noqa: E402
from repro_torch.workload import slo as tslo  # noqa: E402
from repro_torch.workload import traces as ttraces  # noqa: E402

SLO_TEXT = "interactive:0.5,batch:4.0"
TIMEOUT_S = 60.0


class Side:
    """One package's Router, request and event types."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.eng, self.ev, self.rt, self.slo = jeng, jev, jrouter, jslo
            self.kw = {}
        else:
            self.eng, self.ev, self.rt, self.slo = teng, tev, trouter, tslo
            self.kw = {"device": "cpu"}
        self.SLO = self.slo.SLOSpec.parse(SLO_TEXT)

    def router(self, backend=None, **kw):
        return self.rt.Router(backend, **kw, **self.kw)

    def req(self, rid, priority="default", tenant="", max_new=2, **kw):
        return self.eng.Request(rid=rid,
                                prompt=np.arange(4, dtype=np.int32),
                                max_new_tokens=max_new, priority=priority,
                                tenant=tenant, **kw)

    def stall(self, capacity):
        return StallBackend(self, capacity)


class StallBackend:
    """In-memory backend whose requests complete only after the test calls
    ``release()``, so a test can hold a backlog open and watch the
    dispatch order."""

    def __init__(self, side, capacity):
        self.side = side
        self.capacity = capacity
        self.device = torch.device("cpu")
        self._inflight: list[list] = [[] for _ in range(capacity)]
        self._stats = [(0.0, 0)] * capacity
        self.dispatch_order: list[int] = []
        self.cancelled: list[int] = []
        self._released = False

    def submit(self, cid, req):
        self.dispatch_order.append(req.rid)
        self._inflight[cid].append(req)

    def submit_many(self, cid, reqs):
        for r in reqs:
            self.submit(cid, r)

    def release(self):
        self._released = True

    def cancel(self, cid, rid):
        self.cancelled.append(rid)
        self._inflight[cid] = [r for r in self._inflight[cid]
                               if r.rid != rid]

    def poll(self):
        if not self._released:
            return []
        ev, eng = self.side.ev, self.side.eng
        out, now = [], time.perf_counter()
        for cid, flight in enumerate(self._inflight):
            for req in flight:
                toks = tuple(range(req.max_new_tokens))
                busy, ntok = self._stats[cid]
                self._stats[cid] = (busy + 1e-4, ntok + len(toks))
                out.append(ev.ChunkEvent(req.rid, cid, toks, now))
                out.append(ev.DoneEvent(req.rid, cid, eng.Completion(
                    req.rid, list(toks), len(req.prompt), 1e-4), now))
            self._inflight[cid] = []
        return out

    def load(self, cid):
        return len(self._inflight[cid])

    def stats(self, cid):
        return self._stats[cid]

    def drain(self, concurrent=True):
        return []

    def close(self):
        pass


def _terminal(h) -> tuple:
    """A handle's terminal state without clock readings or reasons."""
    if h.completion is not None:
        return ("done", h.priority, list(h.completion.tokens))
    f = h.failure
    if f is None:
        return ("pending", h.priority)
    return (type(f).__name__, getattr(f, "kind", None),
            getattr(f, "priority", None), h.priority)


def _class_counts(history) -> list:
    return [{name: (cw.n_done, cw.n_shed, cw.n_failed,
                    cw.target_ttfc_p95_s, cw.attained)
             for name, cw in w.per_class.items()} for w in history]


# ---------------------------------------------------------------------------
# the scenarios of tests/test_slo_router.py, one function each
# ---------------------------------------------------------------------------
def interactive_before_batch(side):
    backend = side.stall(1)
    with side.router(backend, slo=side.SLO, dispatch_depth=1) as router:
        hs = [router.submit(side.req(0, "batch")),
              router.submit(side.req(1, "batch")),
              router.submit(side.req(2, "interactive")),
              router.submit(side.req(3, "interactive"))]
        held = list(backend.dispatch_order)
        backend.release()
        router.drain()
    assert held == [0]
    assert backend.dispatch_order == [0, 2, 3, 1]
    return held, backend.dispatch_order, [_terminal(h) for h in hs]


def fifo_within_a_class(side):
    backend = side.stall(1)
    with side.router(backend, slo=side.SLO, dispatch_depth=1) as router:
        hs = [router.submit(side.req(rid, "interactive"))
              for rid in range(4)]
        backend.release()
        router.drain()
    assert backend.dispatch_order == [0, 1, 2, 3]
    return backend.dispatch_order, [_terminal(h) for h in hs]


def unknown_priority_is_worst_class(side):
    backend = side.stall(1)
    with side.router(backend, slo=side.SLO, dispatch_depth=1) as router:
        hs = [router.submit(side.req(0, "batch")),
              router.submit(side.req(1, "mystery")),
              router.submit(side.req(2, "interactive"))]
        backend.release()
        router.drain()
    assert [h.priority for h in hs] == ["batch", "batch", "interactive"]
    assert backend.dispatch_order == [0, 2, 1]
    return backend.dispatch_order, [_terminal(h) for h in hs]


def class_queue_share(side):
    backend = side.stall(1)
    with side.router(backend, slo=side.SLO, dispatch_depth=1,
                     max_queue=4) as router:
        hs = [router.submit(side.req(0, "interactive")),
              router.submit(side.req(1, "interactive")),
              router.submit(side.req(2, "batch")),
              router.submit(side.req(3, "interactive"))]
        shed = hs[2].failure
        assert isinstance(shed, side.ev.RejectedEvent)
        assert (shed.kind, shed.priority) == ("queue", "batch")
        assert "class 'batch' share of max_queue=4" in shed.reason
        assert hs[3].failure is None
        backend.release()
        router.drain()
        totals = (router.shed_total, router.failed_total)
    return backend.dispatch_order, [_terminal(h) for h in hs], totals


def per_class_shed_tail(side):
    backend = side.stall(2)
    with side.router(backend, slo=side.SLO, dispatch_depth=4) as router:
        now = time.perf_counter()
        for _ in range(10):   # >= 8 samples, over 2 x 0.5 s
            router.note_ttfc(1.7, at=now, priority="interactive")
        hs = [router.submit(side.req(0, "interactive")),
              router.submit(side.req(1, "batch"))]
        shed = hs[0].failure
        assert isinstance(shed, side.ev.RejectedEvent)
        assert (shed.kind, shed.priority) == ("slo", "interactive")
        assert "class 'interactive' ttfc p95 1.700s" in shed.reason
        assert hs[1].failure is None
        backend.release()
        router.drain()
    return backend.dispatch_order, [_terminal(h) for h in hs]


def tenant_quota_freed_on_completion(side):
    backend = side.stall(2)
    with side.router(backend, slo=side.SLO, dispatch_depth=4,
                     tenant_quota=2) as router:
        hs = [router.submit(side.req(0, "interactive", tenant="hog")),
              router.submit(side.req(1, "interactive", tenant="hog")),
              router.submit(side.req(2, "interactive", tenant="hog")),
              router.submit(side.req(3, "interactive", tenant="meek"))]
        third = hs[2].failure
        assert isinstance(third, side.ev.RejectedEvent)
        assert third.kind == "tenant" and hs[3].failure is None
        assert dict(router._tenants) == {"hog": 2, "meek": 1}
        backend.release()
        router.drain()
        assert not router._tenants
        hs.append(router.submit(side.req(4, "interactive", tenant="hog")))
        assert hs[-1].failure is None
        router.drain()
    return backend.dispatch_order, [_terminal(h) for h in hs]


def non_slo_rejections_unchanged(side):
    backend = side.stall(1)
    with side.router(backend, max_queue=1) as router:
        hs = [router.submit(side.req(0)), router.submit(side.req(1))]
        shed = hs[1].failure
        assert isinstance(shed, side.ev.RejectedEvent)
        assert (shed.kind, shed.priority) == ("queue", "default")
        assert not router._backlog        # no SLO: straight to a container
        backend.release()
        router.drain()
    return backend.dispatch_order, [_terminal(h) for h in hs]


def window_s_closes_sparse_window(side):
    def factory(n):
        b = side.stall(n)
        b.release()
        return b

    router = side.router(backend_factory=factory, feasible_counts=[1],
                         window=1000, window_s=0.05, epsilon=0.0)
    for rid in range(3):
        h = router.submit(side.req(rid))
        while not h.done:
            router.poll()
    deadline = time.perf_counter() + 2.0
    while not router.history and time.perf_counter() < deadline:
        time.sleep(0.01)
        router.poll()
    router.close()
    assert router.history, "window_s never closed a sparse window"
    assert 0 < router.history[0].n_requests <= 3
    assert router.scheduler.n_observations >= 1
    return router.history[0].per_class, len(router.history) > 0


def per_class_window_stats(side):
    def factory(n):
        b = side.stall(n)
        b.release()
        return b

    router = side.router(backend_factory=factory, feasible_counts=[1],
                         window=4, epsilon=0.0, slo=side.SLO)
    rids = iter(range(100))
    for _ in range(2):
        handles = [router.submit(side.req(next(rids), pri))
                   for pri in ("interactive", "interactive",
                               "batch", "batch")]
        while not all(h.done for h in handles):
            router.poll()
    router.close()
    assert router.history
    cw = router.history[0].per_class["interactive"]
    assert set(router.history[0].per_class) == {"interactive", "batch"}
    assert cw.n_done == 2 and cw.attained is True
    assert cw.target_ttfc_p95_s == pytest.approx(0.5)
    return _class_counts(router.history), router.scheduler.n_observations


SCENARIOS = [interactive_before_batch, fifo_within_a_class,
             unknown_priority_is_worst_class, class_queue_share,
             per_class_shed_tail, tenant_quota_freed_on_completion,
             non_slo_rejections_unchanged, window_s_closes_sparse_window,
             per_class_window_stats]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_slo_router_scenario_on_both_routers(scenario):
    port = scenario(Side("port"))
    ref = scenario(Side("jax"))
    assert port == ref


# ---------------------------------------------------------------------------
# the backlog under the deadline backstop and cancel
# ---------------------------------------------------------------------------
def backlog_backstop_and_cancel(side):
    """Requests still in the backlog: one passes its deadline (the
    Router's backstop fails it without ever dispatching or cancelling it
    in a container), one is cancelled (its tenant slot comes back); the
    survivors leave the backlog in rank order once the container
    frees."""
    backend = side.stall(1)
    with side.router(backend, slo=side.SLO, dispatch_depth=1,
                     tenant_quota=3, deadline_grace_s=0.0) as router:
        hs = [router.submit(side.req(0, "batch", tenant="a")),
              router.submit(side.req(1, "batch", tenant="a",
                                     deadline_s=0.01)),
              router.submit(side.req(2, "interactive", tenant="a")),
              router.submit(side.req(3, "interactive", tenant="b"))]
        assert backend.dispatch_order == [0]
        assert router.cancel(2) is True
        assert router.cancel(2) is False
        assert dict(router._tenants) == {"a": 2, "b": 1}
        time.sleep(0.03)
        router.poll()                 # the backstop fails rid 1
        assert dict(router._tenants) == {"a": 1, "b": 1}
        assert hs[1].failure.kind == "deadline"
        assert hs[2].failure.kind == "cancelled"
        assert hs[1].failure.container_id == hs[2].failure.container_id == -1
        backend.release()
        router.drain()
        assert not router._tenants and router.in_flight == 0
    assert backend.dispatch_order == [0, 3]
    assert backend.cancelled == []    # neither ever reached a container
    return (backend.dispatch_order, [_terminal(h) for h in hs],
            router.failed_total)


def test_backstop_and_cancel_act_on_backlog_requests_on_both_routers():
    assert (backlog_backstop_and_cancel(Side("port"))
            == backlog_backstop_and_cancel(Side("jax")))


def test_backlog_fails_when_no_container_is_alive():
    """A backlog entry with no live container at all fails typed instead
    of stranding; without an SLO the same submit is born failed."""
    backend = Side("port").stall(1)
    backend.alive = lambda cid: False
    with trouter.Router(backend, slo=tslo.SLOSpec.parse(SLO_TEXT),
                        device="cpu") as router:
        h = router.submit(Side("port").req(0, "interactive", tenant="t"))
        assert h.failure.kind == "container" and h.done
        assert not router._tenants and router.in_flight == 0
    assert backend.dispatch_order == []


def resize_withholds_the_warmup_window(side):
    """Adaptive SLO mode: the window after a resize is recorded in
    ``history`` but withheld from the scheduler, whose tail sample is the
    constraint class's censored p95 (a shed interactive arrival counts at
    twice its target)."""
    observed = []

    def factory(n):
        b = side.stall(n)
        b.release()
        return b
    with side.router(backend_factory=factory, feasible_counts=[1, 2],
                     window=4, epsilon=0.0, slo=side.SLO,
                     objective="energy_under_slo", max_queue=8) as router:
        observe = router.scheduler.observe

        def record(n, time_s, energy_j, ttfc_p95_s=None):
            observed.append((n, ttfc_p95_s))
            observe(n, time_s, energy_j, ttfc_p95_s=ttfc_p95_s)
        router.scheduler.observe = record
        rid = 0
        for _ in range(3):
            hs = [router.submit(side.req(rid + i, pri)) for i, pri in
                  enumerate(("interactive", "batch", "interactive",
                             "batch"))]
            rid += 4
            while not all(h.done for h in hs):
                router.poll()
            router.poll()              # the resize waits for the drain
        counts = [w.n_containers for w in router.history]
    assert len(counts) == 3 and counts[1] == counts[2] != counts[0]
    assert [n for n, _ in observed] == [counts[0], counts[2]]
    assert all(q is not None and q < 1.0 for _, q in observed)
    return counts, [n for n, _ in observed]


def test_resize_in_slo_mode_withholds_the_warmup_window_on_both_routers():
    assert (resize_withholds_the_warmup_window(Side("port"))
            == resize_withholds_the_warmup_window(Side("jax")))


def test_censored_constraint_tail_reaches_the_scheduler_on_both_routers():
    """A window whose interactive arrivals were all shed observes the cap
    (2 x 0.5 s) as the constraint class's tail on both Routers."""
    def run(side):
        seen = []

        def factory(n):
            b = side.stall(n)
            b.release()
            return b
        with side.router(backend_factory=factory, feasible_counts=[1],
                         window=2, epsilon=0.0, slo=side.SLO,
                         objective="energy_under_slo") as router:
            observe = router.scheduler.observe
            router.scheduler.observe = (
                lambda n, t, e, ttfc_p95_s=None: (
                    seen.append(ttfc_p95_s),
                    observe(n, t, e, ttfc_p95_s=ttfc_p95_s)))
            now = time.perf_counter()
            for _ in range(10):
                router.note_ttfc(1.7, at=now, priority="interactive")
            shed = router.submit(side.req(0, "interactive"))
            assert shed.failure.kind == "slo"
            hs = [router.submit(side.req(1 + i, "batch")) for i in range(2)]
            while not all(h.done for h in hs):
                router.poll()
        return seen
    assert run(Side("port")) == run(Side("jax")) == [1.0]


def test_energy_under_slo_wires_the_constraint_into_the_scheduler():
    spec = tslo.SLOSpec.parse("interactive:0.5,batch:8.0")

    def factory(n):
        return Side("port").stall(n)
    with trouter.Router(backend_factory=factory, feasible_counts=[1, 2],
                        objective="energy_under_slo", slo=spec,
                        device="cpu") as r:
        assert r.scheduler.objective == "energy_under_slo"
        assert r.scheduler.slo_ttfc_p95_s == 0.5
    with trouter.Router(backend_factory=factory, feasible_counts=[1, 2],
                        objective="energy", slo=spec, device="cpu") as r:
        assert r.scheduler.objective == "energy"


# ---------------------------------------------------------------------------
# a short trace through both packages' Routers over the same weights
# ---------------------------------------------------------------------------
ARCH = "qwen3-0.6b-reduced"


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _replayed(side, model, params, trace):
    slo = side.slo.SLOSpec.parse("interactive:60,batch:60")
    be = tbackend if side.name == "port" else jbackend
    replay = treplay if side.name == "port" else jreplay
    backend = be.ThreadBackend(model, params, 2, config=side.eng.EngineConfig(
        n_slots=2, max_len=96, batch_admit=False), **side.kw)
    router = side.router(backend, slo=slo, tenant_quota=8)
    handles = []
    submit = router.submit

    def keep(req):
        h = submit(req)
        handles.append(h)
        return h
    router.submit = keep
    with router:
        report = replay.replay(trace, router, time_scale=25.0,
                               vocab_size=model.cfg.vocab_size,
                               max_requests=12)
    return report, {h.rid: list(h.completion.tokens) for h in handles}


def test_a_short_trace_gives_jax_tokens_per_request(pair):
    jm, jp, tm, tp = pair
    spec = dataclasses.replace(ttraces.get_preset("poisson-light"),
                               lengths=ttraces.LengthSpec(
                                   prompt_median=12.0, prompt_max=40,
                                   output_medians=(4.0, 12.0),
                                   output_max=24))
    jspec = dataclasses.replace(jtraces.get_preset("poisson-light"),
                                lengths=jtraces.LengthSpec(
                                    prompt_median=12.0, prompt_max=40,
                                    output_medians=(4.0, 12.0),
                                    output_max=24))
    t0 = time.perf_counter()
    rep_t, got = _replayed(Side("port"), tm, tp,
                           ttraces.synthesize(spec, seed=2))
    rep_j, want = _replayed(Side("jax"), jm, jp,
                            jtraces.synthesize(jspec, seed=2))
    assert time.perf_counter() - t0 < TIMEOUT_S
    assert rep_t.n_requests == rep_j.n_requests > 0
    assert rep_t.n_done == rep_j.n_done == len(got) == 12
    assert rep_t.n_shed == rep_t.n_failed == 0
    assert got == want
    assert set(rep_t.per_class) == set(rep_j.per_class)
    for name, cw in rep_t.per_class.items():
        assert (cw.n_done, cw.n_shed, cw.n_failed) == (
            rep_j.per_class[name].n_done, rep_j.per_class[name].n_shed,
            rep_j.per_class[name].n_failed)

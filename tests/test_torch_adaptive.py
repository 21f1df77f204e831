"""The online container-count loop of the port: ``serving/adaptive.py``,
``serving/pool.py`` and the Router's adaptive mode, against the JAX
package.

Counterparts of ``tests/test_adaptive_pool.py`` (the synthetic-pool
convergence, per-count pool reuse, the LRU bound and closing; its
submesh test becomes "the port takes no ``submesh_devices``") and of
``tests/test_streaming.py``'s windowed-resize and deferred-resize tests
over a scripted port backend. Over reduced qwen3 ``ThreadBackend``s the
greedy completions of the adaptive Router, the adaptive pool and
``ContainerServingPool(n)`` for n in {1, 2, 4} equal the JAX Router's
tokens; ``serve_wave`` keeps submission order; and the shed hint follows
the last window's median latency.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import pool as jpool  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.containers import card_feasible_counts  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving.adaptive import (AdaptiveServingPool,  # noqa: E402
                                          SyntheticContainerPool,
                                          synthetic_pool_factory)
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import (Completion, EngineConfig,  # noqa: E402
                                        Request)
from repro_torch.serving.events import ChunkEvent, DoneEvent  # noqa: E402
from repro_torch.serving.router import (RequestRejected,  # noqa: E402
                                        Router, WindowStats)

ARCH = "qwen3-0.6b-reduced"
SLOTS, MAX_LEN, CHUNK = 2, 64, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _quiet_wave_shims(monkeypatch):
    """The wave shims warn once a process; keep each test's view the
    same whatever ran before it."""
    monkeypatch.setattr(tpool, "_WAVE_SHIM_WARNED", True)
    monkeypatch.setattr(jpool, "_WAVE_SHIM_WARNED", True)


def _convex_time(n):
    return 1.0 / n + 0.02 * n * n          # argmin over {1,2,4,8} at n=4


def _energy(n):
    return _convex_time(n) * (40.0 + 7.0 * n)   # argmin at n=2


# ---------------------------------------------------------------------------
# the adaptive pool over synthetic pools (tests/test_adaptive_pool.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("objective,best", [("time", 4), ("energy", 2)])
def test_adaptive_converges_to_the_argmin_within_8_waves(objective, best):
    apool = AdaptiveServingPool(
        None, None, [1, 2, 4, 8], objective=objective,
        pool_factory=synthetic_pool_factory(_convex_time, _energy))
    for _ in range(8):
        apool.serve_wave([])
    assert apool.choice == best
    assert apool.scheduler.n_observations == 8
    assert all(w.n_containers in (1, 2, 4, 8) for w in apool.history)


def test_adaptive_reuses_pools_per_count():
    built = []

    def factory(n):
        built.append(n)
        return SyntheticContainerPool(n, _convex_time, _energy)

    apool = AdaptiveServingPool(None, None, [1, 2, 4], objective="time",
                                pool_factory=factory)
    for _ in range(6):
        apool.serve_wave([])
    assert len(built) == len(set(built))


class _FixedScheduler:
    def __init__(self, picks):
        self.picks, self.n_observations = list(picks), 0

    def pick(self):
        return self.picks[self.n_observations]

    def observe(self, n, t, e):
        self.n_observations += 1


def test_max_cached_pools_evicts_lru_and_closes_what_it_drops():
    built, closed = [], []

    class ClosingPool(SyntheticContainerPool):
        def close(self):
            closed.append(self.n_containers)

    def factory(n):
        built.append(n)
        return ClosingPool(n, _convex_time, _energy)

    picks = [1, 2, 4, 2, 1]            # 4 evicts 1; re-probing 1 rebuilds
    apool = AdaptiveServingPool(None, None, [1, 2, 4],
                                scheduler=_FixedScheduler(picks),
                                pool_factory=factory, max_cached_pools=2)
    for _ in picks:
        apool.serve_wave([])
    assert built == [1, 2, 4, 1]
    assert set(apool._pools) == {2, 1}
    assert closed == [1, 4]            # each eviction closed its pool
    apool.close()
    assert sorted(closed) == [1, 1, 2, 4] and apool._pools == {}


def test_adaptive_wave_history_and_completions():
    apool = AdaptiveServingPool(
        None, None, [1, 2], objective="time",
        pool_factory=synthetic_pool_factory(_convex_time))
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=2) for i in range(5)]
    assert [c.rid for c in apool.serve_wave(list(reqs))] == [0, 1, 2, 3, 4]
    w = apool.history[0]
    assert w.wave == 0 and w.n_requests == 5
    assert w.wall_s > 0 and w.energy_j > 0
    assert w.latency_p50_s == w.latency_p95_s == 0.0


def test_requires_model_or_factory_and_takes_no_submesh_devices():
    with pytest.raises(ValueError):
        AdaptiveServingPool(None, None, [1, 2])
    with pytest.raises(TypeError, match="submesh_devices"):
        AdaptiveServingPool(None, None, [1, 2, 4],
                            pool_factory=synthetic_pool_factory(
                                _convex_time), submesh_devices=6)
    with pytest.raises(ValueError, match="isolation"):
        AdaptiveServingPool(None, None, [1], isolation="vm",
                            pool_factory=synthetic_pool_factory(
                                _convex_time))


def test_energy_proxy_and_wave_accounting_are_jax_s():
    assert tpool.EnergyProxy() == tpool.EnergyProxy(40.0, 7.0)
    for wall, busy, n in ((1.0, 0.5, 2), (0.3, 0.0, 1), (2.0, 1.9, 0)):
        assert (tpool.EnergyProxy().container_energy(wall, busy, n)
                == jpool.EnergyProxy().container_energy(wall, busy, n))
    reqs = [Request(i, np.arange(3, dtype=np.int32), 2) for i in range(5)]
    segs = [reqs[:3], reqs[3:]]
    out = [([Completion(2, [1], 3, 0.2), Completion(0, [1, 2], 3, 0.1),
             Completion(1, [], 3, 0.3)], 0.5, 0.25, 3),
           ([Completion(4, [7], 3, 0.4), Completion(3, [8], 3, 0.5)],
            0.7, 0.5, 2)]
    ordered, results, energy = tpool.assemble_wave(out, segs, 0.8,
                                                   tpool.EnergyProxy())
    jordered, jresults, jenergy = jpool.assemble_wave(out, segs, 0.8,
                                                      jpool.EnergyProxy())
    assert [c.rid for c in ordered] == [c.rid for c in jordered] \
        == [0, 1, 2, 3, 4]
    assert energy == jenergy
    for r, j in zip(results, jresults):
        assert (r.container_id, r.wall_s, r.n_requests, r.busy_s,
                r.energy_j, r.n_tokens, r.tokens_per_s, r.latency_p50_s,
                r.latency_p95_s) == (
            j.container_id, j.wall_s, j.n_requests, j.busy_s, j.energy_j,
            j.n_tokens, j.tokens_per_s, j.latency_p50_s, j.latency_p95_s)
    assert tpool.latency_percentiles([]) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# the Router's windows over a scripted backend (tests/test_streaming.py)
# ---------------------------------------------------------------------------
class ScriptedBackend:
    """Each request completes with one chunk after ``delay_polls`` polls
    (``tests/test_streaming.py``'s backend, with the port's events and a
    device)."""

    device = CPU

    def __init__(self, capacity: int, delay_polls: int = 1):
        self.capacity = capacity
        self.delay = delay_polls
        self._inflight: list[list] = [[] for _ in range(capacity)]
        self._stats = [(0.0, 0)] * capacity
        self.closed = False

    def submit(self, cid, req):
        self._inflight[cid].append([req, self.delay])

    def poll(self):
        out, now = [], time.perf_counter()
        for cid, flight in enumerate(self._inflight):
            keep = []
            for entry in flight:
                req, left = entry
                if left > 1:
                    entry[1] = left - 1
                    keep.append(entry)
                    continue
                toks = tuple(range(req.max_new_tokens))
                busy, ntok = self._stats[cid]
                self._stats[cid] = (busy + 1e-4, ntok + len(toks))
                out.append(ChunkEvent(req.rid, cid, toks, now))
                out.append(DoneEvent(req.rid, cid, Completion(
                    req.rid, list(toks), len(req.prompt), 1e-4), now))
            self._inflight[cid] = keep
        return out

    def load(self, cid):
        return len(self._inflight[cid])

    def stats(self, cid):
        return self._stats[cid]

    def close(self):
        self.closed = True


def _req(rid, plen=6, max_new=2):
    return Request(rid=rid, prompt=np.zeros((plen,), np.int32),
                   max_new_tokens=max_new)


def test_windowed_scheduler_resizes_between_windows():
    built = []

    def factory(n):
        built.append(n)
        return ScriptedBackend(n)

    router = Router(backend_factory=factory, feasible_counts=[1, 2, 4],
                    window=4, epsilon=0.0, device="cpu")
    rid = 0
    for _ in range(5):
        for _ in range(4):
            router.submit(_req(rid, max_new=3))
            rid += 1
        router.drain()
    assert len(router.history) == 5
    for w in router.history:
        assert isinstance(w, WindowStats)
        assert w.n_requests == 4 and w.n_tokens == 12
        assert w.n_containers in (1, 2, 4)
        assert w.wall_s > 0 and w.energy_j > 0 and w.tokens_per_s > 0
    assert router.scheduler.n_observations == 5
    assert len(built) == len(set(built))
    assert len({w.n_containers for w in router.history}) >= 3
    assert router.n_containers in (1, 2, 4)
    assert router.choice in (1, 2, 4)
    backends = list(router._backends.values())
    router.close()
    assert backends and all(b.closed for b in backends)


def test_resize_deferred_while_requests_in_flight():
    built = []

    def factory(n):
        built.append(n)
        return ScriptedBackend(n, delay_polls=3)

    router = Router(backend_factory=factory, feasible_counts=[1, 2],
                    window=2, epsilon=0.0, device="cpu")
    before = router.backend
    hs = [router.submit(_req(i)) for i in range(3)]
    router.drain()
    assert all(h.done for h in hs)
    assert len(router.history) == 1 and router.history[0].n_requests == 3
    assert router.backend is not before or len(built) == 1
    # the swap happened only once nothing was in flight, and the new
    # backend's bucket counters start empty
    assert len(router._cid_buckets) == router.backend.capacity
    router.close()


def test_a_time_closed_window_observes_its_scaled_cost():
    seen = []

    class Recording:
        feasible = [1, 2]
        n_observations = 0

        def pick(self):
            return 1

        def observe(self, n, t, e, ttfc_p95_s=None):
            seen.append((n, t, e, ttfc_p95_s))

        def best(self):
            return 1

    router = Router(backend_factory=ScriptedBackend, scheduler=Recording(),
                    window=8, window_s=0.02, device="cpu")
    router.submit(_req(0)).result()
    router.submit(_req(1)).result()
    time.sleep(0.03)
    router.poll()                       # the window's time is up: observe
    assert len(router.history) == 1 and router.history[0].n_requests == 2
    w = router.history[0]
    (n, t, e, q), = seen
    assert n == 1 and t == pytest.approx(w.wall_s * 4)
    assert e == pytest.approx(w.energy_j * 4) and q == w.ttfc_p95_s
    time.sleep(0.03)
    router.poll()                       # an idle window only restarts
    assert len(router.history) == 1 and len(seen) == 1
    router.close()


def test_retry_hint_follows_the_last_windows_median_latency():
    router = Router(backend_factory=ScriptedBackend, feasible_counts=[1],
                    window=2, max_queue=0, device="cpu")
    with pytest.raises(RequestRejected) as ei:
        router.submit(_req(0)).result()
    assert ei.value.event.retry_after_s == 0.25   # no history yet
    router.max_queue = None
    for rid in (1, 2):
        router.submit(_req(rid))
    router.drain()
    assert len(router.history) == 1
    router.max_queue = 0
    p50 = router.history[-1].latency_p50_s
    with pytest.raises(RequestRejected) as ei:
        router.submit(_req(3)).result()
    assert ei.value.event.retry_after_s == max(0.05, p50)
    assert router.history[-1].n_shed == 1   # the first window's rejection
    router.history[-1].latency_p50_s = 0.7
    with pytest.raises(RequestRejected) as ei:
        router.submit(_req(4)).result()
    assert ei.value.event.retry_after_s == 0.7
    router.close()


def test_fixed_router_has_no_scheduler_and_the_fixed_hint():
    router = Router(ScriptedBackend(2), max_queue=0, device="cpu")
    with pytest.raises(RequestRejected) as ei:
        router.submit(_req(0)).result()
    assert ei.value.event.retry_after_s == 0.25
    assert router.history == [] and router.scheduler is None
    with pytest.raises(RuntimeError, match="no scheduler"):
        router.choice
    with pytest.raises(ValueError, match="backend_factory"):
        Router(device="cpu")
    with pytest.raises(ValueError, match="feasible_counts"):
        Router(backend_factory=ScriptedBackend, device="cpu")
    router.close()


# ---------------------------------------------------------------------------
# real containers: every count serves JAX's greedy tokens
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


CONFIG = EngineConfig(n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK)
SPECS = [(6, 3), (9, 4), (5, 2), (20, 7), (6, 1), (3, 5), (17, 5), (7, 6),
         (12, 2), (4, 4), (30, 3), (8, 6)]


def _specs(seed=1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(SPECS)]


@pytest.fixture(scope="module")
def jax_tokens(pair):
    """The JAX Router(ThreadBackend(1))'s greedy tokens of every spec."""
    jm, jp, _, _ = pair
    with jrouter.Router(jbackend.ThreadBackend(
            jm, jp, 1, config=jeng.EngineConfig(
                n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK))) as jr:
        hs = [jr.submit(jeng.Request(i, p.copy(), mn))
              for i, p, mn in _specs()]
        return {h.rid: h.tokens() for h in hs}


def _waves(size=4):
    reqs = [Request(i, p.copy(), mn) for i, p, mn in _specs()]
    return [reqs[i:i + size] for i in range(0, len(reqs), size)]


def test_the_adaptive_router_serves_jax_s_tokens_at_every_count(
        pair, jax_tokens):
    _, _, tm, tp = pair
    built = []

    def factory(n):
        built.append(n)
        return ThreadBackend(tm, tp, n, CONFIG, device="cpu")

    counts = card_feasible_counts(tm.cfg, CONFIG, card_bytes=1 << 34,
                                  max_containers=4)
    assert counts == [1, 2, 4]
    got = {}
    with Router(backend_factory=factory, feasible_counts=counts, window=4,
                epsilon=0.0, objective="energy", device="cpu") as router:
        for wave in _waves():
            ordered, results, wall, energy = router.serve_wave(wave)
            assert [c.rid for c in ordered] == [r.rid for r in wave]
            assert len(results) in counts and wall > 0 and energy > 0
            got.update({c.rid: list(c.tokens) for c in ordered})
        assert {w.n_containers for w in router.history} == {1, 2, 4}
        assert sorted(built) == [1, 2, 4]
        assert router.choice in counts
    assert got == jax_tokens


def test_the_adaptive_pool_serves_jax_s_tokens(pair, jax_tokens):
    _, _, tm, tp = pair
    apool = AdaptiveServingPool(tm, tp, [1, 2, 4], objective="energy",
                                config=CONFIG, device="cpu")
    got = {}
    for wave in _waves():
        out = apool.serve_wave(wave)
        assert [c.rid for c in out] == [r.rid for r in wave]
        got.update({c.rid: list(c.tokens) for c in out})
    assert [w.n_containers for w in apool.history] == [2, 1, 4]
    assert all(0.0 < w.latency_p50_s <= w.latency_p95_s <= w.wall_s
               for w in apool.history)
    assert apool.choice in (1, 2, 4)
    apool.close()
    assert got == jax_tokens


@pytest.mark.parametrize("n", [1, 2, 4])
def test_container_pool_serves_jax_s_tokens(pair, jax_tokens, n):
    _, _, tm, tp = pair
    reqs = [r for wave in _waves() for r in wave]
    pool = tpool.ContainerServingPool(tm, tp, n, CONFIG, device="cpu")
    ordered, results, wall, energy = pool.serve_timed(reqs)
    pool.close()
    assert [c.rid for c in ordered] == [r.rid for r in reqs]
    assert {c.rid: list(c.tokens) for c in ordered} == jax_tokens
    assert len(results) == n and sum(r.n_requests for r in results) == 12
    assert energy == pytest.approx(sum(r.energy_j for r in results))
    assert sum(r.n_tokens for r in results) == sum(
        len(c.tokens) for c in ordered)


def test_router_serve_wave_keeps_submission_order_and_accounts(pair):
    _, _, tm, tp = pair
    reqs = [r for wave in _waves() for r in wave][::-1]
    with Router(ThreadBackend(tm, tp, 2, CONFIG, device="cpu"),
                device="cpu") as router:
        ordered, results, wall, energy = router.serve_wave(reqs)
    assert [c.rid for c in ordered] == [r.rid for r in reqs]
    assert len(results) == 2 and energy > 0
    assert sum(r.n_requests for r in results) == len(reqs)
    assert all(0 < r.wall_s <= wall for r in results)

"""The port's Router + ThreadBackend against the JAX Router + ThreadBackend
on the same weights, for one and two containers: identical greedy tokens,
the same dispatch, and streamed chunks that concatenate to ``result()``.
Both sides get the same explicit ``chunk_tokens``."""
from __future__ import annotations

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
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request  # noqa: E402
from repro_torch.serving.events import ChunkEvent, DoneEvent  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402

ARCH = "qwen3-0.6b-reduced"
SLOTS, MAX_LEN, CHUNK = 2, 64, 4


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


def _routers(pair, n):
    jm, jp, tm, tp = pair
    jr = jrouter.Router(jbackend.ThreadBackend(
        jm, jp, n, config=jeng.EngineConfig(
            n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK)))
    tr = Router(ThreadBackend(
        tm, tp, n, config=EngineConfig(n_slots=SLOTS, max_len=MAX_LEN,
                                       chunk_tokens=CHUNK), device="cpu"),
        device="cpu")
    return jr, tr


SPECS = [(6, 3), (9, 4), (5, 2), (20, 7), (6, 1), (3, 0), (40, 5), (7, 6)]


@pytest.mark.parametrize("n", [1, 2])
def test_router_tokens_and_dispatch_match_jax(pair, n):
    specs = _specs(SPECS, seed=1)
    jr, tr = _routers(pair, n)
    with jr, tr:
        jh = [jr.submit(jeng.Request(i, p, mn)) for i, p, mn in specs]
        th = [tr.submit(Request(i, p, mn)) for i, p, mn in specs]
        assert ([h.container_id for h in th]
                == [h.container_id for h in jh])
        want = {h.rid: h.tokens() for h in jh}
        got = {h.rid: h.tokens() for h in th}
    assert got == want


@pytest.mark.parametrize("n", [1, 2])
def test_router_stream_concatenates_to_result(pair, n):
    specs = _specs([(6, 5), (9, 4), (5, 0), (12, 3), (7, 2)], seed=2)
    _, tr = _routers(pair, n)
    with tr:
        handles = [tr.submit(Request(i, p, mn)) for i, p, mn in specs]
        for h, (_, _, mn) in zip(handles, specs):
            evs = list(h.stream())
            assert isinstance(evs[-1], DoneEvent)
            assert all(isinstance(e, ChunkEvent) and e.rid == h.rid
                       for e in evs[:-1])
            stamps = [e.time_s for e in evs]
            assert stamps == sorted(stamps)
            streamed = [t for e in evs[:-1] for t in e.tokens]
            assert streamed == h.result().tokens
            assert len(streamed) == max(mn, 0)
            if mn > 0:
                assert h.ttfc_s is not None and h.ttfc_s >= 0.0
        assert tr.in_flight == 0


def test_router_interleaved_submission_matches_jax(pair):
    specs = _specs([(6, 4), (8, 3), (5, 4), (7, 2), (14, 5)], seed=3)
    jr, tr = _routers(pair, 2)
    with jr, tr:
        out = []
        for r, mk in ((jr, jeng.Request), (tr, Request)):
            reqs = [mk(i, p, mn) for i, p, mn in specs]
            h0 = r.submit(reqs[0])
            r.poll()                 # the first request starts decoding
            rest = [r.submit(q) for q in reqs[1:]]
            out.append({h.rid: h.tokens() for h in [h0, *rest]})
    assert out[1] == out[0]


def test_backend_drain_and_stats(pair):
    _, _, tm, tp = pair
    be = ThreadBackend(tm, tp, 2, config=EngineConfig(
        n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK), device="cpu")
    specs = _specs([(6, 3), (9, 2), (5, 4)], seed=4)
    be.submit(0, Request(*specs[0]))
    for s in specs[1:]:
        be.submit(1, Request(*s))
    assert (be.load(0), be.load(1)) == (1, 2)
    out = be.drain()
    assert sorted(c.rid for c in out[1][0]) == [1, 2]
    assert [len(c.tokens) for c in out[0][0]] == [3]
    assert be.stats(1)[1] == 6 and out[1][3] == 6
    be.close()
    assert be.capacity == 0


def test_router_rejects_duplicate_rid_and_closed_submit(pair):
    _, tr = _routers(pair, 1)
    p = np.arange(5, dtype=np.int32)
    tr.submit(Request(0, p, 3))
    with pytest.raises(ValueError, match="already in flight"):
        tr.submit(Request(0, p, 3))
    tr.drain()
    tr.close()
    with pytest.raises(RuntimeError, match="closed"):
        tr.submit(Request(1, p, 3))

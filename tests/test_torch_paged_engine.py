"""The port's paged ServingEngine against the JAX paged ServingEngine on
the same weights: identical greedy ``Completion.tokens`` and
``prefix_hit_tokens`` on the cases of tests/test_paged_cache.py — paged
matches dense with more requests in flight than ``n_slots``, block
exhaustion, ``max_len`` truncation, the ``EngineConfig`` surface, deferred
frees, and prefix sharing with its two-phase traffic — plus the Router
over a paged ThreadBackend. Both sides get the same requests (numpy,
seeded) and the same explicit ``chunk_tokens``."""
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
from repro_torch.models.cache import PagedLayout  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.cache import PagedCache  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.router import Router  # noqa: E402

ARCH = "qwen3-0.6b-reduced"
CHUNK = 8
# ragged prompts around the block boundary (15/16/17), ragged budgets, a
# 2-token prompt, more requests than the dense engine's 2 slots
SPEC = [(5, 4), (15, 3), (16, 5), (17, 2), (9, 6), (2, 1), (12, 8), (7, 5)]
DENSE = dict(n_slots=2, max_len=64)
PAGED = dict(n_slots=2, max_len=64, cache="paged", block_size=16)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _specs(plens_max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _serve(pair, phases, conf):
    """Drive the request phases through one JAX and one port engine,
    draining between phases. Returns ``{rid: (tokens, hit_tokens)}`` per
    side and the two engines."""
    jm, jp, tm, tp = pair
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(chunk_tokens=CHUNK,
                                                      **conf))
    te = ServingEngine(tm, tp, EngineConfig(chunk_tokens=CHUNK, **conf),
                       device="cpu")
    out = []
    for eng, mk in ((je, jeng.Request), (te, Request)):
        got = {}
        for specs in phases:
            eng.submit_many([mk(i, p.copy(), mn) for i, p, mn in specs])
            for c in eng.run():
                got[c.rid] = (list(c.tokens), c.prefix_hit_tokens)
        out.append(got)
    return out[0], out[1], je, te


def _tokens(got):
    return {rid: t for rid, (t, _) in got.items()}


def test_paged_matches_dense_and_jax(pair):
    specs = _specs(SPEC)
    want_dense, got_dense, _, _ = _serve(pair, [specs], DENSE)
    want, got, je, te = _serve(pair, [specs], PAGED)
    assert _tokens(got) == _tokens(want) == _tokens(want_dense)
    assert _tokens(got_dense) == _tokens(want_dense)
    assert te.peak_active == je.peak_active > DENSE["n_slots"]
    assert te.prefill_tokens_executed == je.prefill_tokens_executed


def test_paged_block_exhaustion_completes(pair):
    """A 3-block pool smaller than the workload: admission stalls on the
    head, frees blocks as requests finish and completes everything."""
    specs = _specs([(16, 4), (16, 4), (16, 4), (5, 2)])
    want, got, _, te = _serve(pair, [specs],
                              dict(PAGED, max_blocks=3))
    assert _tokens(got) == _tokens(want)
    assert te.peak_active <= 2
    cb = te.cache_backend
    assert cb.allocator.n_free + sum(len(b) for b in cb._blocks) == 3


def test_paged_respects_max_len_truncation(pair):
    specs = _specs([(8, 100), (30, 100), (17, 10)])
    want, got, _, _ = _serve(pair, [specs], dict(PAGED, max_len=32))
    assert _tokens(got) == _tokens(want)
    assert len(got[0][0]) == 32 - 8


def test_prompt_bucket_past_max_len_matches_jax(pair):
    """A 40-token prompt pads to a 64-token bucket past max_len=48: the
    dense ring wraps the padding over the prompt's first positions, the
    JAX paged scatter copies that ring, and the port does the same on
    both caches."""
    specs = _specs([(40, 6), (20, 5)], seed=9)
    want_dense, got_dense, _, _ = _serve(pair, [specs],
                                         dict(DENSE, max_len=48))
    want, got, _, _ = _serve(pair, [specs], dict(PAGED, max_len=48))
    assert (_tokens(got) == _tokens(got_dense) == _tokens(want)
            == _tokens(want_dense))


def test_engine_config_validation():
    with pytest.raises(ValueError, match="dense.*paged|paged.*dense"):
        EngineConfig(cache="bogus")
    with pytest.raises(ValueError, match="multiple"):
        EngineConfig(cache="paged", max_len=60, block_size=16)
    with pytest.raises(ValueError, match="prefix_cache"):
        EngineConfig(prefix_cache=True)
    cfg = EngineConfig(n_slots=2, max_len=64, cache="paged", block_size=16)
    assert cfg.resolved_max_blocks == 8          # dense footprint default
    assert cfg.resolved_max_seqs == 8
    assert cfg.n_rows == 8
    assert EngineConfig(n_slots=2, max_len=64).n_rows == 2
    for kw in (dict(cache="paged", max_len=64, max_blocks=5, max_seqs=3),
               dict(n_slots=3, max_len=32)):
        mine, ref = EngineConfig(**kw), jeng.EngineConfig(**kw)
        assert ((mine.resolved_max_blocks, mine.resolved_max_seqs,
                 mine.n_rows) == (ref.resolved_max_blocks,
                                  ref.resolved_max_seqs, ref.n_rows))


def test_can_admit_counts_deferred_frees():
    cache = PagedCache([], 2, PagedLayout(block_size=4, max_blocks=4), 16)
    assert cache.alloc(0, 16)                  # whole pool to row 0
    assert not cache.can_admit(4)              # live row: truly full
    cache.free(0)                              # deferred (awaiting flush)
    assert cache.allocator.n_free == 0
    assert cache.can_admit(16)                 # ...but all reclaimable
    cache.flush()
    assert cache.alloc(1, 16)


def test_admission_reclaims_deferred_frees_same_step(pair):
    """Each max_new=1 request finishes inside its admission batch on a
    pool one request wide; the engine flushes and keeps admitting within
    the same step, as the JAX engine does."""
    specs = _specs([(48, 1), (48, 1), (48, 1)])
    conf = dict(n_slots=4, max_len=64, cache="paged", block_size=16,
                max_blocks=4)
    jm, jp, tm, tp = pair
    te = ServingEngine(tm, tp, EngineConfig(chunk_tokens=CHUNK, **conf),
                       device="cpu")
    te.submit_many([Request(i, p, mn) for i, p, mn in specs])
    te.step()
    assert len(te.done) == 3 and te.steps == 1
    cb = te.cache_backend
    cb.flush()
    assert cb.allocator.n_free == 4 and cb.n_live_blocks == 0
    want, _, _, _ = _serve(pair, [specs], conf)
    assert {c.rid: list(c.tokens) for c in te.done} == _tokens(want)


# ---------------------------------------------------------------------------
# prefix sharing: the two-phase traffic of tests/test_paged_cache.py
# ---------------------------------------------------------------------------
SHARE_PREFIX_LEN = 64                 # four full 16-token blocks
SHARE_PHASE1 = [(80, 4)]              # seeds the prefix index alone
SHARE_PHASE2 = [(72, 3), (70, 4), (75, 2)]
SHARE = dict(n_slots=4, max_len=128, cache="paged", block_size=16)


def _shared_prefix_phases(seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 512, (SHARE_PREFIX_LEN,), dtype=np.int32)
    phases = []
    for rid0, specs in ((0, SHARE_PHASE1), (10, SHARE_PHASE2)):
        phases.append([
            (rid0 + i, np.concatenate([prefix, rng.integers(
                0, 512, (plen - SHARE_PREFIX_LEN,), dtype=np.int32)]), mn)
            for i, (plen, mn) in enumerate(specs)])
    return phases


def test_prefix_sharing_bit_parity_and_hits_match_jax(pair):
    phases = _shared_prefix_phases()
    want_on, on, je_on, te_on = _serve(pair, phases,
                                       dict(SHARE, prefix_cache=True))
    _, off, _, te_off = _serve(pair, phases,
                               dict(SHARE, prefix_cache=False))
    # on the port: sharing on == sharing off, bit for bit, and == JAX
    assert _tokens(on) == _tokens(off) == _tokens(want_on)
    assert on == want_on                       # hit tokens per request too
    assert [h for r, (_, h) in sorted(on.items()) if r >= 10] \
        == [SHARE_PREFIX_LEN] * len(SHARE_PHASE2)
    assert all(h == 0 for _, h in off.values())
    assert te_on.prefix_hit_tokens_total == je_on.prefix_hit_tokens_total \
        == SHARE_PREFIX_LEN * len(SHARE_PHASE2)
    assert te_on.prefill_tokens_executed == je_on.prefill_tokens_executed \
        < te_off.prefill_tokens_executed
    cb = te_on.cache_backend
    cb.flush()
    assert cb.allocator.n_free + cb.n_live_blocks == cb.layout.max_blocks


def test_block_hashes_match_jax_byte_for_byte(pair):
    jm, jp, tm, tp = pair
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(
        prefix_cache=True, chunk_tokens=CHUNK, **SHARE))
    te = ServingEngine(tm, tp, EngineConfig(prefix_cache=True,
                                            chunk_tokens=CHUNK, **SHARE),
                       device="cpu")
    for _, prompt, mn in _specs([(80, 1), (16, 1), (15, 1), (33, 1)]):
        assert (te._block_hashes(Request(0, prompt, mn))
                == je._block_hashes(jeng.Request(0, prompt, mn)))


def test_router_over_paged_backend_matches_jax(pair):
    """Two paged, prefix-sharing containers behind the Router: the same
    dispatch, tokens and hit counts as the JAX Router, and the hit count
    reaches ``CompletionHandle.result()``."""
    jm, jp, tm, tp = pair
    conf = dict(SHARE, prefix_cache=True, chunk_tokens=CHUNK)
    jr = jrouter.Router(jbackend.ThreadBackend(
        jm, jp, 2, config=jeng.EngineConfig(**conf)))
    tr = Router(ThreadBackend(tm, tp, 2, config=EngineConfig(**conf),
                              device="cpu"), device="cpu")
    out = []
    with jr, tr:
        for r, mk in ((jr, jeng.Request), (tr, Request)):
            got = {}
            for specs in _shared_prefix_phases(seed=1):
                hs = [r.submit(mk(i, p.copy(), mn)) for i, p, mn in specs]
                for h in hs:
                    c = h.result()
                    got[c.rid] = (h.container_id, list(c.tokens),
                                  c.prefix_hit_tokens)
            out.append(got)
    assert out[1] == out[0]
    assert any(h > 0 for _, _, h in out[1].values())

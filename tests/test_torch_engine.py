"""The port's ServingEngine against the JAX ServingEngine on the same
weights: identical greedy ``Completion.tokens`` (and the same event
stream shape) on the cases of tests/test_serving.py and
tests/test_decode_chunk.py — ragged prompts and budgets, mid-chunk
finishes, zero-budget requests, ``max_len`` truncation and interleaved
submission. Both sides get the same explicit ``chunk_tokens``."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.events import ChunkEvent, DoneEvent  # noqa: E402

ARCH = "qwen3-0.6b-reduced"


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


def _engines(pair, n_slots, max_len, chunk):
    jm, jp, tm, tp = pair
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(
        n_slots=n_slots, max_len=max_len, chunk_tokens=chunk))
    te = ServingEngine(tm, tp, EngineConfig(
        n_slots=n_slots, max_len=max_len, chunk_tokens=chunk), device="cpu")
    return je, te


def _serve_both(pair, specs, n_slots=2, max_len=64, chunk=4):
    je, te = _engines(pair, n_slots, max_len, chunk)
    je.submit_many([jeng.Request(i, p, mn) for i, p, mn in specs])
    te.submit_many([Request(i, p, mn) for i, p, mn in specs])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    return want, got, je, te


@pytest.mark.parametrize("plens_max_new,seed", [
    # ragged prompts across buckets, ragged budgets: the chunk clamps to
    # the shortest budget, slots refill mid-stream, zero/negative budgets
    # complete empty
    ([(6, 3), (9, 4), (5, 2), (20, 7), (6, 1), (3, 0), (40, 5), (7, -2)], 1),
    # more requests than slots in one bucket: batched admission + refill
    ([(8, 4)] * 5 + [(30, 6)] * 3, 2),
])
def test_engine_tokens_match_jax(pair, plens_max_new, seed):
    want, got, je, te = _serve_both(pair, _specs(plens_max_new, seed))
    assert got == want
    assert te.tokens_generated == je.tokens_generated
    assert te.prefill_tokens_executed == je.prefill_tokens_executed


def test_engine_max_len_truncation_matches_jax(pair):
    """Budgets past the horizon stop at max_len - 1, and a prompt whose
    padded bucket exceeds max_len wraps its prefill into the ring exactly
    as the JAX engine does."""
    specs = _specs([(8, 100), (20, 9), (3, 30)], seed=3)
    want, got, _, _ = _serve_both(pair, specs, n_slots=2, max_len=24)
    assert got == want
    assert 0 < len(got[0]) <= 24 - 8


def test_engine_interleaved_submission_matches_jax(pair):
    specs = _specs([(6, 4), (8, 3), (5, 4), (7, 2), (12, 5)], seed=4)
    je, te = _engines(pair, 2, 64, 2)
    for eng, mk in ((je, jeng.Request), (te, Request)):
        reqs = [mk(i, p, mn) for i, p, mn in specs]
        eng.submit(reqs[0])
        eng.step()
        eng.submit(reqs[1])
        eng.step()
        eng.step()
        eng.submit_many(reqs[2:])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    assert got == want and len(got) == len(specs)


def test_engine_events_concatenate_to_completion(pair):
    _, _, tm, tp = pair
    te = ServingEngine(tm, tp, EngineConfig(n_slots=2, max_len=64,
                                            chunk_tokens=4), device="cpu")
    events = []
    te.on_event = events.append
    specs = _specs([(6, 5), (9, 3), (4, 0)], seed=5)
    te.submit_many([Request(i, p, mn) for i, p, mn in specs])
    done = {c.rid: list(c.tokens) for c in te.run()}
    for rid, _, mn in specs:
        mine = [e for e in events if e.rid == rid]
        assert isinstance(mine[-1], DoneEvent)
        assert all(isinstance(e, ChunkEvent) for e in mine[:-1])
        assert [t for e in mine[:-1] for t in e.tokens] == done[rid]
        assert len(done[rid]) == max(mn, 0)
    # every step that found work ran exactly one fused decode chunk
    assert te.chunks == te.steps


def test_engine_chunk_lengths_are_powers_of_two(pair, monkeypatch):
    _, _, tm, tp = pair
    te = ServingEngine(tm, tp, EngineConfig(n_slots=2, max_len=64,
                                            chunk_tokens=8), device="cpu")
    seen = []
    real = tm.decode_chunk

    def spy(params, cache, state, n_tokens, *, max_len):
        seen.append(n_tokens)
        return real(params, cache, state, n_tokens, max_len=max_len)
    monkeypatch.setattr(tm, "decode_chunk", spy)
    te.submit_many([Request(i, p, mn) for i, p, mn in
                    _specs([(6, 12), (7, 4)], seed=6)])
    te.run()
    assert seen and all(n & (n - 1) == 0 and n <= 8 for n in seen)
    assert seen[0] == 2          # clamped by the 3 tokens rid 1 still owes

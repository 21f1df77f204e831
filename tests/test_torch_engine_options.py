"""The port's engine options against the JAX engine's, on the same weights:
the per-token baseline (``chunked=False``), one-at-a-time admission
(``batch_admit=False``), ``run``'s step budget, ``Request.extras`` in the
admit key and the block hashes, sampling (``greedy=False``) and deadlines.

Greedy streams are held bit for bit against JAX's over qwen3, stablelm,
mamba2 and deepseek reduced, on the dense, paged and int8 caches. Sampled
tokens are never compared with JAX's: a sampled stream is held to its own
contract (chunked = per-token, a seed reproduces, another seed differs)
and the sampler's frequencies, beside JAX's ``categorical`` on the same
logits, to a chi-square test against ``softmax``."""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import sampling  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.events import ChunkEvent, DoneEvent  # noqa: E402
from repro_torch.serving.events import FailedEvent  # noqa: E402

QWEN = "qwen3-0.6b-reduced"
# (arch, int8 KV cache, cache kind)
KINDS = {"qwen3_dense": (QWEN, False, "dense"),
         "qwen3_paged": (QWEN, False, "paged"),
         "qwen3_int8_dense": (QWEN, True, "dense"),
         "qwen3_int8_paged": (QWEN, True, "paged"),
         "stablelm_dense": ("stablelm-1.6b-reduced", False, "dense"),
         "stablelm_paged": ("stablelm-1.6b-reduced", False, "paged"),
         "mamba2": ("mamba2-2.7b-reduced", False, "dense"),
         "deepseek_dense": ("deepseek-v2-lite-16b-reduced", False, "dense"),
         "deepseek_paged": ("deepseek-v2-lite-16b-reduced", False, "paged")}
SLOTS, MAX_LEN, CHUNK = 2, 64, 4


@pytest.fixture(scope="module")
def weights():
    """JAX parameters per arch (seed 0) and their numpy leaves."""
    out = {}
    for name in {arch for arch, _, _ in KINDS.values()}:
        jp = JaxModel(jax_config(name)).init(jax.random.PRNGKey(0))
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _pair(weights, arch, int8=False):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if int8:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    jp, tree = weights[arch]
    tm = Model(tcfg, device="cpu")
    return JaxModel(jcfg), jp, tm, bridge.from_numpy(tcfg, tree,
                                                    device="cpu")


def _specs(plens_max_new, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _serve(eng, specs, mk):
    eng.submit_many([mk(i, p.copy(), mn) for i, p, mn in specs])
    return {c.rid: list(c.tokens) for c in eng.run()}


def _port(tm, tp, **kw):
    return ServingEngine(tm, tp, EngineConfig(
        n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK, **kw),
        device="cpu")


def _jax(jm, jp, **kw):
    return jeng.ServingEngine(jm, jp, jeng.EngineConfig(
        n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK, **kw))


# mamba2's prompts are prefilled unpadded: lengths its 256-token chunk
# (min(256, S)) divides, here any S <= 64
SPECS = [(6, 5), (9, 3), (7, 6), (6, 4), (12, 2)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_per_token_greedy_equals_jax_and_the_chunked_engine(weights, kind):
    """``chunked=False``: one decode step, one pick and one host read a
    token, one ChunkEvent a token, and greedy streams equal to JAX's
    per-token engine and to the port's chunked engine."""
    arch, int8, cache = KINDS[kind]
    jm, jp, tm, tp = _pair(weights, arch, int8)
    specs = _specs(SPECS, seed=1)
    want = _serve(_jax(jm, jp, cache=cache, chunked=False), specs,
                  jeng.Request)
    tok = _port(tm, tp, cache=cache, chunked=False)
    events = []
    tok.on_event = events.append
    prefills = []
    real = tm.prefill

    def spy(*args, **kw):
        prefills.append(1)
        return real(*args, **kw)
    tm.prefill = spy
    try:
        got = _serve(tok, specs, Request)
    finally:
        del tm.prefill
    chunked = _serve(_port(tm, tp, cache=cache), specs, Request)
    assert got == want == chunked
    assert tok.chunks == 0 and tok._buf is None
    assert tok.tokens_generated == sum(len(t) for t in got.values())
    # one host read a prefill batch and one a decode step (every step
    # decodes: no budget ends at its prefill sample)
    assert tok.host_reads == len(prefills) + tok.steps
    chunks = [e for e in events if isinstance(e, ChunkEvent)]
    assert all(len(e.tokens) == 1 for e in chunks)
    assert len(chunks) == tok.tokens_generated
    assert sum(isinstance(e, DoneEvent) for e in events) == len(specs)


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("chunked", [True, False])
def test_batch_admit_false_equals_jax(weights, cache, chunked):
    """One request a prefill (a dense queue head alone, a paged run of
    one): the same streams and prefill work as JAX's engine."""
    jm, jp, tm, tp = _pair(weights, QWEN)
    specs = _specs([(8, 4)] * 3 + [(6, 3), (20, 5), (7, 2)], seed=2)
    je = _jax(jm, jp, cache=cache, batch_admit=False, chunked=chunked)
    te = _port(tm, tp, cache=cache, batch_admit=False, chunked=chunked)
    calls = []
    real = tm.prefill

    def spy(params, tokens, cache_, logits_at=-1, **kw):
        calls.append(tokens.shape[0])
        return real(params, tokens, cache_, logits_at=logits_at, **kw)
    tm.prefill = spy
    try:
        got = _serve(te, specs, Request)
    finally:
        del tm.prefill
    assert got == _serve(je, specs, jeng.Request)
    assert calls == [1] * len(specs)
    assert te.prefill_tokens_executed == je.prefill_tokens_executed
    assert te.peak_active == je.peak_active


def test_run_budget_counts_admit_only_steps(weights):
    """As tests/test_serving.py:193: every ``step()`` counts against
    ``run``'s budget, admit-only ones included, in both engines."""
    jm, jp, tm, tp = _pair(weights, QWEN)
    specs = _specs([(6, 1)] * 5, seed=3)
    out = []
    for eng, mk in ((jeng.ServingEngine(jm, jp, jeng.EngineConfig(
            n_slots=1, max_len=MAX_LEN)), jeng.Request),
            (ServingEngine(tm, tp, EngineConfig(n_slots=1, max_len=MAX_LEN),
                           device="cpu"), Request)):
        eng.submit_many([mk(i, p, mn) for i, p, mn in specs])
        with pytest.warns(RuntimeWarning, match="exhausted max_steps"):
            done = eng.run(max_steps=3)
        assert len(done) == 3 and eng.has_work and eng.budget_exhausted
        rest = eng.run()
        assert len(rest) == 2 and not eng.budget_exhausted
        out.append([list(c.tokens) for c in done + rest])
    assert out[0] == out[1]


def test_run_budget_exhaustion_warns_and_flags(weights):
    """As tests/test_serving.py:208: a budget that runs out with work left
    warns and sets ``budget_exhausted``; a run that drains clears it
    without a warning."""
    jm, jp, tm, tp = _pair(weights, QWEN)
    specs = _specs([(6, 4)] * 3, seed=4)
    for eng, mk in ((jeng.ServingEngine(jm, jp, jeng.EngineConfig(
            n_slots=1, max_len=MAX_LEN, chunk_tokens=1)), jeng.Request),
            (ServingEngine(tm, tp, EngineConfig(
                n_slots=1, max_len=MAX_LEN, chunk_tokens=1),
                device="cpu"), Request)):
        assert eng.budget_exhausted is False
        eng.submit_many([mk(i, p, mn) for i, p, mn in specs])
        with pytest.warns(RuntimeWarning, match="partial completions"):
            partial = eng.run(max_steps=2)
        assert eng.budget_exhausted and len(partial) < 3
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rest = eng.run()
        assert not eng.budget_exhausted
        assert len(partial) + len(rest) == 3


EXTRAS = [{}, {"b": np.arange(3, dtype=np.int32)},
          {"b": np.arange(3, dtype=np.int32),
           "a": np.ones((2, 2), np.float32)},
          {"a": np.zeros(4, np.float32)}]


@pytest.mark.parametrize("extras", range(len(EXTRAS)))
def test_extras_enter_the_admit_key_and_block_hashes_as_in_jax(weights,
                                                               extras):
    jm, jp, tm, tp = _pair(weights, QWEN)
    conf = dict(cache="paged", block_size=8, prefix_cache=True)
    je, te = _jax(jm, jp, **conf), _port(tm, tp, **conf)
    prompt = np.random.default_rng(5).integers(0, 512, (37,),
                                                dtype=np.int32)
    ex = EXTRAS[extras]
    jr = jeng.Request(0, prompt, 4, extras=ex)
    tr = Request(0, prompt, 4, extras=ex)
    assert te._block_hashes(tr) == je._block_hashes(jr)
    assert te._admit_key(tr) == je._admit_key(jr)
    plan = (16, [], [])
    assert te._key_for(tr, plan) == je._key_for(jr, plan)
    # extras change both: no request with other extras shares a hash or
    # a prefill batch with this one
    plain = Request(0, prompt, 4)
    if ex:
        assert te._block_hashes(tr)[0] != te._block_hashes(plain)[0]
        assert te._admit_key(tr) != te._admit_key(plain)


def test_extras_split_admission_batches_as_in_jax(weights):
    """Same-bucket requests whose extras differ by name prefill apart, in
    both engines, and their (text-only) streams stay JAX's."""
    jm, jp, tm, tp = _pair(weights, QWEN)
    specs = _specs([(8, 3)] * 4, seed=6)
    ex = [{}, {"x": np.arange(2)}, {}, {"x": np.arange(2)}]
    out = []
    for eng, mk in ((_jax(jm, jp), jeng.Request), (_port(tm, tp), Request)):
        eng.submit_many([mk(i, p, mn, extras=e)
                         for (i, p, mn), e in zip(specs, ex)])
        out.append({c.rid: list(c.tokens) for c in eng.run()})
        assert eng.prefill_tokens_executed == 32
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# sampling: held to its own contract, never to JAX's bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_sampled_chunked_equals_per_token_and_the_seed_reproduces(weights,
                                                                  cache):
    """One random stream an engine, one draw a pick (the prefill sample,
    then every decode step), so a chunked engine and a per-token one with
    the same seed sample the same streams; the seed reproduces them and
    another seed differs."""
    _, _, tm, tp = _pair(weights, QWEN)
    specs = _specs([(6, 6), (8, 4), (7, 5), (9, 7)], seed=7)

    def serve(seed, chunked, chunk=CHUNK):
        eng = ServingEngine(tm, tp, EngineConfig(
            n_slots=SLOTS, max_len=MAX_LEN, cache=cache, greedy=False,
            seed=seed, chunked=chunked, chunk_tokens=chunk), device="cpu")
        return _serve(eng, specs, Request), eng
    want, per_token = serve(13, False)
    got, chunked = serve(13, True)
    assert got == want
    assert serve(13, True, chunk=3)[0] == want
    assert serve(14, True)[0] != want
    assert per_token.draws == chunked.draws > per_token.chunks
    greedy = _serve(_port(tm, tp, cache=cache), specs, Request)
    assert got != greedy
    assert [len(got[i]) for i, _, _ in specs] == [m for _, _, m in specs]


def test_the_chunk_step_advances_the_stream_and_equals_its_picks(weights):
    """A sampling chunk of n steps takes draws k..k+n-1 and leaves the key
    at k + n; each step's token is the Gumbel-max of that step's logits
    under its draw, so the chunk equals n single picks."""
    _, _, tm, tp = _pair(weights, QWEN)
    rng = np.random.default_rng(8)
    cache = tm.init_cache(3, MAX_LEN)
    toks = torch.from_numpy(rng.integers(0, 512, (3, 10), dtype=np.int32))
    tm.prefill(tp, toks, cache)
    cache2 = [{k: t.clone() for k, t in g.items()} for g in cache]
    state = {"tokens": toks[:, -1].clone(),
             "pos": torch.full((3,), 10, dtype=torch.int32),
             "remaining": torch.tensor([2, 6, 6], dtype=torch.int32),
             "active": torch.tensor([True, True, False]),
             "key": sampling.new_key(5, 40)}
    block, emitted, new = tm.decode_chunk(tp, cache, dict(state), 4,
                                          max_len=MAX_LEN, greedy=False)
    assert new["key"].tolist() == [5, 44]
    assert emitted.tolist() == [2, 4, 0]
    tok, pos = state["tokens"].clone(), state["pos"].clone()
    for step in range(4):
        logits = tm.decode_step(tp, tok[:, None], cache2, pos)
        pick = sampling.gumbel_argmax(logits, sampling.new_key(5, 40 + step))
        for row, n in enumerate(emitted.tolist()):
            if step < n:
                assert block[row, step].item() == pick[row].item()
        act = torch.tensor([step < n for n in emitted.tolist()])
        tok = torch.where(act, pick.to(torch.int32), tok)
        pos = torch.where(act, pos + 1, pos)


def test_sampler_noise_depends_on_seed_draw_and_element_only():
    key = sampling.new_key(3, 9)
    u = sampling.uniform(key, 5, 1000)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    # a row's noise does not depend on how many rows the call has
    assert torch.equal(sampling.uniform(key, 2, 1000), u[:2])
    assert not torch.equal(sampling.uniform(sampling.new_key(3, 10), 5,
                                            1000), u)
    assert not torch.equal(sampling.uniform(sampling.new_key(4, 9), 5,
                                            1000), u)
    # consecutive draws are uncorrelated
    a = sampling.uniform(sampling.new_key(3, 0), 1, 100_000)[0].double()
    b = sampling.uniform(sampling.new_key(3, 1), 1, 100_000)[0].double()
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.02
    assert abs(float(a.mean()) - 0.5) < 0.01


LOGITS16 = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25,
                     3.0, -2.0, 0.75, -0.25, 1.25, 0.1, -1.5, 2.5],
                    np.float32)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_frequencies_pass_chi_square_beside_jax(seed):
    """One fixed 16-way logits row repeated 20,000 times, one call: the
    port's frequencies and JAX's ``categorical``'s on the same logits
    each pass a chi-square test against ``softmax`` at p > 1e-3."""
    n = 20_000
    p = np.exp(LOGITS16.astype(np.float64) - LOGITS16.max())
    p /= p.sum()
    logits = torch.from_numpy(np.tile(LOGITS16, (n, 1)))
    got = sampling.gumbel_argmax(logits, sampling.new_key(seed)).numpy()
    jgot = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(seed), jnp.asarray(np.tile(LOGITS16, (n, 1)))))
    for draws in (got, jgot):
        counts = np.bincount(draws, minlength=16)
        assert stats.chisquare(counts, p * n).pvalue > 1e-3
    # bf16 logits sample in float32
    b = sampling.gumbel_argmax(logits.to(torch.bfloat16)[:64],
                               sampling.new_key(seed))
    assert torch.equal(b, sampling.gumbel_argmax(
        logits.to(torch.bfloat16).float()[:64], sampling.new_key(seed)))


# ---------------------------------------------------------------------------
# engine deadlines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_deadlines_fail_typed_and_free_as_jax(weights, cache,
                                                     monkeypatch):
    """On a fake clock both engines expire a queued request and an active
    one at the top of a step: the same FailedEvents (kind, reason), the
    freed slot (paged: blocks conserved) and the same streams for the
    rest."""
    jm, jp, tm, tp = _pair(weights, QWEN)
    specs = _specs([(6, 30), (9, 30), (7, 4)], seed=9)
    out = []
    one = dict(cache=cache, chunk_tokens=1)
    for eng, mk in ((jeng.ServingEngine(jm, jp, jeng.EngineConfig(
            n_slots=SLOTS, max_len=MAX_LEN, **one)), jeng.Request),
            (ServingEngine(tm, tp, EngineConfig(
                n_slots=SLOTS, max_len=MAX_LEN, **one), device="cpu"),
             Request)):
        clock = [100.0]
        monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
        events = []
        eng.on_event = events.append
        deadlines = [1.0, 5.0, None]
        eng.submit_many([mk(i, p, mn, deadline_s=d)
                         for (i, p, mn), d in zip(specs, deadlines)])
        eng.step()                    # dense: 0 and 1 admitted, 2 queued
        eng.step()
        clock[0] = 101.5              # request 0 expires mid-decode
        eng.step()
        clock[0] = 106.0              # request 1 too
        while eng.has_work:
            eng.step()
        monkeypatch.undo()
        # each package's own event classes, compared by name
        fails = [(e.rid, e.kind, e.reason) for e in events
                 if type(e).__name__ == "FailedEvent"]
        done = {e.rid: list(e.completion.tokens) for e in events
                if type(e).__name__ == "DoneEvent"}
        out.append((fails, done))
        if cache == "paged":
            cb = eng.cache_backend
            cb.flush()
            assert cb.allocator.n_free + cb.n_live_blocks == \
                cb.layout.max_blocks
    assert out[0] == out[1]
    fails, done = out[1]
    assert [f[:2] for f in fails] == [(0, "deadline"), (1, "deadline")]
    assert "mid-decode" in fails[0][2] and sorted(done) == [2]


def test_engine_deadline_while_queued_and_cancel(weights, monkeypatch):
    """A request that expires in the queue leaves it with the queued
    reason; a cancelled request's deadline is forgotten."""
    _, _, tm, tp = _pair(weights, QWEN)
    clock = [10.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    eng = ServingEngine(tm, tp, EngineConfig(n_slots=1, max_len=MAX_LEN,
                                             chunk_tokens=1), device="cpu")
    events = []
    eng.on_event = events.append
    specs = _specs([(6, 20), (6, 3), (6, 3)], seed=10)
    eng.submit_many([Request(i, p, mn, deadline_s=0.5)
                     for i, p, mn in specs])
    eng.step()                          # 0 admitted, 1 and 2 queued
    assert eng.cancel(2) and 2 not in eng._deadline_abs
    clock[0] = 11.0
    eng.step()
    fails = {e.rid: e.reason for e in events if isinstance(e, FailedEvent)}
    assert fails == {0: "deadline expired mid-decode after 2 tokens",
                     1: "deadline expired while queued"}
    assert not eng.has_work

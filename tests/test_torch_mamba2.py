"""The port's SSM family against the JAX package on the same weights
(``mamba2-2.7b-reduced``: 2 layers, d_model 256, 32 SSD heads of width
16, state 16, chunk 32): the Mamba2 block's prefill output, conv tail and
final state and its decode steps, the model's prefill and decode logits
(all float32, to 1e-4), and greedy completions of the ServingEngine and
of Router(ThreadBackend(2)), identical to the JAX package's for ragged,
unpadded prompts. A prompt the scan's chunk does not divide raises in
both packages (a reference-side caveat the port keeps)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.router import Router  # noqa: E402

ARCH = "mamba2-2.7b-reduced"
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["stack"])


def test_weights_cross_with_float32_leaves_kept():
    cfg = get_config(ARCH)
    jp = JaxModel(jax_config(ARCH)).init(jax.random.PRNGKey(1))
    tp = bridge.from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                           dtype=torch.bfloat16)
    m = tp["layers"][1]["mamba"]
    assert len(tp["layers"]) == cfg.n_layers and set(tp["layers"][0]) == {
        "ln", "mamba"}
    for name in ssm.F32_LEAVES:
        assert m[name].dtype == torch.float32
        assert np.array_equal(m[name].numpy(),
                              np.asarray(jp["stack"]["mamba"][name][1]))
    assert m["in_proj"].dtype == m["conv_w"].dtype == torch.bfloat16
    di, nh = cfg.d_inner, cfg.ssm_n_heads
    assert m["in_proj"].shape == (cfg.d_model,
                                  2 * di + 2 * cfg.ssm_state + nh)


def test_port_init_matches_the_reference_shapes_and_constants():
    cfg = get_config(ARCH)
    tp = Model(cfg, device="cpu").init(seed=3, dtype=torch.bfloat16)
    jp = JaxModel(jax_config(ARCH)).init(jax.random.PRNGKey(3),
                                         dtype=jnp.bfloat16)
    jm = _layer(jp, 0)["mamba"]
    tm = tp["layers"][0]["mamba"]
    for name, t in tm.items():
        if isinstance(t, dict):
            continue
        assert tuple(t.shape) == jm[name].shape, name
        assert t.dtype == (torch.float32 if name in ssm.F32_LEAVES
                           else torch.bfloat16), name
        assert str(jm[name].dtype) == str(t.dtype).split(".")[1], name
    for name in ("dt_bias", "D"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-6)
    A = torch.exp(tm["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0


def test_mamba2_block_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    B, S = 2, 64
    x = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    jpl = _layer(jp, 1)["mamba"]
    tpl = tp["layers"][1]["mamba"]
    wy, wcache = jssm.mamba2_fwd(jpl, jm.cfg, jnp.asarray(x),
                                 return_cache=True)
    cache = ssm.init_mamba2_cache(cfg, B, torch.float32,
                                  torch.device("cpu"))
    y = ssm.mamba2_fwd(tpl, cfg, torch.from_numpy(x), cache)
    _close(y, wy)
    _close(cache["conv"], wcache["conv"])
    _close(cache["state"], wcache["state"])
    for t in range(5):
        xt = (0.5 * rng.standard_normal((B, 1, cfg.d_model))).astype(
            np.float32)
        wy, wcache = jssm.mamba2_decode(jpl, jm.cfg, jnp.asarray(xt), wcache)
        y = ssm.mamba2_decode(tpl, cfg, torch.from_numpy(xt), cache)
        _close(y, wy)
        _close(cache["conv"], wcache["conv"])
        _close(cache["state"], wcache["state"])


def test_softplus_is_jax_softplus_past_the_torch_threshold():
    x = np.array([-50.0, -3.0, 0.0, 2.0, 19.5, 20.5, 40.0], np.float32)
    _close(ssm.softplus(torch.from_numpy(x)), jax.nn.softplus(x))


def test_model_prefill_and_decode_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    B, S = 2, 64
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S), dtype=np.int32)
    wl, wcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(B, S))
    cache = tm.init_cache(B, S)
    logits = tm.prefill(tp, torch.from_numpy(toks), cache)
    _close(logits, wl)
    for i, c in enumerate(cache):
        _close(c["state"], wcache["stack"]["state"][i])
        _close(c["conv"], wcache["stack"]["conv"][i])
    pos = np.full((B,), S, np.int32)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)[:, None]
        wl, wcache = jm.decode_step(jp, jnp.asarray(tok), wcache,
                                    jnp.asarray(pos))
        logits = tm.decode_step(tp, torch.from_numpy(tok), cache,
                                torch.from_numpy(pos.copy()))
        _close(logits, wl)
        pos += 1


def test_prefill_suffix_and_paged_cache_are_refused(pair):
    """Prefix sharing is refused; a paged layout pages nothing of an SSM
    model (its cache is the dense state rows, as in JAX; the paged engine
    runs its block accounting beside them, tests/test_torch_paged_ssm.py)."""
    from repro_torch.models.cache import PagedLayout
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="prefix sharing unsupported"):
        tm.prefill_suffix(tp, torch.zeros((1, 4), dtype=torch.int32),
                          tm.init_cache(1, 4), [], 16)
    paged = tm.init_cache(1, 32, layout=PagedLayout(16, 4))
    dense = tm.init_cache(1, 32)
    assert [{k: t.shape for k, t in g.items()} for g in paged] == [
        {k: t.shape for k, t in g.items()} for g in dense]


def _specs(plens_max_new, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _serve_both(pair, specs, monkeypatch, n_slots=2, max_len=128,
                chunk=3):
    """Both engines serve ``specs``; the port's prefill batch shapes are
    recorded."""
    jm, jp, tm, tp = pair
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(
        n_slots=n_slots, max_len=max_len, chunk_tokens=chunk))
    te = ServingEngine(tm, tp, EngineConfig(
        n_slots=n_slots, max_len=max_len, chunk_tokens=chunk), device="cpu")
    widths = []
    prefill = tm.prefill

    def recording_prefill(params, tokens, cache, logits_at=-1, **kw):
        widths.append(tuple(tokens.shape))
        return prefill(params, tokens, cache, logits_at=logits_at, **kw)
    monkeypatch.setattr(tm, "prefill", recording_prefill)
    je.submit_many([jeng.Request(i, p, mn) for i, p, mn in specs])
    te.submit_many([Request(i, p, mn) for i, p, mn in specs])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    return want, got, je, te, widths


@pytest.mark.parametrize("plens_max_new,seed", [
    # ragged prompts and budgets, as tests/test_decode_chunk.py
    ([(6, 5), (9, 3), (7, 6), (6, 4)], 0),
    # one- and two-chunk prefills at chunk 32, and a same-length pair
    ([(32, 4), (64, 5), (12, 3), (12, 6), (31, 2)], 1),
])
def test_engine_greedy_tokens_match_jax_unpadded(pair, plens_max_new, seed,
                                                monkeypatch):
    specs = _specs(plens_max_new, seed)
    want, got, je, te, widths = _serve_both(pair, specs, monkeypatch)
    assert got == want
    assert te.tokens_generated == je.tokens_generated
    assert te.prefill_tokens_executed == je.prefill_tokens_executed
    # every prefill batch is exactly as wide as its prompts: no padding
    assert {w for _, w in widths} <= {len(p) for _, p, _ in specs}
    assert sum(n * w for n, w in widths) == sum(len(p) for _, p, _ in specs)


def test_same_length_prompts_prefill_as_one_batch(pair, monkeypatch):
    specs = _specs([(12, 3), (12, 4), (9, 2)], seed=2)
    want, got, _, _, widths = _serve_both(pair, specs, monkeypatch,
                                          n_slots=3)
    assert got == want
    assert sorted(widths) == [(1, 9), (2, 12)]


def test_prompt_the_chunk_does_not_divide_raises_in_both_engines(pair):
    """40 tokens at chunk 32: the JAX oracle asserts inside run(), and the
    port raises where it does (a reference-side caveat, ROADMAP queue 3)."""
    jm, jp, tm, tp = pair
    prompt = np.arange(40, dtype=np.int32)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(
        n_slots=1, max_len=64, chunk_tokens=4))
    je.submit(jeng.Request(0, prompt, 3))
    with pytest.raises(AssertionError):
        je.run()
    te = ServingEngine(tm, tp, EngineConfig(n_slots=1, max_len=64,
                                            chunk_tokens=4), device="cpu")
    te.submit(Request(0, prompt, 3))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        te.run()


def test_router_two_containers_match_jax(pair):
    jm, jp, tm, tp = pair
    specs = _specs([(6, 5), (9, 3), (7, 6), (6, 4), (32, 3), (64, 4)],
                   seed=3)
    jr = jrouter.Router(jbackend.ThreadBackend(
        jm, jp, 2, config=jeng.EngineConfig(n_slots=2, max_len=128,
                                            chunk_tokens=3)))
    tr = Router(ThreadBackend(tm, tp, 2, config=EngineConfig(
        n_slots=2, max_len=128, chunk_tokens=3), device="cpu"),
        device="cpu")
    with jr, tr:
        jh = [jr.submit(jeng.Request(i, p, mn)) for i, p, mn in specs]
        th = [tr.submit(Request(i, p, mn)) for i, p, mn in specs]
        assert [h.container_id for h in th] == [h.container_id for h in jh]
        want = {h.rid: list(h.result().tokens) for h in jh}
        got = {h.rid: list(h.result().tokens) for h in th}
    assert got == want
    assert all(len(got[i]) == mn for i, _, mn in specs)

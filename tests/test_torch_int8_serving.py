"""The port's int8 KV cache against the JAX package's on the same weights.

A reduced qwen3 with ``kv_cache_dtype="int8"`` (selected as the JAX
package's own tests select it, ``dataclasses.replace``), weights from the
JAX ``Model.init`` through ``params.from_numpy``:

* the model: after prefill the cache codes are EXACTLY JAX's and the
  scales within 1e-5 relative (they are absmax / 127 of keys and values
  that the two sides project with sums in another order); the logits
  after prefill and after decode steps are within 1e-4 (f32), over the
  dense ring and over pages;
* ``ServingEngine`` over the dense and the paged int8 cache, and
  ``Router(ThreadBackend(2))``: greedy completions identical to the JAX
  engine's and Router's on the same requests;
* prefix sharing is off for an int8 cache in both packages: with
  ``prefix_cache=True`` no hit tokens and the same tokens as without.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.cache import PagedLayout as JaxLayout  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.cache import PagedLayout  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.router import Router  # noqa: E402

ARCH = "qwen3-0.6b-reduced"
LOGIT_TOL = 1e-4
SCALE_RTOL = 1e-5
CHUNK = 8
NAMES = ("k", "v", "k_scale", "v_scale")


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(dataclasses.replace(jax_config(ARCH),
                                      kv_cache_dtype="int8"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(get_config(ARCH), kv_cache_dtype="int8"),
               device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _assert_leaves(got: dict, want: dict, names, what: str):
    for name in names:
        g, w = got[name].numpy(), np.asarray(want[name])
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"{what} {name}")


def _prefill_both(pair, B=3, S=16, max_len=48, seed=1):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S), dtype=np.int32)
    last = np.array([S - 1, 6, 11][:B], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(B, max_len),
                        logits_at=jnp.asarray(last))
    tc = tm.init_cache(B, max_len)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc,
                    logits_at=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    return jl, jc, tc, last


def test_int8_cache_layout_matches_jax(pair):
    jm, _, tm, _ = pair
    for layout in (None, 4):
        jcache = jm.init_cache(2, 32, layout=layout and JaxLayout(layout, 6))
        tcache = tm.init_cache(2, 32, layout=layout and PagedLayout(layout, 6))
        want = jcache["stack"]
        assert len(tcache) == jm.cfg.n_layers
        for group in tcache:
            assert set(group) == set(want)
            for name, t in group.items():
                assert t.dtype == torch.from_numpy(
                    np.zeros(0, np.asarray(want[name]).dtype)).dtype, name
                assert t.shape == want[name].shape[1:], name


def test_prefill_codes_and_decode_logits_match_on_the_dense_ring(pair):
    jm, jp, tm, tp = pair
    jl, jc, tc, last = _prefill_both(pair)
    for j in range(jm.cfg.n_layers):
        _assert_leaves(tc[j], {n: jc["stack"][n][j] for n in NAMES}, NAMES,
                       f"layer {j} after prefill")
    pos = last + 1
    for step in range(3):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        pos = pos + 1
    for j in range(jm.cfg.n_layers):
        _assert_leaves(tc[j], {n: jc["stack"][n][j] for n in NAMES}, NAMES,
                       f"layer {j} after decode")


def test_prefill_wrapping_the_ring_keeps_codes_and_scales_together(pair):
    """A 16-token prefill into a 12-slot ring: positions 4..15 land in
    slots p % 12, scales with their codes, as in JAX."""
    jm, _, _, _ = pair
    _, jc, tc, _ = _prefill_both(pair, max_len=12)
    for j in range(jm.cfg.n_layers):
        _assert_leaves(tc[j], {n: jc["stack"][n][j] for n in NAMES}, NAMES,
                       f"layer {j}")


def test_decode_logits_match_over_pages(pair):
    """The dense prefill caches scattered into pages (each row its own
    scattered pages, the rest of its table on scratch) on both sides, then
    paged int8 decode steps: logits within 1e-4 and the pages the steps
    wrote hold JAX's codes."""
    jm, jp, tm, tp = pair
    B, max_len, bs, P = 3, 48, 4, 40
    nblk = max_len // bs
    jl, jc, tc, last = _prefill_both(pair, B=B, max_len=max_len)
    rng = np.random.default_rng(2)
    table = rng.permutation(P)[:B * nblk].reshape(B, nblk).astype(np.int32)
    jpaged = jm.init_cache(B, max_len, layout=JaxLayout(bs, P))["stack"]
    tpaged = tm.init_cache(B, max_len, layout=PagedLayout(bs, P))
    tpaged[0]["table"].copy_(torch.from_numpy(table))
    jnew = {"table": jnp.broadcast_to(jnp.asarray(table),
                                      jpaged["table"].shape)}
    for name in NAMES:
        pages = np.array(jpaged[f"{name}_pages"])
        for j in range(jm.cfg.n_layers):
            src = np.asarray(jc["stack"][name][j])
            pages[j][table] = src.reshape(B, nblk, bs, *src.shape[2:])
            dense = tc[j][name]
            tpaged[j][f"{name}_pages"][torch.from_numpy(table).long()] = \
                dense.reshape(B, nblk, bs, *dense.shape[2:])
        jnew[f"{name}_pages"] = jnp.asarray(pages)
    jc = {"stack": jnew}
    pos = last + 1
    for step in range(3):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tpaged,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"paged decode step {step}")
        pos = pos + 1
    for j in range(jm.cfg.n_layers):
        got = {n: tpaged[j][f"{n}_pages"][:P] for n in NAMES}
        want = {n: jc["stack"][f"{n}_pages"][j, :P] for n in NAMES}
        _assert_leaves(got, want, NAMES, f"layer {j} pages")


def test_suffix_prefill_refuses_an_int8_cache(pair):
    _, _, tm, tp = pair
    cache = tm.init_cache(1, 16)
    ctx = [{"k": torch.zeros(1, 16, tm.cfg.n_kv_heads, tm.cfg.head_dim),
            "v": torch.zeros(1, 16, tm.cfg.n_kv_heads, tm.cfg.head_dim)}
           ] * tm.cfg.n_layers
    with pytest.raises(NotImplementedError, match="int8"):
        tm.prefill_suffix(tp, torch.zeros((1, 16), dtype=torch.int32),
                          cache, ctx, 16)


# ---------------------------------------------------------------------------
# engines and Router
# ---------------------------------------------------------------------------
# ragged prompts around the block boundary, ragged budgets, a 2-token
# prompt, more requests than the dense engine's 2 slots
SPEC = [(5, 4), (15, 3), (16, 5), (17, 2), (9, 6), (2, 1), (12, 8), (7, 5)]
DENSE = dict(n_slots=2, max_len=64)
PAGED = dict(n_slots=2, max_len=64, cache="paged", block_size=16)


def _specs(plens_max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _serve(pair, phases, conf):
    """The request phases through one JAX and one port engine, draining
    between phases: ``{rid: (tokens, hit_tokens)}`` per side and the
    engines."""
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


@pytest.mark.parametrize("conf", [DENSE, PAGED, dict(PAGED, max_len=32)],
                         ids=["dense", "paged", "paged-truncated"])
def test_int8_engine_greedy_matches_jax(pair, conf):
    specs = _specs(SPEC if conf["max_len"] == 64
                   else [(8, 100), (30, 100), (17, 10)])
    want, got, je, te = _serve(pair, [specs], conf)
    assert got == want
    assert te.prefill_tokens_executed == je.prefill_tokens_executed
    assert te.peak_active == je.peak_active


def test_int8_dense_and_paged_engines_agree(pair):
    specs = _specs(SPEC, seed=4)
    _, dense, _, _ = _serve(pair, [specs], DENSE)
    _, paged, _, te = _serve(pair, [specs], PAGED)
    assert dense == paged
    assert te.peak_active > DENSE["n_slots"]


SHARE_PREFIX_LEN = 64                 # four full 16-token blocks
SHARE = dict(n_slots=4, max_len=128, cache="paged", block_size=16)


def _shared_prefix_phases(seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 512, (SHARE_PREFIX_LEN,), dtype=np.int32)
    return [[(rid0 + i, np.concatenate([prefix, rng.integers(
        0, 512, (plen - SHARE_PREFIX_LEN,), dtype=np.int32)]), mn)
        for i, (plen, mn) in enumerate(specs)]
        for rid0, specs in ((0, [(80, 4)]),
                            (10, [(72, 3), (70, 4), (75, 2)]))]


def test_int8_prefix_cache_shares_nothing_in_either_package(pair):
    phases = _shared_prefix_phases()
    want_on, on, je_on, te_on = _serve(pair, phases,
                                       dict(SHARE, prefix_cache=True))
    want_off, off, _, _ = _serve(pair, phases,
                                 dict(SHARE, prefix_cache=False))
    assert not je_on._share and not te_on._share
    assert on == off == want_on == want_off
    assert te_on.prefix_hit_tokens_total == je_on.prefix_hit_tokens_total \
        == 0
    assert all(h == 0 for _, h in on.values())


def test_int8_router_over_two_paged_containers_matches_jax(pair):
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
    assert all(h == 0 for _, _, h in out[1].values())


def test_int8_router_over_two_dense_containers_matches_jax(pair):
    jm, jp, tm, tp = pair
    conf = dict(DENSE, chunk_tokens=4)
    specs = _specs(SPEC, seed=5)
    jr = jrouter.Router(jbackend.ThreadBackend(
        jm, jp, 2, config=jeng.EngineConfig(**conf)))
    tr = Router(ThreadBackend(tm, tp, 2, config=EngineConfig(**conf),
                              device="cpu"), device="cpu")
    out = []
    with jr, tr:
        for r, mk in ((jr, jeng.Request), (tr, Request)):
            hs = [r.submit(mk(i, p.copy(), mn)) for i, p, mn in specs]
            out.append({h.rid: (h.container_id, h.result().tokens)
                        for h in hs})
    assert out[1] == out[0]

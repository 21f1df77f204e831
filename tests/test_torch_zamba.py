"""The port's hybrid family (zamba2) against the JAX ``Model`` and
``ServingEngine`` on the same weights.

Two configs, on both packages: ``zamba2-7b-reduced`` (2 SSM layers, each
followed by the weight-shared attention + MLP block, ``shared_attn_every``
1) and a variant with a remainder, ``replace(reduced, n_layers=5,
shared_attn_every=2)``: 2 super-blocks of 2 SSM layers and the shared
block, then 1 SSM layer. Weights come from JAX's ``Model.init`` and cross
through ``repro_torch.params.from_numpy``, the shared block converted once
and referred to at each application. Prefill and decode logits are
compared in float32 within 1e-4; greedy streams of the dense and the
paged engine (SSM rows dense beside the paged shared-block groups) must
equal JAX's, chunked and per-token; prompts the scan's chunk does not
divide raise in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduce_config as jax_reduce  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.base import reduce_config  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.cache import is_paged_group  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

TOL = 1e-4
MAX_LEN = 64
# the reduced config, and one whose 5 layers leave an SSM remainder
CASES = {"reduced": {}, "remainder": dict(n_layers=5, shared_attn_every=2)}
# prompt lengths the scan's chunk (min(32, S)) divides, with budgets
SPEC = [(8, 6), (32, 9), (16, 4), (24, 7), (32, 3)]


def _cfgs(case: str):
    over = CASES[case]
    return (jax_reduce(jax_config("zamba2-7b"), **over),
            reduce_config(get_config("zamba2-7b"), **over))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jm, jp, tm, tp


def test_layer_order_and_one_shared_block(pair):
    """JAX's scan order: each super-block's SSM layers, then the shared
    block, then the remainder; the shared block is one dict, never
    copied, and each application has a cache of its own."""
    case, jm, _, tm, tp = pair
    per = jm.super_len
    want = (["ssm"] * per + ["attn"]) * jm.n_super + ["ssm"] * jm.n_rem
    assert tm.kinds == want
    assert ["mamba" in p for p in tp["layers"]] == [k == "ssm"
                                                   for k in want]
    shared = [p for p, k in zip(tp["layers"], want) if k == "attn"]
    assert all(p is shared[0] for p in shared)
    cache = tm.init_cache(2, MAX_LEN)
    attn = [c for c, k in zip(cache, want) if k == "attn"]
    assert len({id(c["k"]) for c in attn}) == len(attn) == jm.n_super
    if case == "remainder":
        assert (jm.n_super, jm.n_rem) == (2, 1)


def test_prefill_and_decode_logits_match_jax(pair):
    _, jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, 32),
                                             dtype=np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, MAX_LEN))
    tc = tm.init_cache(2, MAX_LEN)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    pos = np.full((2,), 32, np.int32)
    for step in range(4):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"decode step {step}")
        pos = pos + 1


def _specs(seed=2):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (n,), dtype=np.int32), mn)
            for i, (n, mn) in enumerate(SPEC)]


def _serve(eng, specs, mk):
    eng.submit_many([mk(i, p.copy(), mn) for i, p, mn in specs])
    return {c.rid: list(c.tokens) for c in eng.run()}


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_greedy_streams_equal_jax_chunked_and_per_token(pair, cache):
    """The dense and the paged engine give JAX's greedy streams, chunked
    and per-token; the paged tree holds a paged group for each
    application of the shared block and dense rows for every SSM layer,
    and no prefix is shared (prefix_cache is shut for the hybrid
    family)."""
    _, jm, jp, tm, tp = pair
    specs = _specs()
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache,
                prefix_cache=cache == "paged")
    want = _serve(jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf)),
                  specs, jeng.Request)
    for chunked in (True, False):
        te = ServingEngine(tm, tp, EngineConfig(chunked=chunked, **conf),
                           device="cpu")
        if cache == "paged":
            paged = [is_paged_group(g) for g in te.cache_backend.tree]
            assert paged == [k == "attn" for k in tm.kinds]
            assert not te._share
        assert _serve(te, specs, Request) == want, f"chunked={chunked}"
        assert te.prefix_hit_tokens_total == 0


def test_prompts_the_chunk_does_not_divide_raise_in_both(pair):
    _, jm, jp, tm, tp = pair
    toks = np.zeros((1, 40), np.int32)     # min(32, 40) = 32 does not
    with pytest.raises(Exception):
        jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                   jm.init_cache(1, MAX_LEN))
    with pytest.raises(ValueError):
        tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(1, MAX_LEN))


def test_save_and_load_keep_the_shared_block_once(pair, tmp_path):
    """``save_params`` writes JAX's tree (``super/ssm`` stacked [n_super,
    k], ``shared`` once, ``rem``) and ``load_params`` gives back the same
    bytes with one shared dict."""
    _, jm, jp, tm, tp = pair
    path = bridge.save_params(tp, tmp_path / "z.npz", tm.cfg)
    with np.load(path) as z:
        keys = set(z.files)
    assert any(k.startswith("shared/") for k in keys)
    assert not any(k.startswith("stack/") for k in keys)
    assert (("rem/ln/scale" in keys) == bool(jm.n_rem))
    back = bridge.load_params(tm.cfg, path, device="cpu")
    shared = [p for p, k in zip(back["layers"], tm.kinds) if k == "attn"]
    assert all(p is shared[0] for p in shared)
    for a, b in zip(jax.tree_util.tree_leaves(back["layers"]),
                    jax.tree_util.tree_leaves(tp["layers"])):
        assert torch.equal(a, b)

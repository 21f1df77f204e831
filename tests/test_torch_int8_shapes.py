"""The int8 KV cache at the head shapes the int8 split body gained, (G, K)
= (1, 112) (zamba2-7b's shared attention) and (6, 128) (mixtral-8x22b,
internvl2-26b), against the JAX package's models.

Reduced zamba2 at K = 112 and reduced mixtral at G = 6, K = 128 (a
16-slot window that a 32-token prompt wraps), each over an int8 cache, on
the same weights in both packages (``params.from_numpy``): the prefill
gives JAX's logits within 1e-4 (float32) and JAX's cache, its codes
equal but for a rare flip by one step and its scales within 1e-5; four
greedy decode steps give JAX's logits, and the dense and the paged
engine JAX's greedy streams. On the CPU the port runs the plain int8
pair, the very functions the card kernels are held against at these
shapes.

Zamba's attention reads the output of a Mamba2 layer, whose float32
noise against JAX's (a scale differs by ~1e-8) moves a key or value
across a rounding edge now and then: 1-2 of 86,016 codes by one step.
A flipped code moves a decode logit by up to ~1e-3, so zamba's decode
logits are held within ``FLIP_TOL``; mixtral's, whose caches come out
equal, within 1e-4.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import reduce_config as jax_reduce  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import reduce_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

TOL = 1e-4
FLIP_TOL = 2e-3
MAX_LEN = 64
SHAPES = {"zamba2-7b": dict(head_dim=112),
          "mixtral-8x22b": dict(n_heads=6, n_kv_heads=1, head_dim=128,
                                sliding_window=16)}
DECODE_TOL = {"zamba2-7b": FLIP_TOL, "mixtral-8x22b": TOL}
NAMES = ("k", "v", "k_scale", "v_scale")


def _int8_groups(tm, jc, tc):
    """(JAX's group, the port's group) for each attention layer's int8
    cache: zamba's per application of the shared block, mixtral's per
    layer."""
    attn = [j for j, kind in enumerate(tm.kinds) if kind == "attn"]
    if tm.fam == "zamba":
        stack = jc["super"]["shared"]
    else:
        stack = jc["stack"]
    return [({n: np.asarray(stack[n][i]) for n in NAMES},
             {n: tc[j][n].numpy() for n in NAMES})
            for i, j in enumerate(attn)]


@pytest.fixture(scope="module", params=sorted(SHAPES))
def pair(request):
    over = dict(SHAPES[request.param], kv_cache_dtype="int8")
    jcfg = jax_reduce(jax_registry.get_config(request.param), **over)
    tcfg = reduce_config(registry.get_config(request.param), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.head_dim) in {
        (1, 112), (6, 128)} & da.INT8_SHAPES
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prefill_both(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (3, 32),
                                             dtype=np.int32)
    last = np.array([31, 6, 19], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(3, MAX_LEN),
                        logits_at=jnp.asarray(last))
    tc = tm.init_cache(3, MAX_LEN)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc,
                    logits_at=torch.from_numpy(last))
    return jl, jc, tl, tc, last


def test_int8_prefill_logits_and_cache_match_jax(pair):
    jm, jp, tm, tp = pair
    jl, jc, tl, tc, _ = _prefill_both(pair)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    groups = _int8_groups(tm, jc, tc)
    assert len(groups) == tm.kinds.count("attn") >= 2
    for want, got in groups:
        for n in ("k", "v"):
            assert got[n].dtype == want[n].dtype == np.int8
            d = np.abs(got[n].astype(np.int16) - want[n].astype(np.int16))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (n, d.sum())
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=0)


def test_int8_decode_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    jl, jc, tl, tc, last = _prefill_both(pair)
    tol = DECODE_TOL[tm.cfg.name.removesuffix("-reduced")]
    pos = last + 1
    for step in range(4):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol, err_msg=f"decode step {step}")
        pos = pos + 1


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_int8_engine_greedy_streams_equal_jax(pair, cache):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, tm.cfg.vocab_size, (n,), dtype=np.int32),
              mn) for i, (n, mn) in enumerate([(5, 6), (17, 4), (30, 9),
                                               (12, 3)])]
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf))
    te = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
    je.submit_many([jeng.Request(i, p.copy(), mn) for i, p, mn in specs])
    te.submit_many([Request(i, p.copy(), mn) for i, p, mn in specs])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    assert got == want and len(got) == len(specs)

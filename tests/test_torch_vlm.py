"""The port's vision-prefixed dense model (internvl2) against the JAX
``Model`` and ``ServingEngine`` on the same weights.

``internvl2-26b-reduced`` (2 layers, 4 / 2 heads, 8 vision tokens of width
64): each request carries its patch embeddings as
``extras["vision_embeds"]``, which ``vis_proj`` (``w1``, the tanh gelu,
``w2``) maps ahead of the token embeddings, so the prompt starts at
position 8. Weights come from JAX's ``Model.init`` and cross through
``repro_torch.params.from_numpy``. Prefill and decode logits are
compared in float32 within 1e-4; greedy streams of the dense and the
paged engine must equal JAX's, chunked and per-token. Prefix sharing, as
tests/test_paged_cache.py holds it for JAX: the block hashes (seeded with
the vision-token count and the image's bytes) equal JAX's byte for byte;
a request with the same image and system prompt hits, one with another
image misses, and a hit shorter than the image counts as none; streams
with sharing on equal those with it off and JAX's, hit tokens included.
A prompt whose bucket behind the image passes ``max_len`` prefills at
most ``max_len`` positions, so no pad position wraps over the image.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

ARCH = "internvl2-26b-reduced"
TOL = 1e-4
MAX_LEN = 96
SHARE_MAX_LEN = 144
SYSTEM = 40          # the shared system prompt, behind the 8-token image


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _image(cfg, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (cfg.n_vision_tokens, cfg.vision_embed_dim))).astype(np.float32)


def test_vision_projection_and_logits_match_jax(pair):
    """Prefill (the image at positions 0..7, per-row logits) and decode
    steps from position 8 + len(prompt), within 1e-4."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    nv = cfg.n_vision_tokens
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 16),
                                             dtype=np.int32)
    img = np.stack([_image(cfg, s) for s in range(3)])
    last = nv + np.array([15, 6, 11], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "vision_embeds": jnp.asarray(img)},
                        jm.init_cache(3, MAX_LEN),
                        logits_at=jnp.asarray(last))
    tc = tm.init_cache(3, MAX_LEN)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc,
                    logits_at=torch.from_numpy(last),
                    vision_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    pos = last + 1
    for step in range(3):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"decode step {step}")
        pos = pos + 1
    with pytest.raises(ValueError, match="vision_embeds"):
        tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(3, MAX_LEN))


def _specs(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), mn,
             {"vision_embeds": _image(cfg, 100 + i)})
            for i, (n, mn) in enumerate(lens)]


def _serve(eng, specs, mk):
    eng.submit_many([mk(i, p.copy(), mn, extras=ex)
                     for i, p, mn, ex in specs])
    return {c.rid: (list(c.tokens), c.prompt_len, c.prefix_hit_tokens)
            for c in eng.run()}


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_greedy_streams_equal_jax_chunked_and_per_token(pair, cache):
    """Ragged prompts, each behind its own image: JAX's streams and
    prompt lengths (the image left out), chunked and per-token."""
    jm, jp, tm, tp = pair
    specs = _specs(tm.cfg, [(5, 6), (17, 4), (30, 9), (12, 3), (9, 7)], 2)
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache)
    want = _serve(jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf)),
                  specs, jeng.Request)
    assert {r: n for r, (_, n, _) in want.items()} == {
        i: len(p) for i, p, _, _ in specs}
    for chunked in (True, False):
        te = ServingEngine(tm, tp, EngineConfig(chunked=chunked, **conf),
                           device="cpu")
        assert _serve(te, specs, Request) == want, f"chunked={chunked}"


def _shared(cfg, plan, seed=5):
    """Requests behind one system prompt: ``plan`` is (prompt length,
    max_new, image seed) per request."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, (SYSTEM,), dtype=np.int32)
    return [(i, np.concatenate([head, rng.integers(
        0, cfg.vocab_size, (n - SYSTEM,), dtype=np.int32)]), mn,
        {"vision_embeds": _image(cfg, img)})
        for i, (n, mn, img) in enumerate(plan)]


def _phases(eng, phases, mk):
    """Each phase through one engine, drained before the next (JAX's
    ``_serve_phases``)."""
    got = {}
    for specs in phases:
        got.update(_serve(eng, specs, mk))
    return got


@pytest.mark.parametrize("block_size", [16, 6])
def test_prefix_sharing_over_the_image_equals_jax(pair, block_size):
    """Phase 1 seeds the index with image 0 behind the system prompt;
    phase 2 sends two requests with image 0 and one with image 1. At
    block_size 16 the image-0 requests hit the 48 leading positions
    (image + 40 prompt tokens) and image 1 misses; at block_size 6 a
    request whose image matches but whose prompt leaves the second block
    (positions 6-11, the image's last two) gives a hit of 6 < 8
    positions: no hit. Streams and hit tokens equal JAX's, and sharing
    on equals sharing off."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    if block_size == 16:
        phases = [_shared(cfg, [(60, 4, 0)]),
                  [(10 + i, p, mn, ex) for i, p, mn, ex in _shared(
                      cfg, [(56, 3, 0), (70, 4, 0), (58, 2, 1)])]]
        want_hits = {10: 48, 11: 48, 12: 0}
    else:
        rng = np.random.default_rng(9)
        one = (0, rng.integers(0, cfg.vocab_size, (30,), dtype=np.int32), 3,
               {"vision_embeds": _image(cfg, 0)})
        other = (10, rng.integers(0, cfg.vocab_size, (30,), dtype=np.int32),
                 3, {"vision_embeds": _image(cfg, 0)})
        phases = [[one], [other]]
        want_hits = {10: 0}
    # a horizon past each prompt's image + bucket (8 + 128): JAX's engine
    # wraps a padded prefill wider than max_len over the image's and the
    # prompt's own slots (the port stops it at the horizon, test below)
    conf = dict(n_slots=2, max_len=SHARE_MAX_LEN, chunk_tokens=4,
                cache="paged", block_size=block_size)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(prefix_cache=True,
                                                      **conf))
    te = ServingEngine(tm, tp, EngineConfig(prefix_cache=True, **conf),
                       device="cpu")
    assert te._share and je._share
    for i, p, mn, ex in (s for ph in phases for s in ph):
        assert (te._block_hashes(Request(i, p, mn, extras=ex))
                == je._block_hashes(jeng.Request(i, p, mn, extras=ex)))
    want = _phases(je, phases, jeng.Request)
    got = _phases(te, phases, Request)
    assert got == want
    assert {r: h for r, (_, _, h) in got.items() if r >= 10} == want_hits
    off = _phases(ServingEngine(tm, tp, EngineConfig(prefix_cache=False,
                                                     **conf), device="cpu"),
                  phases, Request)
    assert {r: t for r, (t, _, _) in off.items()} == {
        r: t for r, (t, _, _) in got.items()}


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_prefill_behind_an_image_stops_at_the_horizon(pair, cache):
    """Prompts of 70 and 66 tokens pad to the 128-token bucket; behind
    the 8-position image that is 136 positions, past max_len 96, where the
    cache ring would wrap the pad positions over the image's slots and
    decode would read them. The port prefills 96 - 8 = 88 positions
    instead, and its streams equal JAX's at max_len 144, where nothing
    wraps (the horizon does not bind these budgets)."""
    jm, jp, tm, tp = pair
    specs = _specs(tm.cfg, [(70, 10), (66, 12)], 7)
    conf = dict(n_slots=2, chunk_tokens=4, cache=cache)
    want = _serve(jeng.ServingEngine(jm, jp, jeng.EngineConfig(
        max_len=SHARE_MAX_LEN, **conf)), specs, jeng.Request)
    te = ServingEngine(tm, tp, EngineConfig(max_len=MAX_LEN, **conf),
                       device="cpu")
    nv = tm.cfg.n_vision_tokens
    assert te._width(70, nv) == te._width(66, nv) == MAX_LEN - nv
    assert te._width(70) == 128
    assert _serve(te, specs, Request) == want

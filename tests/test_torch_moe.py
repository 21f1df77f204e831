"""The port's mixture of experts against the JAX package's ``moe_fwd``.

Same weights (JAX's init, crossed as numpy), same inputs (a seeded numpy
draw), float32, within 1e-5:

* reduced deepseek-v2-lite (4 experts, top-2, cf = E/K = 2: it can never
  drop an assignment), with the two shared experts;
* a drop variant (16 experts, top-2, cf 2.0, 4 dispatch groups: E/K = 8 >
  cf, so an expert holds C = 4 of a 16-token group's 32 assignments): the
  port's routing must drop some assignments, and the output still
  matches JAX's, which drops the same ones; greedy completions of the
  port's engines over a model built on this variant equal the JAX
  engine's;
* T = 12 with 16 dispatch groups, which halves G twice (16 -> 8 -> 4);
* a window-free GQA MoE (mixtral's reduced config without its window)
  through the paged engine with prefix sharing, against the JAX engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

ARCH = "deepseek-v2-lite-16b-reduced"
DROP = dict(n_experts=16, n_experts_per_tok=2, moe_eval_cf=2.0,
            moe_dispatch_groups=4)


def _cfgs(**over):
    return (dataclasses.replace(jax_config(ARCH), **over),
            dataclasses.replace(get_config(ARCH), **over))


def _moe_pair(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


@pytest.mark.parametrize("over,B,S,drops", [
    ({}, 2, 24, False),                          # dropless reduced config
    (DROP, 2, 32, True),                         # Tg = 16, C = 4
    ({"moe_dispatch_groups": 16}, 3, 4, False),  # T = 12: G 16 -> 8 -> 4
])
def test_moe_fwd_matches_jax(over, B, S, drops):
    jcfg, cfg = _cfgs(**over)
    jp, tp = _moe_pair(jcfg)
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want, _ = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    got = moe.moe_fwd(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _, _, pos, keep, C = moe.route(tp, cfg, torch.from_numpy(x).reshape(
        B * S, cfg.d_model))
    G = pos.shape[0]
    assert G * pos.shape[1] == B * S * cfg.n_experts_per_tok
    assert C == moe._capacity(B * S // G, cfg)
    assert bool((~keep).any()) == drops
    if over.get("moe_dispatch_groups") == 16:
        assert G == 4


def test_dropped_assignments_add_nothing():
    """A token whose every assignment is dropped gets only the shared
    experts' output, and each kept one exactly its expert's row."""
    _, cfg = _cfgs(**DROP, n_shared_experts=0)
    jcfg, _ = _cfgs(**DROP, n_shared_experts=0)
    _, tp = _moe_pair(jcfg, seed=1)
    # every token routes alike: 2 experts take all 64 assignments of a
    # group, so only the first C = 4 tokens of each group keep theirs
    x = torch.ones((1, 64, cfg.d_model))
    out = moe.moe_fwd(tp, cfg, x)
    _, _, _, keep, C = moe.route(tp, cfg, x.reshape(64, cfg.d_model))
    kept = keep.reshape(4, 16, 2).all(dim=2).reshape(64)
    assert C == 4 and int(kept.sum()) == 4 * C
    assert bool((out[0, ~kept] == 0).all())
    assert bool((out[0, kept] != 0).any())
    assert torch.equal(out[0, kept], out[0, :1].expand(16, -1))


@pytest.fixture(scope="module")
def drop_models():
    jcfg, cfg = _cfgs(**DROP)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, device="cpu")
    tp = bridge.from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_drop_variant_engine_matches_jax(drop_models, cache, monkeypatch):
    """Prompts of 40-64 tokens prefill in the 64-token bucket (Tg >= 16
    per row): the port's engine drops assignments there and still emits
    the JAX engine's greedy tokens."""
    jm, jp, tm, tp = drop_models
    rng = np.random.default_rng(7)
    specs = [(i, rng.integers(0, 512, (n,), dtype=np.int32), mn)
             for i, (n, mn) in enumerate([(40, 5), (64, 3), (50, 6),
                                          (17, 4), (60, 2)])]
    conf = dict(n_slots=2, max_len=128, chunk_tokens=4, cache=cache)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf))
    te = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
    dropped = []
    route = moe.route

    def recording_route(p, cfg, xt):
        out = route(p, cfg, xt)
        dropped.append(int((~out[3]).sum()))
        return out
    monkeypatch.setattr(moe, "route", recording_route)
    je.submit_many([jeng.Request(i, p, mn) for i, p, mn in specs])
    te.submit_many([Request(i, p, mn) for i, p, mn in specs])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    assert got == want
    assert sum(dropped) > 0


def test_window_free_gqa_moe_shares_prefixes_like_jax():
    """The sharing gate admits a GQA MoE without a window (mixtral's
    reduced config with ``sliding_window=0``, no dense prologue): the
    suffix prefill runs through the MoE block, and the port's paged
    engine gives the JAX engine's tokens and hit counts over two phases
    that share a 64-token prompt prefix."""
    from repro_torch.configs.base import ArchConfig
    jcfg = dataclasses.replace(jax_config("mixtral-8x22b-reduced"),
                               sliding_window=0)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, device="cpu")
    tp = bridge.from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, (64,), dtype=np.int32)
    phases = [[(rid, np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (n - 64,), dtype=np.int32)]), mn)
        for rid, (n, mn) in group]
        for group in ([(0, (80, 4))],
                      [(10, (72, 3)), (11, (70, 4)), (12, (75, 2))])]
    conf = dict(n_slots=4, max_len=128, cache="paged", block_size=16,
                prefix_cache=True, chunk_tokens=4)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf))
    te = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
    assert te._share and je._share
    want, got = {}, {}
    for reqs in phases:
        je.submit_many([jeng.Request(i, p, mn) for i, p, mn in reqs])
        te.submit_many([Request(i, p, mn) for i, p, mn in reqs])
        want.update({c.rid: (list(c.tokens), c.prefix_hit_tokens)
                     for c in je.run()})
        got.update({c.rid: (list(c.tokens), c.prefix_hit_tokens)
                    for c in te.run()})
    assert got == want
    assert te.prefix_hit_tokens_total == 64 * 3

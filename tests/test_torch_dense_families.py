"""The dense family's 8B configs (qwen3-8b, llama3.1-8b) and the shape
check that refuses, on the card, the head shapes no decode kernel is
built for.

Every field of the port's configs equals JAX's, under JAX's registry
names. Reduced qwen3-8b and llama3.1-8b keep the full models' G = 4
(``n_heads=8, n_kv_heads=2``) and match JAX's prefill and decode logits
within 1e-4 (float32) and its engines' greedy streams on the dense and
the paged cache. On a CUDA device ``Model`` refuses mixtral-8x22b (G = 6)
and zamba2-7b (K = 112) for their shapes, naming G and K; on the CPU the
families still to come (audio, vision, hybrid) are refused as before.
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
from repro_torch.configs.base import ArchConfig, reduce_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

NEW = ("qwen3-8b", "llama3.1-8b", "gemma3-27b")
DENSE_8B = ("qwen3-8b", "llama3.1-8b")
G4 = dict(n_heads=8, n_kv_heads=2)       # the full models' G = 4, reduced
TOL = 1e-4
MAX_LEN = 64


@pytest.mark.parametrize("name", [n + s for n in NEW
                                  for s in ("", "-reduced")])
def test_configs_equal_jax_field_by_field(name):
    assert (dataclasses.asdict(registry.get_config(name))
            == dataclasses.asdict(jax_registry.get_config(name)))


def test_registry_names_are_jax_names():
    assert set(NEW) <= set(registry.ARCH_NAMES)
    assert set(registry.ARCH_NAMES) <= set(jax_registry._MODULES)
    for name in registry.ARCH_NAMES:
        assert registry.get_config(name).name == name


def test_full_width_configs_build_on_the_cpu():
    """``Model`` builds for each new config on the CPU (no weights are
    drawn); the 8B models' G is 4 and K 128, and their JAX parameter
    counts are 8.19 and 8.03 G."""
    for name in NEW:
        cfg = registry.get_config(name)
        m = Model(cfg, device="cpu")
        assert m.fam == ("gemma" if name.startswith("gemma") else "dense")
        assert cfg.param_count() == jax_registry.get_config(
            name).param_count()
    for name, params in (("qwen3-8b", 8.19e9), ("llama3.1-8b", 8.03e9)):
        cfg = registry.get_config(name)
        assert cfg.n_heads // cfg.n_kv_heads == 4 and cfg.head_dim == 128
        assert abs(cfg.param_count() - params) < 0.005e9
    assert abs(registry.get_config("gemma3-27b").param_count()
               - 28.42e9) < 0.005e9


@pytest.fixture(scope="module", params=DENSE_8B)
def pair(request):
    jcfg = jax_reduce(jax_registry.get_config(request.param), **G4)
    tcfg = reduce_config(registry.get_config(request.param), **G4)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.n_heads // tcfg.n_kv_heads == 4
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_prefill_and_decode_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (3, 16),
                                             dtype=np.int32)
    last = np.array([15, 6, 11], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(3, MAX_LEN),
                        logits_at=jnp.asarray(last))
    tc = tm.init_cache(3, MAX_LEN)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc,
                    logits_at=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    pos = last + 1
    for step in range(4):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"decode step {step}")
        pos = pos + 1


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_greedy_streams_equal_jax(pair, cache):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, tm.cfg.vocab_size, (n,), dtype=np.int32),
              mn) for i, (n, mn) in enumerate([(5, 6), (17, 4), (30, 9),
                                               (12, 3), (9, 7)])]
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf))
    te = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
    je.submit_many([jeng.Request(i, p.copy(), mn) for i, p, mn in specs])
    te.submit_many([Request(i, p.copy(), mn) for i, p, mn in specs])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    assert got == want and len(got) == len(specs)


def _port_config(name: str) -> ArchConfig:
    """A JAX config as the port's dataclass (the port's registry does not
    list the families still to come)."""
    return ArchConfig(**dataclasses.asdict(jax_registry.get_config(name)))


@pytest.fixture
def fake_card(monkeypatch):
    """A host that reports a card: ``Model`` resolves ``cuda:0`` and runs
    its card-only checks, and nothing is allocated on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("name,shape", [("mixtral-8x22b", "G=6, K=128"),
                                        ("internvl2-26b", "G=6, K=128"),
                                        ("zamba2-7b", "G=1, K=112")])
def test_card_refuses_head_shapes_without_a_decode_kernel(fake_card, name,
                                                          shape):
    """mixtral-8x22b and internvl2-26b have G = 6 (G·K = 768 > 512) and
    zamba2-7b K = 112: refused at ``Model(...)`` for their shapes, with G
    and K named, before anything reaches a kernel."""
    with pytest.raises(ValueError, match=f"no kernel for {shape}"):
        Model(_port_config(name))


def test_card_accepts_the_served_shapes(fake_card):
    for name in NEW + ("qwen3-0.6b", "stablelm-1.6b", "mamba2-2.7b",
                       "deepseek-v2-lite-16b"):
        assert Model(registry.get_config(name)).device.type == "cuda"
    # mixtral's window is served; only its G has no kernel on the card
    cfg = jax_reduce(jax_registry.get_config("mixtral-8x22b"))
    Model(ArchConfig(**dataclasses.asdict(cfg)), device="cpu")


@pytest.mark.parametrize("name", ["whisper-large-v3", "internvl2-26b",
                                  "zamba2-7b"])
def test_families_still_to_come_are_refused_on_the_cpu(name):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Model(_port_config(name), device="cpu")

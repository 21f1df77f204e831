"""The dense family's 8B configs (qwen3-8b, llama3.1-8b), mixtral-8x22b,
and the shape check that refuses, on the card, the head shapes no decode
kernel is built for.

Every field of the port's configs equals JAX's, under JAX's registry
names (zamba2-7b, internvl2-26b, mixtral-8x22b and whisper-large-v3 too,
full and reduced). Reduced qwen3-8b and llama3.1-8b keep the full
models' G = 4 (``n_heads=8, n_kv_heads=2``), reduced mixtral its G = 6
(``n_heads=6, n_kv_heads=1``) and a 16-slot window that wraps; each
matches JAX's prefill and decode logits within 1e-4 (float32) and its
engines' greedy streams on the dense and the paged cache. On a CUDA
device ``Model`` takes exactly the (G, K) pairs the split bodies are
built for, (1, 112) and (6, 128) too, over a bf16 or an int8 cache, and
refuses the rest, naming G and K; every config of JAX's registry is
served, whisper's too.
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
LATER = ("zamba2-7b", "internvl2-26b", "mixtral-8x22b")
LAST = ("whisper-large-v3",)
DENSE_8B = ("qwen3-8b", "llama3.1-8b")
G4 = dict(n_heads=8, n_kv_heads=2)       # the full models' G = 4, reduced
# mixtral's G = 6, reduced, and a window its 30-token prompts wrap
OVERRIDES = {**{n: G4 for n in DENSE_8B},
             "mixtral-8x22b": dict(n_heads=6, n_kv_heads=1,
                                   sliding_window=16)}
TOL = 1e-4
MAX_LEN = 64


@pytest.mark.parametrize("name", [n + s for n in NEW + LATER + LAST
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
    for name, fam in zip(LATER, ("zamba", "dense", "moe")):
        assert Model(registry.get_config(name), device="cpu").fam == fam


@pytest.fixture(scope="module", params=DENSE_8B + ("mixtral-8x22b",))
def pair(request):
    over = OVERRIDES[request.param]
    jcfg = jax_reduce(jax_registry.get_config(request.param), **over)
    tcfg = reduce_config(registry.get_config(request.param), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.n_heads // tcfg.n_kv_heads == over["n_heads"] // over[
        "n_kv_heads"]
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
    if tm.cfg.sliding_window:
        # mixtral: rings that wrap in prefill (30 tokens) and in decode
        specs += [(5, specs[2][1].copy(), 20)]
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf))
    te = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
    je.submit_many([jeng.Request(i, p.copy(), mn) for i, p, mn in specs])
    te.submit_many([Request(i, p.copy(), mn) for i, p, mn in specs])
    want = {c.rid: list(c.tokens) for c in je.run()}
    got = {c.rid: list(c.tokens) for c in te.run()}
    assert got == want and len(got) == len(specs)


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
    """The int8 split body is built for the split body's shapes:
    mixtral-8x22b and internvl2-26b (G = 6) and zamba2-7b (K = 112) over
    an int8 cache are taken on the card. Shapes no body is built for (G =
    6 at K = 256, G = 3) are refused at ``Model(...)``, with G and K
    named, before anything reaches a kernel."""
    from repro_torch.kernels import decode_attention as da

    cfg = dataclasses.replace(registry.get_config(name),
                              kv_cache_dtype="int8")
    assert f"G={cfg.n_heads // cfg.n_kv_heads}, K={cfg.head_dim}" == shape
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) in da.INT8_SHAPES
    assert Model(cfg).device.type == "cuda"
    for over, bad in ((dict(head_dim=256), "G=6, K=256"),
                      (dict(n_kv_heads=16), "G=3, K=128")):
        cfg = dataclasses.replace(registry.get_config("mixtral-8x22b"),
                                  **over)
        with pytest.raises(ValueError, match=f"no kernel for {bad}"):
            Model(cfg)


def test_card_accepts_the_served_shapes(fake_card):
    for name in NEW + LATER + LAST + ("qwen3-0.6b", "stablelm-1.6b",
                                      "mamba2-2.7b",
                               "deepseek-v2-lite-16b"):
        assert Model(registry.get_config(name)).device.type == "cuda"
    # mixtral's window is served on the CPU too
    cfg = jax_reduce(jax_registry.get_config("mixtral-8x22b"))
    Model(ArchConfig(**dataclasses.asdict(cfg)), device="cpu")


@pytest.mark.parametrize("G,K,int8,ok", [
    (1, 112, False, True), (6, 128, False, True), (4, 128, False, True),
    (2, 256, False, True), (8, 64, False, True), (6, 256, False, False),
    (3, 128, False, False), (2, 112, False, False), (6, 64, False, False),
    (1, 112, True, True), (6, 128, True, True), (4, 128, True, True)])
def test_shape_rule_is_the_instantiated_pairs(G, K, int8, ok):
    """``check_kernel_shape`` takes exactly the instantiated (G, K), one
    set for both split bodies: G in 1, 2, 4, 8, K in 32 ... 256, G·K <=
    512, and (1, 112) and (6, 128); a refusal names G and K (and int8 for
    the int8 body)."""
    from repro_torch.kernels import decode_attention as da

    assert da.KERNEL_SHAPES == da.INT8_SHAPES
    assert {(1, 112), (6, 128)} <= da.INT8_SHAPES
    if ok:
        da.check_kernel_shape("m", 8 * G, 8, K, int8=int8)
        return
    with pytest.raises(ValueError, match=f"G={G}, K={K}") as e:
        da.check_kernel_shape("m", 8 * G, 8, K, int8=int8)
    assert ("int8" in str(e.value)) == int8


def test_every_jax_config_is_served():
    """``check_supported`` accepts every config of JAX's registry, full
    and reduced, as the port's dataclass: the port serves every family.
    A config the port does not serve is still refused for its reasons,
    named: learned positions or a plain MLP outside the audio family."""
    from repro_torch.models.model import check_supported

    for name in jax_registry._MODULES:
        for cfg in (jax_registry.get_config(name),
                    jax_reduce(jax_registry.get_config(name))):
            check_supported(ArchConfig(**dataclasses.asdict(cfg)))
    bad = dataclasses.replace(registry.get_config("qwen3-0.6b"),
                              pos_embed="learned", mlp_gated=False)
    with pytest.raises(NotImplementedError, match="not ported yet") as e:
        Model(bad, device="cpu")
    for reason in ("pos_embed", "mlp_gated"):
        assert reason in str(e.value)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_per_token_and_prefix_cache_give_the_chunked_streams(pair, cache):
    """The six-family parity of tests/test_decode_chunk.py and
    tests/test_paged_cache.py for these configs (mixtral is JAX's MoE
    representative): a per-token engine gives the chunked engine's greedy
    streams, and on the paged cache ``prefix_cache=True`` gives those of
    sharing off (mixtral's window shuts the gate: 0 hit tokens); each
    run's streams and hit tokens equal JAX's engine's in that mode."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(3)
    head = rng.integers(0, tm.cfg.vocab_size, (32,), dtype=np.int32)
    specs = [(i, np.concatenate([head, rng.integers(
        0, tm.cfg.vocab_size, (n,), dtype=np.int32)]), mn)
        for i, (n, mn) in enumerate([(4, 5), (12, 3), (20, 6), (8, 4)])]
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache)

    def run(**kw):
        out = []
        for eng, req in (
                (ServingEngine(tm, tp, EngineConfig(**conf, **kw),
                               device="cpu"), Request),
                (jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf, **kw)),
                 jeng.Request)):
            got = {}
            for phase in (specs[:1], specs[1:]):
                eng.submit_many([req(i, p.copy(), mn) for i, p, mn in phase])
                got.update({c.rid: (list(c.tokens), c.prefix_hit_tokens)
                            for c in eng.run()})
            out.append(got)
        assert out[0] == out[1], f"{kw}: port {out[0]} != JAX {out[1]}"
        return out[0]
    want = run()
    assert run(chunked=False) == want
    if cache == "paged":
        shared = run(prefix_cache=True)
        assert {r: t for r, (t, _) in shared.items()} == {
            r: t for r, (t, _) in want.items()}
        hits = [h for _, h in shared.values()]
        assert hits == ([0] * 4 if tm.cfg.sliding_window
                        else [0, 32, 32, 32])

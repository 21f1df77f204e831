"""The port's gemma family against the JAX ``Model`` and ``ServingEngine``
on the same weights.

The config is ``reduce_config(gemma3-27b, n_layers=5, sliding_window=16)``
with ``max_len`` 64: two super-blocks of one local and one global layer,
then one local layer left over, and a 16-slot ring that wraps in prefill
(prompts of 40 tokens) and in decode (10-token prompts that decode past
position 16). Weights come from JAX's ``Model.init`` and cross through
``repro_torch.params.from_numpy``. Logits and ring leaves are compared in
float32 within 1e-4 (as tests/test_torch_model.py); greedy streams must be
identical, on the dense cache and on the paged one (whose local rings stay
dense rows beside the paged global groups), chunked and per-token, with
``prefix_cache=True`` (which a window turns off: 0 hit tokens) and over
an int8 cache. The JAX package's own reduced config (window 64 =
``max_len``, so the local layer pages too) and the gated gelu MLP
(``jax.nn.gelu``'s tanh form) are held as well.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.base import reduce_config  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

TOL = 1e-4
MAX_LEN, WINDOW = 64, 16
OVER = dict(n_layers=5, sliding_window=WINDOW)
# prompts shorter and longer than the window; the 10-token ones decode
# past position 16, so their rings wrap in decode, the 40-token ones
# wrap in prefill
SPEC = [(10, 30), (40, 14), (10, 9), (40, 20), (10, 3)]
ENGINE = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=8)


def _cfgs(int8: bool = False, **over):
    over = {**OVER, **over}
    j = jax_reduce(jax_config("gemma3-27b"), **over)
    t = reduce_config(get_config("gemma3-27b"), **over)
    if int8:
        j = dataclasses.replace(j, kv_cache_dtype="int8")
        t = dataclasses.replace(t, kv_cache_dtype="int8")
    return j, t


@pytest.fixture(scope="module")
def weights():
    """JAX's parameters for the reduced config (seed 0) and their leaves."""
    jp = JaxModel(_cfgs()[0]).init(jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _pair(weights, int8: bool = False):
    jcfg, tcfg = _cfgs(int8)
    jp, tree = weights
    tm = Model(tcfg, device="cpu")
    return JaxModel(jcfg), jp, tm, bridge.from_numpy(tcfg, tree,
                                                    device="cpu")


def _jax_leaf(jm, tree: dict, layer: int):
    """Layer ``layer``'s part of a JAX gemma tree (parameters or cache),
    in the port's layer order: each super-block's locals, its global,
    then the remainder."""
    per = jm.super_len
    s, j = divmod(layer, per)
    if s < jm.n_super:
        group = tree["super"]
        if j < per - 1:
            return jax.tree.map(lambda a: a[s, j], group["local"])
        return jax.tree.map(lambda a: a[s], group["global"])
    return jax.tree.map(lambda a: a[layer - jm.n_super * per], tree["rem"])


def _specs(spec=SPEC, seed=3, prefix=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 512, (prefix,), dtype=np.int32)
    return [(i, np.concatenate([head, rng.integers(
        0, 512, (n - prefix,), dtype=np.int32)]), mn)
        for i, (n, mn) in enumerate(spec)]


def _serve(eng, specs, mk):
    eng.submit_many([mk(i, p.copy(), mn) for i, p, mn in specs])
    return {c.rid: (list(c.tokens), c.prefix_hit_tokens) for c in eng.run()}


_JAX_STREAMS: dict = {}


def _jax_streams(jm, jp, key, specs, **conf):
    """The JAX engine's completions, once per (case, cache) key."""
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = _serve(
            jeng.ServingEngine(jm, jp, jeng.EngineConfig(**ENGINE, **conf)),
            specs, jeng.Request)
    return _JAX_STREAMS[key]


def _port(tm, tp, **conf):
    return ServingEngine(tm, tp, EngineConfig(**ENGINE, **conf),
                         device="cpu")


# ---------------------------------------------------------------------------
def test_configs_and_layer_layout_match_jax():
    for name in ("gemma3-27b", "gemma3-27b-reduced"):
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jax_config(name)))
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for cfg in (tcfg, get_config("gemma3-27b"),
                get_config("gemma3-27b-reduced")):
        tm = Model(cfg, device="cpu")
        jm = JaxModel(jcfg if cfg is tcfg else jax_config(cfg.name))
        assert tm.fam == jm.fam == "gemma"
        w = cfg.sliding_window
        want = ([w] * (jm.super_len - 1) + [0]) * jm.n_super + [w] * jm.n_rem
        assert tm.windows == want
    full = Model(get_config("gemma3-27b"), device="cpu")
    # 62 layers: 10 super-blocks (50 local, 10 global), then 2 local
    assert full.windows.count(0) == 10 and len(full.windows) == 62
    assert full.windows[-3:] == [0, 1024, 1024]
    assert Model(tcfg, device="cpu").windows == [16, 0, 16, 0, 16]


def test_gelu_mlp_matches_jax_and_is_the_tanh_form():
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for act in ("gelu", "silu"):
        want = np.asarray(jlayers.mlp_fwd(jp, jnp.asarray(x), act))
        got = layers.mlp_fwd(tp, torch.from_numpy(x), act).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    z = rng.standard_normal(4096).astype(np.float32) * 4
    np.testing.assert_allclose(layers.gelu_tanh(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z))),
                               atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(z)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(z)))).max() > 1e-4


def _assert_rings(jm, jc, tc) -> None:
    """Every layer's cache leaf against JAX's: float32 leaves within 1e-4,
    int8 scales within 1e-5 relative, int8 codes within one step at fewer
    than one code in a thousand (past the first layer the float32 keys
    differ from JAX's in their last bits, and a key on a rounding edge
    may round the other way)."""
    for layer, c in enumerate(tc):
        want = _jax_leaf(jm, jc, layer)
        assert set(c) == set(want)
        for name, t in c.items():
            got, w = t.numpy(), np.asarray(want[name])
            what = f"layer {layer} {name}"
            if t.dtype == torch.int8:
                diff = np.abs(got.astype(np.int32) - w)
                assert diff.max() <= 1 and diff.mean() < 1e-3, what
            elif "scale" in name:
                np.testing.assert_allclose(got, w, rtol=1e-5, atol=0,
                                           err_msg=what)
            else:
                np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL,
                                           err_msg=what)


def _prefill_both(weights, S: int, int8: bool, B: int = 2):
    jm, jp, tm, tp = _pair(weights, int8)
    toks = np.random.default_rng(S).integers(0, 512, (B, S), dtype=np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(B, MAX_LEN))
    tc = tm.init_cache(B, MAX_LEN)
    assert [c["k"].shape[1] for c in tc] == [WINDOW, MAX_LEN] * 2 + [WINDOW]
    tl = tm.prefill(tp, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    _assert_rings(jm, jc, tc)
    return jm, jp, tm, tp, jl, jc, tc


@pytest.mark.parametrize("S", [10, 40])
def test_prefill_and_decode_logits_and_rings_match_jax(weights, S):
    """Prefill of S tokens and 24 greedy decode steps: logits within 1e-4
    and every layer's cache leaf equal to JAX's after the prefill and
    after the steps; the local rings are 16 wide and wrap."""
    jm, jp, tm, tp, jl, jc, tc = _prefill_both(weights, S, int8=False)
    step = jax.jit(jm.decode_step)
    pos = np.full((tc[0]["k"].shape[0],), S, np.int32)
    for i in range(24):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"decode step {i}")
        pos = pos + 1
    assert pos[0] > WINDOW + 16          # every ring has wrapped
    _assert_rings(jm, jc, tc)


@pytest.mark.parametrize("S", [10, 40])
def test_int8_prefill_logits_and_rings_match_jax(weights, S):
    """An int8 cache: the prefill's logits within 1e-4 and its codes and
    scales as ``_assert_rings`` holds them. Its decode is held by the
    engines' greedy streams (``test_int8_engine_streams_equal_jax``): a
    code that rounds the other way moves later logits by more than
    1e-4."""
    _prefill_both(weights, S, int8=True)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_streams_equal_jax_chunked_and_per_token(weights, cache):
    """The same greedy streams as JAX's engine, chunked and per-token; a
    paged engine pages the global layers and keeps the local rings as
    dense rows, and its rows are the dense engine's n_slots."""
    jm, jp, tm, tp = _pair(weights)
    specs = _specs()
    conf = dict(cache="paged", max_seqs=2) if cache == "paged" else {}
    want = _jax_streams(jm, jp, ("f32", cache, 2), specs, **conf)
    eng = _port(tm, tp, **conf)
    kinds = [sorted(g) for g in eng.cache_backend.tree]
    if cache == "paged":
        assert kinds == [["k", "v"], ["k_pages", "table", "v_pages"]] * 2 \
            + [["k", "v"]]
        assert eng.cache_backend.tree[0]["k"].shape[:2] == (2, WINDOW)
    else:
        assert kinds == [["k", "v"]] * 5
    assert _serve(eng, specs, Request) == want
    assert _serve(_port(tm, tp, chunked=False, **conf), specs,
                  Request) == want


def test_paged_engine_admits_past_the_dense_slots_like_jax(weights):
    """A paged engine over the default ``max_seqs`` (its block budget)
    holds more sequences than n_slots, each with its own dense ring row,
    and serves JAX's paged streams."""
    jm, jp, tm, tp = _pair(weights)
    specs = _specs()
    want = _jax_streams(jm, jp, ("f32", "paged"), specs, cache="paged")
    eng = _port(tm, tp, cache="paged")
    assert eng.cache_backend.tree[0]["k"].shape[0] == eng.config.n_rows > 2
    assert _serve(eng, specs, Request) == want
    assert eng.peak_active > 2


def test_prefix_cache_is_off_under_a_window(weights):
    """Prompts that share a 32-token prefix: with ``prefix_cache=True``
    the sharing gate stays shut for a windowed model, so no hit tokens,
    and the streams are JAX's (whose gate is shut as well)."""
    jm, jp, tm, tp = _pair(weights)
    specs = _specs([(40, 6), (40, 5), (48, 4)], seed=5, prefix=32)
    want = _jax_streams(jm, jp, ("f32", "shared"), specs, cache="paged",
                        prefix_cache=True)
    eng = _port(tm, tp, cache="paged", prefix_cache=True)
    assert not eng._share
    got = _serve(eng, specs, Request)
    assert got == want
    assert all(hits == 0 for _, hits in got.values())
    assert eng.prefix_hit_tokens_total == 0


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_int8_engine_streams_equal_jax(weights, cache):
    jm, jp, tm, tp = _pair(weights, int8=True)
    specs = _specs(SPEC[:3])
    want = _jax_streams(jm, jp, ("int8", cache), specs, cache=cache)
    eng = _port(tm, tp, cache=cache)
    assert eng.cache_backend.tree[0]["k"].dtype == torch.int8
    assert eng.cache_backend.tree[0]["k_scale"].shape[1] == WINDOW
    assert _serve(eng, specs, Request) == want


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_jax_reduced_config_pages_its_full_width_window(cache):
    """``gemma3-27b-reduced`` as the JAX package reduces it: one super-block
    of a local and a global layer, window 64 = ``max_len``, so the local
    layer's ring never wraps and a paged engine pages both layers."""
    jcfg, tcfg = jax_config("gemma3-27b-reduced"), get_config(
        "gemma3-27b-reduced")
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert tm.windows == [MAX_LEN, 0]
    specs = _specs([(12, 20), (30, 10), (12, 6)], seed=4)
    want = _jax_streams(jm, jp, ("jax-reduced", cache), specs, cache=cache)
    eng = _port(tm, tp, cache=cache)
    pages = [("k_pages" in g) for g in eng.cache_backend.tree]
    assert pages == [cache == "paged"] * 2
    assert _serve(eng, specs, Request) == want


def test_mini_cache_rings_are_as_wide_as_the_engine_ring():
    tm = Model(_cfgs()[1], device="cpu")
    mini = tm.init_cache(3, MAX_LEN, width=10)
    assert [g["k"].shape[:2] for g in mini] == [
        (3, WINDOW), (3, 10), (3, WINDOW), (3, 10), (3, WINDOW)]
    # a window no narrower than the horizon pages, so its mini-cache
    # follows the width
    wide = Model(get_config("gemma3-27b-reduced"), device="cpu")
    assert [g["k"].shape[1] for g in wide.init_cache(1, 64, width=10)] == [
        10, 10]


def test_bridge_reads_the_super_block_tree_and_round_trips(weights,
                                                            tmp_path):
    jm, jp, tm, tp = _pair(weights)
    tree = weights[1]
    for layer, p in enumerate(tp["layers"]):
        want = _jax_leaf(jm, tree, layer)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            got = p
            for k in path:
                got = got[k.key]
            assert got.numpy().tobytes() == np.ascontiguousarray(
                leaf).tobytes(), (layer, path)
    path = bridge.save_params(tp, tmp_path / "gemma.npz", tm.cfg)
    back = bridge.load_params(tm.cfg, path, device="cpu")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tp)):
        assert torch.equal(a, b)
    # without the config the layers go out as one stack, which the gemma
    # layout refuses on the way back
    flat = bridge.save_params(tp, tmp_path / "flat.npz")
    with pytest.raises(ValueError, match="parameter groups"):
        bridge.load_params(tm.cfg, flat, device="cpu")
    with pytest.raises(ValueError, match="leading axes"):
        bad = dict(tree, rem=jax.tree.map(lambda a: a[:0], tree["rem"]))
        bridge.from_numpy(tm.cfg, bad, device="cpu")

"""The port's whisper (the audio encoder-decoder) against the JAX ``Model``
and ``ServingEngine`` on the same weights.

``whisper-large-v3-reduced`` (2 encoder and 2 decoder layers, d 256, 4
heads of 32, 16 frames): each request carries its frame embeddings as
``extras["audio_frames"]`` (16, 256) float32. Weights come from JAX's
``Model.init`` and cross through ``repro_torch.params.from_numpy``. The
encoder's output, the prefill logits and the decode logits are compared
in float32 within 1e-4; other frames give other logits. With bfloat16
weights and float32 frames each stage's dtype is JAX's (``eval_shape``):
the encoder and the prefill's memory float32, the cache's memory
bfloat16. ``decode_cross_attention``'s plain version equals JAX's op and
its Pallas decode kernel (interpreted) over an all-valid memory. Greedy
streams of the dense and the paged engine equal JAX's, chunked and
per-token, over an int8 cache too; with ``prefix_cache=True`` a paged
engine shares nothing (sinusoidal positions shut the gate, as in JAX)
and its streams equal sharing off, the block accounting exact. The
weights round-trip through ``save_params``/``load_params``, and
``engine_cache_bytes`` counts the memory rows (equal to the engines'
allocations in tests/test_torch_containers.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.kernels import decode_attention as jax_da  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import containers as tcont  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

ARCH = "whisper-large-v3-reduced"
TOL = 1e-4
MAX_LEN = 64
SPECS = [(5, 6), (17, 4), (30, 9), (12, 3), (9, 7)]


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _frames(cfg, seed: int, batch: int | None = None) -> np.ndarray:
    shape = (cfg.encoder_seq, cfg.d_model)
    if batch is not None:
        shape = (batch,) + shape
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _prefill_both(pair, toks, frames, last):
    jm, jp, tm, tp = pair
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "audio_frames": jnp.asarray(frames)},
                        jm.init_cache(len(toks), MAX_LEN),
                        logits_at=jnp.asarray(last))
    tc = tm.init_cache(len(toks), MAX_LEN)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc,
                    logits_at=torch.from_numpy(last),
                    audio_frames=torch.from_numpy(frames))
    return jl, jc, tl, tc


def test_encoder_prefill_and_decode_match_jax(pair):
    """The encoder's output (frames + sinusoid, 2 layers, enc_norm), the
    prefill logits at each row's last position and 3 decode steps (the
    sinusoid at each row's position), within 1e-4; the memory rows the
    prefill stored equal JAX's."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    frames = _frames(cfg, 1, 3)
    np.testing.assert_allclose(
        tm._encode(tp, torch.from_numpy(frames), 3).numpy(),
        np.asarray(jm._encode(jp, {"audio_frames": jnp.asarray(frames)})),
        atol=TOL, rtol=TOL)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 16),
                                             dtype=np.int32)
    last = np.array([15, 6, 11], np.int32)
    jl, jc, tl, tc = _prefill_both(pair, toks, frames, last)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    for layer, c in enumerate(tc):
        for name in ("mem_k", "mem_v"):
            np.testing.assert_allclose(
                c[name].numpy(), np.asarray(jc["stack"][name][layer]),
                atol=TOL, rtol=TOL)
    pos = last + 1
    for step in range(3):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"decode step {step}")
        pos = pos + 1
    with pytest.raises(ValueError, match="audio_frames"):
        tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(3, MAX_LEN))
    with pytest.raises(ValueError, match="audio_frames"):
        tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(3, MAX_LEN),
                   audio_frames=torch.from_numpy(frames[:2]))


def test_other_frames_give_other_logits(pair):
    """The decoder reads the audio: one prompt behind two recordings gives
    two sets of logits (tests/test_models.py's check), each JAX's."""
    cfg = pair[2].cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8),
                                             dtype=np.int32)
    toks[1] = toks[0]
    frames = _frames(cfg, 4, 2)
    jl, _, tl, _ = _prefill_both(pair, toks, frames, np.array([7, 7]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert float((tl[0] - tl[1]).abs().max()) > 1e-3


def test_bf16_stage_dtypes_are_jax_s(pair, monkeypatch):
    """bfloat16 weights and float32 frames, as the engines pass them: the
    encoder runs in float32 (promoted against the weights), the prefill's
    cross-attention keys and values are float32, and its logits and the
    cache's memory rows are JAX's dtypes (``jax.eval_shape``)."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp16 = bridge.from_numpy(cfg, jax.tree.map(np.asarray, jp16),
                             device="cpu")
    frames = _frames(cfg, 5, 2)
    toks = np.zeros((2, 8), np.int32)
    enc = jax.eval_shape(jm._encode, jp16,
                         {"audio_frames": jnp.asarray(frames)})
    jl, jcache = jax.eval_shape(
        lambda p, b: jm.prefill(p, b, jm.init_cache(2, MAX_LEN)), jp16,
        {"tokens": jnp.asarray(toks), "audio_frames": jnp.asarray(frames)})
    assert enc.dtype == jnp.float32 and jcache["stack"]["mem_k"].dtype == \
        jnp.float32
    assert str(tm._encode(tp16, torch.from_numpy(frames), 2).dtype) == \
        f"torch.{enc.dtype}"
    seen = []
    memory = tattn.cross_attn_memory

    def spy(*a, **k):
        kv = memory(*a, **k)
        seen.append(kv[0].dtype)
        return kv
    monkeypatch.setattr(tattn, "cross_attn_memory", spy)
    tc = tm.init_cache(2, MAX_LEN, torch.bfloat16)
    tl = tm.prefill(tp16, torch.from_numpy(toks), tc,
                    audio_frames=torch.from_numpy(frames))
    assert seen == [torch.float32] * cfg.n_layers
    assert str(tl.dtype) == f"torch.{jl.dtype}"
    jmem = jm.init_cache(2, MAX_LEN, jnp.bfloat16)["stack"]["mem_k"]
    assert jmem.dtype == jnp.bfloat16
    assert all(c["mem_k"].dtype == torch.bfloat16 for c in tc)
    eng = ServingEngine(tm, tp16, EngineConfig(
        n_slots=2, max_len=MAX_LEN, dtype=torch.bfloat16), device="cpu")
    assert {c["mem_v"].dtype for c in eng.cache_backend.tree} == {
        torch.bfloat16}


@pytest.mark.parametrize("S_mem", [100, 1500])
def test_decode_cross_attention_matches_jax_op_and_pallas(S_mem):
    """The plain version behind ``ops.decode_cross_attention`` (one query
    token, a wholly valid memory) against JAX's op and its Pallas decode
    kernel, interpreted, at whisper-large-v3's 20 heads of 64 (G = 1)
    over a ragged memory and the full 1500 frames; softcap on and off."""
    rng = np.random.default_rng(S_mem)
    q = rng.standard_normal((2, 20, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, S_mem, 20, 64)).astype(np.float32)
            for _ in range(2))
    valid = jnp.ones((2, S_mem), bool)
    keep = torch.ones((2, S_mem), dtype=torch.bool)
    for softcap in (0.0, 30.0):
        got = ops.decode_cross_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            keep, softcap=softcap).numpy()
        want = jops.decode_cross_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), softcap=softcap)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
        pallas = jax_da.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid,
            softcap=softcap, block_k=S_mem // 3 if S_mem % 3 == 0 else S_mem,
            interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5,
                                   rtol=2e-5)
    # the decode op over the all-true mask, bit for bit
    assert torch.equal(
        ops.decode_cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), keep),
        ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), keep))


def _specs(cfg, lens=SPECS, seed=6, frames_seed=100):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), mn,
             {"audio_frames": _frames(cfg, frames_seed + i)})
            for i, (n, mn) in enumerate(lens)]


def _serve(eng, specs, mk):
    eng.submit_many([mk(i, p.copy(), mn, extras=ex)
                     for i, p, mn, ex in specs])
    return {c.rid: (list(c.tokens), c.prompt_len, c.prefix_hit_tokens)
            for c in eng.run()}


@pytest.fixture(scope="module")
def jax_streams(pair):
    """JAX's streams of SPECS, by (cache, int8), computed once."""
    jm, jp = pair[:2]
    out = {}
    specs = _specs(pair[2].cfg)
    for int8 in (False, True):
        m = (JaxModel(dataclasses.replace(jm.cfg, kv_cache_dtype="int8"))
             if int8 else jm)
        for cache in ("dense", "paged"):
            conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4,
                        cache=cache)
            out[cache, int8] = _serve(jeng.ServingEngine(
                m, jp, jeng.EngineConfig(**conf)), specs, jeng.Request)
    return out


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_greedy_streams_equal_jax_chunked_and_per_token(
        pair, jax_streams, cache):
    """Ragged prompts, each with its own frames: JAX's streams, chunked
    and per-token, on the dense and the paged cache; every paged block is
    back once the engine drains."""
    tm, tp = pair[2:]
    specs = _specs(tm.cfg)
    want = jax_streams[cache, False]
    assert {r: n for r, (_, n, _) in want.items()} == {
        i: len(p) for i, p, _, _ in specs}
    for chunked in (True, False):
        te = ServingEngine(tm, tp, EngineConfig(
            n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache,
            chunked=chunked), device="cpu")
        assert _serve(te, specs, Request) == want, f"chunked={chunked}"
        if cache == "paged":
            cb = te.cache_backend
            cb.flush()
            assert cb.allocator.n_free == cb.layout.max_blocks
            assert cb.n_live_blocks == 0


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_int8_engine_streams_equal_jax(pair, jax_streams, cache):
    """An int8 self-attention cache beside memory rows in the model's
    dtype, as JAX keeps them: JAX's streams."""
    tm, tp = pair[2:]
    cfg = dataclasses.replace(tm.cfg, kv_cache_dtype="int8")
    m8 = Model(cfg, device="cpu")
    te = ServingEngine(m8, tp, EngineConfig(
        n_slots=2, max_len=MAX_LEN, chunk_tokens=4, cache=cache),
        device="cpu")
    layer = te.cache_backend.tree[0]
    names = ("k_pages", "k_scale_pages") if cache == "paged" else (
        "k", "k_scale")
    assert (layer["self"][names[0]].dtype, layer["self"][names[1]].dtype,
            layer["mem_k"].dtype) == (torch.int8, torch.float32,
                                      torch.float32)
    assert _serve(te, _specs(cfg), Request) == jax_streams[cache, True]


def test_prefix_cache_shares_nothing_and_changes_nothing(pair):
    """Two phases of requests behind one 32-token prompt head and one
    recording, as tests/test_paged_cache.py drives every family: the
    paged engine with ``prefix_cache=True`` does not share (learned
    positions shut the gate, as in JAX), has 0 hit tokens, and gives the
    streams of sharing off and of JAX's engine; the blocks add up."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(8)
    head = rng.integers(0, cfg.vocab_size, (32,), dtype=np.int32)
    ex = {"audio_frames": _frames(cfg, 9)}
    phases = [[(rid, np.concatenate([head, rng.integers(
        0, cfg.vocab_size, (n - 32,), dtype=np.int32)]), mn, ex)
        for rid, n, mn in plan]
        for plan in ([(0, 40, 4), (1, 48, 3)], [(10, 44, 4), (11, 52, 2),
                                                (12, 36, 5)])]
    conf = dict(n_slots=4, max_len=128, cache="paged", block_size=16,
                chunk_tokens=4)

    def run(eng, mk):
        got = {}
        for specs in phases:
            got.update(_serve(eng, specs, mk))
        return got
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(prefix_cache=True,
                                                      **conf))
    want = run(je, jeng.Request)
    on = ServingEngine(tm, tp, EngineConfig(prefix_cache=True, **conf),
                       device="cpu")
    off = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
    assert not on._share and not je._share
    got = run(on, Request)
    assert got == want == run(off, Request)
    assert on.prefix_hit_tokens_total == 0
    assert all(h == 0 for _, _, h in got.values())
    cb = on.cache_backend
    cb.flush()
    assert cb.allocator.n_free + cb.n_live_blocks == cb.layout.max_blocks


def test_graph_leaves_hold_every_memory_row(pair):
    """A CUDA engine's step graph holds every cache leaf by address: the
    leaves it checks before a replay include each layer's memory rows
    beside its self attention's group."""
    tm, tp = pair[2:]
    eng = ServingEngine(tm, tp, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                             cache="paged"), device="cpu")
    paths = [p for p, _ in eng.graph_leaves() if p.startswith("cache/")]
    for i in range(tm.cfg.n_layers):
        assert {f"cache/{i}/mem_k", f"cache/{i}/mem_v",
                f"cache/{i}/self/k_pages", f"cache/{i}/self/table"} <= set(
                    paths)


def test_save_load_round_trip(pair, tmp_path):
    """``save_params`` writes JAX's stacked tree (``enc_stack``,
    ``enc_norm``, ``stack``) and ``load_params`` reads it back bit for
    bit, in float32 and bfloat16."""
    tm, tp = pair[2:]
    cfg = tm.cfg
    for dtype in (None, torch.bfloat16):
        params = tp if dtype is None else bridge.from_numpy(
            cfg, _numpy_tree(tp), device="cpu", dtype=dtype)
        path = bridge.save_params(params, tmp_path / "w.npz")
        with np.load(path) as z:
            tops = {key.split("/")[0] for key in z.files}
        assert tops == {"embed", "final_norm", "enc_stack", "enc_norm",
                        "stack"}
        back = bridge.load_params(cfg, path, device="cpu")
        assert len(back["enc_layers"]) == cfg.n_encoder_layers
        assert len(back["layers"]) == cfg.n_layers
        for (pa, a), (pb, b) in zip(_leaves(params), _leaves(back)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _numpy_tree(params) -> dict:
    """The port's parameters as JAX's stacked numpy tree."""
    out = {k: {n: t.numpy() for n, t in v.items()}
           for k, v in params.items() if isinstance(v, dict)}

    def stack(layers):
        first = layers[0]
        return {k: stack([p[k] for p in layers]) if isinstance(v, dict)
                else np.stack([p[k].numpy() for p in layers])
                for k, v in first.items()}
    out["enc_stack"] = stack(params["enc_layers"])
    out["stack"] = stack(params["layers"])
    return out


def test_full_width_model_builds_on_the_cpu():
    """``Model(whisper-large-v3)`` builds on the CPU (no weights drawn),
    its layers all cross blocks, and its budget counts 32 layers of
    (4, 1500, 20, 64) bf16 memory rows: 983 MB at 4 rows."""
    cfg = get_config("whisper-large-v3")
    m = Model(cfg, device="cpu")
    assert m.fam == "whisper" and m.kinds == ["attn"] * 32
    assert m.windows == [0] * 32
    config = EngineConfig(n_slots=4, max_len=448, dtype=torch.bfloat16)
    mem = 32 * 4 * 2 * 1500 * 20 * 64 * 2
    assert mem == 983_040_000
    assert tcont.engine_cache_bytes(cfg, config) == mem + (
        32 * 4 * 448 * 2 * 20 * 64 * 2)
    assert cfg.param_count() == jax_config("whisper-large-v3").param_count()


def test_routers_over_threads_and_a_process_equal_jax(pair, jax_streams):
    """``Router(ThreadBackend(2))`` gives JAX's Router's streams, and
    ``Router(ProcessBackend(1))`` (the frames pickled to a spawned child,
    7.7 MB a request at full width) gives JAX's engine's."""
    from repro.serving import backend as jbackend
    from repro.serving import router as jrouter
    from repro_torch.serving.backend import ProcessBackend, ThreadBackend
    from repro_torch.serving.router import Router

    jm, jp, tm, tp = pair
    specs = _specs(tm.cfg)
    conf = dict(n_slots=2, max_len=MAX_LEN, chunk_tokens=4)
    with jrouter.Router(jbackend.ThreadBackend(
            jm, jp, 2, config=jeng.EngineConfig(**conf))) as jr:
        hs = [jr.submit(jeng.Request(i, p, mn, extras=ex))
              for i, p, mn, ex in specs]
        want = {h.rid: h.tokens() for h in hs}
    with Router(ThreadBackend(tm, tp, 2, EngineConfig(**conf),
                              device="cpu"), device="cpu") as router:
        hs = [router.submit(Request(i, p, mn, extras=ex))
              for i, p, mn, ex in specs]
        assert {h.rid: h.tokens() for h in hs} == want
    backend = ProcessBackend(tm.cfg, 1, EngineConfig(**conf), params=tp,
                             device="cpu", allow_shared_cores=True,
                             start_timeout_s=120.0)
    with Router(backend, device="cpu") as router:
        hs = [router.submit(Request(i, p, mn, extras=ex))
              for i, p, mn, ex in specs]
        got = {h.rid: h.tokens() for h in hs}
    assert got == {r: t for r, (t, _, _) in jax_streams["dense",
                                                         False].items()}
    assert backend.workers is None


def test_entry_points_default_to_cuda_and_refuse_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("whisper-large-v3"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config(ARCH))

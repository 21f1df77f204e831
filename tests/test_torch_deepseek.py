"""The port's deepseek-v2-lite (MLA + MoE) against the JAX package on the
same weights (``deepseek-v2-lite-16b-reduced``: one MLA + dense-MLP
layer, then one MLA + MoE layer of 4 experts top-2 and 2 shared ones;
d_model 256, 4 heads, r = 64, dr = 16):

* the model's prefill and decode logits, float32, within 1e-4;
* greedy completions of the dense and the paged ServingEngine (with
  ``prefix_cache=True``, which a latent cache ignores: no hit tokens) and
  of Router(ThreadBackend(2)), identical to the JAX package's;
* within the port, dense and paged greedy streams bit-identical;
* the weight bridge: ``dense0`` and ``stack`` depths are checked, the
  router stays float32 under a bfloat16 cast, experts keep their E axis;
* a prompt bucket wider than ``max_len`` keeps the first ``max_len``
  latents (the latent cache truncates where the GQA ring wraps), pinned
  against JAX.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.router import Router  # noqa: E402

ARCH = "deepseek-v2-lite-16b-reduced"
TOL = 1e-4
# ragged prompts around the block boundary and the buckets, ragged budgets
SPEC = [(5, 4), (15, 3), (16, 5), (17, 2), (9, 6), (2, 1), (33, 8), (7, 5)]


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


def _specs(plens_max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def test_prefill_and_decode_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    B, S, L = 2, 32, 48
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S), dtype=np.int32)
    last = np.array([S - 1, 20], np.int32)
    wl, wcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(B, L), logits_at=jnp.asarray(last))
    cache = tm.init_cache(B, L)
    logits = tm.prefill(tp, torch.from_numpy(toks), cache,
                        logits_at=torch.from_numpy(last))
    _close(logits, wl)
    _close(cache[0]["ckv"], wcache["dense0"]["ckv"][0])
    _close(cache[1]["k_rope"], wcache["stack"]["k_rope"][0])
    pos = last + 1
    for _ in range(5):
        tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)[:, None]
        wl, wcache = jm.decode_step(jp, jnp.asarray(tok), wcache,
                                    jnp.asarray(pos))
        logits = tm.decode_step(tp, torch.from_numpy(tok), cache,
                                torch.from_numpy(pos.copy()))
        _close(logits, wl)
        pos += 1


@pytest.mark.parametrize("conf", [
    dict(n_slots=2, max_len=64),
    dict(n_slots=2, max_len=64, cache="paged", block_size=16,
         prefix_cache=True),
])
def test_engine_greedy_tokens_match_jax(pair, conf):
    jm, jp, tm, tp = pair
    specs = _specs(SPEC)
    je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(chunk_tokens=4,
                                                      **conf))
    te = ServingEngine(tm, tp, EngineConfig(chunk_tokens=4, **conf),
                       device="cpu")
    assert te.paged == je.paged and not te._share
    je.submit_many([jeng.Request(i, p, mn) for i, p, mn in specs])
    te.submit_many([Request(i, p, mn) for i, p, mn in specs])
    want = {c.rid: (list(c.tokens), c.prefix_hit_tokens) for c in je.run()}
    got = {c.rid: (list(c.tokens), c.prefix_hit_tokens) for c in te.run()}
    assert got == want
    assert all(len(got[i][0]) == mn and got[i][1] == 0
               for i, _, mn in specs)
    assert te.tokens_generated == je.tokens_generated
    assert te.prefill_tokens_executed == je.prefill_tokens_executed


def test_router_two_containers_match_jax(pair):
    jm, jp, tm, tp = pair
    specs = _specs(SPEC[:6], seed=3)
    conf = dict(n_slots=2, max_len=64, chunk_tokens=3)
    jr = jrouter.Router(jbackend.ThreadBackend(
        jm, jp, 2, config=jeng.EngineConfig(**conf)))
    tr = Router(ThreadBackend(tm, tp, 2, config=EngineConfig(**conf),
                              device="cpu"), device="cpu")
    with jr, tr:
        jh = [jr.submit(jeng.Request(i, p, mn)) for i, p, mn in specs]
        th = [tr.submit(Request(i, p, mn)) for i, p, mn in specs]
        assert [h.container_id for h in th] == [h.container_id for h in jh]
        want = {h.rid: list(h.result().tokens) for h in jh}
        got = {h.rid: list(h.result().tokens) for h in th}
    assert got == want


def test_dense_and_paged_streams_are_bit_identical(pair):
    """Same-bucket groups of at most n_slots in queue order and max_seqs =
    n_slots: both engines prefill the same batches and decode the same
    rows, so their greedy streams agree token for token."""
    _, _, tm, tp = pair
    specs = _specs([(20, 6), (30, 7), (25, 5), (5, 9), (9, 4), (40, 3)],
                   seed=5)
    streams = []
    for cache in ("dense", "paged"):
        eng = ServingEngine(tm, tp, EngineConfig(
            n_slots=3, max_len=64, cache=cache, block_size=16, max_seqs=3,
            chunk_tokens=4), device="cpu")
        eng.submit_many([Request(i, p, mn) for i, p, mn in specs])
        streams.append({c.rid: list(c.tokens) for c in eng.run()})
    assert streams[0] == streams[1]
    assert len(streams[0]) == len(specs)


def test_bridge_checks_depths_and_keeps_the_router_float32():
    cfg = get_config(ARCH)
    jp = JaxModel(jax_config(ARCH)).init(jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.from_numpy(cfg, tree, device="cpu", dtype=torch.bfloat16)
    assert [sorted(p) for p in tp["layers"]] == [
        ["attn", "ln1", "ln2", "mlp"], ["attn", "ln1", "ln2", "moe"]]
    m = tp["layers"][1]["moe"]
    assert m["router"].dtype == torch.float32
    assert np.array_equal(m["router"].numpy(),
                          np.asarray(jp["stack"]["moe"]["router"][0]))
    assert m["experts"]["w_gate"].shape == (cfg.n_experts, cfg.d_model,
                                            cfg.moe_d_ff)
    assert m["experts"]["w_down"].dtype == torch.bfloat16
    assert tp["layers"][0]["attn"]["w_dkv"].shape == (
        cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    for name, extra in (("dense0", 1), ("stack", 1)):
        bad = dict(tree)
        bad[name] = jax.tree.map(lambda a: np.concatenate([a] * (1 + extra)),
                                 tree[name])
        with pytest.raises(ValueError, match=f"{name} leaves"):
            bridge.from_numpy(cfg, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "dense0"}
    with pytest.raises(ValueError, match="parameter groups"):
        bridge.from_numpy(cfg, missing, device="cpu")


def test_port_init_is_shaped_like_the_reference():
    cfg = get_config(ARCH)
    tp = Model(cfg, device="cpu").init(seed=0, dtype=torch.bfloat16)
    jm = JaxModel(jax_config(ARCH))
    jp = jax.eval_shape(lambda k: jm.init(k, jnp.bfloat16),
                        jax.random.PRNGKey(0))
    for i, (group, layer) in enumerate((("dense0", 0), ("stack", 0))):
        want = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                            jp[group])
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[1]),
                           tp["layers"][i])
        assert got == want


def test_bucket_past_max_len_keeps_the_first_latents(pair):
    """A 40-token prompt pads to the 64-token bucket; with max_len 48 the
    latent cache keeps positions [0, 48) (pads 40-47 included, masked
    until decode overwrites them), where the GQA ring would wrap. The
    cache rows and the engines' completions match JAX's."""
    jm, jp, tm, tp = pair
    prompt = np.random.default_rng(9).integers(0, 512, (40,),
                                               dtype=np.int32)
    padded = np.zeros((1, 64), np.int32)
    padded[0, :40] = prompt
    _, wcache = jm.prefill(jp, {"tokens": jnp.asarray(padded)},
                           jm.init_cache(1, 48), logits_at=39)
    cache = tm.init_cache(1, 48)
    tm.prefill(tp, torch.from_numpy(padded), cache, logits_at=39)
    for i, group in enumerate(("dense0", "stack")):
        for name in ("ckv", "k_rope"):
            _close(cache[i][name], wcache[group][name][0])
        assert bool((cache[i]["ckv"][0, 40:] != 0).any())
    for conf in (dict(n_slots=1, max_len=48),
                 dict(n_slots=1, max_len=48, cache="paged", block_size=16)):
        je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(chunk_tokens=4,
                                                          **conf))
        te = ServingEngine(tm, tp, EngineConfig(chunk_tokens=4, **conf),
                           device="cpu")
        je.submit(jeng.Request(0, prompt, 6))
        te.submit(Request(0, prompt, 6))
        assert [list(c.tokens) for c in te.run()] == [
            list(c.tokens) for c in je.run()]

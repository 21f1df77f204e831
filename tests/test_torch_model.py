"""The port's dense model against the JAX ``Model`` on the same weights.

Weights come from the JAX ``Model.init`` and cross over through
``repro_torch.params.from_numpy`` (numpy arrays only). Logits are compared
in f32 at atol = rtol = 1e-4: the two sides sum the projections in a
different order (measured max difference about 4e-6 on these configs),
and 1e-4 still sits far below the gaps between the top logits that greedy
decoding has to resolve. Greedy tokens must be identical.
qwen3-0.6b-reduced covers GQA, qk_norm and the tied head; stablelm-1.6b-
reduced covers layernorm and partial rotary embeddings.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = ["qwen3-0.6b-reduced", "stablelm-1.6b-reduced"]
LOGIT_TOL = 1e-4
MAX_LEN = 48


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    name = request.param
    jm = JaxModel(jax_config(name))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(name), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _prompts(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def test_port_config_matches_jax_config():
    import dataclasses
    for name in ARCHS + [a[: -len("-reduced")] for a in ARCHS]:
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jax_config(name)))


def test_bridge_reproduces_every_leaf_byte_for_byte():
    jm = JaxModel(jax_config("qwen3-0.6b-reduced"))
    jp = jm.init(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.from_numpy(jm.cfg, tree, device="cpu")

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(prefix + (k,), v)
        else:
            yield prefix, node

    n = 0
    for path, leaf in walk((), tree):
        if path[0] == "stack":
            for layer in range(jm.cfg.n_layers):
                got = tp["layers"][layer]
                for k in path[1:]:
                    got = got[k]
                want = np.ascontiguousarray(leaf[layer])
                assert got.numpy().tobytes() == want.tobytes(), path
                n += 1
        else:
            got = tp
            for k in path:
                got = got[k]
            assert got.numpy().tobytes() == leaf.tobytes(), path
            n += 1
    # embed, final norm; per layer: 2 norms, 4 projections, q/k norms, 3 mlp
    assert n == 2 + jm.cfg.n_layers * 11
    with pytest.raises(ValueError, match="leading axes"):
        bad = dict(tree, stack=jax.tree.map(lambda a: a[:1], tree["stack"]))
        bridge.from_numpy(jm.cfg, bad, device="cpu")


def test_bridge_keeps_bfloat16_bits():
    jm = JaxModel(jax_config("qwen3-0.6b-reduced"))
    jp = jm.init(jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.from_numpy(jm.cfg, tree, device="cpu")
    want = tree["stack"]["attn"]["wq"][1]
    got = tp["layers"][1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.uint16).numpy().tobytes() == \
        np.ascontiguousarray(want).view(np.uint16).tobytes()


def test_prefill_and_decode_step_logits_match(pair):
    jm, jp, tm, tp = pair
    toks = _prompts(tm.cfg, 3, 16, seed=1)
    last = np.array([15, 6, 11], np.int32)      # ragged real lengths
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(3, MAX_LEN),
                        logits_at=jnp.asarray(last))
    tc = tm.init_cache(3, MAX_LEN)
    tl = tm.prefill(tp, torch.from_numpy(toks), tc,
                    logits_at=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for j in range(jm.cfg.n_layers):
        np.testing.assert_allclose(tc[j]["k"].numpy(),
                                   np.asarray(jc["stack"]["k"][j]),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)

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


def test_greedy_decode_chunk_tokens_identical(pair):
    """Ragged budgets: one slot finishes mid-chunk, one is idle from the
    start, one runs into the max_len - 1 horizon."""
    jm, jp, tm, tp = pair
    ml = 24
    toks = _prompts(tm.cfg, 3, 16, seed=2)
    last = np.array([15, 9, 15], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(3, ml), logits_at=jnp.asarray(last))
    tc = tm.init_cache(3, ml)
    tm.prefill(tp, torch.from_numpy(toks), tc,
               logits_at=torch.from_numpy(last))
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)
    state = {"tokens": first, "pos": last + 1,
             "remaining": np.array([3, 5, 20], np.int32),
             "active": np.array([True, False, True])}
    jblock, jemit, jstate, _ = jm.decode_chunk(
        jp, jc, dict({k: jnp.asarray(v) for k, v in state.items()},
                     key=jax.random.PRNGKey(0)), 8, max_len=ml)
    tblock, temit, tstate = tm.decode_chunk(
        tp, tc, {k: torch.from_numpy(v) for k, v in state.items()}, 8,
        max_len=ml)
    assert temit.tolist() == np.asarray(jemit).tolist() == [3, 0, 7]
    for i, n in enumerate(temit.tolist()):
        assert tblock[i, :n].tolist() == np.asarray(jblock)[i, :n].tolist()
    for k in ("tokens", "pos", "remaining", "active"):
        assert tstate[k].tolist() == np.asarray(jstate[k]).tolist(), k


@pytest.mark.parametrize("shape", [(3, 77, 64), (5, 64), (2, 128, 64),
                                   (0, 64)])
def test_sliced_matmul_is_the_products_of_its_slices(shape):
    """``layers.sliced_matmul``, the card's float32 projection: every row
    comes from one ``ROW_SLICE``-row product of the zero-padded slice that
    holds it, and the whole agrees with JAX's ``x @ w``."""
    from repro_torch.models import layers

    rows = layers.ROW_SLICE
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    got = layers.sliced_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (*shape[:-1], 40)
    flat = torch.from_numpy(x.reshape(-1, 64))
    n = flat.shape[0]
    padded = torch.cat([flat, flat.new_zeros((-n % rows, 64))])
    want = [padded[i:i + rows] @ torch.from_numpy(w)
            for i in range(0, padded.shape[0], rows)]
    assert torch.equal(got.reshape(-1, 40),
                       torch.cat(want)[:n] if want else flat[:, :40])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnp.asarray(x) @ jnp.asarray(w)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_project_is_one_product_off_the_card(dtype):
    """On the CPU (and in bfloat16 anywhere) ``layers.project`` is the one
    product ``x @ w``, so the CPU path keeps its bits."""
    from repro_torch.models import layers

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    x, w = x.to(dtype), w.to(dtype)
    assert torch.equal(layers.project(x, w), x @ w)


def test_prefill_products_is_scoped_to_its_thread():
    """``layers.prefill_products`` turns float32 slicing on for its own
    thread only (a ThreadBackend runs one engine a thread), nests, and is
    off again after it, an exception included."""
    import threading

    from repro_torch.models import layers

    def on():
        return getattr(layers._prefill, "on", False)

    seen = []
    with layers.prefill_products():
        worker = threading.Thread(target=lambda: seen.append(on()))
        worker.start()
        worker.join()
        with layers.prefill_products():
            assert on()
        assert on()
    assert seen == [False] and not on()
    with pytest.raises(RuntimeError):
        with layers.prefill_products():
            raise RuntimeError
    assert not on()


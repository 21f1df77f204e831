"""Training in bfloat16 on the port against the JAX package, on the CPU.

One reduced config of each of the seven families, with JAX's init from
``jax.random.PRNGKey(0)`` crossing over as numpy through
``params.from_numpy`` and then cast to bfloat16 on both sides (but the
leaves both packages keep float32 under any cast: a Mamba2 block's
``A_log``, ``dt_bias``, ``D`` and the MoE router): the port's
``Model.loss`` of one batch and its gradients (through the plain
backward versions ``ref.flash_attention_bwd``, ``ref.rmsnorm_bwd`` and
``ref.ssd_scan_bwd``, the card kernels' contracts) against
``jax.value_and_grad(Model.loss)`` of the same bfloat16 tree. The loss
within 1e-3 relative and every gradient leaf within 5e-2 of max|JAX
leaf|: two bfloat16 computations that round at different places (JAX's
own bfloat16 gradients differ from its float32 ones by up to ~2.5e-2 of
max|leaf| on these models). JAX runs jitted on the CPU, as its own
tests run it. Inputs come from a seeded numpy generator.
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
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

FAMILIES = {"dense": "qwen3-0.6b-reduced", "gemma": "gemma3-27b-reduced",
            "moe": "deepseek-v2-lite-16b-reduced",
            "ssm": "mamba2-2.7b-reduced", "zamba": "zamba2-7b-reduced",
            "whisper": "whisper-large-v3-reduced",
            "vision": "internvl2-26b-reduced"}
B, S = 2, 16
LOSS_TOL = 1e-3     # relative
GRAD_TOL = 5e-2     # of max|JAX leaf|


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small models: one torch thread runs them about as fast as many and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, fam: str) -> dict:
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if fam in ("dense", "vision"):
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.int32)
    if cfg.n_vision_tokens:
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_embed_dim)).astype(np.float32)
    if cfg.arch_type == "audio":
        b["audio_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_bf16_loss_and_grads_match_jax(fam):
    jc = jax_config(FAMILIES[fam])
    if jc.is_moe:
        jc = dataclasses.replace(jc, router_aux_loss_coef=0.003)
    cfg = ArchConfig(**dataclasses.asdict(jc))
    jm = JaxModel(jc)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    batch = _batch(cfg, fam)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            a, jnp.float32 if path[-1].key in bridge.F32_LEAVES
            else jnp.bfloat16), tree)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    model = Model(cfg, device="cpu")
    params = bridge.from_numpy(cfg, tree, device="cpu", dtype=torch.bfloat16)
    leaves = opt.unique_leaves(params)
    assert torch.bfloat16 in {t.dtype for t in leaves}
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    g = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    grads = bridge.to_numpy(cfg, opt.map_tree(lambda p: g[id(p)], params))

    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_TOL)
    want_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    for path, want in _leaves(want_tree):
        got = _at(grads, path)
        assert got.shape == want.shape, path
        assert _at(jgrads, path).dtype == _at(jp, path).dtype, path
        err = float(np.max(np.abs(got - want)))
        bound = GRAD_TOL * max(float(np.max(np.abs(want))), 1e-30)
        assert err <= bound, (path, err, bound)

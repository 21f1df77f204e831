"""The port's multi-head latent attention (MLA) against the JAX package's.

Three parts, inputs from a seeded numpy generator through both sides:

* the plain ``mla_decode_ctx`` against ``repro.kernels.ref``'s and
  against the Pallas kernel in interpret mode, at the shapes of
  tests/test_kernels.py (f32 within 2e-5, bf16 within 2e-2). A row with
  no valid position is the one documented difference (the port gives 0,
  the JAX oracle the mean of the latent rows) and is checked against 0;
* ``mla_prefill_into_cache`` and ``mla_decode`` of one reduced
  deepseek-v2-lite layer against JAX's ``mla_prefill``,
  ``_mla_fill_cache`` and ``mla_decode`` on the same weights (f32,
  1e-4), the cache rows included;
* within the port, decode over the paged latent cache gives the dense
  cache's bits for the same logical cache, whatever the unowned pages
  hold.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mla_decode import \
    mla_decode_ctx as pallas_mla  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import cache as paged  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "deepseek-v2-lite-16b-reduced"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(seed, B, H, r, dr, S, dead_row):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, r), (B, H, dr), (B, S, r), (B, S, dr))]
    valid = rng.random((B, S)) < 0.7
    valid[:, 0] = True
    if dead_row:
        valid[-1] = False
    return arrays, valid


@pytest.mark.parametrize("B,H,r,dr,S,bs", [
    (2, 4, 64, 16, 256, 64),
    (1, 8, 128, 32, 512, 128),
    (3, 2, 32, 8, 128, 128),      # single block
])
@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
@pytest.mark.parametrize("dead_row", [False, True])
def test_plain_mla_decode_matches_jax_ref_and_pallas_interpret(
        B, H, r, dr, S, bs, dn, dead_row):
    arrays, valid = _case(B + S, B, H, r, dr, S, dead_row)
    scale = (r + dr) ** -0.5
    got = ops.mla_decode_ctx(*(torch.from_numpy(a).to(TDT[dn])
                               for a in arrays),
                             torch.from_numpy(valid), scale=scale)
    assert got.shape == (B, H, r) and got.dtype == TDT[dn]
    jargs = [jnp.asarray(a).astype(JDT[dn]) for a in arrays]
    want_ref = jref.mla_decode_ctx(*jargs, jnp.asarray(valid), scale=scale)
    want_pallas = pallas_mla(*jargs, jnp.asarray(valid), scale=scale,
                             block_s=bs, interpret=True)
    live = valid.any(axis=1)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(
            got.float().numpy()[live],
            np.asarray(want.astype(jnp.float32))[live],
            atol=TOL[dn], rtol=TOL[dn])
    assert bool((got[torch.from_numpy(~live)] == 0).all())


def test_plain_mla_decode_takes_any_S_and_ignores_dead_positions():
    """S = 37 (no Pallas block divides it); whatever finite values the
    dead positions hold, the output keeps its bits."""
    arrays, valid = _case(5, 2, 4, 64, 16, 37, False)
    t = [torch.from_numpy(a) for a in arrays]
    want = tref.mla_decode_ctx(*t, torch.from_numpy(valid), scale=0.125)
    got_j = jref.mla_decode_ctx(*(jnp.asarray(a) for a in arrays),
                                jnp.asarray(valid), scale=0.125)
    np.testing.assert_allclose(want.numpy(), np.asarray(got_j), atol=2e-5,
                               rtol=2e-5)
    dead = torch.from_numpy(~valid)
    t[2][dead] = 1e4
    t[3][dead] = -1e4
    got = tref.mla_decode_ctx(*t, torch.from_numpy(valid), scale=0.125)
    assert torch.equal(got, want)


# rows live to the card body's split edges (64-position splits): one
# position, a split's last, its edge and the next split's first, the
# second edge, the whole horizon, and one row with no live position
EDGE_DEPTHS = [1, 63, 64, 65, 127, 128, 129, 192, 0]


@pytest.mark.parametrize("H,r,dr", [
    (16, 64, 20),     # deepseek's 16 heads, dr not a multiple of 16
    (3, 32, 4),       # H < 16: the card body pads the MMA rows
    (5, 128, 64),
])
def test_plain_mla_decode_at_the_split_edges_matches_jax(H, r, dr):
    """The plain version, the card's yardstick, at exactly the lengths the
    card body cuts at: against the JAX oracle and the Pallas kernel in
    interpret mode (float32, 2e-5); the all-dead row against 0, the
    port's stated difference."""
    B, S = len(EDGE_DEPTHS), 192
    arrays, _ = _case(H + r + dr, B, H, r, dr, S, False)
    valid = np.arange(S)[None, :] < np.array(EDGE_DEPTHS)[:, None]
    scale = (r + dr) ** -0.5
    got = ops.mla_decode_ctx(*(torch.from_numpy(a) for a in arrays),
                             torch.from_numpy(valid), scale=scale)
    jargs = [jnp.asarray(a) for a in arrays]
    live = valid.any(axis=1)
    for want in (jref.mla_decode_ctx(*jargs, jnp.asarray(valid),
                                     scale=scale),
                 pallas_mla(*jargs, jnp.asarray(valid), scale=scale,
                            block_s=64, interpret=True)):
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], atol=2e-5,
                                   rtol=2e-5)
    assert not live[-1] and bool((got[-1] == 0).all())


@pytest.fixture(scope="module")
def layer():
    """Layer 0 (MLA + dense MLP) of reduced deepseek on both sides."""
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return (jm.cfg, jax.tree.map(lambda a: a[0], jp["dense0"])["attn"],
            tm.cfg, tp["layers"][0]["attn"])


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("S,L", [(24, 40), (24, 16)])
def test_mla_prefill_and_decode_match_jax(layer, S, L):
    """Prefill of S tokens into an L-wide latent cache (L < S keeps the
    first L positions, as JAX's ``_mla_fill_cache``), then decode steps at
    ragged positions inside the cache."""
    jcfg, jpa, cfg, tpa = layer
    rng = np.random.default_rng(S + L)
    B = 2
    x = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    want = jattn.mla_prefill(jpa, jcfg, jnp.asarray(x))
    jcache = jblocks._mla_fill_cache(
        jpa, jcfg, jnp.asarray(x),
        jattn.init_mla_cache(jcfg, B, L, jnp.float32))
    cache = attn.init_mla_cache(cfg, B, L, torch.float32,
                                torch.device("cpu"))
    got = attn.mla_prefill_into_cache(tpa, cfg, torch.from_numpy(x), cache)
    _close(got, want)
    _close(cache["ckv"], jcache["ckv"])
    _close(cache["k_rope"], jcache["k_rope"])
    pos = np.array([min(S, L - 3), 5], np.int32)
    for _ in range(3):
        xt = (0.5 * rng.standard_normal((B, 1, cfg.d_model))).astype(
            np.float32)
        want, jcache = jattn.mla_decode(jpa, jcfg, jnp.asarray(xt), jcache,
                                        jnp.asarray(pos))
        got = attn.mla_decode(tpa, cfg, torch.from_numpy(xt), cache,
                              torch.from_numpy(pos.copy()))
        _close(got, want)
        _close(cache["ckv"], jcache["ckv"])
        _close(cache["k_rope"], jcache["k_rope"])
        pos += 1


def test_paged_mla_decode_gives_the_dense_bits(layer):
    """The same logical latent cache as dense rows and as scattered pages
    (garbage in every unowned page): decode writes the same latents and
    returns the same bits."""
    _, _, cfg, tpa = layer
    rng = np.random.default_rng(3)
    B, L, bs = 3, 64, 16
    nblk, n_pages = L // bs, 2 * B * (L // bs)
    layout = paged.PagedLayout(bs, n_pages)
    dense = attn.init_mla_cache(cfg, B, L, torch.float32,
                                torch.device("cpu"))
    for name in dense:
        dense[name].copy_(torch.from_numpy(
            rng.standard_normal(dense[name].shape).astype(np.float32)))
    table = torch.from_numpy(rng.permutation(n_pages)[:B * nblk].reshape(
        B, nblk).astype(np.int32))
    group = paged.init_paged_mla_cache(cfg, table, layout, torch.float32)
    pos = torch.tensor([0, 17, 62], dtype=torch.int32)
    # positions past each row's first decode are dead: other garbage there
    dead = torch.arange(L)[None, :] > pos[:, None].long()
    for dk, sk in (("ckv_pages", "ckv"), ("k_rope_pages", "k_rope")):
        pages = group[dk]
        pages.copy_(torch.from_numpy(
            100 * rng.standard_normal(pages.shape).astype(np.float32)))
        view = dense[sk].clone()
        view[dead] = torch.from_numpy(100 * rng.standard_normal(
            view[dead].shape).astype(np.float32))
        pages[table.long()] = view.reshape(B, nblk, bs, -1)
    for _ in range(2):
        x = torch.from_numpy((0.5 * rng.standard_normal(
            (B, 1, cfg.d_model))).astype(np.float32))
        want = attn.mla_decode(tpa, cfg, x, dense, pos.clone())
        got = attn.mla_decode(tpa, cfg, x, group, pos.clone())
        assert torch.equal(got, want)
        for dk, sk in (("ckv_pages", "ckv"), ("k_rope_pages", "k_rope")):
            view = group[dk][table.long()].reshape(dense[sk].shape)
            assert torch.equal(view[torch.arange(B), pos.long()],
                               dense[sk][torch.arange(B), pos.long()])
        pos = pos + 1

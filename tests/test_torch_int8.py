"""The port's int8 KV quantiser and its plain int8 decode kernels against
the JAX package's.

Inputs come from a seeded numpy generator and go through both sides:

* ``_quant_kv``: codes and scales EXACTLY equal to the reference's as the
  model runs it, under ``jax.jit`` (XLA turns its ``absmax / 127.0`` into
  a multiply by float32(1/127) there; the port writes that multiply), in
  float32 and bfloat16, zero rows included; plus the round-trip bound of
  tests/test_layers.py.
* the plain int8 dense decode against ``repro.kernels.ref``'s blocked
  oracle with scales and the Pallas int8 kernel in interpret mode, at the
  shapes of tests/test_kernels.py; the plain int8 paged decode against
  ``ref.paged_decode_attention`` with scale pages and the Pallas paged
  int8 kernel, at the shape of tests/test_paged_kernel.py (f32 within
  2e-5, bf16 within 2e-2). Every row sees a key: a row that sees none is
  the documented difference (0 in the port) and is checked against 0.
* the port's own contract: the paged plain version gives the dense plain
  version's bits over the gathered view, and NaN in every page and scale
  page no row owns (scratch included) moves nothing.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_int8 as pallas_int8  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention_int8 as pallas_paged_int8  # noqa: E402
from repro.models.attention import _quant_kv as jax_quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.attention import _quant_kv  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _quant_np(x):
    """Codes and scales of float32 numpy ``x`` (..., K) by the port."""
    q, s = _quant_kv(torch.from_numpy(x))
    return q.numpy(), s.numpy()


# ---------------------------------------------------------------------------
# the quantiser
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
def test_quant_kv_codes_and_scales_equal_jitted_jax(dn):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 64, 8, 128))
         * np.exp(rng.standard_normal((4, 64, 8, 1)) * 2)).astype(np.float32)
    x[1, 3] = 0.0                          # zero rows: scale floors at 1e-8
    x[2, 5, 1] = 1e-12                     # a row below the floor
    xj = jnp.asarray(x).astype(JDT[dn])
    want_q, want_s = jax.jit(jax_quant)(xj)
    got_q, got_s = _quant_kv(torch.from_numpy(x).to(TDT[dn]))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()
    assert bool((got_q[1, 3] == 0).all())
    assert bool((got_s[1, 3] == np.float32(1e-8)).all())


@pytest.mark.parametrize("seed,scale", [(0, 0.01), (1, 1.0), (2, 7.5),
                                        (3, 100.0)])
def test_quant_roundtrip_bounded_error(seed, scale):
    x = (scale * np.random.default_rng(seed).standard_normal((3, 5, 32))
         ).astype(np.float32)
    q, s = _quant_np(x)
    deq = q.astype(np.float32) * s[..., None]
    # absmax int8: error per element <= half a step of rowmax / 127
    err = np.abs(deq - x).max(axis=-1)
    bound = np.abs(x).max(axis=-1) / 127.0 * 0.51
    assert np.all(err <= bound + 1e-7)
    assert np.all(np.abs(q) <= 127)


def test_quant_zero_row_is_safe():
    q, s = _quant_np(np.zeros((2, 3, 16), np.float32))
    assert np.all(q == 0) and np.all(np.isfinite(s))


# ---------------------------------------------------------------------------
# plain int8 dense decode
# ---------------------------------------------------------------------------
def _dense_case(seed, B, H, Hkv, K, W):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, K)).astype(np.float32)
    kq, ks = _quant_np(rng.standard_normal((B, W, Hkv, K)).astype(np.float32))
    vq, vs = _quant_np(rng.standard_normal((B, W, Hkv, K)).astype(np.float32))
    valid = rng.random((B, W)) < 0.7
    valid[:, 0] = True
    return q, kq, vq, valid, ks, vs


def _port_dense(dn, q, kq, vq, valid, ks, vs, softcap=0.0):
    return tref.decode_attention(
        torch.from_numpy(q).to(TDT[dn]), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(valid), softcap=softcap,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))


def _close(got, want, dn):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dn], rtol=TOL[dn])


@pytest.mark.parametrize("B,H,Hkv,K,W", [(2, 4, 2, 64, 256),
                                         (1, 8, 8, 32, 512)])
@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
def test_plain_int8_decode_matches_jax_ref_and_pallas_interpret(B, H, Hkv, K,
                                                                W, dn):
    q, kq, vq, valid, ks, vs = _dense_case(0, B, H, Hkv, K, W)
    got = _port_dense(dn, q, kq, vq, valid, ks, vs)
    assert got.shape == (B, H, K) and got.dtype == TDT[dn]
    jargs = (jnp.asarray(q).astype(JDT[dn]), jnp.asarray(kq),
             jnp.asarray(vq), jnp.asarray(valid))
    _close(got, jref.decode_attention_blocked(
        *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)), dn)
    _close(got, pallas_int8(*jargs, jnp.asarray(ks), jnp.asarray(vs),
                            block_k=128, interpret=True), dn)


def test_plain_int8_decode_softcap_matches_jax():
    q, kq, vq, valid, ks, vs = _dense_case(1, 2, 4, 2, 64, 128)
    got = _port_dense("float32", q, kq, vq, valid, ks, vs, softcap=30.0)
    want = jref.decode_attention_blocked(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(valid), softcap=30.0, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    _close(got, want, "float32")


def test_plain_int8_decode_dequantises_then_runs_the_plain_path():
    """The int8 plain version is the float plain version over
    ``codes * scale``, bit for bit, and a row with no valid slot is 0."""
    q, kq, vq, valid, ks, vs = _dense_case(2, 3, 4, 2, 32, 64)
    valid[2] = False
    got = _port_dense("float32", q, kq, vq, valid, ks, vs)
    kf = torch.from_numpy(kq).float() * torch.from_numpy(ks)[..., None]
    vf = torch.from_numpy(vq).float() * torch.from_numpy(vs)[..., None]
    want = tref.decode_attention(torch.from_numpy(q), kf, vf,
                                 torch.from_numpy(valid))
    assert torch.equal(got, want)
    assert bool((got[2] == 0).all())


# ---------------------------------------------------------------------------
# plain int8 paged decode
# ---------------------------------------------------------------------------
def _paged_case(seed, B, H, Hkv, K, bs, nblk, P, owned_only=False):
    """q, int8 pages with scale pages, a table and lengths in
    [1, bs * nblk]. With ``owned_only`` each row owns distinct pages for
    the blocks its length covers and points the rest of its table at the
    scratch page P, as the serving cache does."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, K)).astype(np.float32)
    kq, ks = _quant_np(rng.standard_normal((P + 1, bs, Hkv, K))
                       .astype(np.float32))
    vq, vs = _quant_np(rng.standard_normal((P + 1, bs, Hkv, K))
                       .astype(np.float32))
    lengths = rng.integers(1, bs * nblk + 1, (B,)).astype(np.int32)
    if owned_only:
        table = rng.permutation(P)[:B * nblk].reshape(B, nblk)
        table[np.arange(nblk)[None, :] >= -(-lengths[:, None] // bs)] = P
    else:
        table = rng.integers(0, P, (B, nblk))
    return q, kq, vq, ks, vs, table.astype(np.int32), lengths


def _port_paged(dn, q, kq, vq, ks, vs, table, lengths, softcap=0.0):
    return tref.paged_decode_attention(
        torch.from_numpy(q).to(TDT[dn]), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(table),
        torch.from_numpy(lengths), softcap=softcap,
        k_scale_pages=torch.from_numpy(ks),
        v_scale_pages=torch.from_numpy(vs))


@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_plain_int8_paged_matches_jax_ref_and_pallas_interpret(dn, softcap):
    q, kq, vq, ks, vs, table, lengths = _paged_case(2, 2, 4, 2, 64, 16, 4,
                                                    32)
    got = _port_paged(dn, q, kq, vq, ks, vs, table, lengths, softcap)
    jq = jnp.asarray(q).astype(JDT[dn])
    jrest = [jnp.asarray(a) for a in (kq, vq, ks, vs, table, lengths)]
    _close(got, jref.paged_decode_attention(
        jq, jrest[0], jrest[1], jrest[4], jrest[5], softcap=softcap,
        k_scale_pages=jrest[2], v_scale_pages=jrest[3]), dn)
    _close(got, pallas_paged_int8(jq, *jrest, softcap=softcap,
                                  interpret=True), dn)


@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
def test_plain_int8_paged_bitwise_equals_plain_dense_despite_nan(dn):
    """For the same logical cache the paged plain version gives the dense
    plain version's bits, and NaN in every page and scale page no row
    owns (the scratch page included, which tables point at past a row's
    blocks) moves neither."""
    B, H, Hkv, K, bs, nblk, P = 3, 4, 2, 32, 16, 4, 16
    q, kq, vq, ks, vs, table, lengths = _paged_case(
        3, B, H, Hkv, K, bs, nblk, P, owned_only=True)
    base = _port_paged(dn, q, kq, vq, ks, vs, table, lengths)
    W = bs * nblk
    idx = table.astype(np.int64)
    valid = np.arange(W)[None, :] < lengths[:, None]
    dense = tref.decode_attention(
        torch.from_numpy(q).to(TDT[dn]),
        torch.from_numpy(kq[idx].reshape(B, W, Hkv, K)),
        torch.from_numpy(vq[idx].reshape(B, W, Hkv, K)),
        torch.from_numpy(valid),
        k_scale=torch.from_numpy(ks[idx].reshape(B, W, Hkv)),
        v_scale=torch.from_numpy(vs[idx].reshape(B, W, Hkv)))
    assert torch.equal(base, dense)
    unowned = np.ones(P + 1, bool)
    unowned[table[table < P]] = False
    assert unowned[P] and unowned.sum() > 1
    ks2, vs2, kq2 = ks.copy(), vs.copy(), kq.copy()
    ks2[unowned], vs2[unowned] = np.nan, np.nan
    kq2[unowned] = 127
    got = _port_paged(dn, q, kq2, vq, ks2, vs2, table, lengths)
    assert torch.equal(got, base)
    assert bool(torch.isfinite(got.float()).all())


def test_plain_int8_paged_zero_length_row_is_zero():
    q, kq, vq, ks, vs, table, lengths = _paged_case(5, 3, 4, 2, 32, 8, 4,
                                                    16)
    lengths[1] = 0
    got = _port_paged("float32", q, kq, vq, ks, vs, table, lengths).numpy()
    assert np.all(got[1] == 0.0)
    want = np.asarray(jref.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kq, vq, table, lengths)),
        k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs)))
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# dispatch and the CUDA wrappers on the CPU
# ---------------------------------------------------------------------------
def test_ops_sends_cpu_int8_tensors_to_the_plain_versions():
    ops.reset_launch_counts()
    q, kq, vq, valid, ks, vs = (torch.from_numpy(a) for a in
                                _dense_case(6, 2, 4, 2, 32, 64))
    got = ops.decode_attention(q, kq, vq, valid, k_scale=ks, v_scale=vs)
    assert torch.equal(got, tref.decode_attention(q, kq, vq, valid,
                                                  k_scale=ks, v_scale=vs))
    q, kq, vq, ks, vs, table, lengths = (
        torch.from_numpy(a) for a in _paged_case(7, 2, 4, 2, 32, 8, 4, 16))
    got = ops.paged_decode_attention(q, kq, vq, table, lengths,
                                     k_scale_pages=ks, v_scale_pages=vs)
    assert torch.equal(got, tref.paged_decode_attention(
        q, kq, vq, table, lengths, k_scale_pages=ks, v_scale_pages=vs))
    counts = ops.launch_counts()
    assert counts["decode_attention_int8"] == 0
    assert counts["paged_decode_attention_int8"] == 0
    with pytest.raises(ValueError, match="both"):
        ops.paged_decode_attention(q, kq, vq, table, lengths,
                                   k_scale_pages=ks)


def test_int8_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: they raise before any
    build or launch."""
    from repro_torch.kernels.decode_attention import decode_attention_int8
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_int8
    q, kq, vq, valid, ks, vs = (torch.from_numpy(a) for a in
                                _dense_case(8, 1, 4, 2, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_int8(q, kq, vq, valid, ks, vs)
    q, kq, vq, ks, vs, table, lengths = (
        torch.from_numpy(a) for a in _paged_case(9, 1, 4, 2, 32, 8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_int8(q, kq, vq, ks, vs, table, lengths)

"""The port's plain paged decode attention against the JAX package's.

Inputs come from a seeded numpy generator and go through both sides: the
port's ``ref.paged_decode_attention`` against ``repro.kernels.ref``'s and
against the Pallas kernel in interpret mode, on the cases of
tests/test_paged_kernel.py (f32 within 2e-5, bf16 within 2e-2). Every row
has at least one live position: a row of length 0 is the one documented
difference (the port gives 0, the JAX oracle the mean of the masked
values) and is checked against 0 alone. Then the port's own contract: the
paged plain version gives the dense plain version's bits on the same
logical cache, whatever the unowned pages hold.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(seed, B, H, Hkv, K, bs, nblk, n_pages, unique_pages=False):
    """Random q, page pool (garbage everywhere a table does not point),
    block table and ragged lengths in [1, bs * nblk], as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, K)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, bs, Hkv, K)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, bs, Hkv, K)).astype(np.float32)
    if unique_pages:
        table = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk)
    else:
        table = rng.integers(0, n_pages, (B, nblk))
    lengths = rng.integers(1, bs * nblk + 1, (B,))
    return q, kp, vp, table.astype(np.int32), lengths.astype(np.int32)


def _port(dn, q, kp, vp, table, lengths, softcap=0.0):
    t = TDT[dn]
    return tref.paged_decode_attention(
        torch.from_numpy(q).to(t), torch.from_numpy(kp).to(t),
        torch.from_numpy(vp).to(t), torch.from_numpy(table),
        torch.from_numpy(lengths), softcap=softcap)


def _jax_args(dn, q, kp, vp, table, lengths):
    t = JDT[dn]
    return (jnp.asarray(q).astype(t), jnp.asarray(kp).astype(t),
            jnp.asarray(vp).astype(t), jnp.asarray(table),
            jnp.asarray(lengths))


def _close(got, want, dn):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dn], rtol=TOL[dn])


@pytest.mark.parametrize("B,H,Hkv,K,bs,nblk", [
    (2, 4, 4, 64, 16, 4),     # MHA
    (3, 4, 2, 64, 16, 4),     # GQA
    (2, 8, 2, 32, 8, 6),      # small pages, more groups
    (2, 16, 8, 128, 16, 8),   # qwen3-0.6b heads
])
@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
def test_plain_paged_matches_jax_ref_and_pallas_interpret(B, H, Hkv, K, bs,
                                                          nblk, dn):
    args = _case(0, B, H, Hkv, K, bs, nblk, 32)
    got = _port(dn, *args)
    assert got.shape == (B, H, K) and got.dtype == TDT[dn]
    _close(got, jref.paged_decode_attention(*_jax_args(dn, *args)), dn)
    _close(got, pallas_paged(*_jax_args(dn, *args), interpret=True), dn)


def test_plain_paged_softcap_matches_jax():
    args = _case(1, 2, 4, 2, 64, 16, 4, 32)
    got = _port("float32", *args, softcap=30.0)
    jargs = _jax_args("float32", *args)
    _close(got, jref.paged_decode_attention(*jargs, softcap=30.0),
           "float32")
    _close(got, pallas_paged(*jargs, softcap=30.0, interpret=True),
           "float32")


def test_plain_paged_ignores_garbage_pages_like_jax():
    """Poisoning every page no table points at (scratch included) moves
    neither side by a bit, and the two still agree."""
    B, H, Hkv, K, bs, nblk, P = 2, 4, 4, 32, 8, 4, 24
    q, kp, vp, table, lengths = _case(4, B, H, Hkv, K, bs, nblk, P,
                                      unique_pages=True)
    base = _port("float32", q, kp, vp, table, lengths)
    poison = np.ones(P + 1, bool)
    poison[np.unique(table)] = False
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[poison], vp2[poison] = 1e9, -1e9
    got = _port("float32", q, kp2, vp2, table, lengths)
    assert torch.equal(got, base)
    _close(got, jref.paged_decode_attention(
        *_jax_args("float32", q, kp2, vp2, table, lengths)), "float32")


@pytest.mark.parametrize("dn", ["float32", "bfloat16"])
def test_plain_paged_bitwise_equals_plain_dense(dn):
    """The port's own parity contract: for the same logical cache the paged
    plain version gives the dense plain version's exact bits."""
    B, H, Hkv, K, bs, nblk, P = 3, 4, 2, 32, 16, 4, 16
    q, kp, vp, table, lengths = _case(3, B, H, Hkv, K, bs, nblk, P,
                                      unique_pages=True)
    t = TDT[dn]
    W = bs * nblk
    kt, vt = torch.from_numpy(kp).to(t), torch.from_numpy(vp).to(t)
    idx = torch.from_numpy(table).long()
    k = kt[idx].reshape(B, W, Hkv, K)
    v = vt[idx].reshape(B, W, Hkv, K)
    valid = torch.arange(W)[None, :] < torch.from_numpy(lengths)[:, None]
    qt = torch.from_numpy(q).to(t)
    want = tref.decode_attention(qt, k, v, valid)
    got = tref.paged_decode_attention(qt, kt, vt, torch.from_numpy(table),
                                      torch.from_numpy(lengths))
    assert torch.equal(got, want)


def test_plain_paged_zero_length_row_is_zero():
    q, kp, vp, table, lengths = _case(5, 3, 4, 2, 32, 8, 4, 16)
    lengths[1] = 0
    got = _port("float32", q, kp, vp, table, lengths).numpy()
    assert np.all(got[1] == 0.0)
    want = np.asarray(jref.paged_decode_attention(
        *_jax_args("float32", q, kp, vp, table, lengths)))
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=2e-5,
                               rtol=2e-5)


def test_ops_sends_cpu_paged_tensors_to_the_plain_version():
    ops.reset_launch_counts()
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _case(6, 2, 4, 2, 32, 8, 4, 16))
    got = ops.paged_decode_attention(q, kp, vp, table, lengths)
    assert torch.equal(got, tref.paged_decode_attention(q, kp, vp, table,
                                                        lengths))
    assert ops.launch_counts()["paged_decode_attention"] == 0


def test_paged_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises before any
    build or launch."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _case(7, 1, 4, 2, 32, 8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q, kp, vp, table, lengths)

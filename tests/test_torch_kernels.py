"""The port's plain attention kernels against the JAX package's, and the
dispatch and wrappers of every kernel (the SSD scan's plain version is
held to JAX in tests/test_torch_ssd.py).

Inputs come from a seeded numpy generator and go through both sides:
``repro_torch.kernels.ref`` against ``repro.kernels.ref`` (any shapes,
ragged ones included) and against the Pallas kernels in interpret mode
(on shapes that divide their blocks). f32 throughout, at the kernel
tolerance 2e-5 of tests/test_kernels.py. Rows with no visible key are the
one documented difference: the port returns 0 there (masked positions
add exactly 0.0), the JAX oracle a uniform average of the masked values —
those rows are compared against 0 and left out of the JAX comparison.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 2e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, B, Sq, Skv, H, Hkv, K, Kv=None):
    rng = np.random.default_rng(seed)
    return (_randn(rng, B, Sq, H, K), _randn(rng, B, Skv, Hkv, K),
            _randn(rng, B, Skv, Hkv, Kv or K))


def _t(a):
    return torch.from_numpy(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,K,Kv,causal,window,softcap", [
    (1, 16, 16, 4, 4, 32, 32, True, 0, 0.0),       # MHA
    (2, 24, 24, 4, 2, 32, 32, True, 0, 0.0),       # GQA
    (1, 37, 37, 16, 8, 128, 128, True, 0, 0.0),    # ragged, qwen3 heads
    (2, 13, 45, 4, 2, 32, 32, True, 0, 0.0),       # Sq < Skv (offset)
    (1, 40, 40, 4, 2, 32, 32, True, 9, 0.0),       # sliding window
    (1, 33, 33, 4, 2, 32, 32, True, 0, 30.0),      # softcap
    (1, 20, 28, 4, 1, 48, 32, False, 0, 0.0),      # non-causal, Kv != K
])
def test_plain_flash_matches_jax_ref(B, Sq, Skv, H, Hkv, K, Kv, causal,
                                     window, softcap):
    q, k, v = _qkv(1, B, Sq, Skv, H, Hkv, K, Kv)
    got = tref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, softcap=softcap)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, Kv)
    _close(got, want)


@pytest.mark.parametrize("B,S,H,Hkv,K,window,softcap", [
    (1, 128, 4, 2, 32, 0, 0.0),
    (2, 128, 8, 4, 64, 64, 0.0),
    (1, 128, 4, 4, 32, 0, 30.0),
])
def test_plain_flash_matches_pallas_interpret(B, S, H, Hkv, K, window,
                                              softcap):
    q, k, v = _qkv(2, B, S, S, H, Hkv, K)
    got = tref.flash_attention(_t(q), _t(k), _t(v), window=window,
                               softcap=softcap)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window, softcap=softcap,
                        block_q=64, block_k=64, interpret=True)
    _close(got, want)


def test_plain_flash_fully_masked_rows_are_zero():
    """Sq > Skv puts the first rows before every key: they see nothing
    and must come out 0 (not NaN); the other rows match JAX."""
    q, k, v = _qkv(3, 1, 12, 8, 4, 2, 32)
    got = tref.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=True))
    assert np.all(got[:, :4] == 0.0)
    _close(got[:, 4:], want[:, 4:])


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
def _decode_inputs(seed, B, W, H, Hkv, K, p_valid=0.7, dead_row=None):
    rng = np.random.default_rng(seed)
    q = _randn(rng, B, H, K)
    k, v = _randn(rng, B, W, Hkv, K), _randn(rng, B, W, Hkv, K)
    valid = rng.random((B, W)) < p_valid
    valid[:, 0] = True
    if dead_row is not None:
        valid[dead_row] = False
    return q, k, v, valid


@pytest.mark.parametrize("B,W,H,Hkv,K,softcap", [
    (2, 64, 4, 2, 32, 0.0),       # GQA, G = 2
    (3, 100, 4, 4, 64, 0.0),      # MHA, W not a block multiple
    (1, 2048, 16, 8, 128, 0.0),   # qwen3-0.6b heads, full ring
    (2, 96, 8, 2, 32, 25.0),      # G = 4, softcap
])
def test_plain_decode_matches_jax_blocked_ref(B, W, H, Hkv, K, softcap):
    q, k, v, valid = _decode_inputs(4, B, W, H, Hkv, K)
    got = tref.decode_attention(_t(q), _t(k), _t(v), _t(valid),
                                softcap=softcap)
    want = jref.decode_attention_blocked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        softcap=softcap, block=32)
    assert got.shape == (B, H, K)
    _close(got, want)


@pytest.mark.parametrize("B,W,H,Hkv,K", [(2, 256, 4, 2, 32),
                                         (1, 512, 16, 8, 128)])
def test_plain_decode_matches_pallas_interpret(B, W, H, Hkv, K):
    q, k, v, valid = _decode_inputs(5, B, W, H, Hkv, K)
    got = tref.decode_attention(_t(q), _t(k), _t(v), _t(valid))
    want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid), block_k=128, interpret=True)
    _close(got, want)


def test_plain_decode_all_false_row_is_zero():
    q, k, v, valid = _decode_inputs(6, 3, 80, 4, 2, 32, dead_row=1)
    got = tref.decode_attention(_t(q), _t(k), _t(v), _t(valid)).numpy()
    want = np.asarray(jref.decode_attention_blocked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid)))
    assert np.all(got[1] == 0.0)
    _close(got[[0, 2]], want[[0, 2]])


def test_plain_decode_masked_slots_add_exactly_zero():
    """Garbage in masked slots must not move the output by a single bit —
    the contract the dense/paged bit parity of the next slice rests on."""
    q, k, v, valid = _decode_inputs(7, 2, 64, 4, 2, 32)
    base = tref.decode_attention(_t(q), _t(k), _t(v), _t(valid))
    k2, v2 = k.copy(), v.copy()
    k2[~valid], v2[~valid] = 1e4, -1e4
    moved = tref.decode_attention(_t(q), _t(k2), _t(v2), _t(valid))
    assert torch.equal(base, moved)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_ops_sends_cpu_tensors_to_the_plain_version():
    ops.reset_launch_counts()
    q, k, v = _qkv(8, 1, 10, 10, 4, 2, 32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert torch.equal(got, tref.flash_attention(_t(q), _t(k), _t(v)))
    q, k, v, valid = _decode_inputs(8, 2, 40, 4, 2, 32)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(valid))
    assert torch.equal(got, tref.decode_attention(_t(q), _t(k), _t(v),
                                                  _t(valid)))
    ssd = _ssd_args(8)
    got = ops.ssd_scan(*ssd, chunk=16)
    want = tref.ssd_scan(*ssd, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mla = [torch.randn(shape, generator=torch.Generator().manual_seed(8))
           for shape in ((2, 4, 32), (2, 4, 8), (2, 20, 32), (2, 20, 8))]
    live = torch.arange(20)[None, :] < torch.tensor([[3], [20]])
    got = ops.mla_decode_ctx(*mla, live, scale=0.2)
    assert torch.equal(got, tref.mla_decode_ctx(*mla, live, scale=0.2))
    # the plain path is not a kernel launch
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0,
                                   "paged_decode_attention": 0,
                                   "decode_attention_int8": 0,
                                   "paged_decode_attention_int8": 0,
                                   "ssd_scan": 0,
                                   "mla_decode_ctx": 0}


def _ssd_args(seed, B=1, S=32, nh=4, hd=8, ng=1, ds=8):
    """Small SSD scan inputs (A < 0 and D float32, as the model passes)."""
    rng = np.random.default_rng(seed)
    return (_t(_randn(rng, B, S, nh, hd)),
            _t(np.log1p(np.exp(_randn(rng, B, S, nh)))),
            _t(-np.exp(_randn(rng, nh))), _t(_randn(rng, B, S, ng, ds)),
            _t(_randn(rng, B, S, ng, ds)), _t(np.ones(nh, np.float32)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: they raise before any
    build or launch."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*_ssd_args(9), chunk=16)
    q, k, v = _qkv(9, 1, 8, 8, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(_t(q), _t(k), _t(v))
    q, k, v, valid = _decode_inputs(9, 1, 16, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(_t(q), _t(k), _t(v), _t(valid))

"""The plain SSD scan of the port (``repro_torch.kernels.ref.ssd_scan``)
and its one-token recurrence (``repro_torch.models.ssm.ssd_decode_step``)
against the JAX package: its oracles ``ref.ssd_scan`` and
``ref.ssd_scan_seq`` and its Pallas kernel run in interpret mode, as
tests/test_kernels.py runs them. Inputs are made with numpy from a seed,
distributed as tests/test_kernels.py ``_ssd_inputs`` draws them.

Tolerances: float32 within 5e-5 abs and rel, the JAX suite's own for its
Pallas kernel; bfloat16 inputs compared in float32 within 2e-2 of the
largest |reference| (both sides round their outputs to bfloat16 once,
after float32 math).

The forward wrapper runs here with its CUDA check and the extension
replaced by stand-ins, which shows what it passes the kernel in both
dtypes (float32 scratch sized by the extension, the dtype flag) and that
a call counts one launch."""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.ssm import ssd_decode_step  # noqa: E402

TOL = 5e-5
BF16_TOL = 2e-2
SHAPES = [  # (B, S, nh, hd, ng, ds, chunk), as tests/test_kernels.py
    (2, 128, 4, 16, 2, 16, 32),
    (1, 64, 8, 8, 1, 32, 16),
    (2, 256, 2, 32, 1, 8, 64),
]


def _ssd_inputs(seed, B, S, nh, hd, ng, ds):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(N(0, 1)) < 0;
    D = 1 — all float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0.0).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((nh,))).astype(np.float32)
    B_ = rng.standard_normal((B, S, ng, ds)).astype(np.float32)
    C_ = rng.standard_normal((B, S, ng, ds)).astype(np.float32)
    D = np.ones((nh,), np.float32)
    return x, dt, A, B_, C_, D


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_matches_jax_oracles_and_pallas_kernel(shape):
    *dims, chunk = shape
    args = _ssd_inputs(0, *dims)
    y, st = tref.ssd_scan(*map(_t, args), chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    assert st.shape == (dims[0], dims[2], dims[3], dims[5])
    jargs = [jnp.asarray(a) for a in args]
    for fn in (jref.ssd_scan, jref.ssd_scan_seq):
        wy, ws = fn(*jargs, chunk=chunk)
        _close(y, wy)
        _close(st, ws)
    wy, ws = pallas_ssd_scan(*jargs, chunk=chunk, interpret=True)
    _close(y, wy)
    _close(st, ws)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_bf16_matches_jax(shape):
    """bf16 x, dt, B and C (A, D float32, as the model passes them): both
    sides compute in float32 and round y and the state to bf16."""
    *dims, chunk = shape
    x, dt, A, B_, C_, D = _ssd_inputs(1, *dims)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dt, B_, C_)]
    wy, ws = jref.ssd_scan_seq(bf[0], bf[1], jnp.asarray(A), bf[2], bf[3],
                               jnp.asarray(D), chunk=chunk)
    tb = [_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in bf]
    y, st = tref.ssd_scan(tb[0], tb[1], _t(A), tb[2], tb[3], _t(D),
                          chunk=chunk)
    assert y.dtype == st.dtype == torch.bfloat16
    for got, want in ((y, wy), (st, ws)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max()


def test_plain_scan_is_chunk_invariant():
    """The scan's result does not depend on where the sequence is cut (the
    kernel's internal tile relies on it), to 2e-5 as in the JAX suite."""
    args = list(map(_t, _ssd_inputs(2, 1, 128, 2, 8, 1, 8)))
    y16, s16 = tref.ssd_scan(*args, chunk=16)
    y64, s64 = tref.ssd_scan(*args, chunk=64)
    y128, s128 = tref.ssd_scan(*args, chunk=128)
    for a, b in ((y16, y64), (s16, s64), (y64, y128), (s64, s128)):
        _close(a, b, 2e-5)


def test_group_repeat_maps_heads_to_groups_as_jax():
    """ng = 4 over nh = 8: head h reads group h // 2 (``jnp.repeat``)."""
    args = _ssd_inputs(3, 2, 64, 8, 8, 4, 16)
    y, st = tref.ssd_scan(*map(_t, args), chunk=32)
    wy, ws = jref.ssd_scan(*map(jnp.asarray, args), chunk=32)
    _close(y, wy)
    _close(st, ws)
    # the same scan with each group copied out to its heads
    x, dt, A, B_, C_, D = args
    rep = [np.repeat(a, 2, axis=2) for a in (B_, C_)]
    y1, s1 = tref.ssd_scan(_t(x), _t(dt), _t(A), _t(rep[0]), _t(rep[1]),
                           _t(D), chunk=32)
    _close(y, y1, 1e-6)
    _close(st, s1, 1e-6)


def test_decode_step_matches_jax_step_by_step():
    B, S, nh, hd, ng, ds = 2, 24, 4, 8, 2, 8
    x, dt, A, B_, C_, D = _ssd_inputs(4, B, S, nh, hd, ng, ds)
    state = np.zeros((B, nh, hd, ds), np.float32)
    jstate, tstate = jnp.asarray(state), _t(state)
    ys = []
    for t in range(S):
        step = (x[:, t], dt[:, t], A, B_[:, t], C_[:, t], D)
        wy, jstate = jref.ssd_decode_step(jstate, *map(jnp.asarray, step))
        y, tstate = ssd_decode_step(tstate, *map(_t, step))
        _close(y, wy)
        _close(tstate, jstate)
        ys.append(y)
    # and the recurrence agrees with the chunked scan
    wy, ws = tref.ssd_scan(*map(_t, (x, dt, A, B_, C_, D)), chunk=8)
    _close(torch.stack(ys, dim=1), wy)
    _close(tstate, ws)


def test_decode_step_keeps_the_state_dtype():
    B, nh, hd, ng, ds = 1, 4, 8, 1, 8
    x, dt, A, B_, C_, D = _ssd_inputs(5, B, 1, nh, hd, ng, ds)
    state = torch.zeros((B, nh, hd, ds), dtype=torch.bfloat16)
    y, new = ssd_decode_step(state, _t(x[:, 0]), _t(dt[:, 0]), _t(A),
                             _t(B_[:, 0]), _t(C_[:, 0]), _t(D))
    assert new.dtype == torch.bfloat16 and y.dtype == torch.float32


def test_s_not_a_multiple_of_chunk_raises_in_both_packages():
    args = _ssd_inputs(6, 1, 40, 2, 8, 1, 8)
    with pytest.raises(AssertionError):
        jref.ssd_scan_seq(*map(jnp.asarray, args), chunk=32)
    with pytest.raises(AssertionError):
        pallas_ssd_scan(*map(jnp.asarray, args), chunk=32, interpret=True)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tref.ssd_scan(*map(_t, args), chunk=32)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.ssd_scan(*map(_t, args), chunk=32)


class _Extension:
    """Records the calls a wrapper makes; scratch of 11 floats."""

    def __init__(self):
        self.calls = []

    def ssd_scan_work_floats(self, *args):
        self.calls.append(("ssd_scan_work_floats", args))
        return 11

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


def test_forward_wrapper_passes_scratch_in_both_dtypes_and_counts_one_launch(
        monkeypatch):
    """float32 and bfloat16 alike: the scratch is asked of the extension for
    the call's shapes, allocated as float32 and passed beside fresh outputs
    with the dtype's flag; one call is one counted launch; S that chunk
    does not divide and ds past MAX_STATE are refused before any launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a wrapper reached the kernel build")
    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "extension", refuse)
    ext = _Extension()
    monkeypatch.setattr(ssd, "extension", lambda: ext)
    monkeypatch.setattr(ssd, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    B, S, nh, hd, ng, ds = 2, 96, 4, 16, 2, 24
    base = list(map(_t, _ssd_inputs(8, B, S, nh, hd, ng, ds)))
    for dtype in (torch.float32, torch.bfloat16):
        args = [a if i in (2, 5) else a.to(dtype) for i, a in enumerate(base)]
        before = ops.launch_counts()["ssd_scan"]
        y, state = ssd.ssd_scan(*args, chunk=32)
        (asked, sizes), (name, call) = ext.calls[-2:]
        assert asked == "ssd_scan_work_floats" and name == "ssd_scan"
        bf16 = dtype == torch.bfloat16
        assert sizes == (B, S, nh, hd, ng, ds)
        assert ops.launch_counts()["ssd_scan"] == before + 1
        assert call[:6] == tuple(t.data_ptr() for t in args)
        assert call[6:8] == (y.data_ptr(), state.data_ptr())
        assert call[8] not in {t.data_ptr() for t in (*args, y, state)}
        assert call[9:] == (B, S, nh, hd, ng, ds, bf16, 0)
        assert y.shape == args[0].shape and y.dtype == dtype
        assert state.shape == (B, nh, hd, ds) and state.dtype == dtype
    n = len(ext.calls)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssd.ssd_scan(*base, chunk=40)
    wide = list(map(_t, _ssd_inputs(9, 1, 8, 2, 8, 1, ssd.MAX_STATE + 8)))
    with pytest.raises(ValueError, match="out of the kernel's range"):
        ssd.ssd_scan(*wide, chunk=8)
    assert len(ext.calls) == n

"""The gradient of the port's SSD scan on the CPU, against JAX's.

``kernels.ops.ssd_scan`` runs through a ``torch.autograd.Function``
wherever autograd records: on a CPU tensor its forward is the plain
``ref.ssd_scan`` and its backward the plain ``ref.ssd_scan_bwd``, derived
by hand; on the card the same Function launches ``ssd_scan`` and
``ssd_scan_bwd``. The plain backward is held to ``jax.vjp`` of
``repro.kernels.ref.ssd_scan_seq`` (what ``jax.grad`` differentiates when
JAX trains mamba2 and zamba2) within 1e-5 of max|JAX| on every gradient,
and to torch autograd through ``ref.ssd_scan``; at chunk 64 (where the
kernel cuts) against the caller's chunk within 1e-4 of max|plain|.
Widths: hd 16-64, ds 16-128, ng 1 and 2, chunk = S and chunk < S, with
and without a gradient of the final state. Inputs come from a seeded
numpy generator, drawn as tests/test_kernels.py draws its SSD inputs.

The backward wrapper runs here with its CUDA check and the extension
replaced by stand-ins, which shows what it passes the kernel (a null
pointer for a missing ``dstate``, no zeros made) and that a call counts
one launch.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TOL = 1e-5        # of max|JAX| (and of max|autograd|), every gradient
CUT_TOL = 1e-4    # of max|plain|: chunk 64 against the caller's chunk
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
SHAPES = [  # (B, S, nh, hd, ng, ds, chunk)
    (2, 128, 4, 16, 2, 16, 32),
    (1, 64, 8, 32, 1, 32, 64),
    (2, 96, 4, 64, 2, 24, 32),
    (1, 128, 4, 32, 1, 128, 128),
    (1, 192, 6, 16, 2, 16, 64),
]
# two heads of 16 rows, one chunk of 128 at ds 128: dA = Σ dt·rc cancels
# so much that JAX's float32 VJP itself sits ~4e-5 of max|dA| from the
# float64 gradient, so both float32 gradients are held to that instead
ILL_CONDITIONED = (1, 128, 2, 16, 1, 128, 128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are small: one torch thread runs them about as
    fast as many, and keeps the module from oversubscribing the cores
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, nh, hd, ng, ds):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(N(0, 1)); D ~
    N(0, 1) (a gradient through D = 1 would hide a missing D); dy and
    dstate ~ N(0, 1) — all float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0.0).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((nh,))).astype(np.float32)
    B_ = rng.standard_normal((B, S, ng, ds)).astype(np.float32)
    C_ = rng.standard_normal((B, S, ng, ds)).astype(np.float32)
    D = rng.standard_normal((nh,)).astype(np.float32)
    dy = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dstate = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    return (x, dt, A, B_, C_, D), dy, dstate


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_grads(args, dy, dstate, chunk):
    """jax.vjp of ssd_scan_seq at (y, state) cotangents (dy, dstate or
    0)."""
    jargs = [jnp.asarray(a) for a in args]
    (y, st), vjp = jax.vjp(lambda *a: jref.ssd_scan_seq(*a, chunk=chunk),
                           *jargs)
    ds_ = jnp.zeros_like(st) if dstate is None else jnp.asarray(dstate)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), ds_))]


def _assert_close(got, want, tol, what=""):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        err = float(np.max(np.abs(g - w)))
        bound = tol * max(float(np.max(np.abs(w))), 1e-30)
        assert err <= bound, (what, name, err, bound)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, with_state):
    *dims, chunk = shape
    args, dy, dstate = _inputs(0, *dims)
    dstate = dstate if with_state else None
    got = ref.ssd_scan_bwd(*map(_t, args), _t(dy),
                           None if dstate is None else _t(dstate),
                           chunk=chunk)
    for g, a in zip(got, args):
        assert g.dtype == torch.float32 and g.shape == a.shape
    _assert_close(got, _jax_grads(args, dy, dstate, chunk), TOL)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_torch_autograd(shape, with_state):
    *dims, chunk = shape
    args, dy, dstate = _inputs(1, *dims)
    leaves = [_t(a).requires_grad_(True) for a in args]
    y, st = ref.ssd_scan(*leaves, chunk=chunk)
    outs, cots = [y], [_t(dy)]
    if with_state:
        outs.append(st)
        cots.append(_t(dstate))
    want = torch.autograd.grad(outs, leaves, cots)
    got = ref.ssd_scan_bwd(*map(_t, args), _t(dy),
                           _t(dstate) if with_state else None, chunk=chunk)
    _assert_close(got, want, TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_ops_trains_through_the_function_bit_for_bit(shape):
    """With grad, ``ops.ssd_scan`` records ``_SsdScan``: its outputs are
    the serving call's bits, and its gradients ``ref.ssd_scan_bwd``'s bit
    for bit, with the state's gradient and without it (training drops
    the state: the backward gets None, not zeros)."""
    *dims, chunk = shape
    args, dy, dstate = _inputs(2, *dims)
    plain = [_t(a) for a in args]
    launched = ops.launch_counts()["ssd_scan_bwd"]
    served = ops.ssd_scan(*plain, chunk=chunk)
    assert served[0].grad_fn is None
    for with_state in (True, False):
        leaves = [_t(a).requires_grad_(True) for a in args]
        y, st = ops.ssd_scan(*leaves, chunk=chunk)
        assert type(y.grad_fn).__name__ == "_SsdScanBackward"
        assert torch.equal(y.detach(), served[0])
        assert torch.equal(st.detach(), served[1])
        outs, cots = [y], [_t(dy)]
        if with_state:
            outs.append(st)
            cots.append(_t(dstate))
        got = torch.autograd.grad(outs, leaves, cots)
        want = ref.ssd_scan_bwd(*plain, _t(dy),
                                _t(dstate) if with_state else None,
                                chunk=chunk)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ops.launch_counts()["ssd_scan_bwd"] == launched  # no kernel


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] % 64 == 0
                                   and s[6] != 64])
def test_gradients_at_the_kernels_cut_match_the_callers_chunk(shape,
                                                               with_state):
    """The kernel cuts at 64 positions whatever the caller's chunk: the
    gradients at chunk 64 are the caller's chunk's within 1e-4 of
    max|plain| (the cut moves where the decays' running sums round)."""
    *dims, chunk = shape
    args, dy, dstate = _inputs(3, *dims)
    kw = dict(dy=_t(dy), dstate=_t(dstate) if with_state else None)
    want = ref.ssd_scan_bwd(*map(_t, args), **kw, chunk=chunk)
    got = ref.ssd_scan_bwd(*map(_t, args), **kw, chunk=64)
    _assert_close(got, want, CUT_TOL)


def _f64_grads(args, dy, dstate):
    """The gradients of the scan's defining recurrence in float64 (state
    <- exp(dt·A) state + dt x ⊗ B, y = state·C + D x, one position at a
    time), through torch autograd."""
    leaves = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
              for a in args]
    x, dt, A, B_, C_, D = leaves
    Bb, S, nh, hd = x.shape
    rep = nh // B_.shape[2]
    Bh = B_.repeat_interleave(rep, dim=2)
    Ch = C_.repeat_interleave(rep, dim=2)
    state = torch.zeros((Bb, nh, hd, B_.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(S):
        state = (state * torch.exp(dt[:, t] * A)[..., None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpd,bhd->bhp", state, Ch[:, t])
                  + D[:, None] * x[:, t])
    y = torch.stack(ys, dim=1)
    grads = torch.autograd.grad(
        [y, state], leaves, [torch.from_numpy(dy.astype(np.float64)),
                             torch.from_numpy(dstate.astype(np.float64))])
    return [g.numpy() for g in grads]


def test_ill_conditioned_gradients_are_as_close_to_float64_as_jaxs():
    """Where float32 cannot reach 1e-5 of max|JAX| (ILL_CONDITIONED: the
    rounding of JAX's own float32 VJP moves dA by ~4e-5 of its largest
    element), each plain float32 gradient is no farther from the float64
    gradient than 1.5 times JAX's float32 one, and within 1e-4 of it."""
    *dims, chunk = ILL_CONDITIONED
    args, dy, dstate = _inputs(0, *dims)
    got = ref.ssd_scan_bwd(*map(_t, args), _t(dy), _t(dstate), chunk=chunk)
    jax_g = _jax_grads(args, dy, dstate, chunk)
    truth = _f64_grads(args, dy, dstate)
    for name, g, j, w in zip(NAMES, got, jax_g, truth):
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g.numpy() - w))) / scale
        jax_err = float(np.max(np.abs(j - w))) / scale
        assert err <= max(1.5 * jax_err, 1e-6) and err <= 1e-4, (
            name, err, jax_err)


def test_plain_backward_refuses_a_chunk_that_does_not_divide_s():
    args, dy, _ = _inputs(4, 1, 40, 2, 16, 1, 16)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ref.ssd_scan_bwd(*map(_t, args), _t(dy), chunk=32)


class _Extension:
    def __init__(self):
        self.calls = []
        self.work_asked = []

    def ssd_scan_bwd_work_floats(self, *args):
        self.work_asked.append(args)
        return 7

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers with CPU tensors: their device checks pass, the stream
    is 0, the extension records its calls, and any build is refused."""
    def refuse(*args, **kwargs):
        raise AssertionError("a wrapper reached the kernel build")
    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "extension", refuse)
    ext = _Extension()
    monkeypatch.setattr(ssd, "extension", lambda: ext)
    monkeypatch.setattr(ssd, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return ext


def test_backward_wrapper_passes_a_null_state_and_counts_one_launch(no_card):
    """One call is one counted launch; no dstate is a null pointer (no
    zeros made); the gradients are fresh tensors shaped as the inputs; the
    scratch is sized by the extension from the call's shapes and passed
    beside them; float32 only, and ds past the shared memory's reach is
    refused."""
    ext = no_card
    B, S, nh, hd, ng, ds = 2, 96, 4, 16, 2, 24
    args, dy, dstate = _inputs(5, B, S, nh, hd, ng, ds)
    args, dy, dstate = [_t(a) for a in args], _t(dy), _t(dstate)
    for st in (dstate, None):
        before = ops.launch_counts()["ssd_scan_bwd"]
        grads = ssd.ssd_scan_bwd(*args, dy, st, chunk=32)
        name, call = ext.calls[-1]
        assert name == "ssd_scan_bwd"
        assert ops.launch_counts()["ssd_scan_bwd"] == before + 1
        assert call[:8] == (*(t.data_ptr() for t in args), dy.data_ptr(),
                            0 if st is None else st.data_ptr())
        assert call[8:14] == tuple(g.data_ptr() for g in grads)
        assert call[15:21] == (B, S, nh, hd, ng, ds)
        assert ext.work_asked[-1] == (B, S, nh, hd, ng, ds)
        assert call[14] not in {t.data_ptr() for t in (*args, dy, *grads)}
        for g, a in zip(grads, args):
            assert g.shape == a.shape and g.dtype == a.dtype
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_bwd(*[a.bfloat16() if i not in (2, 5) else a
                           for i, a in enumerate(args)], dy.bfloat16(),
                         chunk=32)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssd.ssd_scan_bwd(*args, dy, chunk=40)
    with pytest.raises(ValueError, match="shapes"):
        ssd.ssd_scan_bwd(*args, dy, dstate[:, :1], chunk=32)
    wide, wdy, _ = _inputs(6, 1, 8, 2, 8, 1, ssd.BWD_MAX_STATE + 8)
    with pytest.raises(ValueError, match="out of the kernel's range"):
        ssd.ssd_scan_bwd(*map(_t, wide), _t(wdy), chunk=8)


def test_ops_refuses_bf16_with_grad_on_the_card(monkeypatch):
    """On the card a bfloat16 scan under autograd raises naming bfloat16
    (no backward kernel for it), before any launch; the CPU trains it."""
    args, _, _ = _inputs(7, 1, 32, 2, 16, 1, 16)
    leaves = [_t(a).to(torch.bfloat16) if i not in (2, 5) else _t(a)
              for i, a in enumerate(args)]
    for t in leaves:
        t.requires_grad_(True)
    y, _ = ops.ssd_scan(*leaves, chunk=32)
    y.float().sum().backward()
    assert leaves[0].grad.dtype == torch.bfloat16
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ops.ssd_scan(*leaves, chunk=32)

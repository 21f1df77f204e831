"""The gradients of the port's attention and RMSNorm on the CPU, against
JAX's.

``kernels.ops.flash_attention`` runs through a ``torch.autograd.Function``
wherever autograd records: on a CPU tensor its forward is the plain
version with each row's log-sum-exp (``ref.flash_attention_lse``) and its
backward the plain ``ref.flash_attention_bwd``; on the card the same
Function launches ``flash_attention`` with its lse and
``flash_attention_bwd``. Both are held here to ``jax.grad`` through
``repro.kernels.flash_ref.flash_attention`` (JAX's custom VJP on the CPU,
``_bwd_impl``) at the five parameter sets of tests/test_kernels.py's
flash_ref test plus K != Kv (MLA's shape), within 5e-5 abs + rel (that
test's grad tolerance); the lse against ``_fwd_impl``'s. RMSNorm's
gradients (``ops.rmsnorm``, ``ops.rmsnorm_pair`` and the plain
``ref.rmsnorm_bwd``) are held to ``jax.grad`` of JAX's ``rmsnorm_fwd``.
Without grad the serving calls keep their bits. Inputs come from a
seeded numpy generator.

The kernel wrappers run here with their CUDA checks and the extension
replaced by stand-ins, which shows what they pass the kernels and that
each call counts one launch.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = 5e-5
EPS = 1e-6
CASES = [  # B, Sq, Skv, H, Hkv, K, Kv, causal, window, cap
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0),
    (2, 64, 64, 4, 2, 16, 16, True, 24, 0.0),
    (1, 48, 48, 2, 2, 8, 8, True, 0, 5.0),
    (2, 1, 64, 4, 4, 16, 16, True, 0, 0.0),     # decode-style single query
    (2, 40, 40, 4, 2, 16, 16, False, 0, 0.0),   # non-divisible
    (1, 40, 40, 4, 4, 24, 16, True, 0, 0.0),    # K != Kv (MLA's kind)
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are small: one torch thread runs them about as
    fast as many, and keeps the module from oversubscribing the cores
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Skv, H, Hkv, K, Kv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, K), (B, Skv, Hkv, K), (B, Skv, Hkv, Kv))]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(
    map(str, c)))
def case(request):
    """The case's inputs, JAX's out, lse and grads of sum(sin(out))."""
    B, Sq, Skv, H, Hkv, K, Kv, causal, window, cap = request.param
    q, k, v = _inputs(0, B, Sq, Skv, H, Hkv, K, Kv)
    kw = dict(causal=causal, window=window, softcap=cap)

    def f(q, k, v):
        return flash_ref.flash_attention(q, k, v, block_q=16, block_k=16,
                                         **kw)
    out, lse = flash_ref._fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=16, block_k=16,
                                   **kw)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                             argnums=(0, 1, 2)))(q, k, v)
    return dict(q=q, k=k, v=v, kw=kw, out=np.asarray(out),
                lse=np.asarray(lse).reshape(B, H, Sq),
                grads=[np.asarray(g) for g in grads])


def test_plain_lse_and_out_match_jax(case):
    t = [torch.from_numpy(a) for a in (case["q"], case["k"], case["v"])]
    out, lse = ref.flash_attention_lse(*t, **case["kw"])
    _close(out, case["out"], 2e-5)
    _close(lse, case["lse"], 2e-5)
    assert torch.equal(out, ref.flash_attention(*t, **case["kw"]))


def test_plain_backward_matches_jax_grad(case):
    t = [torch.from_numpy(a) for a in (case["q"], case["k"], case["v"])]
    out, lse = ref.flash_attention_lse(*t, **case["kw"])
    got = ref.flash_attention_bwd(*t, out, lse, torch.cos(out),
                                  **case["kw"])
    for g, want in zip(got, case["grads"]):
        _close(g, want)


def test_function_cpu_path_matches_jax_grad_and_serving_bits(case):
    t = [torch.from_numpy(a).requires_grad_(True)
         for a in (case["q"], case["k"], case["v"])]
    out = ops.flash_attention(*t, **case["kw"])
    assert out.grad_fn is not None
    torch.sin(out).sum().backward()
    for x, want in zip(t, case["grads"]):
        _close(x.grad, want)
    with torch.no_grad():
        served = ops.flash_attention(*t, **case["kw"])
    assert served.grad_fn is None
    assert torch.equal(served, out.detach())


def _rms_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jax_rms_grads(x, s, g):
    def f(x, s):
        return jnp.sum(jlayers.rmsnorm_fwd({"scale": s}, x, EPS) * g)
    return [np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(x, s)]


@pytest.mark.parametrize("shape", [(37, 128), (2, 9, 1024), (3, 5, 4, 512)])
def test_rmsnorm_grads_match_jax(shape):
    x, s, g = _rms_inputs(1, shape)
    want = _jax_rms_grads(x, s, g)
    for got in (ref.rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(g), EPS),):
        _close(got[0], want[0])
        _close(got[1], want[1])
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    y = ops.rmsnorm(tx, ts, EPS)
    (y * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, want[0])
    _close(ts.grad, want[1])
    with torch.no_grad():
        assert torch.equal(ops.rmsnorm(tx, ts, EPS), y.detach())


def test_rmsnorm_grad_through_a_strided_slice_matches_jax():
    """The MLA latent norm reads dkv[..., :r] in place: its gradient lands
    in the slice's columns of the wider row and 0 beside them."""
    rng = np.random.default_rng(2)
    wide = rng.standard_normal((6, 576)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(512)).astype(np.float32)
    g = rng.standard_normal((6, 512)).astype(np.float32)
    want = _jax_rms_grads(wide[:, :512], s, g)
    tw = torch.from_numpy(wide).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    (ops.rmsnorm(tw[:, :512], ts, EPS) * torch.from_numpy(g)).sum().backward()
    _close(tw.grad[:, :512], want[0])
    assert not tw.grad[:, 512:].any()
    _close(ts.grad, want[1])


def test_rmsnorm_pair_grads_match_jax():
    xq, sq, gq = _rms_inputs(3, (2, 7, 4, 128))
    xk, sk, gk = _rms_inputs(4, (2, 7, 2, 128))
    wq, wk = _jax_rms_grads(xq, sq, gq), _jax_rms_grads(xk, sk, gk)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (xq, sq, xk, sk)]
    oq, ok = ops.rmsnorm_pair(t[0], t[1], t[2], t[3], EPS)
    ((oq * torch.from_numpy(gq)).sum()
     + (ok * torch.from_numpy(gk)).sum()).backward()
    for got, want in zip((t[0].grad, t[1].grad, t[2].grad, t[3].grad),
                         (*wq, *wk)):
        _close(got, want)


class _Extension:
    def __init__(self):
        self.calls = []

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
    monkeypatch.setattr(rn, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(rn, "extension", lambda: ext)
    monkeypatch.setattr(fa, "extension", lambda: ext)
    monkeypatch.setattr(fa, "_check", _check_no_device(fa._check))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return ext


def _check_no_device(check):
    def run(name, t, like, dtypes, dim):
        cpu = types.SimpleNamespace(device=types.SimpleNamespace(
            type="cuda"))
        if t.dtype != like.dtype or t.dtype not in dtypes:
            raise TypeError(f"{name} dtype {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-d tensor")
        del cpu
    return run


def test_flash_wrappers_pass_lse_and_count_one_backward_launch(no_card):
    ext = no_card
    B, Sq, Skv, H, Hkv, K, Kv = 2, 40, 50, 4, 2, 192, 128
    q = torch.zeros(B, Sq, H, K)
    k = torch.zeros(B, Skv, Hkv, K)
    v = torch.zeros(B, Skv, Hkv, Kv)
    fa.flash_attention(q, k, v, causal=False)
    assert ext.calls[-1][1][4] == 0                  # serving: no lse
    out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    assert lse.shape == (B, H, Sq) and ext.calls[-1][1][4] == lse.data_ptr()
    with pytest.raises(TypeError, match="backward"):
        fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                           return_lse=True)
    before = ops.launch_counts()["flash_attention_bwd"]
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out, causal=False,
                                        window=0, softcap=0.0)
    name, args = ext.calls[-1]
    assert name == "flash_attention_bwd"
    assert args[:9] == tuple(t.data_ptr() for t in (q, k, v, out, lse, out,
                                                    dq, dk, dv))
    assert args[10:17] == (B, Sq, Skv, H, Hkv, K, Kv)
    assert args[17] is False and args[19] == pytest.approx(K ** -0.5)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 8, 2, 256)
        fa.flash_attention_bwd(big, big, big, big, torch.zeros(1, 2, 8), big)


def test_rmsnorm_bwd_wrappers_pass_segments_and_count_one_launch(no_card):
    ext = no_card
    x = torch.zeros(6, 576)[:, :512]
    s = torch.ones(512)
    g = torch.zeros(6, 512)
    before = ops.launch_counts()["rmsnorm_bwd"]
    dx, ds = rn.rmsnorm_bwd(x, s, g, EPS)
    name, args = ext.calls[-1]
    assert name == "rmsnorm_bwd"
    assert args[0] == x.data_ptr() and args[4:6] == (6, 576)
    assert args[10:12] == (0, 0) and args[12] == 512
    assert dx.shape == x.shape and dx.is_contiguous() and ds.shape == (512,)
    q, k = torch.zeros(4, 1, 16, 128), torch.zeros(4, 1, 8, 128)
    sq, sk = torch.ones(128), torch.ones(128)
    (dq, dsq), (dk, dsk) = rn.rmsnorm_pair_bwd(q, sq, q, k, sk, k, EPS)
    name, args = ext.calls[-1]
    assert args[4:6] == (64, 128) and args[10:12] == (32, 128)
    assert ops.launch_counts()["rmsnorm_bwd"] == before + 2
    with pytest.raises(TypeError, match="float32 only"):
        rn.rmsnorm_bwd(x.bfloat16(), s.bfloat16(), g.bfloat16())

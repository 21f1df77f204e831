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
Each case runs in float32 and again in bfloat16 (inputs rounded to
bfloat16 on both sides): there the lse within 1e-5 abs + rel, and out
and every gradient within 2e-2 of max|JAX| (bfloat16's rounding of the
outputs; the sums are float32 on both sides). Without grad the serving
calls keep their bits. Inputs come from a seeded numpy generator.

The kernel wrappers run here with their CUDA checks and the extension
replaced by stand-ins, which shows what they pass the kernels and that
each call counts one launch.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = 5e-5
BF16_TOL = 2e-2     # of max|JAX|: bfloat16 outputs, float32 sums
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


def _f32(x):
    """A tensor or array (bfloat16 too) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _held(got, want, dtype, tol=TOL):
    """float32: within ``tol`` abs + rel; bfloat16: every element within
    ``BF16_TOL`` of max|want|."""
    if dtype == "float32":
        _close(got, want, tol)
        return
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    np.testing.assert_array_less(np.abs(g - w).max(),
                                 BF16_TOL * max(np.abs(w).max(), 1e-30))


def _as(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t if dtype == "float32" else t.bfloat16()


def _jnp(a: np.ndarray, dtype: str):
    return jnp.asarray(a, jnp.float32 if dtype == "float32" else jnp.bfloat16)


@pytest.fixture(scope="module", params=[(c, dt) for dt in ("float32",
                                                           "bfloat16")
                                        for c in CASES],
                ids=lambda p: "-".join(map(str, p[0])) + f"-{p[1]}")
def case(request):
    """The case's inputs (numpy float32, rounded to bfloat16 on both sides
    in the bfloat16 cases), JAX's out, lse and grads of sum(sin(out))."""
    (B, Sq, Skv, H, Hkv, K, Kv, causal, window, cap), dtype = request.param
    q, k, v = _inputs(0, B, Sq, Skv, H, Hkv, K, Kv)
    jq, jk, jv = (_jnp(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=cap)

    def f(q, k, v):
        return flash_ref.flash_attention(q, k, v, block_q=16, block_k=16,
                                         **kw)
    out, lse = flash_ref._fwd_impl(jq, jk, jv, block_q=16, block_k=16, **kw)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                             argnums=(0, 1, 2)))(jq, jk, jv)
    return dict(q=q, k=k, v=v, kw=kw, dtype=dtype, out=out,
                lse=np.asarray(lse).reshape(B, H, Sq), grads=grads)


def test_plain_lse_and_out_match_jax(case):
    dt = case["dtype"]
    t = [_as(a, dt) for a in (case["q"], case["k"], case["v"])]
    out, lse = ref.flash_attention_lse(*t, **case["kw"])
    _held(out, case["out"], dt, 2e-5)
    _close(lse, case["lse"], 2e-5 if dt == "float32" else 1e-5)
    assert torch.equal(out, ref.flash_attention(*t, **case["kw"]))


def test_plain_backward_matches_jax_grad(case):
    dt = case["dtype"]
    t = [_as(a, dt) for a in (case["q"], case["k"], case["v"])]
    out, lse = ref.flash_attention_lse(*t, **case["kw"])
    got = ref.flash_attention_bwd(*t, out, lse, torch.cos(out),
                                  **case["kw"])
    for g, x, want in zip(got, t, case["grads"]):
        assert g.dtype == x.dtype
        _held(g, want, dt)


def test_function_cpu_path_matches_jax_grad_and_serving_bits(case):
    dt = case["dtype"]
    t = [_as(a, dt).requires_grad_(True)
         for a in (case["q"], case["k"], case["v"])]
    out = ops.flash_attention(*t, **case["kw"])
    assert out.grad_fn is not None
    torch.sin(out).sum().backward()
    for x, want in zip(t, case["grads"]):
        _held(x.grad, want, dt)
    with torch.no_grad():
        served = ops.flash_attention(*t, **case["kw"])
    assert served.grad_fn is None
    assert torch.equal(served, out.detach())


def _rms_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jax_rms_grads(x, s, g, dtype="float32"):
    """JAX's gradients of sum(rmsnorm_fwd(x, s) * g), the three in
    ``dtype`` (float32 numpy, or bfloat16 jax arrays)."""
    gj = _jnp(g, dtype)

    def f(x, s):
        return jnp.sum(jlayers.rmsnorm_fwd({"scale": s}, x, EPS) * gj)
    grads = jax.grad(f, argnums=(0, 1))(_jnp(x, dtype), _jnp(s, dtype))
    return [np.asarray(a) if dtype == "float32" else a for a in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 128), (2, 9, 1024), (3, 5, 4, 512)])
def test_rmsnorm_grads_match_jax(shape, dtype):
    x, s, g = _rms_inputs(1, shape)
    want = _jax_rms_grads(x, s, g, dtype)
    tx, ts, tg = (_as(a, dtype) for a in (x, s, g))
    got = ref.rmsnorm_bwd(tx, ts, tg, EPS)
    assert got[0].dtype == got[1].dtype == tx.dtype
    _held(got[0], want[0], dtype)
    _held(got[1], want[1], dtype)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    y = ops.rmsnorm(tx, ts, EPS)
    (y * tg).sum().backward()
    _held(tx.grad, want[0], dtype)
    _held(ts.grad, want[1], dtype)
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
    # the bf16 body writes an lse too, and its backward takes bf16
    bq, bk, bv = q.bfloat16(), k.bfloat16(), v.bfloat16()
    bout, blse = fa.flash_attention(bq, bk, bv, causal=False,
                                    return_lse=True)
    assert blse.dtype == torch.float32 and blse.shape == (B, H, Sq)
    assert ext.calls[-1][1][4] == blse.data_ptr() and ext.calls[-1][1][16]
    grads = fa.flash_attention_bwd(bq, bk, bv, bout, blse, bout,
                                   causal=False)
    assert ext.calls[-1][0] == "flash_attention_bwd"
    assert ext.calls[-1][1][21] is True               # the bf16 body
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    with pytest.raises(TypeError, match="lse"):
        fa.flash_attention_bwd(bq, bk, bv, bout, blse.bfloat16(), bout)
    before = ops.launch_counts()["flash_attention_bwd"]
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out, causal=False,
                                        window=0, softcap=0.0)
    name, args = ext.calls[-1]
    assert name == "flash_attention_bwd"
    assert args[:9] == tuple(t.data_ptr() for t in (q, k, v, out, lse, out,
                                                    dq, dk, dv))
    assert args[10:17] == (B, Sq, Skv, H, Hkv, K, Kv)
    assert args[17] is False and args[19] == pytest.approx(K ** -0.5)
    assert args[21] is False                          # the float32 body
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    big = torch.zeros(1, 8, 2, 256)
    with pytest.raises(ValueError, match="shared memory"):
        fa.flash_attention_bwd(big, big, big, big, torch.zeros(1, 2, 8), big)
    # bf16 tiles are half as wide: the same heads fit
    fa.flash_attention_bwd(*(big.bfloat16(),) * 4, torch.zeros(1, 2, 8),
                           big.bfloat16())


class _AtenOps(TorchDispatchMode):
    """The names of the aten operations run while open."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# what a backward call may run besides its kernel: allocations and views
# (no torch.zeros, fill or copy: the kernel writes dscale whole)
_BWD_HOST_OPS = {"empty", "view", "select"}


def _bwd_call(ext, fn, *args):
    """fn(*args) under _AtenOps, with the launches it counted and the
    extension calls it made."""
    before, n_calls = ops.launch_counts()["rmsnorm_bwd"], len(ext.calls)
    with _AtenOps() as seen:
        out = fn(*args)
    assert set(seen.names) <= _BWD_HOST_OPS, seen.names
    assert ops.launch_counts()["rmsnorm_bwd"] == before + 1
    assert len(ext.calls) == n_calls + 1 and ext.calls[-1][0] == "rmsnorm_bwd"
    return out, ext.calls[-1][1]


def test_rmsnorm_bwd_wrappers_pass_segments_and_count_one_launch(no_card):
    """One call is one counted launch with no zeros or copy on the host;
    the single, strided and pair calls hand the kernel each segment's
    pointers, rows, row stride and partition ((per, blocks) from its rows
    and width alone), and dscale is the kernel's own (segments, D)
    buffer."""
    ext = no_card
    x = torch.zeros(6, 576)[:, :512]
    s = torch.ones(512)
    g = torch.zeros(6, 512)
    (dx, ds), args = _bwd_call(ext, rn.rmsnorm_bwd, x, s, g, EPS)
    assert args[:8] == (x.data_ptr(), s.data_ptr(), g.data_ptr(),
                        dx.data_ptr(), 6, 576, *rn.bwd_partition(6, 512))
    assert args[8:16] == (0,) * 8                 # no second tensor
    assert args[16] == 512 and args[17] == pytest.approx(EPS)
    assert args[18:21] == (*rn.layout(512, 4), True)
    assert args[22] == ds.data_ptr() and args[23] == 1
    assert dx.shape == x.shape and dx.is_contiguous() and ds.shape == (512,)

    def rows(n, width):
        return torch.zeros(4, 1, n, width), torch.ones(width)
    (q, sq), (k, sk) = rows(16, 128), rows(8, 128)
    ((dq, dsq), (dk, dsk)), args = _bwd_call(ext, rn.rmsnorm_pair_bwd, q,
                                             sq, q, k, sk, k, EPS)
    assert args[:8] == (q.data_ptr(), sq.data_ptr(), q.data_ptr(),
                        dq.data_ptr(), 64, 128, *rn.bwd_partition(64, 128))
    assert args[8:16] == (k.data_ptr(), sk.data_ptr(), k.data_ptr(),
                          dk.data_ptr(), 32, 128, *rn.bwd_partition(32, 128))
    assert args[22] == dsq.data_ptr() and args[23] == 2
    assert dsk.data_ptr() == dsq.data_ptr() + 128 * 4
    # each segment of the pair gets what its solo launch gets
    _, solo = _bwd_call(ext, rn.rmsnorm_bwd, k, sk, k, EPS)
    assert solo[4:8] == args[12:16] and solo[16:21] == args[16:21]
    # an empty segment: no blocks, its dscale row still the kernel's
    ((de, dse), _), args = _bwd_call(ext, rn.rmsnorm_pair_bwd, q[:0], sq,
                                     q[:0], k, sk, k, EPS)
    assert args[4] == 0 and args[7] == 0 and args[12:16] == solo[4:8]
    assert de.shape == q[:0].shape and dse.data_ptr() == args[22]
    # a base off 16 bytes takes the one-element path, same partition
    off = torch.zeros(6 * 512 + 1)[1:].view(6, 512)
    _, args = _bwd_call(ext, rn.rmsnorm_bwd, off, s, g, EPS)
    assert args[4:8] == (6, 512, *rn.bwd_partition(6, 512))
    assert args[18:21] == (*rn.layout(512, 4), False)
    assert args[24:26] == (False, False)          # float32 rows and scale
    # bf16 rows: the forward's bf16 layout and flags, dx in bf16 and
    # dscale in the scale's dtype, the same partition
    for sd in (torch.bfloat16, torch.float32):
        (bdx, bds), args = _bwd_call(ext, rn.rmsnorm_bwd, x.bfloat16(),
                                     s.to(sd), g.bfloat16(), EPS)
        assert args[4:8] == (6, 512, *rn.bwd_partition(6, 512))
        assert args[18:21] == (*rn.layout(512, 2), True)
        assert args[24:26] == (True, sd == torch.bfloat16)
        assert bdx.dtype == torch.bfloat16 and bds.dtype == sd
    # a pair takes one dtype and scale dtype
    with pytest.raises(ValueError, match="pair"):
        rn.rmsnorm_pair_bwd(q, sq, q, k.bfloat16(), sk, k.bfloat16(), EPS)

"""The port's plain RMSNorm against the JAX package's, and its dispatch.

``repro_torch.kernels.ref.rmsnorm`` is held to ``repro.kernels.ref
.rmsnorm`` and to the Pallas kernel ``repro.kernels.rmsnorm.rmsnorm`` in
interpret mode (as tests/test_kernels.py runs it), at every width the
port's norms see: 128 (qwen3 q/k norms), 512 (the deepseek latent norm),
1024 / 2048 / 2560 (block norms) and 5120 (the mamba2 gated norm), plus a
strided slice like the MLA ``dkv[..., :r]``. Inputs come from a seeded
numpy generator; bf16 inputs are the same float32 draws rounded on each
side. Tolerances are the kernel contract of tests/test_kernels.py: 2e-5
in float32, 2e-2 in bfloat16. On the CPU the model's ``rmsnorm_fwd``
goes through ``ops.rmsnorm`` to the plain version, bit for bit, and
``ops.rmsnorm_pair`` (a layer's q and k norms, one launch on the card) is
that plain version twice, held to JAX's two ``rmsnorm_fwd`` calls at q's
and k's row counts.

Without a build, the wrapper runs with its CUDA check and the extension
replaced by stand-ins: that shows the lane layout it picks from the width
and dtype alone (every layout one of the kernel's instantiations), where
it takes the 16-byte path and where the one-element path, and that a pair
is one launch over both tensors.
"""
from __future__ import annotations

import pathlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WIDTHS = (128, 512, 1024, 2048, 2560, 5120)
EPS = 1e-6


def _draw(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x, scale


def _pair(a: np.ndarray, dtype: str):
    """The same values on both sides: numpy float32 rounded to ``dtype``
    by jax and by torch (both round to nearest even)."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", WIDTHS)
def test_plain_rmsnorm_matches_jax_ref_and_pallas(D, dtype):
    x, s = _draw(D, (3, 7, D))
    jx, tx = _pair(x, dtype)
    js, ts = _pair(s, dtype)
    got = tref.rmsnorm(tx, ts, EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    _close(got, jref.rmsnorm(jx, js, EPS).astype(jnp.float32), dtype)
    pallas = pallas_rmsnorm(jx, js, eps=EPS, block_rows=8, interpret=True)
    _close(got, pallas.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rmsnorm_on_a_strided_slice(dtype):
    """The MLA latent norm reads ``dkv[..., :r]`` of a wider row (deepseek:
    r = 512 of r + dr = 576)."""
    r, dr = 512, 64
    x, s = _draw(7, (2, 9, r + dr))
    jx, tx = _pair(x, dtype)
    js, ts = _pair(s[:r], dtype)
    view = tx[..., :r]
    assert not view.is_contiguous()
    got = tref.rmsnorm(view, ts, EPS)
    assert torch.equal(got, tref.rmsnorm(view.contiguous(), ts, EPS))
    want = jref.rmsnorm(jx[..., :r], js, EPS).astype(jnp.float32)
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_in_float32_under_bfloat16_rows(dtype):
    """scale may be float32 while x is bfloat16 (or x's own dtype)."""
    x, s = _draw(3, (4, 1024))
    jx, tx = _pair(x, "bfloat16")
    js, ts = _pair(s, dtype)
    got = tref.rmsnorm(tx, ts, EPS)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(),
           jref.rmsnorm(jx, js, EPS).astype(jnp.float32), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_norm_goes_through_ops_and_matches_jax_layer(dtype):
    """``layers.rmsnorm_fwd`` sends a CPU tensor to the plain version (no
    launch counted) and agrees with JAX's ``layers.rmsnorm_fwd``."""
    x, s = _draw(11, (2, 5, 16, 128))
    jx, tx = _pair(x, dtype)
    js, ts = _pair(s, dtype)
    ops.reset_launch_counts()
    got = tlayers.rmsnorm_fwd({"scale": ts}, tx, EPS)
    assert torch.equal(got, tref.rmsnorm(tx, ts, EPS))
    assert ops.launch_counts()["rmsnorm"] == 0
    want = jlayers.rmsnorm_fwd({"scale": js}, jx, EPS)
    _close(got.float().numpy(), want.astype(jnp.float32), dtype)


def test_plain_rmsnorm_is_the_former_model_body_bit_for_bit():
    """The plain version is exactly what ``rmsnorm_fwd`` computed before it
    went through ``ops``, so every CPU parity test keeps its bits."""
    x, s = _draw(5, (3, 4, 1024))
    for dtype in (torch.float32, torch.bfloat16):
        tx, ts = torch.from_numpy(x).to(dtype), torch.from_numpy(s).to(dtype)
        xf = tx.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        before = (xf * torch.rsqrt(var + EPS) * ts.float()).to(dtype)
        assert torch.equal(tref.rmsnorm(tx, ts, EPS), before)


def test_rmsnorm_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.rmsnorm import rmsnorm
    x, s = _draw(1, (2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(torch.from_numpy(x), torch.from_numpy(s))


# ---------------------------------------------------------------------------
# the q/k pair: one launch on the card, the plain version twice on the CPU
# ---------------------------------------------------------------------------
# (q, k) shapes of qwen3's q/k norms: a 4-slot decode step and a prefill
QK_SHAPES = [((4, 1, 16, 128), (4, 1, 8, 128)),
             ((2, 7, 16, 128), (2, 7, 8, 128))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_shape,k_shape", QK_SHAPES)
def test_rmsnorm_pair_on_cpu_is_two_singles_bit_for_bit(q_shape, k_shape,
                                                        dtype):
    xq, sq = _draw(21, q_shape)
    xk, sk = _draw(22, k_shape)
    (_, tq), (_, tk) = _pair(xq, dtype), _pair(xk, dtype)
    (_, tsq), (_, tsk) = _pair(sq, dtype), _pair(sk, dtype)
    ops.reset_launch_counts()
    gq, gk = ops.rmsnorm_pair(tq, tsq, tk, tsk, EPS)
    assert torch.equal(gq, ops.rmsnorm(tq, tsq, EPS))
    assert torch.equal(gk, ops.rmsnorm(tk, tsk, EPS))
    assert ops.launch_counts()["rmsnorm"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_shape,k_shape", QK_SHAPES)
def test_rmsnorm_pair_matches_jax_ref_and_pallas(q_shape, k_shape, dtype):
    """JAX's attention normalises q and k with two ``rmsnorm_fwd`` calls;
    the pair agrees with its ref and with the Pallas kernel on each."""
    xq, sq = _draw(31, q_shape)
    xk, sk = _draw(32, k_shape)
    (jq, tq), (jk, tk) = _pair(xq, dtype), _pair(xk, dtype)
    (jsq, tsq), (jsk, tsk) = _pair(sq, dtype), _pair(sk, dtype)
    got = ops.rmsnorm_pair(tq, tsq, tk, tsk, EPS)
    for g, jx, js in zip(got, (jq, jk), (jsq, jsk)):
        g = g.float().numpy()
        _close(g, jref.rmsnorm(jx, js, EPS).astype(jnp.float32), dtype)
        _close(g, jlayers.rmsnorm_fwd({"scale": js}, jx, EPS).astype(
            jnp.float32), dtype)
        pallas = pallas_rmsnorm(jx, js, eps=EPS, block_rows=8, interpret=True)
        _close(g, pallas.astype(jnp.float32), dtype)


# ---------------------------------------------------------------------------
# the wrapper's layout and path, without a build
# ---------------------------------------------------------------------------
# (W, N) by width: float32 (V = 4) and bfloat16 (V = 8); the widths of the
# port's norms, then those of the families still to come
LAYOUTS = {128: ((1, 1), (1, 1)), 512: ((4, 1), (2, 1)),
           1024: ((4, 2), (4, 1)), 2048: ((8, 2), (4, 2)),
           2560: ((8, 4), (8, 2)), 5120: ((8, 8), (8, 4)),
           4096: ((8, 4), (8, 2)), 5376: ((8, 8), (8, 4)),
           6144: ((8, 8), (8, 4)), 7168: ((8, 8), (8, 4))}
CSRC = pathlib.Path(rn.__file__).parent / "csrc" / "rmsnorm.cu"


def _instantiations():
    """(W, N) of every 16-byte instantiation in the kernel's dispatch."""
    text = CSRC.read_text().replace("MAX_SLOTS", str(rn.MAX_SLOTS))
    return {(int(w), int(n)) for w, n in re.findall(
        r"launch<T, S, (\d+), (\d+), true>", text)}


@pytest.mark.parametrize("D", sorted(LAYOUTS))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_layout_holds_the_row_in_registers_from_width_and_dtype(D, itemsize):
    W, N = rn.layout(D, itemsize)
    assert (W, N) == LAYOUTS[D][itemsize == 2]
    per_vector = rn.VEC_BYTES // itemsize
    assert 32 * W * N * per_vector >= D
    # the first of WARP_SLOTS that holds the row: no earlier one does
    caps = dict(rn.WARP_SLOTS)
    assert -(-D // (per_vector * 32 * W)) <= caps[W]
    assert all(-(-D // (per_vector * 32 * w)) > cap
               for w, cap in rn.WARP_SLOTS if w < W)
    assert (W, N) in _instantiations()


@pytest.mark.parametrize("D,itemsize", [(1, 2), (3, 4), (100, 2), (1000, 4),
                                        (16384, 2), (8192, 4)])
def test_every_width_in_registers_has_an_instantiation(D, itemsize):
    assert rn.layout(D, itemsize) in _instantiations()


@pytest.mark.parametrize("D,itemsize", [(16385, 2), (8193, 4), (40000, 4)])
def test_rows_beyond_registers_take_the_most_warps_and_loop(D, itemsize):
    W, N = rn.layout(D, itemsize)
    assert W == rn.WARP_SLOTS[-1][0] and N > rn.MAX_SLOTS


class _Extension:
    """Records the rmsnorm entry point's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def rmsnorm(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def no_card(monkeypatch):
    """The wrapper with CPU tensors: its device check passes, the stream
    is 0, the extension records its calls, and any build is refused."""
    def refuse(*args, **kwargs):
        raise AssertionError("the rmsnorm wrapper reached the kernel build")
    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "extension", refuse)
    ext = _Extension()
    monkeypatch.setattr(rn, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(rn, "extension", lambda: ext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return ext


def _aligned(n, dtype, offset=0):
    """``n`` zeros of ``dtype`` starting ``offset`` elements past 16 bytes."""
    isz = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(n + 32 + offset, dtype=dtype)
    start = (-buf.data_ptr()) % 16 // isz + offset
    return buf[start:start + n]


def _call(ext):
    """The recorded call's (segments, D, bf16, scale bf16, W, N, vec)."""
    args = ext.calls[-1]
    return ([args[i:i + 5] for i in (0, 5)], *args[10:11], *args[12:17])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 512, 1024, 2560, 5120])
def test_wrapper_takes_16_byte_loads_where_every_address_allows(no_card, D,
                                                                dtype):
    ext = no_card
    isz = torch.empty((), dtype=dtype).element_size()
    rows = 5
    x = _aligned(rows * D, dtype).view(rows, D)
    s = _aligned(D, dtype)
    before = ops.launch_counts()["rmsnorm"]
    out = rn.rmsnorm(x, s, EPS)
    assert out.shape == x.shape and out.dtype == dtype
    (a, b), D_, bf16, _, W, N, vec = _call(ext)
    assert a[0] == x.data_ptr() and a[3:] == (rows, D) and b == (0,) * 5
    assert (D_, bf16, (W, N), vec) == (D, dtype == torch.bfloat16,
                                       rn.layout(D, isz), True)
    assert ops.launch_counts()["rmsnorm"] == before + 1
    # the MLA latent slice of 576-wide rows keeps the 16-byte path
    wide = _aligned(rows * 576, dtype).view(rows, 576)
    rn.rmsnorm(wide[:, :512], _aligned(512, dtype), EPS)
    (a, _), *_, vec = _call(ext)
    assert a[3:] == (rows, 576) and vec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["base", "stride", "width", "scale",
                                  "beyond"])
def test_wrapper_takes_one_element_loads_where_an_address_does_not(
        no_card, case, dtype):
    """A base one element off 16 bytes, a row stride of D + 1, a width
    that V does not divide, a scale off 16 bytes, a row beyond registers:
    the same layout, the one-element path."""
    ext = no_card
    isz = torch.empty((), dtype=dtype).element_size()
    rows, D = 6, {"width": 1020 if isz == 2 else 1022,
                  "beyond": 20000}.get(case, 1024)
    x = _aligned(rows * D, dtype, offset=case == "base").view(rows, D)
    if case == "stride":
        x = _aligned(rows * (D + 1), dtype).view(rows, D + 1)[:, :D]
    s = _aligned(D, dtype, offset=case == "scale")
    rn.rmsnorm(x, s, EPS)
    (a, _), D_, _, _, W, N, vec = _call(ext)
    assert (D_, (W, N), vec) == (D, rn.layout(D, isz), False)
    assert a[4] == (D + 1 if case == "stride" else D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_pair_is_one_launch_over_both_tensors(no_card, dtype):
    ext = no_card
    q = _aligned(4 * 16 * 128, dtype).view(4, 1, 16, 128)
    k = _aligned(4 * 8 * 128, dtype).view(4, 1, 8, 128)
    sq, sk = _aligned(128, dtype), _aligned(128, dtype)
    before = ops.launch_counts()["rmsnorm"]
    oq, ok = rn.rmsnorm_pair(q, sq, k, sk, EPS)
    assert oq.shape == q.shape and ok.shape == k.shape
    assert ops.launch_counts()["rmsnorm"] == before + 1 and len(ext.calls) == 1
    (a, b), D, *_, vec = _call(ext)
    assert a == (q.data_ptr(), sq.data_ptr(), oq.data_ptr(), 64, 128)
    assert b == (k.data_ptr(), sk.data_ptr(), ok.data_ptr(), 32, 128)
    assert D == 128 and vec
    # one tensor off 16 bytes sends both to the one-element path
    k_off = _aligned(4 * 8 * 128, dtype, offset=1).view(4, 1, 8, 128)
    rn.rmsnorm_pair(q, sq, k_off, sk, EPS)
    assert _call(ext)[-1] is False
    # a tensor without rows leaves a launch over the other
    rn.rmsnorm_pair(q[:0], sq, k, sk, EPS)
    (a, b), *_ = _call(ext)
    assert a[3] == 32 and b == (0,) * 5
    n = len(ext.calls)
    rn.rmsnorm_pair(q[:0], sq, k[:0], sk, EPS)
    rn.rmsnorm(q[:0], sq, EPS)
    assert len(ext.calls) == n


def test_wrapper_pair_refuses_unlike_tensors(no_card):
    q = _aligned(4 * 128, torch.float32).view(4, 128)
    s = _aligned(128, torch.float32)
    with pytest.raises(ValueError, match="one width"):
        rn.rmsnorm_pair(q, s, q[:, :64], s[:64], EPS)
    with pytest.raises(ValueError, match="one width"):
        rn.rmsnorm_pair(q, s, q.bfloat16(), s, EPS)
    with pytest.raises(ValueError, match="one width"):
        rn.rmsnorm_pair(q, s, q, s.bfloat16(), EPS)
    with pytest.raises(TypeError, match="dtype"):
        rn.rmsnorm_pair(q, s, q.half(), s, EPS)
    assert not no_card.calls

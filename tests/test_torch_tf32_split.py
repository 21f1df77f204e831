"""The arithmetic of the float32 flash bodies on the tensor cores, emulated
on the CPU, against JAX's flash path.

``csrc/flash_attention.cu`` (its float32 body) and
``csrc/flash_attention_bwd.cu`` run every product as split TF32: each
operand x is split into hi = tf32(x) (``cvt.rna``: round to nearest, ties
away, 10 mantissa bits) and lo = tf32(x - hi), and a product is lo.hi +
hi.lo + hi.hi, three ``mma.sync.m16n8k8`` into one float32 accumulator
per k8 step. Here torch reproduces that: the rounding by bit masking,
the three products of every k8 step added in that order in float32, the
forward's online softmax over 64-key tiles in log2 units and its lse,
and the backward's p = exp2(x - lse log2 e), ds, dq, dk and dv. The
emulated forward (out, lse) is held to ``repro.kernels.flash_ref``'s
``_fwd_impl`` within 2e-5 and the emulated gradients to ``jax.grad``
through ``flash_ref.flash_attention`` within 5e-5 (abs + rel, element by
element; the card's tolerances), at small shapes of every mask kind:
causal, a window, softcap 30, not causal, K != Kv, and K = 5 and 72
padded to the MMA depth. One TF32 product alone (hi.hi) misses the
forward's tolerance at the same shapes. Inputs come from a seeded numpy
generator; torch runs on one thread.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FWD_TOL, BWD_TOL = 2e-5, 5e-5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
BK = 64  # keys a KV tile
CASES = [  # B, Sq, Skv, H, Hkv, K, Kv, causal, window, softcap
    (2, 80, 80, 4, 2, 32, 32, True, 0, 0.0),      # causal, GQA, 2 KV tiles
    (1, 96, 96, 2, 2, 72, 32, True, 40, 0.0),     # a window; K = 72
    (1, 64, 64, 2, 1, 5, 16, True, 0, 30.0),      # softcap 30; K = 5 -> 8
    (2, 48, 70, 2, 2, 24, 16, False, 0, 0.0),     # not causal, Sq < Skv;
]                                                 # K != Kv


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit masking: half a TF32 ulp added to the
    magnitude's bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    r = v.to(torch.float32)
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def mm3(a: torch.Tensor, b: torch.Tensor, *, single: bool = False,
        step_sum: bool = False, truncate: bool = False):
    """a @ b (float32, ..., m, k) x (..., k, n) as the kernels take it: for
    each k8 step in order, lo_a.hi_b, then hi_a.lo_b, then hi_a.hi_b added
    to one float32 accumulator, as ``mma.cuh``'s ``mma_tf32x3`` does
    (``single``: hi_a.hi_b alone, one TF32 product). ``step_sum``: each
    step's three products go into an accumulator of their own, started at
    zero, which one float32 addition rounded to nearest then adds into the
    running sum (``ssd_f32.cuh``'s ``mma_tf32x3_rn``). ``truncate``: each
    m16n8k8 adds its 8 exact products to its accumulator and rounds the
    sum toward zero, as the tensor cores round; how they align the
    addends before that is not modelled. k is zero-padded to a multiple
    of 8."""
    k = a.shape[-1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)

    def mma(c, x, y):
        if truncate:
            return _toward_zero(c.double() + x.double() @ y.double())
        return c + x @ y

    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        t = torch.zeros_like(acc) if step_sum else acc
        if not single:
            t = mma(t, al[..., s], bh[..., s, :])
            t = mma(t, ah[..., s], bl[..., s, :])
        t = mma(t, ah[..., s], bh[..., s, :])
        acc = acc + t if step_sum else t
    return acc


def _heads(q, k, v):
    """(B, H, S, .) views with each kv head repeated for its G queries."""
    G = q.shape[2] // k.shape[2]
    return (q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3).repeat_interleave(
        G, 1), v.permute(0, 2, 1, 3).repeat_interleave(G, 1))


def _x(s, scale, softcap):
    """The scaled (capped) score in log2 units, as the kernels compute it,
    and the cap's derivative factor."""
    if softcap:
        t = torch.tanh(s * scale / softcap)
        return t * softcap * LOG2E, 1 - t * t
    return s * (scale * LOG2E), 1.0


def emulated_forward(q, k, v, *, causal, window, softcap, single=False):
    """The float32 body: KV tiles of 64 keys on absolute boundaries, the
    online softmax in log2 units, out = o / max(l, 1e-30) and lse =
    (m + log2(max(l, 1e-30))) ln 2."""
    B, Sq, H, K = q.shape
    Skv = k.shape[1]
    qh, kh, vh = _heads(q, k, v)
    scale = torch.tensor(K ** -0.5, dtype=torch.float32)
    mask = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                              device=q.device)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    o = torch.zeros(B, H, Sq, vh.shape[-1])
    for k0 in range(0, Skv, BK):
        keys = slice(k0, k0 + BK)
        s = mm3(qh, kh[:, :, keys].transpose(-1, -2), single=single)
        x, _ = _x(s, scale, softcap)
        x = torch.where(mask[:, keys], x, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
        p = torch.where(x == -math.inf, 0.0, torch.exp2(x - m_new[..., None]))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm3(p, vh[:, :, keys], single=single)
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    return (o / denom[..., None]).permute(0, 2, 1, 3), (m + torch.log2(
        denom)) * LN2


def emulated_backward(q, k, v, out, lse, dout, *, causal, window, softcap):
    """The backward kernels: delta, p = exp2(x - lse log2 e) where visible,
    ds = p (dp - delta) (* (1 - t^2) under a cap), dq = scale ds.K,
    dk = scale ds^T.Q and dv = p^T.dO summed over a kv head's G heads."""
    B, Sq, H, K = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qh, kh, vh = _heads(q, k, v)
    doh = dout.permute(0, 2, 1, 3)
    scale = torch.tensor(K ** -0.5, dtype=torch.float32)
    mask = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                              device=q.device)
    delta = (dout * out).sum(-1).permute(0, 2, 1)
    x, dcap = _x(mm3(qh, kh.transpose(-1, -2)), scale, softcap)
    p = torch.where(mask, torch.exp2(x - lse[..., None] * LOG2E), 0.0)
    ds = p * (mm3(doh, vh.transpose(-1, -2)) - delta[..., None]) * dcap
    dq = scale * mm3(ds, kh)
    G = H // Hkv
    dk = (scale * mm3(ds.transpose(-1, -2), qh)).view(B, Hkv, G, Skv, K)
    dv = mm3(p.transpose(-1, -2), doh).view(B, Hkv, G, Skv, -1)
    return (dq.permute(0, 2, 1, 3), dk.sum(2).permute(0, 2, 1, 3),
            dv.sum(2).permute(0, 2, 1, 3))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(
    map(str, c)))
def case(request):
    """The case's inputs, JAX's out and lse, and its grads of
    sum(sin(out))."""
    B, Sq, Skv, H, Hkv, K, Kv, causal, window, cap = request.param
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, K), (B, Skv, Hkv, K), (B, Skv, Hkv, Kv)))
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_ref._fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=128, block_k=128,
                                   **kw)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(
        flash_ref.flash_attention(*a, block_q=128, block_k=128, **kw))),
        argnums=(0, 1, 2)))(q, k, v)
    return dict(t=[torch.from_numpy(a) for a in (q, k, v)], kw=kw,
                out=np.asarray(out), lse=np.asarray(lse).reshape(B, H, Sq),
                grads=[np.asarray(g) for g in grads])


def test_tf32_rounding_and_the_split():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(4096) * np.exp2(
        rng.integers(-20, 20, 4096))).astype(np.float32))
    hi, lo = split(x)
    assert bool((hi.view(torch.int32) & 0x1fff).eq(0).all())
    assert bool((lo.view(torch.int32) & 0x1fff).eq(0).all())
    # hi is x to nearest at 10 mantissa bits, ties away from zero
    ulp = torch.exp2(torch.floor(torch.log2(x.abs().double())) - 10)
    assert bool(((x.double() - hi.double()).abs() <= ulp / 2).all())
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2 ** -22 * x.abs().double()).all())


def test_emulated_forward_matches_jax(case):
    out, lse = emulated_forward(*case["t"], **case["kw"])
    _close(out, case["out"], FWD_TOL)
    _close(lse, case["lse"], FWD_TOL)


def test_one_tf32_product_misses_the_forward_tolerance(case):
    out, _ = emulated_forward(*case["t"], single=True, **case["kw"])
    err = np.abs(out.numpy() - case["out"])
    assert (err > FWD_TOL + FWD_TOL * np.abs(case["out"])).any()


def test_emulated_backward_matches_jax_grad(case):
    out, lse = emulated_forward(*case["t"], **case["kw"])
    dout = torch.cos(torch.tensor(case["out"]))
    got = emulated_backward(*case["t"], out, lse, dout, **case["kw"])
    for g, want in zip(got, case["grads"]):
        _close(g, want, BWD_TOL)

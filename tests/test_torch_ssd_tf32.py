"""The arithmetic of the float32 SSD scan and its backward on the tensor
cores, emulated on the CPU, against JAX's scan and its VJP.

``csrc/ssd_scan.cu`` (its float32 body), ``csrc/ssd_f32.cuh`` and
``csrc/ssd_scan_bwd.cu`` cut the sequence into 64-position chunks (a
ragged last chunk padded with zeros) and run every product as split TF32:
each operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a
product is lo.hi + hi.lo + hi.hi, three ``mma.sync.m16n8k8`` a k8 step
into an accumulator of the step's own, which one float32 addition rounded
to nearest adds into the running sum (``ssd_f32.cuh``'s
``mma_tf32x3_rn``); each m16n8k8 rounds its sum toward zero, as the
tensor cores do (``test_torch_tf32_split.mm3`` with ``step_sum`` and
``truncate``). Here torch reproduces their decomposition: each chunk's
running sum of dt * A one addition at a time, its own state (wk x)^T.B
and G = C.B^T, the float32 pass over the chunks; y = exp(cum) (C.S^T) +
M.x + D x; for the backward each chunk's own part of the state's gradient
(exp(cum) dy)^T.C, the reverse pass from dstate, R = dy.x^T, Q's row and
column sums, E = B.dS^T, Z = C.S^T, dx = M^T.dy + wk E + D dy, dcum's
reverse running sum within the chunk, ddt, dA, dD, and dB / dC as
(wk x).dS + dG^T.C and (exp(cum) dy).S + dG.B added over a group's heads.

The emulated outputs are held to ``repro.kernels.ref.ssd_scan_seq`` and
the gradients to ``jax.vjp`` of it, at the card's tolerances: y and the
final state within 5e-5 abs + rel element by element against JAX cut
where the kernels cut (64 positions) and within 5e-5 of max|JAX| at the
caller's chunk; every gradient within 5e-5 abs + 5e-5 max|JAX| at the
64-position cut and within 1e-4 of max|JAX| at the caller's chunk. Shapes:
a ragged S with two groups, the JAX suite's draw (tests/test_kernels.py),
mamba2's widths (hd 64, ds 128) and two 64-row pieces of hd (hd 80), with
and without a gradient of the final state. One TF32 product alone (hi.hi)
misses the forward's tolerance: the reason for the split. Where the
running sum grows, one truncating accumulator over a product's 3 x 16
steps (C.S^T at ds 128) loses several times what the step sums lose: the
reason for ``mma_tf32x3_rn``. The model truncates only each m16n8k8's
sum, so it drifts less than the card did: the scan's one-accumulator
drift on the card (2.75e-4 abs of y) is not reproduced here, and
``chip_smoke.py``'s phase 2 is what holds the kernels to the gate. Inputs
come from a seeded numpy generator; torch runs on one thread.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_tf32_split import mm3  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

CL = 64              # positions a chunk: where the kernels cut
FWD_TOL = 5e-5       # chip_smoke.py SSD_TOL["float32"]
BWD_TOL = 5e-5       # abs + rel of max|JAX|, at the cut (BWD_TOL)
CUT_TOL = 1e-4       # of max|JAX|, at the caller's chunk (SSD_BWD_CUT_TOL)
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")
SHAPES = [  # (B, S, nh, hd, ng, ds, chunk, draw)
    (2, 96, 4, 16, 2, 24, 32, "model"),     # ragged at the cut, two groups
    (2, 128, 4, 16, 2, 16, 32, "suite"),    # the JAX suite's draw
    (1, 128, 4, 64, 1, 128, 128, "model"),  # mamba2's hd and ds
    (1, 128, 2, 80, 1, 32, 64, "model"),    # two 64-row pieces of hd
]


def mm(a, b, *, single=False):
    """a @ b as the kernels take it (``mma_tf32x3_rn`` on truncating
    tensor cores)."""
    return mm3(a, b, single=single, step_sum=True, truncate=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, nh, hd, ng, ds, draw, seed=0):
    """x, B, C, dy, dstate ~ N(0, 1); D ~ N(0, 1). "model": dt =
    softplus(N(0, 1) + the mamba2 init's dt bias, dt 0.001-0.1 at 0), A =
    -exp(U(0, log 16)), as chip_smoke.py's model-like draw; "suite": dt =
    softplus(N(0, 1)), A = -exp(N(0, 1)). float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd))
    if draw == "model":
        bias = np.log(np.expm1(np.linspace(1e-3, 1e-1, nh)))
        dt = np.logaddexp(rng.standard_normal((B, S, nh)) + bias, 0.0)
        A = -np.exp(rng.uniform(0.0, np.log(16.0), nh))
    else:
        dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0.0)
        A = -np.exp(rng.standard_normal(nh))
    B_ = rng.standard_normal((B, S, ng, ds))
    C_ = rng.standard_normal((B, S, ng, ds))
    D = rng.standard_normal(nh)
    dy = rng.standard_normal((B, S, nh, hd))
    dstate = rng.standard_normal((B, nh, hd, ds))
    f = np.float32
    return ([a.astype(f) for a in (x, dt, A, B_, C_, D)], dy.astype(f),
            dstate.astype(f))


def _chunks(a, nc):
    """(B, S, ...) -> (B, nc, CL, ...), the last chunk padded with zeros."""
    pad = nc * CL - a.shape[1]
    if pad:
        a = torch.cat([a, a.new_zeros(a.shape[0], pad, *a.shape[2:])], 1)
    return a.reshape(a.shape[0], nc, CL, *a.shape[2:])


def _t(a):
    """(B, nc, nh, m, k) -> its transpose in the last two dims."""
    return a.transpose(-1, -2)


def _forward_parts(x, dt, A, B_, C_, *, single=False):
    """What the chunk-state kernel and the state pass leave: per chunk the
    running sums, dt, wk, exp(cum), G per head, and the state entering it
    (B, nc, nh, hd, ds); and the final state."""
    Bb, S, nh, hd = x.shape
    ng = B_.shape[2]
    rep, nc = nh // ng, -(-S // CL)
    xc, dtc = _chunks(x, nc), _chunks(dt, nc)                # (B, nc, CL, nh, .)
    Bc = _chunks(B_, nc).permute(0, 1, 3, 2, 4)              # (B, nc, ng, CL, ds)
    Cc = _chunks(C_, nc).permute(0, 1, 3, 2, 4)
    cum = torch.empty_like(dtc)
    run = torch.zeros_like(dtc[:, :, 0])
    for i in range(CL):                          # one addition at a time
        run = run + dtc[:, :, i] * A
        cum[:, :, i] = run
    last = cum[:, :, -1]                                     # (B, nc, nh)
    wk = dtc * torch.exp(last[:, :, None] - cum)             # (B, nc, CL, nh)
    xh = xc.permute(0, 1, 3, 2, 4)                           # (B, nc, nh, CL, hd)
    Bh, Ch = (a.repeat_interleave(rep, 2) for a in (Bc, Cc))
    own = mm(_t(xh * wk.transpose(2, 3)[..., None]), Bh, single=single)
    G = mm(Cc, _t(Bc), single=single).repeat_interleave(rep, 2)
    state = torch.zeros_like(own[:, 0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + own[:, c]
    return dict(nc=nc, cum=cum.transpose(2, 3), dt=dtc.transpose(2, 3),
                wk=wk.transpose(2, 3), ec=torch.exp(cum).transpose(2, 3),
                last=last, xh=xh, Bh=Bh, Ch=Ch, G=G,
                S=torch.stack(entering, 1), state=state)


def _lower(cum):
    """exp(cum[t] - cum[k]) for k <= t, else 0: (..., CL) -> (..., CL, CL)."""
    tri = torch.ones(CL, CL, dtype=torch.bool).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    return torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)


def _back(a, S):
    """(B, nc, nh, CL, .) -> (B, S, nh, .)."""
    Bb, nc, nh, _, m = a.shape
    return a.permute(0, 1, 3, 2, 4).reshape(Bb, nc * CL, nh, m)[:, :S]


def emulated_forward(x, dt, A, B_, C_, D, *, single=False):
    """y (B, S, nh, hd) and the final state, as the float32 body computes
    them."""
    f = _forward_parts(x, dt, A, B_, C_, single=single)
    M = f["G"] * _lower(f["cum"]) * f["dt"][..., None, :]
    y = (mm(f["Ch"], _t(f["S"]), single=single) * f["ec"][..., None]
         + mm(M, f["xh"], single=single))
    return _back(y, x.shape[1]) + x * D[:, None], f["state"]


def emulated_backward(x, dt, A, B_, C_, D, dy, dstate):
    """(dx, ddt, dA, dB, dC, dD) as the backward's kernels compute them."""
    Bb, S, nh, hd = x.shape
    ng = B_.shape[2]
    f = _forward_parts(x, dt, A, B_, C_)
    nc, cum, dtk, wk, ec = f["nc"], f["cum"], f["dt"], f["wk"], f["ec"]
    xh, Bh, Ch, G, Sc = f["xh"], f["Bh"], f["Ch"], f["G"], f["S"]
    yh = _chunks(dy, nc).permute(0, 1, 3, 2, 4)              # (B, nc, nh, CL, hd)
    own = mm(_t(yh * ec[..., None]), Ch)                    # (B, nc, nh, hd, ds)
    decay = torch.exp(f["last"])
    run = torch.zeros_like(own[:, 0]) if dstate is None else dstate.clone()
    dL = [None] * nc
    for c in reversed(range(nc)):        # the gradient of the state leaving c
        dL[c] = run
        run = run * decay[:, c][..., None, None] + own[:, c]
    dL = torch.stack(dL, 1)

    w = _lower(cum)
    R = mm(yh, _t(xh))                                      # [t, k]
    Q = G * w * R
    rowP = (Q * dtk[..., None, :]).sum(-1)
    colQ = Q.sum(-2)
    M = G * w * dtk[..., None, :]
    E = mm(Bh, _t(dL))                                      # [k, p]
    Z = mm(Ch, _t(Sc))                                      # [t, p]
    dx = mm(_t(M), yh) + wk[..., None] * E + D[:, None, None] * yh
    V, W = (xh * E).sum(-1), (yh * Z).sum(-1)
    dot = (dL * Sc).sum((-2, -1))
    dcum = rowP - dtk * colQ + ec * W - wk * V
    dcum[..., -1] += decay * dot + (wk * V).sum(-1)
    rc = torch.empty_like(dcum)
    acc = torch.zeros_like(dcum[..., 0])
    for t in reversed(range(CL)):        # restarts each chunk
        acc = acc + dcum[..., t]
        rc[..., t] = acc
    dec = torch.exp(f["last"][..., None] - cum)
    ddt = colQ + dec * V + A[:, None] * rc
    dA = (dtk * rc).sum((0, 1, 3))
    dD = torch.diagonal(R, dim1=-2, dim2=-1).sum((0, 1, 3))
    dG = w * dtk[..., None, :] * R
    dBh = mm(xh * wk[..., None], dL) + mm(_t(dG), Ch)     # (B, nc, nh, CL, ds)
    dCh = mm(yh * ec[..., None], Sc) + mm(dG, Bh)
    rep = nh // ng
    dB, dC = (a.reshape(Bb, nc, ng, rep, CL, -1).sum(3) for a in (dBh, dCh))
    return (_back(dx, S), _back(ddt[..., None], S)[..., 0], dA, _back(dB, S),
            _back(dC, S), dD)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "-".join(
    map(str, s)))
def case(request):
    """The inputs, JAX's (y, state) and its VJP at the caller's chunk and,
    where 64 divides S, at the kernels' cut; with and without dstate."""
    B, S, nh, hd, ng, ds, chunk, draw = request.param
    args, dy, dstate = _inputs(B, S, nh, hd, ng, ds, draw)
    jax_out = {}
    for c in {chunk} | ({CL} if S % CL == 0 else set()):
        out, vjp = jax.vjp(lambda *a, c=c: jref.ssd_scan_seq(*a, chunk=c),
                           *map(jnp.asarray, args))
        grads = {}
        for name, st in (("with", dstate), ("without", None)):
            cot = jnp.zeros_like(out[1]) if st is None else jnp.asarray(st)
            grads[name] = [np.asarray(g) for g in vjp((jnp.asarray(dy), cot))]
        jax_out[c] = ([np.asarray(o) for o in out], grads)
    return dict(args=[torch.from_numpy(a) for a in args],
                dy=torch.from_numpy(dy), dstate=torch.from_numpy(dstate),
                chunk=chunk, S=S, jax=jax_out)


def test_emulated_forward_matches_jax(case):
    y, state = emulated_forward(*case["args"])
    want = case["jax"][case["chunk"]][0]
    for got, w in zip((y, state), want):
        scale = float(np.abs(w).max())
        assert float(np.abs(got.numpy() - w).max()) <= FWD_TOL * scale
    if CL in case["jax"]:
        for got, w in zip((y, state), case["jax"][CL][0]):
            np.testing.assert_allclose(got.numpy(), w, atol=FWD_TOL,
                                       rtol=FWD_TOL)


def test_one_tf32_product_misses_the_forward_tolerance(case):
    y, state = emulated_forward(*case["args"], single=True)
    want = case["jax"][case["chunk"]][0]
    err = [np.abs(g.numpy() - w) - FWD_TOL - FWD_TOL * np.abs(w)
           for g, w in zip((y, state), want)]
    assert max(float(e.max()) for e in err) > 0


@pytest.mark.parametrize("with_state", [True, False])
def test_emulated_backward_matches_jax_vjp(case, with_state):
    st = case["dstate"] if with_state else None
    got = emulated_backward(*case["args"], case["dy"], st)
    key = "with" if with_state else "without"
    for c, tol in ((CL, None), (case["chunk"], CUT_TOL)):
        if c not in case["jax"]:
            continue
        for name, g, w in zip(GRADS, got, case["jax"][c][1][key]):
            assert g.shape == w.shape, name
            scale = float(np.abs(w).max())
            err = float(np.abs(g.numpy() - w).max())
            bound = (BWD_TOL + BWD_TOL * scale) if tol is None else tol * scale
            assert err <= bound, (c, name, err, bound)


def test_step_sums_hold_what_one_truncating_accumulator_loses():
    """C.S^T at mamba2's ds (k = 128: 16 k8 steps, 48 m16n8k8) with
    positive terms, so that the running sum grows. Against the exact
    product, one truncating accumulator (``mma_tf32x3`` on the tensor
    cores) loses ~8 float32 ulps of the result, all toward zero; the step
    sums of ``mma_tf32x3_rn`` lose ~0.5 on average and at most 3."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.0, 1.0, (128, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    ulp = exact.abs() * 2.0 ** -23
    one = (exact - mm3(a, b, truncate=True).double()) / ulp
    step = (exact - mm(a, b).double()) / ulp
    assert float(one.min()) > 0.0
    assert float(one.mean()) > 10 * float(step.abs().mean())
    assert float(step.abs().max()) <= 3.0

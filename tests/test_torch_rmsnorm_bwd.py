"""The partition and the summation order of the port's RMSNorm backward
kernel (``csrc/rmsnorm_bwd.cu``), on the CPU.

``kernels.rmsnorm.bwd_partition`` splits a tensor's rows into the rows
pass's blocks; it must be a function of (rows, D) alone and cover every
row exactly once, so a tensor's dscale has the same bits alone and in a
pair. ``_emulate`` repeats the kernel's order in numpy float32: each
lane's elements in slot order (fmaf), a xor-shuffle tree over a warp's
lanes, the warps in order, then dscale per lane over the rows its group
walks, the groups of a block in order, and the block partials in eight
runs of block order, the runs in order. It is held to ``jax.grad`` of
JAX's ``rmsnorm_fwd`` within 5e-5 abs + rel (tests/test_kernels.py's
grad tolerance), at the kernel's layouts (one warp a row at D = 128 up to
8 warps of 8 vectors, the one-element path's D = 1000 and the looping
body past 8192), with enough rows for many blocks and runs. Inputs come
from a seeded numpy generator. The file takes about 15 s (20 s with its
imports), most of it JAX compiling each shape's gradient.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = 5e-5
EPS = 1e-6
RUNS = 8          # runs of block partials in the kernel's dscale pass
F32 = np.float32


def _rows_of(rows: int, D: int) -> np.ndarray:
    """Every (block, group, row) the rows pass walks, as rows in walk
    order, from ``bwd_partition`` and ``bwd_groups`` alone."""
    per, blocks = rn.bwd_partition(rows, D)
    _, _, R, U = rn.bwd_groups(D)
    b = np.arange(blocks)[:, None, None, None]
    it = np.arange(per // (R * U))[None, :, None, None]
    q = np.arange(R)[None, None, :, None]
    u = np.arange(U)[None, None, None, :]
    row = b * per + it * R * U + q * U + u
    return row[row < np.minimum(rows, (b + 1) * per)]


@pytest.mark.parametrize("D", [128, 512, 1024, 5376])
@pytest.mark.parametrize("rows", [0, 1, 3, 37, 4096, 98304])
def test_bwd_partition_covers_each_row_once(rows, D):
    per, blocks = rn.bwd_partition(rows, D)
    rn.bwd_partition.cache_clear()
    assert rn.bwd_partition(rows, D) == (per, blocks)   # recomputed alike
    _, _, R, U = rn.bwd_groups(D)
    assert per % (R * U) == 0 and 0 <= blocks <= rn.BWD_MAX_BLOCKS
    assert blocks == -(-rows // per)                     # none empty
    walked = _rows_of(rows, D)
    assert np.array_equal(np.bincount(walked, minlength=rows),
                          np.ones(rows, dtype=np.int64))


def _fma(a, b, c):
    """fmaf in float32 (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _emulate(x, s, g, eps):
    """(dx, dscale) in the kernel's order of summation, float32."""
    rows, D = x.shape
    W, N, R, U = rn.bwd_groups(D)
    per, blocks = rn.bwd_partition(rows, D)
    lanes = 32 * W
    # lane t's elements in its order: slot n, element e of vector n L + t
    order = np.arange(N * lanes * 4).reshape(N, lanes, 4)
    order = order.transpose(1, 0, 2).reshape(lanes, N * 4)
    valid = order < D
    at = np.minimum(order, D - 1)
    gs = (g * s).astype(F32)
    xo, go = x[:, at], gs[:, at]                      # (rows, lanes, N*4)
    ss = np.zeros((rows, lanes), F32)
    sg = np.zeros((rows, lanes), F32)
    for k in range(N * 4):
        ss = np.where(valid[:, k], _fma(xo[..., k], xo[..., k], ss), ss)
        sg = np.where(valid[:, k], _fma(xo[..., k], go[..., k], sg), sg)

    def warps_in_order(v):
        v = v.reshape(rows, W, 32)
        lane = np.arange(32)
        for o in (16, 8, 4, 2, 1):                    # the xor tree
            v = (v + v[..., lane ^ o]).astype(F32)
        total = v[:, 0, 0]
        for w in range(1, W):
            total = (total + v[:, w, 0]).astype(F32)
        return total
    tss, tsg = warps_in_order(ss), warps_in_order(sg)
    r = (1.0 / np.sqrt((tss / F32(D)).astype(F32) + F32(eps))).astype(F32)
    coef = (r * r * r * (tsg / F32(D)).astype(F32)).astype(F32)
    dx = _fma(-x, coef[:, None], (r[:, None] * gs).astype(F32))

    gx = (g * x).astype(F32)
    partials = []
    for b in range(blocks):
        r0, r1 = b * per, min(rows, (b + 1) * per)
        acc = np.zeros((R, D), F32)
        for base in range(r0, r1, R * U):
            for q in range(R):
                for u in range(U):
                    row = base + q * U + u
                    if row < r1:
                        acc[q] = _fma(gx[row], r[row], acc[q])
        part = acc[0]
        for q in range(1, R):
            part = (part + acc[q]).astype(F32)
        partials.append(part)
    length = -(-blocks // RUNS)
    runs = []
    for run in range(RUNS):
        a = np.zeros(D, F32)
        for b in range(run * length, min(blocks, (run + 1) * length)):
            a = (a + partials[b]).astype(F32)
        runs.append(a)
    dscale = runs[0]
    for run in runs[1:]:
        dscale = (dscale + run).astype(F32)
    return dx, dscale


@pytest.mark.parametrize("rows,D", [
    (37, 128),        # one warp a row, four rows in flight
    (9000, 128),      # 141 blocks: every run of the dscale pass
    (300, 512),       # 4 warps, one vector a lane
    (9, 1024),        # qwen3's block norm: 4 warps, two vectors a lane
    (40, 2048),       # 8 warps, two vectors
    (300, 5376),      # 8 warps, eight vectors: 150 blocks of 2 rows
    (6, 1000),        # the one-element path's width
    (3, 9000),        # past 8 vectors a lane: the looping body
])
def test_kernel_order_matches_jax_grad(rows, D):
    rng = np.random.default_rng(rows * 7 + D)
    x = rng.standard_normal((rows, D)).astype(F32)
    s = (1 + 0.1 * rng.standard_normal(D)).astype(F32)
    g = rng.standard_normal((rows, D)).astype(F32)

    def f(x, s):
        return jnp.sum(jlayers.rmsnorm_fwd({"scale": s}, x, EPS) * g)
    want = [np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(x, s)]
    got = _emulate(x, s, g, EPS)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=TOL, rtol=TOL)

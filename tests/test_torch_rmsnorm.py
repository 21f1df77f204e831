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
goes through ``ops.rmsnorm`` to the plain version, bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
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

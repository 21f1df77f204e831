"""The split body of the bf16/f32 decode kernels, on the CPU: the
wrapper's split arithmetic, and the CPU path of ``ops.decode_attention``
and ``ops.paged_decode_attention`` at lengths around a split's edge.

On the card ``decode_attention`` and ``paged_decode_attention`` cut each
row into splits of ``SPLIT`` logical positions and merge them through a
float32 workspace (``csrc/decode_split.cuh``); ``split_layout`` is that
arithmetic in plain Python, held here without any build. A CPU tensor
still takes the plain version through ``ops`` (no launch counted), which
must agree with the JAX oracle at the lengths where the card's splits
begin and end (f32 within 2e-5, as tests/test_kernels.py). A row of
length 0 is the one documented difference (the port gives 0) and is held
against 0 alone.
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

TOL = 2e-5


@pytest.mark.parametrize("extent,nsplit", [
    (0, 0), (1, 1), (63, 1), (64, 1), (65, 2), (100, 2), (128, 2),
    (512, 8), (520, 9), (2048, 32),
])
def test_split_layout_counts_splits_and_sizes_the_workspace(extent, nsplit):
    B, Hkv, G, K = 4, 8, 2, 128
    got, shape = da.split_layout(extent, B, Hkv, G, K)
    assert got == nsplit
    # G*K context floats per (row, kv head, split), then a max and a
    # normaliser per query head
    assert shape == (B * Hkv * nsplit * G * (K + 2),)


def test_split_is_the_kernels_positions_per_split():
    """The wrapper sizes the workspace with SPLIT and passes it; the
    kernel refuses any split but its own P, so the two must agree."""
    header = (pathlib.Path(da.__file__).parent / "csrc"
              / "decode_split.cuh").read_text()
    assert re.search(r"constexpr int P = (\d+);", header).group(1) == str(
        da.SPLIT)


def test_split_layout_needs_no_extension(monkeypatch):
    """The arithmetic is plain Python: it never builds or loads the
    kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("split_layout reached the kernel build")
    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "extension", refuse)
    assert da.split_layout(300, 3, 8, 2, 128) == (5, (3 * 8 * 5 * 2 * 130,))


def _edge_lengths(W: int) -> list[int]:
    """A split's last position, its edge, the next split's first, an
    empty row and the full horizon."""
    P = da.SPLIT
    return [P - 1, P, P + 1, 0, W]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("W", [2 * da.SPLIT + 16, 2048])
@pytest.mark.parametrize("H,Hkv,K,softcap", [
    (16, 8, 128, 0.0),     # qwen3-0.6b heads, G = 2
    (8, 8, 256, 30.0),     # G = 1, the widest K, softcap
    (16, 4, 64, 0.0),      # G = 4
    (16, 2, 32, 20.0),     # G = 8, the narrowest K, softcap
    (32, 32, 112, 0.0),    # zamba2-7b: G = 1, K = 112
    (48, 8, 128, 30.0),    # mixtral-8x22b, internvl2-26b: G = 6
])
def test_ops_on_cpu_matches_the_jax_oracle_at_split_edges(W, H, Hkv, K,
                                                          softcap):
    bs = 16
    lengths = np.array(_edge_lengths(W), dtype=np.int32)
    B, nblk = len(lengths), W // bs
    rng = np.random.default_rng(W + K)
    q = rng.standard_normal((B, H, K)).astype(np.float32)
    n_pages = 2 * B * nblk
    kp = rng.standard_normal((n_pages + 1, bs, Hkv, K)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, bs, Hkv, K)).astype(np.float32)
    table = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(
        np.int32)
    k = kp[table].reshape(B, W, Hkv, K)
    v = vp[table].reshape(B, W, Hkv, K)
    valid = np.arange(W)[None, :] < lengths[:, None]
    live = lengths > 0

    ops.reset_launch_counts()
    dense = ops.decode_attention(*map(torch.from_numpy, (q, k, v, valid)),
                                 softcap=softcap)
    paged = ops.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, table, lengths)),
        softcap=softcap)
    assert set(ops.launch_counts().values()) == {0}
    assert dense.shape == paged.shape == (B, H, K)
    assert torch.equal(dense, paged)
    assert bool((dense[~torch.from_numpy(live)] == 0).all())
    want_dense = jref.decode_attention(*map(jnp.asarray, (q, k, v, valid)),
                                       softcap=softcap)
    want_paged = jref.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, table, lengths)), softcap=softcap)
    _close(dense[live], np.asarray(want_dense)[live])
    _close(paged[live], np.asarray(want_paged)[live])

"""The int8 split body of the int8 decode kernels, on the CPU: the
wrappers' use of the split arithmetic and their alignment refusal without
any build, and the CPU path of ``ops.decode_attention`` and
``ops.paged_decode_attention`` with scales at lengths around a split's
edge.

On the card ``decode_attention_int8`` and ``paged_decode_attention_int8``
cut each row into splits of ``SPLIT`` logical positions and merge them
through a float32 workspace (``csrc/decode_int8_split.cuh``, reusing
``csrc/decode_split.cuh``'s positions a split, address policies and
merge). Here the wrappers run with their CUDA checks and the extension
replaced by stand-ins, which shows what they size and pass and that they
refuse int8 codes not on 16 bytes before anything is built. A CPU tensor
still takes the plain version through ``ops`` (no launch counted), which
must agree with the JAX oracle and with the Pallas int8 kernels in
interpret mode at the lengths where the card's splits begin and end
(f32 within 2e-5, as tests/test_kernels.py). A row of length 0 is the one
documented difference (the port gives 0) and is held against 0 alone.
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
from repro.kernels.decode_attention import \
    decode_attention_int8 as pallas_int8  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention_int8 as pallas_paged_int8  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.attention import _quant_kv  # noqa: E402

TOL = 2e-5
CSRC = pathlib.Path(da.__file__).parent / "csrc"


# ---------------------------------------------------------------------------
# the wrappers, without a build
# ---------------------------------------------------------------------------
class _Extension:
    """Records the int8 entry points' arguments and reports success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if name not in ("decode_attention_int8",
                        "paged_decode_attention_int8"):
            raise AttributeError(name)

        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def no_card(monkeypatch):
    """The int8 wrappers with CPU tensors: their device checks pass, the
    stream is 0, the extension and split_layout record their calls, and
    any build is refused."""
    def refuse(*args, **kwargs):
        raise AssertionError("an int8 wrapper reached the kernel build")
    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "extension", refuse)
    ext = _Extension()
    layouts, real = [], da.split_layout

    def split_layout(*args):
        layouts.append(args)
        return real(*args)
    for mod in (da, pa):
        monkeypatch.setattr(mod, "check_cuda", lambda *a, **k: None)
        monkeypatch.setattr(mod, "extension", lambda: ext)
        monkeypatch.setattr(mod, "split_layout", split_layout)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return ext, layouts


def _codes(*shape, offset=0):
    """int8 zeros of ``shape`` starting ``offset`` bytes into a 16-byte
    aligned buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 16 + offset, dtype=torch.int8)
    start = (-buf.data_ptr()) % 16 + offset
    return buf[start:start + n].reshape(shape)


def _dense_args(B=3, W=200, H=16, Hkv=8, K=128, offset=0):
    q = torch.zeros(B, H, K)
    k, v = _codes(B, W, Hkv, K, offset=offset), _codes(B, W, Hkv, K)
    s = torch.ones(B, W, Hkv)
    return q, k, v, torch.ones(B, W, dtype=torch.bool), s, s.clone()


def _paged_args(B=3, nblk=13, bs=16, H=16, Hkv=8, K=128, offset=0):
    q = torch.zeros(B, H, K)
    n = B * nblk + 1
    k, v = _codes(n, bs, Hkv, K), _codes(n, bs, Hkv, K, offset=offset)
    s = torch.ones(n, bs, Hkv)
    table = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    return (q, k, v, s, s.clone(), table,
            torch.full((B,), 100, dtype=torch.int32))


@pytest.mark.parametrize("H,Hkv,K", [(16, 8, 128), (16, 2, 64), (8, 8, 256)])
def test_dense_int8_wrapper_sizes_the_workspace_with_split_layout(no_card, H,
                                                                  Hkv, K):
    ext, layouts = no_card
    B, W = 3, 200
    before = ops.launch_counts()["decode_attention_int8"]
    out = da.decode_attention_int8(*_dense_args(B, W, H, Hkv, K))
    assert out.shape == (B, H, K)
    assert layouts == [(W, B, Hkv, H // Hkv, K)]
    args = ext.calls["decode_attention_int8"]
    # ..., out, work, B, W, H, Hkv, K, split, scale, softcap, bf16, stream
    assert args[8:14] == (B, W, H, Hkv, K, da.SPLIT)
    assert args[14] == K ** -0.5
    assert ops.launch_counts()["decode_attention_int8"] == before + 1


@pytest.mark.parametrize("nblk,bs", [(13, 16), (4, 8), (128, 16)])
def test_paged_int8_wrapper_sizes_the_workspace_with_split_layout(no_card,
                                                                  nblk, bs):
    ext, layouts = no_card
    B, H, Hkv, K = 3, 16, 8, 128
    before = ops.launch_counts()["paged_decode_attention_int8"]
    out = pa.paged_decode_attention_int8(*_paged_args(B, nblk, bs, H, Hkv,
                                                      K))
    assert out.shape == (B, H, K)
    assert layouts == [(nblk * bs, B, Hkv, H // Hkv, K)]
    args = ext.calls["paged_decode_attention_int8"]
    # ..., out, work, B, nblk, bs, H, Hkv, K, split, scale, ...
    assert args[9:16] == (B, nblk, bs, H, Hkv, K, da.SPLIT)
    assert ops.launch_counts()["paged_decode_attention_int8"] == before + 1


def test_int8_wrappers_with_no_rows_launch_nothing(no_card):
    ext, _ = no_card
    assert da.decode_attention_int8(*_dense_args(B=0)).shape == (0, 16, 128)
    assert pa.paged_decode_attention_int8(
        *_paged_args(B=0)).shape == (0, 16, 128)
    assert not ext.calls


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_int8_wrappers_refuse_codes_off_16_bytes(no_card, offset):
    ext, _ = no_card
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.decode_attention_int8(*_dense_args(offset=offset))
    with pytest.raises(ValueError, match="16-byte aligned"):
        pa.paged_decode_attention_int8(*_paged_args(offset=offset))
    assert not ext.calls


def test_int8_header_reuses_the_split_bodys_positions_and_merge():
    """The int8 body takes decode_split.cuh's P (which the wrappers' SPLIT
    must equal), address policies and merge, and defines none of its own."""
    header = (CSRC / "decode_int8_split.cuh").read_text()
    assert '#include "decode_split.cuh"' in header
    for name in ("P", "NW", "DenseSplit", "PagedSplit",
                 "decode_merge_kernel"):
        assert f"using decode_split_detail::{name};" in header
    assert not re.search(r"constexpr int P\b", header)
    assert "decode_merge_kernel<T, G, K>" in header
    split = (CSRC / "decode_split.cuh").read_text()
    assert re.search(r"constexpr int P = (\d+);", split).group(1) == str(
        da.SPLIT)


# ---------------------------------------------------------------------------
# the CPU path at the split edges, against JAX
# ---------------------------------------------------------------------------
def _quant_np(x):
    q, s = _quant_kv(torch.from_numpy(x))
    return q.numpy(), s.numpy()


def _edge_lengths(edges: str, W: int) -> list[int]:
    """A split's last position, its edge, the next split's first, an
    empty or one-position row and the full horizon (or one short)."""
    P = da.SPLIT
    return ([P - 1, P, P + 1, 0, W] if edges == "first"
            else [2 * P - 1, 2 * P, 2 * P + 1, 1, W - 1])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("edges", ["first", "second"])
@pytest.mark.parametrize("W", [2 * da.SPLIT + 16 + 16 * 8, 2048])
@pytest.mark.parametrize("H,Hkv,K,softcap", [
    (16, 8, 128, 0.0),     # qwen3-0.6b heads, G = 2
    (8, 8, 256, 30.0),     # G = 1, the widest K, softcap
    (16, 4, 64, 0.0),      # G = 4
    (16, 2, 32, 20.0),     # G = 8, the narrowest K, softcap
])
def test_int8_ops_on_cpu_match_jax_at_split_edges(edges, W, H, Hkv, K,
                                                  softcap):
    bs = 16
    lengths = np.array(_edge_lengths(edges, W), dtype=np.int32)
    B, nblk = len(lengths), W // bs
    rng = np.random.default_rng(W + K + len(edges))
    q = rng.standard_normal((B, H, K)).astype(np.float32)
    n_pages = 2 * B * nblk
    kq, ks = _quant_np(rng.standard_normal((n_pages + 1, bs, Hkv, K))
                       .astype(np.float32))
    vq, vs = _quant_np(rng.standard_normal((n_pages + 1, bs, Hkv, K))
                       .astype(np.float32))
    table = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(
        np.int32)
    k, v = kq[table].reshape(B, W, Hkv, K), vq[table].reshape(B, W, Hkv, K)
    k_s, v_s = ks[table].reshape(B, W, Hkv), vs[table].reshape(B, W, Hkv)
    valid = np.arange(W)[None, :] < lengths[:, None]
    live = lengths > 0

    ops.reset_launch_counts()
    t = torch.from_numpy
    dense = ops.decode_attention(t(q), t(k), t(v), t(valid), softcap=softcap,
                                 k_scale=t(k_s), v_scale=t(v_s))
    paged = ops.paged_decode_attention(
        t(q), t(kq), t(vq), t(table), t(lengths), softcap=softcap,
        k_scale_pages=t(ks), v_scale_pages=t(vs))
    assert set(ops.launch_counts().values()) == {0}
    assert dense.shape == paged.shape == (B, H, K)
    assert torch.equal(dense, paged)
    assert bool((dense[~t(live)] == 0).all())

    j = jnp.asarray
    want = [jref.decode_attention_blocked(
                j(q), j(k), j(v), j(valid), softcap=softcap,
                k_scale=j(k_s), v_scale=j(v_s)),
            jref.paged_decode_attention(
                j(q), j(kq), j(vq), j(table), j(lengths), softcap=softcap,
                k_scale_pages=j(ks), v_scale_pages=j(vs))]
    if W < 2048:  # the Pallas int8 kernels, interpreted, at the short horizon
        want += [pallas_int8(j(q), j(k), j(v), j(valid), j(k_s), j(v_s),
                             softcap=softcap, interpret=True),
                 pallas_paged_int8(j(q), j(kq), j(vq), j(ks), j(vs),
                                   j(table), j(lengths), softcap=softcap,
                                   interpret=True)]
    for w in want:
        _close(dense[live], np.asarray(w)[live])

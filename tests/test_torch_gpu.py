"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: on a host without a CUDA device every test here skips
(the check runs inside a fixture, so every pytest worker collects the
same tests). On the card: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``. Tolerances as in tests/test_kernels.py.
"""
from __future__ import annotations

import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v) for v in tree]
    return tree.cuda()


def _assert_close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,K,Kv,window,softcap", [
    (1, 77, 77, 16, 8, 128, 128, 0, 0.0),
    (2, 30, 95, 4, 2, 64, 64, 0, 0.0),
    (1, 130, 130, 4, 4, 32, 32, 17, 0.0),
    (1, 64, 64, 8, 2, 128, 128, 0, 20.0),
    (1, 100, 100, 4, 2, 72, 64, 0, 0.0),      # K padded to the MMA depth
    (1, 130, 130, 4, 2, 192, 128, 0, 0.0),
    (1, 77, 77, 4, 2, 5, 32, 0, 0.0),         # rows not on 16 bytes
    (2, 70, 70, 4, 2, 64, 16, 0, 0.0),        # the narrowest Kv
    (1, 90, 90, 4, 1, 128, 256, 0, 0.0),      # the widest Kv, Hkv = 1
    (1, 40, 40, 4, 2, 256, 256, 0, 0.0),
    (1, 96, 96, 8, 1, 128, 128, 0, 0.0),
    (2, 1, 50, 4, 2, 128, 128, 0, 0.0),       # Sq = 1
    (1, 40, 150, 4, 2, 64, 64, 0, 0.0),       # Sq < Skv, Skv ragged
    (1, 80, 50, 4, 2, 64, 64, 0, 0.0),        # rows that see no key
    (1, 130, 130, 32, 32, 112, 112, 0, 0.0),  # zamba2-7b: Kv = 112
    (2, 77, 77, 4, 2, 112, 112, 17, 0.0),     # Kv = 112, GQA and a window
])
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Skv, H, Hkv, K, Kv,
                                    window, softcap):
    q = _randn(cuda, B, Sq, H, K, dtype=dtype)
    k = _randn(cuda, B, Skv, Hkv, K, dtype=dtype)
    v = _randn(cuda, B, Skv, Hkv, Kv, dtype=dtype)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    _assert_close(got, ref.flash_attention(q, k, v, window=window,
                                           softcap=softcap), dtype)
    # right-aligned queries: the first Sq - Skv rows see no key and give 0
    assert bool((got[:, :max(Sq - Skv, 0)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,Hkv,K", [(3, 300, 16, 8, 128),
                                         (2, 64, 4, 4, 64),
                                         (2, 100, 8, 1, 32)])
def test_decode_kernel_matches_plain(cuda, dtype, B, W, H, Hkv, K):
    q = _randn(cuda, B, H, K, dtype=dtype)
    k = _randn(cuda, B, W, Hkv, K, dtype=dtype)
    v = _randn(cuda, B, W, Hkv, K, dtype=dtype)
    valid = torch.rand(B, W, generator=cuda, device="cuda") < 0.6
    valid[-1] = False
    got = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    _assert_close(got, ref.decode_attention(q, k, v, valid), dtype)
    assert bool((got[-1] == 0).all())


def _paged_inputs(gen, lengths, H, Hkv, K, bs, nblk, dtype):
    """q, pages and a table giving each row its own scattered pages (the
    rest of its table on the scratch page, the pool's last)."""
    B = len(lengths)
    n_pages = 2 * B * nblk
    q = _randn(gen, B, H, K, dtype=dtype)
    kp = _randn(gen, n_pages + 1, bs, Hkv, K, dtype=dtype)
    vp = _randn(gen, n_pages + 1, bs, Hkv, K, dtype=dtype)
    table = torch.randperm(n_pages, generator=gen, device="cuda")[
        :B * nblk].reshape(B, nblk).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    owned = (torch.arange(nblk, device="cuda")[None, :]
             < (lens[:, None] + bs - 1) // bs)
    table[~owned] = n_pages
    return q, kp, vp, table.contiguous(), lens, owned


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,H,Hkv,K,bs,nblk,softcap", [
    ([48, 160, 300, 544], 16, 8, 128, 16, 128, 0.0),
    ([5, 0, 64, 17], 16, 8, 128, 16, 8, 30.0),
    ([90, 7, 500], 16, 4, 64, 8, 64, 0.0),
    ([33, 1], 8, 8, 32, 4, 16, 0.0),
])
def test_paged_kernel_matches_plain_and_dense_bits(cuda, dtype, lengths, H,
                                                   Hkv, K, bs, nblk,
                                                   softcap):
    q, kp, vp, table, lens, owned = _paged_inputs(cuda, lengths, H, Hkv, K,
                                                  bs, nblk, dtype)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, kp, vp, table, lens,
                                     softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    _assert_close(got, ref.paged_decode_attention(q, kp, vp, table, lens,
                                                  softcap=softcap), dtype)
    # bitwise the dense kernel over the gathered view
    B, W = len(lengths), nblk * bs
    k = kp[table.long()].reshape(B, W, Hkv, K).contiguous()
    v = vp[table.long()].reshape(B, W, Hkv, K).contiguous()
    valid = torch.arange(W, device="cuda")[None, :] < lens[:, None]
    assert torch.equal(got, ops.decode_attention(q, k, v, valid,
                                                 softcap=softcap))
    # pages no row owns (scratch included) are never read
    unowned = torch.ones(kp.shape[0], dtype=torch.bool, device="cuda")
    unowned[table[owned].long()] = False
    kp[unowned] = float("nan")
    vp[unowned] = float("nan")
    assert torch.equal(got, ops.paged_decode_attention(
        q, kp, vp, table, lens, softcap=softcap))
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


def _split_case(gen, dtype, lengths, H, Hkv, K, bs, nblk, softcap):
    """The split body on one paged case: the paged kernel against the
    plain version, bitwise against the dense kernel over the gathered
    view, unchanged with NaN in every page no row owns, length-0 rows 0;
    one launch counted per call. Returns the paged output."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, table, lens, owned = _paged_inputs(gen, lengths, H, Hkv, K,
                                                  bs, nblk, dtype)
    before = ops.launch_counts()
    got = pa.paged_decode_attention(q, kp, vp, table, lens, softcap=softcap)
    torch.cuda.synchronize()
    _assert_close(got, ref.paged_decode_attention(q, kp, vp, table, lens,
                                                  softcap=softcap), dtype)
    B, W = len(lengths), nblk * bs
    k = kp[table.long()].reshape(B, W, Hkv, K).contiguous()
    v = vp[table.long()].reshape(B, W, Hkv, K).contiguous()
    valid = torch.arange(W, device="cuda")[None, :] < lens[:, None]
    dense = da.decode_attention(q, k, v, valid, softcap=softcap)
    assert torch.equal(got, dense)
    after = ops.launch_counts()
    for name in ("decode_attention", "paged_decode_attention"):
        assert after[name] == before[name] + 1
    unowned = torch.ones(kp.shape[0], dtype=torch.bool, device="cuda")
    unowned[table[owned].long()] = False
    kp[unowned] = float("nan")
    vp[unowned] = float("nan")
    assert torch.equal(got, pa.paged_decode_attention(
        q, kp, vp, table, lens, softcap=softcap))
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edges", ["first", "second"])
def test_split_body_at_split_edges(cuda, dtype, edges):
    """Rows ending on a split's last position, its edge and the next
    split's first, an empty row, and the full 2048 horizon."""
    from repro_torch.kernels.decode_attention import SPLIT as P
    lengths = ([P - 1, P, P + 1, 0, 2048] if edges == "first"
               else [2 * P - 1, 2 * P, 2 * P + 1, 1, 2047])
    _split_case(cuda, dtype, lengths, 16, 8, 128, 16, 128, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_body_over_a_scattered_ring(cuda, dtype):
    """Live slots scattered over the ring so that live and dead splits
    alternate (every other split has no live slot), and a row with no
    live slot at all."""
    from repro_torch.kernels import decode_attention as da
    B, W, H, Hkv, K = 3, 1000, 16, 8, 128
    q = _randn(cuda, B, H, K, dtype=dtype)
    k = _randn(cuda, B, W, Hkv, K, dtype=dtype)
    v = _randn(cuda, B, W, Hkv, K, dtype=dtype)
    valid = torch.rand(B, W, generator=cuda, device="cuda") < 0.3
    pos = torch.arange(W, device="cuda")
    valid &= (pos // da.SPLIT % 2 == 0)[None, :]
    valid[-1] = False
    got = da.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    _assert_close(got, ref.decode_attention(q, k, v, valid), dtype)
    assert bool((got[-1] == 0).all())
    # dead slots are never read
    k[~valid], v[~valid] = float("nan"), float("nan")
    assert torch.equal(got, da.decode_attention(q, k, v, valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,K", [
    (8, 8, 256),      # G = 1, K = 256
    (16, 16, 32),     # G = 1, K = 32
    (16, 4, 64),      # G = 4
    (16, 4, 128),     # G = 4, K = 128
    (16, 2, 32),      # G = 8
    (16, 2, 64),      # G = 8, G*K = 512
    (16, 8, 256),     # G = 2, K = 256
    (32, 32, 112),    # G = 1, K = 112 (zamba2-7b)
    (48, 8, 128),     # G = 6, K = 128 (mixtral-8x22b, internvl2-26b)
])
def test_split_body_groups_and_head_dims(cuda, dtype, H, Hkv, K):
    _split_case(cuda, dtype, [300, 64, 0, 129], H, Hkv, K, 16, 32, 30.0)


def _horizon_case(gen, dtype, H, Hkv, K):
    """The same live prefix gives the same bits at W = 512 and W = 2048
    (dense), at nblk = 32 and 128 (paged), and dense = paged."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    lengths = [48, 160, 300, 512, 0]
    q, kp, vp, table, lens, _ = _paged_inputs(gen, lengths, H, Hkv, K, 16,
                                              128, dtype)
    long_ = pa.paged_decode_attention(q, kp, vp, table, lens)
    short = pa.paged_decode_attention(q, kp, vp, table[:, :32].contiguous(),
                                      lens)
    assert torch.equal(long_, short)
    B = len(lengths)
    k = kp[table.long()].reshape(B, 2048, Hkv, K).contiguous()
    v = vp[table.long()].reshape(B, 2048, Hkv, K).contiguous()
    valid = torch.arange(2048, device="cuda")[None, :] < lens[:, None]
    wide = da.decode_attention(q, k, v, valid)
    narrow = da.decode_attention(q, k[:, :512].contiguous(),
                                 v[:, :512].contiguous(),
                                 valid[:, :512].contiguous())
    assert torch.equal(wide, narrow)
    assert torch.equal(wide, long_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_body_bits_do_not_depend_on_the_horizon(cuda, dtype):
    """The same live prefix gives the same bits at W = 512 and W = 2048
    (dense), and at nblk = 32 and 128 (paged)."""
    _horizon_case(cuda, dtype, 16, 8, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edges", ["first", "second"])
@pytest.mark.parametrize("H,Hkv,K", [(32, 32, 112), (48, 8, 128)])
def test_split_body_new_shapes_at_edges_and_horizons(cuda, dtype, edges, H,
                                                     Hkv, K):
    """The two pairs past G·K <= 512, (G, K) = (1, 112) (lanes past a
    row's 14 or 28 loads idle) and (6, 128) (a 768-thread merge): rows at
    the split edges against the plain version, the paged kernel bit for
    bit the dense one, and the same bits at horizons 512 and 2048."""
    from repro_torch.kernels.decode_attention import SPLIT as P
    lengths = ([P - 1, P, P + 1, 0, 2048] if edges == "first"
               else [2 * P - 1, 2 * P, 2 * P + 1, 1, 2047])
    _split_case(cuda, dtype, lengths, H, Hkv, K, 16, 128, 0.0)
    _horizon_case(cuda, dtype, H, Hkv, K)


def test_split_wrappers_reject_unaligned_kv(cuda):
    q = _randn(cuda, 2, 16, 128, dtype=torch.bfloat16)
    k = _randn(cuda, 2 * 64 * 8 * 128 + 1, dtype=torch.bfloat16)[1:]
    k = k.reshape(2, 64, 8, 128)
    valid = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    lens = torch.full((2,), 64, dtype=torch.int32, device="cuda")
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.decode_attention(q, k, k, valid)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.paged_decode_attention(q, k.reshape(8, 16, 8, 128), k.clone()
                                   .reshape(8, 16, 8, 128), table, lens)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, kp, vp, table, lens, _ = _paged_inputs(cuda, [20, 9], 16, 8, 128,
                                              16, 4, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, table, lens.long())
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kp.to(torch.bfloat16), vp, table,
                                   lens)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, kp, vp, table.t().contiguous().t(),
                                   lens)
    with pytest.raises(ValueError, match="do not match"):
        ops.paged_decode_attention(q, kp, vp, table[:1], lens)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention(_randn(cuda, 2, 128, 64,
                                          dtype=torch.float32),
                                   kp[..., :64].contiguous(),
                                   vp[..., :64].contiguous(), table, lens)


def _quant(x):
    """Per-(row, head) absmax int8 codes and float32 scales, as the model
    stores keys and values."""
    from repro_torch.models.attention import _quant_kv
    return _quant_kv(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,Hkv,K,softcap", [(4, 2048, 16, 8, 128, 0.0),
                                                 (2, 64, 4, 4, 64, 30.0),
                                                 (2, 100, 8, 1, 32, 0.0)])
def test_int8_decode_kernel_matches_plain(cuda, dtype, B, W, H, Hkv, K,
                                          softcap):
    q = _randn(cuda, B, H, K, dtype=dtype)
    kq, ks = _quant(_randn(cuda, B, W, Hkv, K, dtype=torch.float32))
    vq, vs = _quant(_randn(cuda, B, W, Hkv, K, dtype=torch.float32))
    valid = torch.rand(B, W, generator=cuda, device="cuda") < 0.6
    valid[-1] = False
    before = ops.launch_counts()["decode_attention_int8"]
    got = ops.decode_attention(q, kq, vq, valid, softcap=softcap,
                               k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention_int8"] == before + 1
    _assert_close(got, ref.decode_attention(q, kq, vq, valid,
                                            softcap=softcap, k_scale=ks,
                                            v_scale=vs), dtype)
    assert bool((got[-1] == 0).all())
    # dead slots' scales are never read
    ks[~valid], vs[~valid] = float("nan"), float("nan")
    assert torch.equal(got, ops.decode_attention(
        q, kq, vq, valid, softcap=softcap, k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,H,Hkv,K,bs,nblk,softcap", [
    ([280, 300, 330, 360, 400, 440, 480, 520], 16, 8, 128, 16, 128, 0.0),
    ([5, 0, 64, 17], 16, 8, 128, 16, 8, 30.0),
    ([90, 7, 500], 16, 4, 64, 8, 64, 0.0),
])
def test_int8_paged_kernel_matches_plain_and_dense_bits(cuda, dtype, lengths,
                                                        H, Hkv, K, bs, nblk,
                                                        softcap):
    q, kp, vp, table, lens, owned = _paged_inputs(cuda, lengths, H, Hkv, K,
                                                  bs, nblk, torch.float32)
    q = q.to(dtype)
    kq, ks = _quant(kp)
    vq, vs = _quant(vp)
    before = ops.launch_counts()["paged_decode_attention_int8"]
    got = ops.paged_decode_attention(q, kq, vq, table, lens,
                                     softcap=softcap, k_scale_pages=ks,
                                     v_scale_pages=vs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention_int8"] == before + 1
    _assert_close(got, ref.paged_decode_attention(
        q, kq, vq, table, lens, softcap=softcap, k_scale_pages=ks,
        v_scale_pages=vs), dtype)
    # bitwise the dense int8 kernel over the gathered view
    B, W = len(lengths), nblk * bs
    idx = table.long()
    valid = torch.arange(W, device="cuda")[None, :] < lens[:, None]
    dense = ops.decode_attention(
        q, kq[idx].reshape(B, W, Hkv, K).contiguous(),
        vq[idx].reshape(B, W, Hkv, K).contiguous(), valid, softcap=softcap,
        k_scale=ks[idx].reshape(B, W, Hkv).contiguous(),
        v_scale=vs[idx].reshape(B, W, Hkv).contiguous())
    assert torch.equal(got, dense)
    # pages and scale pages no row owns (scratch included) are never read
    unowned = torch.ones(kq.shape[0], dtype=torch.bool, device="cuda")
    unowned[table[owned].long()] = False
    ks[unowned], vs[unowned] = float("nan"), float("nan")
    kq[unowned], vq[unowned] = 127, -127
    assert torch.equal(got, ops.paged_decode_attention(
        q, kq, vq, table, lens, softcap=softcap, k_scale_pages=ks,
        v_scale_pages=vs))
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, kp, vp, table, lens, _ = _paged_inputs(cuda, [20, 9], 16, 8, 128,
                                              16, 4, torch.float32)
    kq, ks = _quant(kp)
    vq, vs = _quant(vp)
    with pytest.raises(TypeError, match="int8"):
        ops.paged_decode_attention(q, kp, vq, table, lens,
                                   k_scale_pages=ks, v_scale_pages=vs)
    with pytest.raises(TypeError, match="float32"):
        ops.paged_decode_attention(q, kq, vq, table, lens,
                                   k_scale_pages=ks.half(),
                                   v_scale_pages=vs)
    with pytest.raises(ValueError, match="does not match"):
        ops.paged_decode_attention(q, kq, vq, table, lens,
                                   k_scale_pages=ks[..., :4].contiguous(),
                                   v_scale_pages=vs)
    with pytest.raises(TypeError, match="q dtype"):
        ops.paged_decode_attention(q.half(), kq, vq, table, lens,
                                   k_scale_pages=ks, v_scale_pages=vs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, kq, vq, table, lens,
                                   k_scale_pages=ks.transpose(1, 2)
                                   .contiguous().transpose(1, 2),
                                   v_scale_pages=vs)
    dense_k = kq[:2].contiguous()
    valid = torch.ones(2, dense_k.shape[1], dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        ops.decode_attention(q, dense_k, dense_k, valid,
                             k_scale=ks[:2].double(), v_scale=ks[:2])


def _int8_split_case(gen, dtype, lengths, H, Hkv, K, bs, nblk, softcap):
    """The int8 split body on one paged case: the paged int8 kernel against
    the plain version, bitwise against the dense int8 kernel over the
    gathered view, unchanged with NaN scales and codes of +-127 in every
    page no row owns, length-0 rows 0; one launch counted per call.
    Returns the paged output."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, table, lens, owned = _paged_inputs(gen, lengths, H, Hkv, K,
                                                  bs, nblk, torch.float32)
    q = q.to(dtype)
    kq, ks = _quant(kp)
    vq, vs = _quant(vp)
    before = ops.launch_counts()
    got = pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table, lens,
                                         softcap=softcap)
    torch.cuda.synchronize()
    _assert_close(got, ref.paged_decode_attention(
        q, kq, vq, table, lens, softcap=softcap, k_scale_pages=ks,
        v_scale_pages=vs), dtype)
    B, W = len(lengths), nblk * bs
    idx = table.long()
    valid = torch.arange(W, device="cuda")[None, :] < lens[:, None]
    dense = da.decode_attention_int8(
        q, kq[idx].reshape(B, W, Hkv, K).contiguous(),
        vq[idx].reshape(B, W, Hkv, K).contiguous(), valid,
        ks[idx].reshape(B, W, Hkv).contiguous(),
        vs[idx].reshape(B, W, Hkv).contiguous(), softcap=softcap)
    assert torch.equal(got, dense)
    after = ops.launch_counts()
    for name in ("decode_attention_int8", "paged_decode_attention_int8"):
        assert after[name] == before[name] + 1
    unowned = torch.ones(kq.shape[0], dtype=torch.bool, device="cuda")
    unowned[table[owned].long()] = False
    ks[unowned], vs[unowned] = float("nan"), float("nan")
    kq[unowned], vq[unowned] = 127, -127
    assert torch.equal(got, pa.paged_decode_attention_int8(
        q, kq, vq, ks, vs, table, lens, softcap=softcap))
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edges", ["first", "second"])
def test_int8_split_body_at_split_edges(cuda, dtype, edges):
    """Rows ending on a split's last position, its edge and the next
    split's first, an empty (or one-position) row, and the full horizon."""
    from repro_torch.kernels.decode_attention import SPLIT as P
    lengths = ([P - 1, P, P + 1, 0, 2048] if edges == "first"
               else [2 * P - 1, 2 * P, 2 * P + 1, 1, 2047])
    _int8_split_case(cuda, dtype, lengths, 16, 8, 128, 16, 128, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_split_body_over_a_scattered_ring(cuda, dtype):
    """Live slots scattered over the ring so that live and dead splits
    alternate, a row with no live slot, and NaN scales with codes of
    +-127 in every dead slot, the dead slots of live splits included."""
    from repro_torch.kernels import decode_attention as da
    B, W, H, Hkv, K = 3, 1000, 16, 8, 128
    q = _randn(cuda, B, H, K, dtype=dtype)
    kq, ks = _quant(_randn(cuda, B, W, Hkv, K, dtype=torch.float32))
    vq, vs = _quant(_randn(cuda, B, W, Hkv, K, dtype=torch.float32))
    valid = torch.rand(B, W, generator=cuda, device="cuda") < 0.3
    pos = torch.arange(W, device="cuda")
    valid &= (pos // da.SPLIT % 2 == 0)[None, :]
    valid[-1] = False
    got = da.decode_attention_int8(q, kq, vq, valid, ks, vs)
    torch.cuda.synchronize()
    _assert_close(got, ref.decode_attention(q, kq, vq, valid, k_scale=ks,
                                            v_scale=vs), dtype)
    assert bool((got[-1] == 0).all())
    # the even splits of the first two rows are live and hold dead slots
    assert bool(((pos // da.SPLIT % 2 == 0)[None, :] & ~valid[:2]).any())
    dead = ~valid
    ks[dead], vs[dead] = float("nan"), float("nan")
    kq[dead], vq[dead] = 127, -127
    poisoned = da.decode_attention_int8(q, kq, vq, valid, ks, vs)
    assert torch.equal(got, poisoned)
    assert bool(torch.isfinite(poisoned.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K", [(g, k) for g in (1, 2, 4, 8)
                                 for k in (32, 64, 128, 256) if g * k <= 512]
                         + [(1, 112), (6, 128)])
def test_int8_split_body_groups_and_head_dims(cuda, dtype, G, K):
    """Every (G, K) the int8 body is instantiated for, with softcap."""
    Hkv = 2
    _int8_split_case(cuda, dtype, [300, 64, 0, 129], G * Hkv, Hkv, K, 16,
                     32, 30.0)


def _int8_horizon_case(gen, dtype, H, Hkv, K):
    """The same live prefix gives the same int8 bits at W = 512 and W =
    2048 (dense), at nblk = 32 and 128 (paged), and dense = paged."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    lengths = [48, 160, 300, 512, 0]
    q, kp, vp, table, lens, _ = _paged_inputs(gen, lengths, H, Hkv, K, 16,
                                              128, torch.float32)
    q = q.to(dtype)
    kq, ks = _quant(kp)
    vq, vs = _quant(vp)
    long_ = pa.paged_decode_attention_int8(q, kq, vq, ks, vs, table, lens)
    short = pa.paged_decode_attention_int8(q, kq, vq, ks, vs,
                                           table[:, :32].contiguous(), lens)
    assert torch.equal(long_, short)
    B, idx = len(lengths), table.long()
    kd = kq[idx].reshape(B, 2048, Hkv, K).contiguous()
    vd = vq[idx].reshape(B, 2048, Hkv, K).contiguous()
    ksd = ks[idx].reshape(B, 2048, Hkv).contiguous()
    vsd = vs[idx].reshape(B, 2048, Hkv).contiguous()
    valid = torch.arange(2048, device="cuda")[None, :] < lens[:, None]
    wide = da.decode_attention_int8(q, kd, vd, valid, ksd, vsd)
    narrow = da.decode_attention_int8(
        q, kd[:, :512].contiguous(), vd[:, :512].contiguous(),
        valid[:, :512].contiguous(), ksd[:, :512].contiguous(),
        vsd[:, :512].contiguous())
    assert torch.equal(wide, narrow)
    assert torch.equal(wide, long_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_split_body_bits_do_not_depend_on_the_horizon(cuda, dtype):
    """The same live prefix gives the same bits at W = 512 and W = 2048
    (dense), at nblk = 32 and 128 (paged), and dense and paged agree."""
    _int8_horizon_case(cuda, dtype, 16, 8, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edges", ["first", "second"])
@pytest.mark.parametrize("H,Hkv,K", [(32, 32, 112), (48, 8, 128)])
def test_int8_split_body_new_shapes_at_edges_and_horizons(cuda, dtype, edges,
                                                          H, Hkv, K):
    """The int8 body at (G, K) = (1, 112) (a row's 7 loads on 8 lanes, the
    8th idle) and (6, 128) (8 codes a lane, a 768-thread merge): rows at
    the split edges against the plain version, the paged kernel bit for
    bit the dense one, NaN in unowned pages ignored, and the same bits at
    horizons 512 and 2048."""
    from repro_torch.kernels.decode_attention import SPLIT as P
    lengths = ([P - 1, P, P + 1, 0, 2048] if edges == "first"
               else [2 * P - 1, 2 * P, 2 * P + 1, 1, 2047])
    _int8_split_case(cuda, dtype, lengths, H, Hkv, K, 16, 128, 0.0)
    _int8_horizon_case(cuda, dtype, H, Hkv, K)


def test_int8_split_wrappers_reject_unaligned_codes(cuda):
    """int8 K/V that do not start on 16 bytes are refused, even where
    they start on 8."""
    q = _randn(cuda, 2, 16, 128, dtype=torch.bfloat16)
    n = 2 * 64 * 8 * 128
    k = torch.zeros(n + 8, dtype=torch.int8, device="cuda")[8:]
    k = k.reshape(2, 64, 8, 128)
    good = torch.zeros(2, 64, 8, 128, dtype=torch.int8, device="cuda")
    s = torch.ones(2, 64, 8, dtype=torch.float32, device="cuda")
    valid = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    lens = torch.full((2,), 64, dtype=torch.int32, device="cuda")
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(2, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.decode_attention(q, k, good, valid, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.decode_attention(q, good, k, valid, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.paged_decode_attention(
            q, k.reshape(8, 16, 8, 128), good.reshape(8, 16, 8, 128), table,
            lens, k_scale_pages=s.reshape(8, 16, 8),
            v_scale_pages=s.reshape(8, 16, 8))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _randn(cuda, 1, 8, 4, 32, dtype=torch.float32)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                            q.transpose(1, 2))
    with pytest.raises(ValueError, match="no kernel"):
        kv = _randn(cuda, 1, 8, 1, 512, dtype=torch.float32)
        ops.decode_attention(_randn(cuda, 1, 16, 512, dtype=torch.float32),
                             kv, kv, torch.ones(1, 8, dtype=torch.bool,
                                                device="cuda"))


def test_router_on_the_card_matches_the_cpu_path(cuda):
    """Two threaded containers on the card (one CUDA stream each, both
    kernels) give the CPU path's greedy tokens on reduced qwen3 in f32."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("qwen3-0.6b-reduced")
    config = EngineConfig(n_slots=2, max_len=96, chunk_tokens=4)
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), m)
             for i, (n, m) in enumerate([(6, 5), (40, 7), (17, 3), (9, 0),
                                         (70, 6)])]
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    gpu_params = _to_card(params)
    out = []
    for model, p, dev in ((cpu_model, params, "cpu"),
                          (Model(cfg, device="cuda"), gpu_params, "cuda")):
        ops.reset_launch_counts()
        with Router(ThreadBackend(model, p, 2, config, device=dev),
                    device=dev) as router:
            handles = [router.submit(Request(*s)) for s in specs]
            out.append({h.rid: h.tokens() for h in handles})
        counts = ops.launch_counts()
        dense = (counts["flash_attention"], counts["decode_attention"])
        assert (min(dense) > 0) == (dev == "cuda"), counts
        assert counts["paged_decode_attention"] == 0, counts
    assert out[1] == out[0]


def test_paged_router_on_the_card_matches_the_cpu_path(cuda):
    """Two paged, prefix-sharing containers on the card (the paged and
    prefill kernels, no dense decode) give the CPU path's greedy tokens
    and hit counts on reduced qwen3 in f32."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("qwen3-0.6b-reduced")
    config = EngineConfig(n_slots=2, max_len=128, chunk_tokens=4,
                          cache="paged", prefix_cache=True)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, (48,), dtype=np.int32)
    waves = [[(i, np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (n,), dtype=np.int32)]), m)
        for i, (n, m) in enumerate(spec, start)]
        for start, spec in ((0, [(9, 4)]), (10, [(20, 5), (3, 6), (40, 3),
                                                  (17, 1)]))]
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    out = []
    for model, p, dev in ((cpu_model, params, "cpu"),
                          (Model(cfg, device="cuda"), _to_card(params),
                           "cuda")):
        ops.reset_launch_counts()
        got = {}
        with Router(ThreadBackend(model, p, 2, config, device=dev),
                    device=dev) as router:
            for wave in waves:
                for h in [router.submit(Request(*s)) for s in wave]:
                    c = h.result()
                    got[c.rid] = (list(c.tokens), c.prefix_hit_tokens)
        counts = ops.launch_counts()
        if dev == "cuda":
            assert counts["paged_decode_attention"] > 0, counts
            assert counts["flash_attention"] > 0, counts
        assert counts["decode_attention"] == 0, counts
        out.append(got)
    assert out[1] == out[0]
    assert any(h > 0 for _, h in out[1].values())


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_int8_router_on_the_card_matches_the_cpu_path(cuda, cache):
    """Two threaded containers over an int8 cache on the card (the int8
    decode kernel of that cache and nothing else for decode) give the CPU
    path's greedy tokens on reduced qwen3 in f32."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = dataclasses.replace(get_config("qwen3-0.6b-reduced"),
                              kv_cache_dtype="int8")
    config = EngineConfig(n_slots=2, max_len=96, chunk_tokens=4,
                          cache=cache, prefix_cache=cache == "paged")
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), m)
             for i, (n, m) in enumerate([(6, 5), (40, 7), (17, 3), (9, 0),
                                         (70, 6)])]
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    kernel = ("paged_decode_attention_int8" if cache == "paged"
              else "decode_attention_int8")
    out = []
    for model, p, dev in ((cpu_model, params, "cpu"),
                          (Model(cfg, device="cuda"), _to_card(params),
                           "cuda")):
        ops.reset_launch_counts()
        with Router(ThreadBackend(model, p, 2, config, device=dev),
                    device=dev) as router:
            handles = [router.submit(Request(*s)) for s in specs]
            out.append({h.rid: (h.tokens(), h.result().prefix_hit_tokens)
                        for h in handles})
        counts = ops.launch_counts()
        assert (counts[kernel] > 0) == (dev == "cuda"), counts
        assert sum(v for k, v in counts.items()
                   if "decode" in k and k != kernel) == 0, counts
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
def _ssd_args(gen, B, S, nh, hd, ng, ds, dtype):
    """The JAX suite's draw: x, B, C ~ N(0, 1), dt = softplus(N(0, 1)),
    A = -exp(N(0, 1)) (float32), D = 1 (float32)."""
    import torch.nn.functional as F
    dt = F.softplus(torch.randn(B, S, nh, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(nh, generator=gen, device="cuda"))
    return (_randn(gen, B, S, nh, hd, dtype=dtype), dt.to(dtype), A,
            _randn(gen, B, S, ng, ds, dtype=dtype),
            _randn(gen, B, S, ng, ds, dtype=dtype),
            torch.ones(nh, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,ng,ds,chunk", [
    (2, 128, 4, 16, 2, 16, 32),       # the shapes of tests/test_kernels.py
    (1, 64, 8, 8, 1, 32, 16),
    (2, 256, 2, 32, 1, 8, 64),
    (1, 512, 80, 64, 1, 128, 256),    # mamba2-2.7b's widths
    (1, 100, 6, 40, 3, 200, 100),     # ragged tile, hd not a tile multiple
    (1, 2048, 80, 64, 1, 128, 256),   # 32 chunks of the kernel's cut
    (1, 512, 80, 64, 2, 128, 256),    # two groups of 40 heads
    (1, 256, 4, 128, 1, 128, 128),    # hd in two 64-row pieces
    (2, 160, 6, 80, 2, 96, 32),       # hd 80: a full and a ragged piece
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, nh, hd, ng, ds, chunk):
    """|kernel - plain| <= tol * max|plain| (5e-5 f32, 2e-2 bf16): the
    kernel cuts the sequence into 64-position tiles, the plain version at
    ``chunk``, and the decays' running sums round with the cut. Where 64
    divides S, also element by element (tol abs + tol rel) against the
    plain version cut where the kernel cuts."""
    args = _ssd_args(cuda, B, S, nh, hd, ng, ds, dtype)
    before = ops.launch_counts()["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, ref.ssd_scan(*args, chunk=chunk)):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())
    if S % 64 == 0:
        for g, w in zip(got, ref.ssd_scan(*args, chunk=64)):
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan
    args = _ssd_args(cuda, 1, 40, 4, 16, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssd_scan(*args, chunk=32)
    x, dt, A, B_, C_, D = args
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x, dt, A.to(torch.bfloat16), B_, C_, D, chunk=40)
    with pytest.raises(TypeError, match="share one dtype"):
        ssd_scan(x, dt.to(torch.bfloat16), A, B_, C_, D, chunk=40)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3), dt, A, B_, C_, D, chunk=40)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan(x, dt, A, B_[:, :, :1].expand(1, 40, 3, 16).contiguous(),
                 C_[:, :, :1].expand(1, 40, 3, 16).contiguous(), D,
                 chunk=40)
    big = _ssd_args(cuda, 1, 8, 2, 8, 1, 300, torch.float32)
    with pytest.raises(ValueError, match="out of the kernel's range"):
        ssd_scan(*big, chunk=8)


# the SSD scan's backward: chip_smoke.py phase 2's shapes (mamba2-2.7b's
# training widths, zamba2-7b's, a ragged padded cut with two groups), and
# head dims past one 64-row piece (128: two pieces; 80: a full and a
# ragged piece, with a ragged cut)
SSD_BWD_SHAPES = [(2, 512, 80, 64, 1, 128, 256), (1, 512, 112, 64, 1, 64, 256),
                  (2, 96, 4, 16, 2, 24, 32), (1, 256, 4, 128, 1, 128, 128),
                  (2, 160, 6, 80, 2, 64, 32)]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("B,S,nh,hd,ng,ds,chunk", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(cuda, B, S, nh, hd, ng, ds, chunk,
                                      with_state):
    """``ssd_scan_bwd`` against ``ref.ssd_scan_bwd``: every gradient within
    5e-5 abs + rel of max|plain| at the kernel's 64-position cut (where 64
    divides S) and within 1e-4 of max|plain| at the caller's chunk; one
    counted launch a call; the same bits from run to run."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_args(cuda, B, S, nh, hd, ng, ds, torch.float32)
    dy = _randn(cuda, B, S, nh, hd, dtype=torch.float32)
    st = _randn(cuda, B, nh, hd, ds, dtype=torch.float32) \
        if with_state else None
    before = ops.launch_counts()["ssd_scan_bwd"]
    got = ssd.ssd_scan_bwd(*args, dy, st, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan_bwd"] == before + 1
    again = ssd.ssd_scan_bwd(*args, dy, st, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, ref.ssd_scan_bwd(*args, dy, st, chunk=chunk)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    if S % 64 == 0:
        for g, w in zip(got, ref.ssd_scan_bwd(*args, dy, st, chunk=64)):
            assert float((g - w).abs().max()) <= 5e-5 + 5e-5 * float(
                w.abs().max())


def test_ssd_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_args(cuda, 1, 40, 4, 16, 2, 16, torch.float32)
    x, dt, A, B_, C_, D = args
    dy = torch.randn_like(x)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssd.ssd_scan_bwd(*args, dy, chunk=32)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_bwd(x.bfloat16(), dt.bfloat16(), A, B_.bfloat16(),
                         C_.bfloat16(), D, dy.bfloat16(), chunk=40)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan_bwd(*args, dy.transpose(2, 3), chunk=40)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_bwd(*args, dy.cpu(), chunk=40)
    with pytest.raises(ValueError, match="shapes"):
        ssd.ssd_scan_bwd(*args, dy, torch.zeros(1, 4, 16, 8, device="cuda"),
                         chunk=40)
    wide = _ssd_args(cuda, 1, 8, 2, 8, 1, ssd.BWD_MAX_STATE + 1,
                     torch.float32)
    with pytest.raises(ValueError, match="out of the kernel's range"):
        ssd.ssd_scan_bwd(*wide, torch.randn_like(wide[0]), chunk=8)


def test_ssm_router_on_the_card_matches_the_cpu_path(cuda):
    """Two threaded containers on the card serving reduced mamba2 in f32
    (the SSD kernel, no attention kernel) give the CPU path's greedy
    tokens."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("mamba2-2.7b-reduced")
    config = EngineConfig(n_slots=2, max_len=128, chunk_tokens=4)
    rng = np.random.default_rng(2)
    specs = [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), m)
             for i, (n, m) in enumerate([(6, 5), (64, 7), (17, 3), (17, 4),
                                         (32, 6)])]
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    out = []
    for model, p, dev in ((cpu_model, params, "cpu"),
                          (Model(cfg, device="cuda"), _to_card(params),
                           "cuda")):
        ops.reset_launch_counts()
        with Router(ThreadBackend(model, p, 2, config, device=dev),
                    device=dev) as router:
            handles = [router.submit(Request(*s)) for s in specs]
            out.append({h.rid: h.tokens() for h in handles})
        counts = ops.launch_counts()
        assert (counts["ssd_scan"] > 0) == (dev == "cuda"), counts
        # every norm of the model runs the rmsnorm kernel on the card
        assert (counts["rmsnorm"] > 0) == (dev == "cuda"), counts
        assert sum(v for k, v in counts.items()
                   if k not in ("ssd_scan", "rmsnorm")) == 0
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# absorbed-MLA decode, and the prefill kernel at MLA's widths
# ---------------------------------------------------------------------------
def _mla_args(gen, B, S, H, r, dr, dtype):
    return tuple(_randn(gen, *shape, dtype=dtype)
                 for shape in ((B, H, r), (B, H, dr), (B, S, r), (B, S, dr)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,r,dr,depths", [
    (4, 2048, 16, 512, 64, [48, 160, 300, 544]),   # deepseek's main shape
    (3, 1000, 16, 512, 64, None),                   # ragged S, a dead row
    (2, 256, 4, 64, 16, None),                      # the reduced widths
    (3, 37, 8, 128, 32, None),
])
def test_mla_kernel_matches_plain(cuda, dtype, B, S, H, r, dr, depths):
    args = _mla_args(cuda, B, S, H, r, dr, dtype)
    if depths is None:
        valid = torch.rand(B, S, generator=cuda, device="cuda") < 0.7
        valid[-1] = False
    else:
        valid = (torch.arange(S, device="cuda")[None, :]
                 < torch.tensor(depths, device="cuda")[:, None])
    scale = 192 ** -0.5
    before = ops.launch_counts()["mla_decode_ctx"]
    got = ops.mla_decode_ctx(*args, valid, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mla_decode_ctx"] == before + 1
    assert got.dtype == dtype and got.shape == (B, H, r)
    _assert_close(got, ref.mla_decode_ctx(*args, valid, scale=scale), dtype)
    if depths is None:
        assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_kernel_over_gathered_pages_ignores_unowned_pages(cuda, dtype):
    """The paged latent cache's path: the view gathered from 16-token
    pages through a scattered table, NaN in every page no row owns."""
    B, H, r, dr, bs, nblk = 3, 16, 512, 64, 16, 32
    lengths = torch.tensor([5, 300, 512], device="cuda")
    n_pages = 2 * B * nblk
    ql, qr, _, _ = _mla_args(cuda, B, 1, H, r, dr, dtype)
    ckv_p = _randn(cuda, n_pages + 1, bs, r, dtype=dtype)
    kr_p = _randn(cuda, n_pages + 1, bs, dr, dtype=dtype)
    table = torch.randperm(n_pages, generator=cuda, device="cuda")[
        :B * nblk].reshape(B, nblk)
    owned = torch.arange(nblk, device="cuda")[None, :] < (
        (lengths[:, None] + bs - 1) // bs)
    table[~owned] = n_pages
    valid = torch.arange(nblk * bs, device="cuda")[None, :] < lengths[:, None]

    def run():
        return ops.mla_decode_ctx(
            ql, qr, ckv_p[table].reshape(B, nblk * bs, r),
            kr_p[table].reshape(B, nblk * bs, dr), valid, scale=0.1)
    got = run()
    _assert_close(got, ref.mla_decode_ctx(
        ql, qr, ckv_p[table].reshape(B, nblk * bs, r),
        kr_p[table].reshape(B, nblk * bs, dr), valid, scale=0.1), dtype)
    unowned = torch.ones(n_pages + 1, dtype=torch.bool, device="cuda")
    unowned[table[owned]] = False
    ckv_p[unowned] = float("nan")
    kr_p[unowned] = float("nan")
    assert torch.equal(run(), got)


def _mla_prefix(lengths, S):
    return (torch.arange(S, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_body_at_split_edges(cuda, dtype):
    """Rows live to one position, a split's last, its edge, the next
    split's first, the second edge and the whole 2048 horizon: against the
    plain version, and each row alone gives its bits in the batch."""
    from repro_torch.kernels.mla_decode import SPLIT as P
    lengths = [1, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 1, 2048]
    S = 2048
    args = _mla_args(cuda, len(lengths), S, 16, 512, 64, dtype)
    valid = _mla_prefix(lengths, S)
    got = ops.mla_decode_ctx(*args, valid, scale=0.1)
    torch.cuda.synchronize()
    _assert_close(got, ref.mla_decode_ctx(*args, valid, scale=0.1), dtype)
    for b in range(len(lengths)):
        alone = ops.mla_decode_ctx(*(a[b:b + 1].contiguous() for a in args),
                                   valid[b:b + 1].contiguous(), scale=0.1)
        assert torch.equal(alone[0], got[b])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_body_never_reads_dead_positions_of_live_tiles(cuda, dtype):
    """Ragged valid flags with holes in every live split, and a row with
    no live position: NaN written into every dead position leaves the
    output's bits as they were, and the dead row is 0."""
    B, S, H, r, dr = 4, 700, 16, 512, 64
    args = _mla_args(cuda, B, S, H, r, dr, dtype)
    valid = torch.rand(B, S, generator=cuda, device="cuda") < 0.5
    valid[-1] = False
    got = ops.mla_decode_ctx(*args, valid, scale=0.1)
    torch.cuda.synchronize()
    _assert_close(got, ref.mla_decode_ctx(*args, valid, scale=0.1), dtype)
    assert bool((got[-1] == 0).all())
    ql, qr, ckv, kr = args
    ckv[~valid] = float("nan")
    kr[~valid] = float("nan")
    assert torch.equal(ops.mla_decode_ctx(ql, qr, ckv, kr, valid,
                                          scale=0.1), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("dr", [4, 16, 20, 64])
@pytest.mark.parametrize("H", [1, 4, 8, 16])
def test_mla_body_every_width(cuda, dtype, r, dr, H):
    """Every instantiated latent width, rope widths that are and are not a
    multiple of 16, and H < 16 (the bf16 body's padded MMA rows)."""
    lengths = [300, 64, 0, 129]
    args = _mla_args(cuda, len(lengths), 300, H, r, dr, dtype)
    valid = _mla_prefix(lengths, 300)
    got = ops.mla_decode_ctx(*args, valid, scale=(r + dr) ** -0.5)
    torch.cuda.synchronize()
    _assert_close(got, ref.mla_decode_ctx(*args, valid,
                                          scale=(r + dr) ** -0.5), dtype)
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_body_bits_do_not_depend_on_the_horizon(cuda, dtype):
    """The same live prefix gives the same bits over S = 512 and 2048."""
    lengths = [48, 160, 300, 512, 0]
    args = _mla_args(cuda, len(lengths), 2048, 16, 512, 64, dtype)
    valid = _mla_prefix(lengths, 2048)
    wide = ops.mla_decode_ctx(*args, valid, scale=0.1)
    ql, qr, ckv, kr = args
    narrow = ops.mla_decode_ctx(ql, qr, ckv[:, :512].contiguous(),
                                kr[:, :512].contiguous(),
                                valid[:, :512].contiguous(), scale=0.1)
    assert torch.equal(wide, narrow)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_body_dense_rows_give_the_gathered_pages_bits(cuda, dtype):
    """One logical latent cache held as dense rows (other garbage in the
    dead positions) and as scattered 16-token pages (NaN in every page no
    row owns), read through the gathered view: the same bits."""
    B, H, r, dr, bs, nblk = 4, 16, 512, 64, 16, 128
    lengths = torch.tensor([48, 160, 300, 544], device="cuda")
    n_pages = 2 * B * nblk
    ql, qr, ckv, kr = _mla_args(cuda, B, nblk * bs, H, r, dr, dtype)
    valid = _mla_prefix(lengths.tolist(), nblk * bs)
    table = torch.randperm(n_pages, generator=cuda, device="cuda")[
        :B * nblk].reshape(B, nblk)
    owned = torch.arange(nblk, device="cuda")[None, :] < (
        (lengths[:, None] + bs - 1) // bs)
    table[~owned] = n_pages
    ckv_p = torch.full((n_pages + 1, bs, r), float("nan"), device="cuda",
                       dtype=dtype)
    kr_p = torch.full((n_pages + 1, bs, dr), float("nan"), device="cuda",
                      dtype=dtype)
    ckv_p[table[owned]] = ckv.reshape(B, nblk, bs, r)[owned]
    kr_p[table[owned]] = kr.reshape(B, nblk, bs, dr)[owned]
    dense = ops.mla_decode_ctx(ql, qr, ckv, kr, valid, scale=0.1)
    paged = ops.mla_decode_ctx(
        ql, qr, ckv_p[table].reshape(B, nblk * bs, r),
        kr_p[table].reshape(B, nblk * bs, dr), valid, scale=0.1)
    assert torch.equal(dense, paged)
    assert bool(torch.isfinite(dense).all())


def test_mla_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.mla_decode import mla_decode_ctx
    ql, qr, ckv, kr = _mla_args(cuda, 2, 40, 4, 64, 16, torch.float32)
    valid = torch.ones(2, 40, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError, match="share one dtype"):
        mla_decode_ctx(ql, qr, ckv.to(torch.bfloat16), kr, valid, scale=1.0)
    with pytest.raises(TypeError, match="bool"):
        mla_decode_ctx(ql, qr, ckv, kr, valid.int(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        mla_decode_ctx(ql, qr, ckv.transpose(0, 1).contiguous().transpose(
            0, 1), kr, valid, scale=1.0)
    with pytest.raises(ValueError, match="no kernel"):
        a = _mla_args(cuda, 2, 40, 4, 96, 16, torch.float32)
        mla_decode_ctx(*a, valid, scale=1.0)
    with pytest.raises(ValueError, match="no kernel"):
        a = _mla_args(cuda, 2, 40, 32, 64, 16, torch.float32)
        mla_decode_ctx(*a, valid, scale=1.0)
    with pytest.raises(ValueError, match="shapes"):
        mla_decode_ctx(ql, qr, ckv, kr[:, :39].contiguous(), valid,
                       scale=1.0)
    shifted = torch.empty(2 * 40 * 64 + 1, device="cuda")[1:].view(2, 40, 64)
    with pytest.raises(ValueError, match="aligned"):
        mla_decode_ctx(ql, qr, shifted, kr, valid, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        mla_decode_ctx(ql.cpu(), qr, ckv, kr, valid, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(512, 512), (77, 77), (1, 1), (1, 130),
                                    (60, 200), (100, 40)])
def test_flash_kernel_at_mla_widths(cuda, dtype, Sq, Skv):
    """MLA prefill: K = 192 (nope 128 + rope 64), Kv = 128, H = Hkv = 16;
    queries right-aligned, rows that see no key give 0."""
    q = _randn(cuda, 1, Sq, 16, 192, dtype=dtype)
    k = _randn(cuda, 1, Skv, 16, 192, dtype=dtype)
    v = _randn(cuda, 1, Skv, 16, 128, dtype=dtype)
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (1, Sq, 16, 128)
    _assert_close(got, ref.flash_attention(q, k, v), dtype)
    assert bool((got[:, :max(Sq - Skv, 0)] == 0).all())


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_deepseek_router_on_the_card_matches_the_cpu_path(cuda, cache):
    """Two threaded containers on the card serving reduced deepseek in f32
    (the prefill kernel at MLA's widths and the MLA decode kernel, no
    other decode kernel) give the CPU path's greedy tokens."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("deepseek-v2-lite-16b-reduced")
    config = EngineConfig(n_slots=2, max_len=96, chunk_tokens=4,
                          cache=cache, block_size=16)
    rng = np.random.default_rng(4)
    specs = [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), m)
             for i, (n, m) in enumerate([(6, 5), (40, 7), (17, 3), (9, 0),
                                         (70, 6)])]
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    out = []
    for model, p, dev in ((cpu_model, params, "cpu"),
                          (Model(cfg, device="cuda"), _to_card(params),
                           "cuda")):
        ops.reset_launch_counts()
        with Router(ThreadBackend(model, p, 2, config, device=dev),
                    device=dev) as router:
            handles = [router.submit(Request(*s)) for s in specs]
            out.append({h.rid: h.tokens() for h in handles})
        counts = ops.launch_counts()
        mla = (counts["flash_attention"], counts["mla_decode_ctx"],
               counts["rmsnorm"])
        assert (min(mla) > 0) == (dev == "cuda"), counts
        assert sum(v for k, v in counts.items()
                   if k not in ("flash_attention", "mla_decode_ctx",
                                "rmsnorm")) == 0
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D", [(7, 128), (4100, 128), (33, 512),
                                    (5, 1024), (513, 2048), (3, 2560),
                                    (9, 5120), (1, 5120)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, D):
    """Every width the port's norms see, row counts that are no multiple
    of the kernel's rows a block; one launch a call."""
    x = _randn(cuda, rows, D, dtype=dtype) * 2
    scale = (1 + 0.1 * _randn(cuda, D, dtype=torch.float32)).to(dtype)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, ref.rmsnorm(x, scale, 1e-6), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_on_strided_rows_and_float32_scale(cuda, dtype):
    """The MLA latent norm's slice dkv[..., :512] of 576-wide rows is read
    in place; scale may be float32 under bfloat16 rows."""
    dkv = _randn(cuda, 2, 37, 576, dtype=dtype)
    x = dkv[..., :512]
    for scale in (_randn(cuda, 512, dtype=dtype),
                  _randn(cuda, 512, dtype=torch.float32)):
        got = ops.rmsnorm(x, scale, 1e-6)
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == x.shape
        _assert_close(got, ref.rmsnorm(x, scale, 1e-6), dtype)
        _assert_close(got, ref.rmsnorm(x.contiguous(), scale, 1e-6), dtype)


# the widths of the port's norms, and those of the families still to come
RMS_WIDTHS = (128, 512, 1024, 2048, 2560, 5120)
RMS_LATER = (4096, 5376, 6144, 7168)
# widths the 16-byte path does not take: V (8 bf16, 4 f32) does not divide
# them, or (20000) a row is wider than 8 vectors a lane of 8 warps
RMS_ODD = (1, 5, 127, 1020, 1022, 2562, 20000)


def _rms_case(gen, rows, D, dtype):
    x = _randn(gen, rows, D, dtype=dtype) * 2
    return x, (1 + 0.1 * _randn(gen, D, dtype=torch.float32)).to(dtype)


def _copy_at(t, offset=0, pad=0):
    """t's values in a fresh buffer: ``offset`` elements past its 16-byte
    aligned base, and with rows ``pad`` elements wider than t's."""
    rows, D = t.shape[0], t.shape[-1]
    buf = torch.empty(offset + rows * (D + pad), dtype=t.dtype,
                      device=t.device)
    view = buf[offset:].view(rows, D + pad)[:, :D]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", RMS_WIDTHS + RMS_LATER + RMS_ODD)
@pytest.mark.parametrize("rows", [1, 37, 4099])
def test_rmsnorm_kernel_at_every_width_and_row_count(cuda, dtype, D, rows):
    x, scale = _rms_case(cuda, rows, D, dtype)
    got = ops.rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    _assert_close(got, ref.rmsnorm(x, scale, 1e-6), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", RMS_WIDTHS + RMS_LATER + RMS_ODD)
def test_rmsnorm_row_bits_do_not_depend_on_rows_or_pair(cuda, dtype, D):
    """A row alone, inside 4099 rows, and in a pair launch (as either
    tensor) gets the same bits."""
    x, scale = _rms_case(cuda, 4099, D, dtype)
    y, y_scale = _rms_case(cuda, 37, D, dtype)
    many = ops.rmsnorm(x, scale, 1e-6)
    for r in (0, 1, 5, 2048, 4098):
        assert torch.equal(ops.rmsnorm(x[r:r + 1], scale, 1e-6)[0], many[r])
    a, b = ops.rmsnorm_pair(x, scale, y, y_scale, 1e-6)
    assert torch.equal(a, many)
    assert torch.equal(b, ops.rmsnorm(y, y_scale, 1e-6))
    c, d = ops.rmsnorm_pair(y, y_scale, x[2048:2049], scale, 1e-6)
    assert torch.equal(d[0], many[2048]) and torch.equal(c, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", RMS_WIDTHS + RMS_LATER + RMS_ODD)
def test_rmsnorm_vector_and_one_element_paths_give_equal_bits(cuda, dtype,
                                                              D):
    """The same rows with a base one element off 16 bytes, with a row
    stride of D + 1 and with a scale off 16 bytes (the one-element path)
    give the bits of the aligned rows; where V divides D the aligned rows
    take the 16-byte path, and the binding's one-element instantiation on
    those very tensors gives their bits too."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    rows = 37
    x, scale = _rms_case(cuda, rows, D, dtype)
    want = ops.rmsnorm(x, scale, 1e-6)
    assert torch.equal(ops.rmsnorm(_copy_at(x, offset=1), scale, 1e-6), want)
    assert torch.equal(ops.rmsnorm(_copy_at(x, pad=1), scale, 1e-6), want)
    off_scale = _copy_at(scale[None], offset=1)[0]
    assert torch.equal(ops.rmsnorm(x, off_scale, 1e-6), want)
    W, N = rn.layout(D, x.element_size())
    out = torch.empty_like(x)
    bf16 = dtype == torch.bfloat16
    err = build.extension().rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, 0, 0, 0, 0,
        0, D, 1e-6, bf16, bf16, W, N, False,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_shape,k_shape", [
    ((4, 1, 16, 128), (4, 1, 8, 128)),      # qwen3's decode step
    ((1, 512, 16, 128), (1, 512, 8, 128)),  # a 512-token prefill
    ((3, 5, 4, 512), (3, 5, 2, 512)),
    ((2, 3, 2, 1020), (2, 3, 1, 1020)),     # one-element path
])
def test_rmsnorm_pair_is_two_singles_bitwise_in_one_launch(cuda, dtype,
                                                           q_shape, k_shape):
    _, q_scale = _rms_case(cuda, 1, q_shape[-1], dtype)
    q = _randn(cuda, *q_shape, dtype=dtype)
    k, k_scale = _randn(cuda, *k_shape, dtype=dtype), q_scale.flip(0)
    before = ops.launch_counts()["rmsnorm"]
    gq, gk = ops.rmsnorm_pair(q, q_scale, k, k_scale, 1e-6)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    assert gq.shape == q.shape and gk.shape == k.shape
    assert torch.equal(gq, ops.rmsnorm(q, q_scale, 1e-6))
    assert torch.equal(gk, ops.rmsnorm(k, k_scale, 1e-6))
    _assert_close(gk, ref.rmsnorm(k, k_scale, 1e-6), dtype)


def test_rmsnorm_pair_of_unlike_tensors_raises(cuda):
    from repro_torch.kernels.rmsnorm import rmsnorm_pair
    x, s = _rms_case(cuda, 4, 128, torch.float32)
    with pytest.raises(ValueError, match="one width"):
        rmsnorm_pair(x, s, x[:, :64], s[:64])
    with pytest.raises(ValueError, match="one width"):
        rmsnorm_pair(x, s, x.bfloat16(), s)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_pair(x, s, x.cpu(), s.cpu())


def test_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = _randn(cuda, 4, 6, 128, dtype=torch.float32)
    s = _randn(cuda, 128, dtype=torch.float32)
    with pytest.raises(ValueError, match="evenly spaced"):
        rmsnorm(x.transpose(0, 1), s)
    with pytest.raises(ValueError, match="last axis must be contiguous"):
        rmsnorm(x[..., ::2], s[:64])
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, s[:64])
    with pytest.raises(TypeError, match="dtype"):
        rmsnorm(x.half(), s)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x, s.cpu())


# ---------------------------------------------------------------------------
# prefix sharing on == off at equal batch shapes (JAX's _serve_phases form)
# ---------------------------------------------------------------------------
def _sharing_phases(vocab, prefix_len, specs_by_phase, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (prefix_len,), dtype=np.int32)
    phases = []
    for rid0, specs in specs_by_phase:
        phases.append([(rid0 + i, np.concatenate([prefix, rng.integers(
            0, vocab, (n - prefix_len,), dtype=np.int32)]), m)
            for i, (n, m) in enumerate(specs)])
    return phases


def _serve_phases(model, params, phases, config):
    """One engine, the phases in turn, draining between them."""
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(model, params, config, device=model.device)
    got = {}
    for reqs in phases:
        eng.submit_many([Request(r, p.copy(), m) for r, p, m in reqs])
        for c in eng.run():
            got[c.rid] = (list(c.tokens), c.prefix_hit_tokens)
    return got, eng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_sharing_on_equals_off_on_the_card(cuda, dtype):
    """Reduced qwen3 on the card: the same two phases of shared-prefix
    requests through one paged engine with sharing and one without, at
    the same block budget; phase 2 hits the whole 64-token prefix and the
    greedy streams are identical."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model

    from repro_torch.serving.engine import EngineConfig

    cfg = get_config("qwen3-0.6b-reduced")
    model = Model(cfg, device="cuda")
    params = model.init(seed=0, dtype=dtype)
    phases = _sharing_phases(cfg.vocab_size, 64, [
        (0, [(80, 4), (76, 3)]), (10, [(72, 3), (70, 4), (75, 2)])])
    base = dict(n_slots=4, max_len=128, cache="paged", block_size=16,
                chunk_tokens=4, dtype=dtype)
    on, eng_on = _serve_phases(model, params, phases,
                               EngineConfig(prefix_cache=True, **base))
    off, eng_off = _serve_phases(model, params, phases,
                                 EngineConfig(prefix_cache=False, **base))
    assert {r: t for r, (t, _) in on.items()} \
        == {r: t for r, (t, _) in off.items()}
    assert [h for r, (_, h) in sorted(on.items()) if r >= 10] == [64] * 3
    assert eng_off.prefix_hit_tokens_total == 0
    assert eng_on.prefill_tokens_executed < eng_off.prefill_tokens_executed


@contextlib.contextmanager
def _bf16_reduced_precision_reduction(allowed: bool):
    """torch's process-wide cuBLAS setting, set for a block and restored."""
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = allowed
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = was


@pytest.mark.parametrize("reduction_allowed", [True, False])
def test_cublas_rows_depend_on_the_row_count(cuda, reduction_allowed):
    """Why a prefill's bf16 products run in fixed slices on the card: at
    qwen3's down projection (K = 3072, N = 1024, bf16) cuBLAS gives the
    same rows other bits in a 16-row product than in a 4096-row one, with
    its reduced-precision reduction allowed (torch's default) or not, so
    that setting is no way around the slicing."""
    w = (0.03 * _randn(cuda, 3072, 1024, dtype=torch.float32)).bfloat16()
    x = _randn(cuda, 4096, 3072, dtype=torch.bfloat16)
    with _bf16_reduced_precision_reduction(reduction_allowed):
        assert not torch.equal(x[:16] @ w, (x @ w)[:16])


PREFILL_ROWS = (128, 129, 200, 256, 384, 512, 1000, 1024, 2048)
HEAD_ROWS = (1, 2, 3, 4, 8, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "stablelm-1.6b",
                                  "internvl2-26b"])
def test_prefill_gemms_give_a_row_the_same_bits_from_min_prefill_rows_on(
        cuda, name, dtype):
    """The projections of the models that share prefixes, at full width,
    as a paged engine's prefill computes them (``layers.project`` inside
    ``layers.prefill_products(every_dtype=True)``), give a row the same
    bits whatever the row count, wherever the row sits among them, and so
    does the logits head, which a prefill computes at one row a prompt:
    at every count from 1, so sharing on and off agree bit for bit. One
    cuBLAS product would not: in float32 it gives the same rows other
    bits between 128 and 4096 rows at these widths, in bfloat16 below 128
    rows at qwen3's and at 128-384 rows (down projection) and 1-4 rows
    (head) at internvl2-26b's, so the card runs a sharing engine's prefill
    products in fixed slices of ``layers.ROW_SLICE`` rows."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import prefill_products, project

    cfg = get_config(name)
    d, ff = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    bad = []

    def check(x, w, rows, what):
        with prefill_products(every_dtype=True):
            full = project(x, w)
            for at in (0, 37):
                bad.extend((what, at, m) for m in rows
                           if not torch.equal(project(x[at:at + m], w),
                                              full[at:at + m]))

    rows = (1, 16, 100) + PREFILL_ROWS
    for K, N in sorted({(d, q), (d, kv), (q, d), (d, ff), (ff, d)}):
        w = (K ** -0.5 * _randn(cuda, K, N, dtype=torch.float32)).to(dtype)
        check(_randn(cuda, 4096, K, dtype=dtype), w, rows, (K, N))
    table = (d ** -0.5 * _randn(cuda, cfg.vocab_size, d,
                                dtype=torch.float32)).to(dtype)
    check(_randn(cuda, 256, d, dtype=dtype), table.T, HEAD_ROWS,
          ("head", d, cfg.vocab_size))
    assert not bad, bad


def test_decode_projections_stay_one_product(cuda):
    """Outside a prefill (a decode step, whose rows are the engine's
    slots) a float32 projection on the card is the one product ``x @ w``;
    inside ``prefill_products`` it is ``sliced_matmul``'s."""
    from repro_torch.models.layers import (prefill_products, project,
                                           sliced_matmul)

    x = _randn(cuda, 8, 1024, dtype=torch.float32)
    w = 0.03 * _randn(cuda, 1024, 3072, dtype=torch.float32)
    assert torch.equal(project(x, w), x @ w)
    with prefill_products():
        assert torch.equal(project(x, w), sliced_matmul(x, w))
    assert torch.equal(project(x, w), x @ w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ctx", [256, 272])
def test_flash_over_context_and_suffix_equals_the_whole_prompt_bits(
        cuda, dtype, ctx):
    """The suffix prefill's attention (queries of the suffix against
    [cached context | suffix]) gives the whole-prompt prefill's rows bit
    for bit on the same keys and values: the kernel walks the keys in
    the same tiles from position 0 in both. A context of 272 (17 blocks of
    16, not a multiple of the 64-row query tile) puts each row at another
    place in its query tile and MMA tile than the whole prompt does."""
    H, Hkv, K, n, whole, sb = 16, 8, 128, 100, 512, 128
    q = _randn(cuda, 2, whole, H, K, dtype=dtype)
    k = _randn(cuda, 2, whole, Hkv, K, dtype=dtype)
    v = _randn(cuda, 2, whole, Hkv, K, dtype=dtype)
    full = ops.flash_attention(q, k, v)
    part = ops.flash_attention(q[:, ctx:ctx + sb].contiguous(),
                               k[:, :ctx + sb].contiguous(),
                               v[:, :ctx + sb].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(part[:, :n], full[:, ctx:ctx + n])


# ---------------------------------------------------------------------------
# process containers on the card
# ---------------------------------------------------------------------------
def test_process_router_on_the_card_matches_threads(cuda):
    """Reduced qwen3 in bf16: Router(ProcessBackend(2)) with the weights
    shared over CUDA IPC gives Router(ThreadBackend(2))'s greedy streams
    (all requests submitted before the first poll); each child launched
    the prefill, decode and rmsnorm kernels, holds no weight copy of its
    own, and imported torch only after it pinned itself."""
    import time

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ProcessBackend, ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cfg = get_config("qwen3-0.6b-reduced")
    model = Model(cfg, device="cuda")
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=2, max_len=128, chunk_tokens=4,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    specs = [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), m)
             for i, (n, m) in enumerate([(6, 5), (40, 7), (17, 3), (9, 0),
                                         (70, 6), (33, 4)])]
    with Router(ThreadBackend(model, params, 2, config)) as router:
        want = {h.rid: h.tokens()
                for h in [router.submit(Request(*s)) for s in specs]}
    backend = ProcessBackend(cfg, 2, config, params=params,
                             allow_shared_cores=True, start_timeout_s=300)
    with Router(backend) as router:
        backend.warm()
        backend.child_stats(reset=True)
        handles = [router.submit(Request(*s)) for s in specs]
        deadline = time.perf_counter() + 300
        while not all(h.done for h in handles):
            assert time.perf_counter() < deadline
            router._pump(block=True)
        got = {h.rid: h.tokens() for h in handles}
        stats = backend.child_stats()
        weights = sum(t.nbytes for t in _leaves(params))
        for info, (counts, memory) in zip(backend.child_info, stats):
            assert info["torch_preloaded"] is False
            assert info["weight_bytes"] == weights
            assert info["memory_allocated"] < weights, info
            for name in ("flash_attention", "decode_attention", "rmsnorm"):
                assert counts[name] > 0, counts
    backend.close()
    assert got == want


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("kill,release", [(True, True), (False, True),
                                          (True, False)])
def test_children_leave_no_weights_parked_in_the_parent(cuda, kill,
                                                        release):
    """torch keeps a CUDA weight the parent shared with a child allocated,
    after the parent frees it, until the child gives back the share's
    reference counter; a closed child gives it back as it frees the
    weights, a killed child never does, and the backend gives it back
    for it (``_SentWeight.release``). In a fresh parent: serve with 2
    process containers (container 1 killed after a step, or none), close,
    free the weights and collect torch's parked shares. The parent's
    ``memory_allocated`` is back where it was before the weights, and
    torch does not warn at exit that shares were still out. The control,
    a kill with the backend's release turned off, keeps the weights
    allocated and warns: the check sees what it measures."""
    import os
    import pathlib
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent(f"""
        import gc, numpy as np, torch
        from repro_torch.configs.registry import get_config
        from repro_torch.models.model import Model
        from repro_torch.serving import backend as backend_mod
        from repro_torch.serving.backend import ProcessBackend
        from repro_torch.serving.engine import EngineConfig, Request
        from repro_torch.serving.faults import Fault, FaultPlan
        from repro_torch.serving.router import Router
        if not {release}:
            backend_mod._SentWeight.release = lambda self: None
        cfg = get_config("qwen3-0.6b-reduced")
        before = torch.cuda.memory_allocated()
        params = Model(cfg).init(seed=0, dtype=torch.bfloat16)
        weights = torch.cuda.memory_allocated() - before
        plan = (FaultPlan((Fault("kill", container_id=1, after_steps=1),))
                if {kill} else None)
        backend = ProcessBackend(
            cfg, 2, EngineConfig(n_slots=2, max_len=64, chunk_tokens=1,
                                 dtype=torch.bfloat16),
            params=params, allow_shared_cores=True, fault_plan=plan,
            max_respawns=0)
        with Router(backend, max_retries=1) as router:
            hs = [router.submit(Request(i, np.arange(5 + i, dtype=np.int32),
                                        6)) for i in range(4)]
            print("tokens", [len(h.result().tokens) for h in hs])
            print("failures", [f.kind for f in router.container_failures])
        del params, backend, router, hs
        gc.collect()
        torch.cuda.ipc_collect()
        print("memory", before, weights, torch.cuda.memory_allocated())
    """)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(src)})
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("tokens", "failures",
                                              "memory"))
    assert "memory" in lines, (out.returncode, out.stdout, out.stderr)
    assert lines["tokens"] == "[6, 6, 6, 6]", out.stdout
    assert lines["failures"] == ("['dead']" if kill else "[]"), out.stdout
    before, weights, after = map(int, lines["memory"].split())
    parked = "shared CUDA tensors released" in out.stderr
    if release:
        assert out.returncode == 0, out.stderr[-3000:]
        assert after == before and not parked, (out.stdout, out.stderr)
    else:
        assert after >= before + weights and parked, (out.stdout,
                                                      out.stderr)


# ---------------------------------------------------------------------------
# the decode chunk as a captured CUDA graph (serving/engine.py)
# ---------------------------------------------------------------------------
# (arch, int8 KV cache, cache, prefix sharing); every cache kind a card
# engine replays its step graph over
GRAPH_KINDS = {
    "dense": ("qwen3-0.6b-reduced", False, "dense", False),
    "paged_shared": ("qwen3-0.6b-reduced", False, "paged", True),
    "int8_dense": ("qwen3-0.6b-reduced", True, "dense", False),
    "int8_paged": ("qwen3-0.6b-reduced", True, "paged", False),
    "mamba2": ("mamba2-2.7b-reduced", False, "dense", False),
    "mla_dense": ("deepseek-v2-lite-16b-reduced", False, "dense", False),
    "mla_paged": ("deepseek-v2-lite-16b-reduced", False, "paged", False),
    # a 64-slot local ring (wraps past position 64) beside a global layer
    # that is a full ring or paged
    "gemma_dense": ("gemma3-27b-reduced", False, "dense", False),
    "gemma_paged": ("gemma3-27b-reduced", False, "paged", False)}
# prompt lengths every family admits (mamba2-reduced: ones its 32-token
# scan chunk divides) and budgets
GRAPH_SPECS = [(12, 21), (32, 9), (20, 30), (64, 17)]


def _graph_engine(kind, dtype=torch.bfloat16, seed=0, **options):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    arch, int8, cache, share = GRAPH_KINDS[kind]
    cfg = get_config(arch)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = Model(cfg, device="cuda")
    params = model.init(seed=seed, dtype=dtype)
    config = EngineConfig(n_slots=3, max_len=128, chunk_tokens=8,
                          dtype=dtype, cache=cache, block_size=16,
                          prefix_cache=share,
                          max_seqs=4 if cache == "paged" else None,
                          **options)
    return ServingEngine(model, params, config, device="cuda")


def _requests(vocab, specs, seed, prefix=None, start=0):
    import numpy as np

    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    head = () if prefix is None else (prefix,)
    return [Request(start + i, np.concatenate(
        [*head, rng.integers(0, vocab, (n,), dtype=np.int32)]), m)
        for i, (n, m) in enumerate(specs)]


def _graph_vs_eager(eng, what):
    """``chip_smoke.py``'s ``graph_vs_eager``: the engine's next chunk,
    replayed, against ``Model.decode_chunk`` run eagerly from the same
    state on a clone of its cache (tokens, emitted counts, every cache
    leaf's bytes and launch counts equal). Returns the chunk's steps."""
    import pathlib
    import sys

    import numpy as np
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs   # its module scope imports the stdlib only
    cs.np, cs.torch = np, torch
    return cs.graph_vs_eager(eng, what, "card test")


@pytest.mark.parametrize("kind", list(GRAPH_KINDS))
def test_graph_replay_gives_the_eager_chunks_bits(cuda, kind):
    """Every cache kind: the replayed chunk equals the eager
    ``decode_chunk`` in tokens, emitted counts, every cache leaf's bytes
    and launch counts; on the paged cache with sharing also after
    admissions that rewrote the table and after a copy-on-write fork."""
    eng = _graph_engine(kind)
    vocab = eng.model.cfg.vocab_size
    prefix = None
    if GRAPH_KINDS[kind][3]:
        import numpy as np
        prefix = np.random.default_rng(9).integers(0, vocab, (32,),
                                                   dtype=np.int32)
        eng.submit_many(_requests(vocab, [(7, 3)], 1, prefix, start=100))
        eng.run()                     # indexes the shared prompt
    eng.submit_many(_requests(vocab, GRAPH_SPECS, 2, prefix))
    eng.step()                        # admission, eager step, capture
    assert eng.graph_capture_s > 0 and eng.graph_pool_bytes >= 0
    compared = _graph_vs_eager(eng, kind)
    if prefix is not None:
        assert eng.prefix_hit_tokens_total > 0
        cb = eng.cache_backend
        row = next(i for i, s in enumerate(eng.slots) if s.active
                   and cb.allocator.ref(cb._blocks[i][0]) > 1)
        assert cb._cow_fork(row, 0)
        compared += _graph_vs_eager(eng, f"{kind} after a fork")
    eng.submit_many(_requests(vocab, [(16, 11)], 3, prefix, start=50))
    eng.step()                        # a re-admission, then a chunk
    while any(s.active for s in eng.slots):
        compared += _graph_vs_eager(eng, kind)
    eng.run()
    assert compared >= 8


def test_graph_streams_equal_the_eager_engines(cuda):
    """A card engine's greedy streams through its graph equal the same
    requests served with every chunk step eager."""
    streams = []
    for graph in (True, False):
        eng = _graph_engine("dense")
        if not graph:
            def eager(state, n, eng=eng):
                st = torch.from_numpy(state).cuda()
                block, emitted, _ = eng.model.decode_chunk(
                    eng.params, eng.cache_backend.tree,
                    {"tokens": st[0], "pos": st[1], "remaining": st[2],
                     "active": st[3].bool()}, n, max_len=eng.max_len)
                return block.cpu().numpy(), emitted.cpu().numpy()
            eng._run_chunk = eager
        eng.submit_many(_requests(eng.model.cfg.vocab_size, GRAPH_SPECS, 4))
        streams.append({c.rid: c.tokens for c in eng.run()})
        assert (eng._graph is not None) == graph
    assert streams[0] == streams[1]


def _serve_all(eng, first, later, seed, barrier=None):
    """Serve ``first``, and ``later`` after two steps, to completion; the
    tokens by request id."""
    vocab = eng.model.cfg.vocab_size
    eng.submit_many(_requests(vocab, first, seed))
    if barrier is not None:
        barrier.wait()
    got, steps = {}, 0
    while eng.has_work:
        eng.step()
        steps += 1
        if steps == 2:
            eng.submit_many(_requests(vocab, later, seed + 10, start=10))
        got.update({c.rid: list(c.tokens) for c in eng.done})
        eng.done.clear()
    return got


def test_two_engines_capture_at_once_while_the_other_prefills(cuda):
    """Two engines in two threads reach their first chunk together, the
    first behind a 512-token prefill, and prefill again while the other
    replays; both capture, and their streams equal each engine's served
    alone."""
    import threading

    plans = [([(12, 20), (500, 9)], [(300, 6)]),
             ([(20, 25), (30, 7)], [(300, 6)])]
    alone = [_serve_all(_graph_engine("dense"), *plans[i], seed=5 + i)
             for i in range(2)]
    engines = [_graph_engine("dense") for _ in range(2)]
    barrier = threading.Barrier(2)
    out, errors = [None, None], []

    def worker(i):
        try:
            out[i] = _serve_all(engines[i], *plans[i], seed=5 + i,
                                barrier=barrier)
        except BaseException as e:       # carried across the join
            errors.append(e)
    workers = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert not errors, errors
    assert all(e.graph_capture_s is not None for e in engines)
    assert out == alone


@pytest.mark.parametrize("what", ["cache", "table", "weight"])
def test_a_moved_leaf_raises_before_the_replay(cuda, what):
    eng = _graph_engine("paged_shared" if what == "table" else "dense")
    eng.submit_many(_requests(eng.model.cfg.vocab_size, [(20, 30)], 6))
    eng.step()
    assert eng._graph is not None
    tree = eng.cache_backend.tree
    if what == "cache":
        tree[1]["v"] = tree[1]["v"].clone()
    elif what == "table":
        tree[0]["table"] = tree[0]["table"].clone()
    else:
        mlp = eng.params["layers"][0]["mlp"]
        mlp["w_up"] = mlp["w_up"].clone()
    replays = eng.graph_replays
    with pytest.raises(RuntimeError, match="moved since its capture"):
        eng.step()
    assert eng.graph_replays == replays


# ---------------------------------------------------------------------------
# sampling inside the step graph, and a rebuilt thread container
# ---------------------------------------------------------------------------
def _chip_smoke():
    import pathlib
    import sys

    import numpy as np
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs   # its module scope imports the stdlib only
    cs.np, cs.torch = np, torch
    return cs


@pytest.mark.parametrize("kind", ["dense", "paged_shared", "mamba2",
                                  "mla_dense"])
def test_sampling_graph_replay_gives_the_eager_chunks_bits(cuda, kind):
    """A sampling engine's replayed chunks equal the eager chunks run
    from the same random stream state, and leave the stream where the
    eager chunk leaves it, chunk after chunk."""
    eng = _graph_engine(kind, greedy=False, seed=3)
    eng.submit_many(_requests(eng.model.cfg.vocab_size, GRAPH_SPECS, 2))
    eng.step()
    assert eng._graph is not None
    compared = 0
    while any(s.active for s in eng.slots):
        compared += _graph_vs_eager(eng, f"{kind} sampling")
    eng.run()
    assert compared >= 8 and eng.draws > compared


def test_consecutive_replays_draw_new_noise(cuda):
    """Replays from one slot state: the second, with the stream as the
    first advanced it, samples other tokens; restoring the stream gives
    the first replay's tokens again."""
    eng = _graph_engine("dense", greedy=False, seed=5)
    eng.submit_many(_requests(eng.model.cfg.vocab_size, GRAPH_SPECS, 3))
    eng.step()
    assert _chip_smoke().noise_advances(eng) > 0


def test_sampled_streams_through_the_graph_equal_per_token(cuda):
    """One seed, one stream: the graph-served chunked engine and the
    eager per-token engine sample the same streams; another seed
    differs."""
    streams = []
    for chunked, seed in ((True, 4), (False, 4), (True, 9)):
        eng = _graph_engine("dense", greedy=False, seed=seed,
                            chunked=chunked)
        eng.submit_many(_requests(eng.model.cfg.vocab_size, GRAPH_SPECS, 4))
        streams.append({c.rid: c.tokens for c in eng.run()})
        assert (eng._graph is not None) == chunked
    assert streams[0] == streams[1] != streams[2]


def test_a_rebuilt_thread_engine_frees_the_old_cache_and_captures_anew(
        cuda):
    """An error in container 1's engine: the engine is rebuilt (its own
    cache, stream and graph) while container 0's engine keeps replaying;
    the dead engine's cache is freed, and every stream equals the
    fault-free run's."""
    import weakref

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.faults import Fault, FaultPlan
    from repro_torch.serving.router import Router

    # float32: a prefill row's bits do not depend on its batch there
    # (fixed ROW_SLICE-row projection slices), so a retried request
    # re-batched on the rebuilt engine must give the fault-free bits
    model = Model(get_config("qwen3-0.6b-reduced"), device="cuda")
    params = model.init(seed=0, dtype=torch.float32)
    config = EngineConfig(n_slots=2, max_len=8192, chunk_tokens=4,
                          dtype=torch.float32)
    reqs = _requests(model.cfg.vocab_size,
                     [(12, 30), (32, 30), (20, 30), (16, 30)], 8)
    with Router(ThreadBackend(model, params, 2, config)) as router:
        want = {h.rid: h.tokens() for h in [router.submit(r) for r in reqs]}
    # one warm-up step an engine (its first cuBLAS workspace, its graph),
    # then the error two steps into the real run
    plan = FaultPlan((Fault("error", container_id=1, after_steps=3),))
    backend = ThreadBackend(model, params, 2, config, fault_plan=plan)
    dead = weakref.ref(backend.engines[1])
    cache_bytes = sum(t.nbytes for g in backend.engines[1].cache_backend.tree
                      for t in g.values())
    with Router(backend, max_retries=2) as router:
        for h in [router.submit(r) for r in _requests(
                model.cfg.vocab_size, [(12, 2), (12, 2)], 9, start=50)]:
            h.result()
        assert all(e._graph is not None for e in backend.engines)
        rebuilds = _chip_smoke().watch_rebuilds(backend)
        handles = [router.submit(r) for r in reqs]
        replays = None
        while not all(h.done for h in handles):
            router.poll()
            if backend.failures and replays is None:
                replays = backend.engines[0].graph_replays
        got = {h.rid: h.tokens() for h in handles}
        assert backend.engines[0].graph_replays > replays
        new = backend.engines[1]
        assert dead() is None and new.graph_capture_s is not None
        assert backend.rebuild_s[1] is not None
        # the dead engine's cache was freed before the new one allocated
        [(cid, incarnation, failed, dropped, built)] = rebuilds
        assert (cid, incarnation) == (1, 1)
        assert failed - dropped >= cache_bytes, (failed, dropped)
        assert built - dropped >= cache_bytes, (dropped, built)
    assert [f.kind for f in router.container_failures] == ["error"]
    assert got == want


# ---------------------------------------------------------------------------
# the paged cache over SSM rows, and the online container-count loop
# ---------------------------------------------------------------------------
def test_paged_mamba2_graph_replay_gives_the_eager_chunks_bits(cuda):
    """A paged mamba2 engine (no paged group: the state rows stay dense
    under the block accounting): replayed chunks equal the eager chunks
    over every state row, through a re-admission into a freed row, and
    its greedy streams equal the dense engine's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    model = Model(get_config("mamba2-2.7b-reduced"), device="cuda")
    params = model.init(seed=0, dtype=torch.bfloat16)
    base = dict(n_slots=3, max_len=128, chunk_tokens=8,
                dtype=torch.bfloat16)
    eng = ServingEngine(model, params, EngineConfig(
        cache="paged", block_size=16, max_seqs=4, **base), device="cuda")
    assert eng.cache_backend._groups == []
    vocab = model.cfg.vocab_size
    eng.submit_many(_requests(vocab, GRAPH_SPECS, 2))
    eng.step()
    compared = _graph_vs_eager(eng, "mamba2 paged")
    eng.submit_many(_requests(vocab, [(16, 11)], 3, start=50))
    eng.step()
    while any(s.active for s in eng.slots):
        compared += _graph_vs_eager(eng, "mamba2 paged")
    eng.run()
    assert compared >= 8
    streams = []
    for cache in ("dense", "paged"):
        e = ServingEngine(model, params, EngineConfig(
            cache=cache, block_size=16, max_seqs=4 if cache == "paged"
            else None, **base), device="cuda")
        e.submit_many(_requests(vocab, GRAPH_SPECS, 4))
        streams.append({c.rid: c.tokens for c in e.run()})
        assert e._graph is not None
    assert streams[0] == streams[1]


def test_a_two_count_adaptive_router_serves_the_fixed_routers_tokens(cuda):
    """Over reduced qwen3 on the card, one request a prefill: windows of 4
    through Router(backend_factory=ThreadBackend, counts 1 and 2) visit
    both counts, build each backend once, and give a fixed
    Router(ThreadBackend(1))'s greedy tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.containers import card_feasible_counts
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.router import Router

    model = Model(get_config("qwen3-0.6b-reduced"), device="cuda")
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=2, max_len=128, chunk_tokens=8,
                          dtype=torch.bfloat16, batch_admit=False)
    counts = card_feasible_counts(
        model.cfg, config, max_containers=2,
        card_bytes=torch.cuda.get_device_properties(0).total_memory)
    assert counts == [1, 2]
    reqs = _requests(model.cfg.vocab_size,
                     [(12, 9), (32, 5), (20, 12), (64, 7)] * 3, 6)
    with Router(ThreadBackend(model, params, 1, config)) as fixed:
        want = {h.rid: h.tokens() for h in [fixed.submit(r) for r in reqs]}
    built = []

    def factory(n):
        built.append(n)
        return ThreadBackend(model, params, n, config)
    got = {}
    with Router(backend_factory=factory, feasible_counts=counts, window=4,
                epsilon=0.0) as router:
        for i in range(0, len(reqs), 4):
            handles = [router.submit(r) for r in reqs[i:i + 4]]
            router.drain()
            got.update({h.rid: h.tokens() for h in handles})
        assert {w.n_containers for w in router.history} == {1, 2}
        assert all(w.energy_j > 0 and w.tokens_per_s > 0
                   for w in router.history)
    assert sorted(built) == [1, 2]
    assert got == want


def test_slo_replay_dispatches_in_rank_order_with_the_plain_tokens(cuda):
    """Phase 13a at 24 requests over reduced qwen3 on the card: the first
    24 arrivals of diurnal-bursty (seed 1), open-loop, through
    Router(ThreadBackend(2)) under interactive:0.5,batch:8.0 with
    tenant_quota 8 and max_queue 32, compressed 100x so that the reduced
    model, which serves a request in milliseconds, still finds a backlog.
    Every dispatch takes the lowest (rank, arrival) of the live backlog,
    some with entries waiting, each request ends once, and every
    completed request's greedy tokens equal a plain fixed Router's fed one
    request at a time."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.events import RejectedEvent
    from repro_torch.serving.router import Router
    from repro_torch.workload.replay import build_request, replay
    from repro_torch.workload.slo import SLOSpec
    from repro_torch.workload.traces import get_preset, synthesize

    model = Model(get_config("qwen3-0.6b-reduced"), device="cuda")
    params = model.init(seed=0, dtype=torch.bfloat16)
    config = EngineConfig(n_slots=4, max_len=512, chunk_tokens=32,
                          dtype=torch.bfloat16, batch_admit=False)
    slo = SLOSpec.parse("interactive:0.5,batch:8.0")
    trace = synthesize(get_preset("diurnal-bursty"), seed=1)
    trace = dataclasses.replace(trace, requests=trace.requests[:24])
    vocab = model.cfg.vocab_size
    backend = ThreadBackend(model, params, 2, config)
    log, handles = [], []
    with Router(backend, slo=slo, tenant_quota=8, max_queue=32) as router:
        submit_backend, submit_router = backend.submit, router.submit

        def logged(cid, req):
            live = [(rank, rid) for rank, _, rid in router._backlog
                    if rid in router._handles and rid not in router._rid_cid]
            log.append(((slo.cls(req.priority).rank, req.rid),
                        min(live) if live else None))
            submit_backend(cid, req)

        def kept(req):
            h = submit_router(req)
            handles.append(h)
            return h
        backend.submit, router.submit = logged, kept
        report = replay(trace, router, time_scale=100.0, vocab_size=vocab)
    assert report.n_done + report.n_shed + report.n_failed == 24
    assert all(low is None or got <= low for got, low in log)
    assert any(low is not None for _, low in log)
    done = {}
    for h in handles:
        assert h.done and (h.completion is None) != (h.failure is None)
        if isinstance(h.failure, RejectedEvent):
            assert h.failure.kind in ("queue", "slo", "tenant")
            assert h.failure.priority in slo.names()
        elif h.completion is not None:
            done[h.rid] = list(h.completion.tokens)
    assert len(done) == report.n_done > 0
    by_rid = {tr.rid: tr for tr in trace.requests}
    with Router(ThreadBackend(model, params, 2, config)) as plain:
        want = {rid: plain.submit(build_request(
            by_rid[rid], vocab_size=vocab)).tokens() for rid in sorted(done)}
    assert done == want


# ---------------------------------------------------------------------------
# the gemma family and the 8B dense configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_gemmas_local_prefill(cuda, dtype):
    """gemma3-27b's local layers: a 1300-token prompt under the 1024-token
    window, H 32 / Hkv 16 / K 128."""
    q = _randn(cuda, 1, 1300, 32, 128, dtype=dtype)
    k = _randn(cuda, 1, 1300, 16, 128, dtype=dtype)
    v = _randn(cuda, 1, 1300, 16, 128, dtype=dtype)
    got = ops.flash_attention(q, k, v, window=1024)
    torch.cuda.synchronize()
    _assert_close(got, ref.flash_attention(q, k, v, window=1024), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_over_gemmas_wrapped_ring(cuda, dtype):
    """G 2, K 128 over a 1024-slot ring written to positions past 1024
    (every slot live) and below it (a live prefix)."""
    from repro_torch.models.attention import ring_positions
    pos = torch.tensor([1030, 1500, 2047, 700], device="cuda")
    valid = (ring_positions(1024, pos) >= 0).contiguous()
    assert bool(valid[:3].all()) and int(valid[3].sum()) == 701
    q = _randn(cuda, 4, 32, 128, dtype=dtype)
    k = _randn(cuda, 4, 1024, 16, 128, dtype=dtype)
    v = _randn(cuda, 4, 1024, 16, 128, dtype=dtype)
    got = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    _assert_close(got, ref.decode_attention(q, k, v, valid), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_the_8b_configs_g4(cuda, dtype):
    """qwen3-8b's and llama3.1-8b's 4-row decode step: G 4, K 128 (G·K =
    512, the widest instantiation), dense and paged, the paged kernel
    bitwise the dense one over the gathered view."""
    got = _split_case(cuda, dtype, [48, 160, 300, 544], 32, 8, 128, 16,
                      128, 0.0)
    assert got.shape == (4, 32, 128)


def _gemma_reduced(**over):
    import dataclasses

    from repro_torch.configs.base import reduce_config
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(reduce_config(
        get_config("gemma3-27b"), n_layers=5, sliding_window=16), **over)


def test_gemma_reduced_on_the_card_matches_the_cpu(cuda):
    """Reduced gemma (two super-blocks and a remainder layer, a 16-slot
    ring) in float32: a 40-token prefill and 40 decode steps, so the rings
    wrap in both, with card logits within 1e-3 of the CPU's; then the
    same requests through a card engine and a CPU engine, dense and paged,
    give the same greedy streams."""
    import numpy as np

    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = _gemma_reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    cp = cpu.init(seed=0)
    gp = _to_card(cp)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40), dtype=np.int32))
    cc, gc = cpu.init_cache(2, 128), card.init_cache(2, 128)
    cl = cpu.prefill(cp, toks, cc)
    gl = card.prefill(gp, toks.cuda(), gc).cpu()
    pos = torch.full((2,), 40, dtype=torch.int32)
    for step in range(41):
        torch.testing.assert_close(gl, cl, atol=1e-3, rtol=1e-3,
                                   msg=f"step {step}")
        if step == 40:
            break
        tok = cl.argmax(-1).to(torch.int32)[:, None]
        cl = cpu.decode_step(cp, tok, cc, pos)
        gl = card.decode_step(gp, tok.cuda(), gc, pos.cuda()).cpu()
        pos = pos + 1
    specs = [(10, 30), (40, 14), (25, 9), (64, 20)]
    for cache in ("dense", "paged"):
        conf = EngineConfig(n_slots=2, max_len=128, chunk_tokens=8,
                            cache=cache, max_seqs=2 if cache == "paged"
                            else None)
        streams = []
        for model, params, dev in ((cpu, cp, "cpu"), (card, gp, "cuda")):
            eng = ServingEngine(model, params, conf, device=dev)
            eng.submit_many(_requests(cfg.vocab_size, specs, 6))
            streams.append({c.rid: c.tokens for c in eng.run()})
        assert streams[0] == streams[1], cache


def test_gemma_dense_equals_paged_in_bf16_without_prefill_padding(cuda):
    """A bf16 paged gemma engine prefills each prompt alone at its exact
    width, as the dense engine does (the window shuts the sharing gate),
    and the two engines' greedy streams are identical."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = _gemma_reduced()
    model = Model(cfg, device="cuda")
    params = model.init(seed=0, dtype=torch.bfloat16)
    specs = [(10, 30), (40, 14), (25, 9), (64, 20), (100, 12)]
    streams = []
    for cache in ("dense", "paged"):
        eng = ServingEngine(model, params, EngineConfig(
            n_slots=2, max_len=128, chunk_tokens=8, cache=cache,
            max_seqs=2 if cache == "paged" else None, prefix_cache=True
            if cache == "paged" else False, dtype=torch.bfloat16),
            device="cuda")
        assert not eng._share
        eng.submit_many(_requests(cfg.vocab_size, specs, 7))
        streams.append({c.rid: c.tokens for c in eng.run()})
    assert streams[0] == streams[1]


def test_model_refuses_head_shapes_without_a_kernel_on_the_card(cuda):
    """G = 6 at K = 256 and G = 3 have no decode kernel: ``Model`` refuses
    them on the card, naming G and K; mixtral-8x22b's (6, 128) and
    zamba2-7b's (1, 112) are taken over a bf16 and over an int8 cache."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    base = get_config("qwen3-8b")
    g6 = dataclasses.replace(base, n_heads=48, n_kv_heads=8)
    k112 = dataclasses.replace(base, n_heads=32, n_kv_heads=32, head_dim=112)
    Model(g6)
    Model(k112)
    with pytest.raises(ValueError, match="G=6, K=256"):
        Model(dataclasses.replace(g6, head_dim=256))
    with pytest.raises(ValueError, match="G=3, K=128"):
        Model(dataclasses.replace(base, n_heads=24))
    Model(dataclasses.replace(g6, kv_cache_dtype="int8"))
    Model(dataclasses.replace(k112, kv_cache_dtype="int8"))
    with pytest.raises(ValueError, match="int8 kernel for G=6, K=256"):
        Model(dataclasses.replace(g6, head_dim=256, kv_cache_dtype="int8"))


def test_ptxas_shows_no_spill_in_the_new_split_instantiations(cuda):
    """``scripts/ptxas_report.py`` (its own build, ``-Xptxas=-v``) lists
    the split body's and the int8 split body's (1, 112) and (6, 128)
    instantiations, both query dtypes and both address policies, with no
    spill, and exits 0."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "scripts" /
                                              "ptxas_report.py")],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    for head, n in (("split decode new shapes:", 12),
                    ("int8 decode new shapes:", 8)):
        line = [ln for ln in out.stdout.splitlines() if ln.startswith(head)]
        assert line and line[0].endswith(" 0 spill"), line
        assert f"{head} {n} instantiations" in line[0], line


# ---------------------------------------------------------------------------
# whisper: the encoder, cross attention and the memory rows on the card
# ---------------------------------------------------------------------------
def _with_frames(cfg, reqs):
    """Each request with its own frames, 0.1 x N(0, 1) seeded by its id."""
    import numpy as np
    for r in reqs:
        r.extras = {"audio_frames": (0.1 * np.random.default_rng(
            r.rid).standard_normal((cfg.encoder_seq, cfg.d_model))).astype(
                np.float32)}
    return reqs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_whispers_shapes(cuda, dtype):
    """The prefill kernel not causal at the encoder's self attention (S
    1500, H = Hkv = 20, K = Kv = 64) and at the cross attention (30
    queries against 1500 keys), causal at the decoder's self attention
    (3 prompts in a 256-token bucket, and a 100-token one off the tile
    edges), and the decode kernel as ``decode_cross_attention`` over a
    wholly valid 1500-row memory (23 splits of 64 and one of 28),
    against their plain versions."""
    q = _randn(cuda, 1, 1500, 20, 64, dtype=dtype)
    k, v = (_randn(cuda, 1, 1500, 20, 64, dtype=dtype) for _ in range(2))
    _assert_close(ops.flash_attention(q, k, v, causal=False),
                  ref.flash_attention(q, k, v, causal=False), dtype)
    for B, S in ((3, 256), (1, 100)):
        qs, ks, vs = (_randn(cuda, B, S, 20, 64, dtype=dtype)
                      for _ in range(3))
        _assert_close(ops.flash_attention(qs, ks, vs, causal=True),
                      ref.flash_attention(qs, ks, vs, causal=True), dtype)
    q = _randn(cuda, 2, 30, 20, 64, dtype=dtype)
    k, v = (_randn(cuda, 2, 1500, 20, 64, dtype=dtype) for _ in range(2))
    _assert_close(ops.flash_attention(q, k, v, causal=False),
                  ref.flash_attention(q, k, v, causal=False), dtype)
    q = _randn(cuda, 3, 20, 64, dtype=dtype)
    valid = torch.ones(3, 1500, dtype=torch.bool, device="cuda")
    before = ops.launch_counts()["decode_attention"]
    _assert_close(ops.decode_cross_attention(q, k[:1].expand(
        3, -1, -1, -1).contiguous(), v[:1].expand(3, -1, -1, -1)
        .contiguous(), valid), ref.decode_attention(
            q, k[:1].expand(3, -1, -1, -1), v[:1].expand(3, -1, -1, -1),
            valid), dtype)
    assert ops.launch_counts()["decode_attention"] == before + 1


def test_whisper_reduced_on_the_card_matches_the_cpu(cuda):
    """Reduced whisper in float32: a 40-token prefill behind each row's
    frames and 16 decode steps with card logits within 1e-3 of the CPU's;
    then the same requests through a card and a CPU engine, dense and
    paged, give the same greedy streams."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = get_config("whisper-large-v3-reduced")
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    cp = cpu.init(seed=0)
    gp = _to_card(cp)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40),
                                         dtype=np.int32))
    frames = torch.from_numpy((0.1 * rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model))).astype(np.float32))
    cc, gc = cpu.init_cache(2, 128), card.init_cache(2, 128)
    cl = cpu.prefill(cp, toks, cc, audio_frames=frames)
    gl = card.prefill(gp, toks.cuda(), gc,
                      audio_frames=frames.cuda()).cpu()
    pos = torch.full((2,), 40, dtype=torch.int32)
    for step in range(17):
        torch.testing.assert_close(gl, cl, atol=1e-3, rtol=1e-3,
                                   msg=f"step {step}")
        if step == 16:
            break
        tok = cl.argmax(-1).to(torch.int32)[:, None]
        cl = cpu.decode_step(cp, tok, cc, pos)
        gl = card.decode_step(gp, tok.cuda(), gc, pos.cuda()).cpu()
        pos = pos + 1
    specs = [(10, 30), (40, 14), (25, 9), (64, 20)]
    for cache in ("dense", "paged"):
        conf = EngineConfig(n_slots=2, max_len=128, chunk_tokens=8,
                            cache=cache, max_seqs=2 if cache == "paged"
                            else None)
        streams = []
        for model, params, dev in ((cpu, cp, "cpu"), (card, gp, "cuda")):
            eng = ServingEngine(model, params, conf, device=dev)
            eng.submit_many(_with_frames(cfg, _requests(cfg.vocab_size,
                                                        specs, 6)))
            streams.append({c.rid: c.tokens for c in eng.run()})
        assert streams[0] == streams[1], cache


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_whisper_graph_replay_gives_the_eager_chunks_bits(cuda, cache):
    """A bf16 whisper engine's replayed chunks equal the eager
    ``decode_chunk`` on a clone of its cache (the memory rows and the
    self attention's rows or pages among the leaves), and its dense and
    paged streams are identical."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = get_config("whisper-large-v3-reduced")
    model = Model(cfg, device="cuda")
    params = model.init(seed=0, dtype=torch.bfloat16)
    eng = ServingEngine(model, params, EngineConfig(
        n_slots=3, max_len=128, chunk_tokens=8, dtype=torch.bfloat16,
        cache=cache, max_seqs=4 if cache == "paged" else None,
        prefix_cache=cache == "paged"), device="cuda")
    assert not eng._share
    eng.submit_many(_with_frames(cfg, _requests(cfg.vocab_size,
                                                GRAPH_SPECS, 2)))
    eng.step()
    compared = 0
    while any(s.active for s in eng.slots):
        compared += _graph_vs_eager(eng, f"whisper {cache}")
    eng.run()
    assert compared >= 8


# ---------------------------------------------------------------------------
# the detector testbed on the card, and card memory after an engine is freed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2])
def test_card_testbed_matches_the_cpu_detector(cuda, n):
    """n pinned containers run their segments on the one card: the
    combined outputs match the detector on the CPU within 1e-3, two
    containers give one container's outputs within 1e-5, and no child is
    left."""
    import multiprocessing

    import numpy as np

    from repro_torch.core import testbed as tb
    frames = tb.make_video(10, seed=4)
    got = tb.run_split(frames, n, total_cores=2, batch=4)
    want = tb.detector_forward(
        [torch.from_numpy(w) for w in tb.detector_weights(0)],
        torch.from_numpy(frames)).numpy()
    assert got.outputs.shape == (10, 18) and got.disjoint
    np.testing.assert_allclose(got.outputs, want, atol=1e-3, rtol=1e-3)
    if n == 2:
        one = tb.run_split(frames, 1, total_cores=2, batch=4)
        np.testing.assert_allclose(got.outputs, one.outputs, atol=1e-5,
                                   rtol=0)
    cpc = got.cores_per_container
    assert got.busy_core_seconds == sum(t * cpc for t in got.per_container_s)
    assert got.busy_core_seconds <= n * cpc * got.wall_s + 1e-6
    assert not multiprocessing.active_children()


def test_card_memory_returns_after_an_engine_is_freed(cuda):
    """A reduced bf16 model served through ``Router(ThreadBackend(2))``
    (two engines, their streams and step graphs), then freed, 5 times:
    once the cuBLAS workspaces are cleared, ``memory_allocated`` after
    the last free is within 1 MiB of its value after the first (no
    tensor of a freed model or engine is held); what the workspaces held
    before the clearing is printed beside it."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.router import Router
    cfg = get_config("qwen3-0.6b-reduced")

    def build_serve_free() -> tuple[int, int, int]:
        model = Model(cfg, device="cuda")
        params = model.init(seed=0, dtype=torch.bfloat16)
        config = EngineConfig(n_slots=2, max_len=256, chunk_tokens=4,
                              dtype=torch.bfloat16)
        with Router(ThreadBackend(model, params, 2, config)) as router:
            for h in [router.submit(r) for r in _requests(
                    cfg.vocab_size, [(12, 8), (40, 8), (20, 8)], 3)]:
                h.result()
            footprint = torch.cuda.memory_allocated()
        del router, params, model
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        return footprint, held, torch.cuda.memory_allocated()

    rows = [build_serve_free() for _ in range(5)]
    print(f"(footprint, after free, after clearing cuBLAS workspaces) B: "
          f"{rows}")
    assert rows[-1][2] - rows[0][2] <= 1 << 20, rows


# ---------------------------------------------------------------------------
# training: the backward kernels and a reduced train step
# ---------------------------------------------------------------------------
BWD_TOL = 5e-5


def _assert_bwd_close(got, want):
    tol = BWD_TOL + BWD_TOL * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,K,Kv,causal,window,softcap", [
    (2, 77, 77, 16, 8, 128, 128, True, 0, 0.0),
    (1, 130, 130, 8, 4, 128, 128, True, 40, 0.0),
    (1, 100, 100, 4, 4, 192, 128, True, 0, 0.0),
    (1, 150, 150, 4, 4, 64, 64, False, 0, 0.0),
    (2, 40, 40, 4, 2, 128, 128, True, 0, 5.0),
    (1, 40, 150, 4, 2, 64, 64, False, 0, 0.0),
    (1, 37, 37, 4, 2, 48, 32, True, 0, 0.0),
    (2, 1, 50, 4, 2, 32, 32, True, 0, 0.0),
])
def test_flash_backward_kernel_matches_plain(cuda, B, Sq, Skv, H, Hkv, K, Kv,
                                             causal, window, softcap):
    from repro_torch.kernels import flash_attention as fa
    f32 = torch.float32
    q = _randn(cuda, B, Sq, H, K, dtype=f32)
    k = _randn(cuda, B, Skv, Hkv, K, dtype=f32)
    v = _randn(cuda, B, Skv, Hkv, Kv, dtype=f32)
    dout = _randn(cuda, B, Sq, H, Kv, dtype=f32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    ro, rl = ref.flash_attention_lse(q, k, v, **kw)
    _assert_bwd_close(lse, rl)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd(q, k, v, ro, rl, dout, **kw)
    for g, w in zip(got, want):
        _assert_bwd_close(g, w)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _f32_flash_both_ways(q, k, v, dout, **kw):
    """The float32 forward (out with and without its lse: the same bits)
    and backward against their plain versions; returns the kernels'
    (out, lse, dq, dk, dv)."""
    from repro_torch.kernels import flash_attention as fa
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    ro, rl = ref.flash_attention_lse(q, k, v, **kw)
    _assert_close(out, ro, torch.float32)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for g, w in zip(grads, ref.flash_attention_bwd(q, k, v, ro, rl, dout,
                                                   **kw)):
        _assert_bwd_close(g, w)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    return (out, lse, *grads)


@pytest.mark.parametrize("Sq,Skv", [(63, 63), (65, 65), (129, 129),
                                    (63, 129), (129, 65), (65, 63)])
@pytest.mark.parametrize("K,Kv", [(64, 64), (128, 128), (100, 112),
                                  (36, 16)])
def test_f32_flash_bodies_at_their_tile_edges(cuda, Sq, Skv, K, Kv):
    """The split-TF32 forward and backward around the 64-row and 64-key
    tile edges, with K not a multiple of 8 (100, 36: padded columns) and
    Kv padded to the tiles' width (112, 16)."""
    f32 = torch.float32
    q = _randn(cuda, 1, Sq, 4, K, dtype=f32)
    k = _randn(cuda, 1, Skv, 2, K, dtype=f32)
    v = _randn(cuda, 1, Skv, 2, Kv, dtype=f32)
    dout = _randn(cuda, 1, Sq, 4, Kv, dtype=f32)
    _f32_flash_both_ways(q, k, v, dout)


def _off_16_bytes(t):
    """t's values in a fresh contiguous buffer one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("K", [128, 72, 5])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 33, 0.0), (True, 0, 30.0)])
def test_f32_flash_bodies_on_rows_off_16_bytes(cuda, K, causal, window,
                                               softcap):
    """Rows that do not start on 16 bytes take the element-by-element
    staging path, and give the bits of the 16-byte (cp.async) path."""
    f32 = torch.float32
    q = _randn(cuda, 2, 90, 4, K, dtype=f32)
    k = _randn(cuda, 2, 90, 2, K, dtype=f32)
    v = _randn(cuda, 2, 90, 2, 64, dtype=f32)
    dout = _randn(cuda, 2, 90, 4, 64, dtype=f32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    aligned = _f32_flash_both_ways(q, k, v, dout, **kw)
    off = _f32_flash_both_ways(*(_off_16_bytes(t) for t in (q, k, v, dout)),
                               **kw)
    assert all(torch.equal(a, b) for a, b in zip(aligned, off))


@pytest.mark.parametrize("K,Kv", [(128, 256), (256, 128)])
def test_flash_backward_at_the_widest_tiles(cuda, K, Kv):
    """K + Kv = 384, the widest pair whose tiles fit in shared memory."""
    f32 = torch.float32
    q = _randn(cuda, 1, 130, 4, K, dtype=f32)
    k = _randn(cuda, 1, 130, 2, K, dtype=f32)
    v = _randn(cuda, 1, 130, 2, Kv, dtype=f32)
    dout = _randn(cuda, 1, 130, 4, Kv, dtype=f32)
    _f32_flash_both_ways(q, k, v, dout, window=40)


@pytest.mark.parametrize("rows,D", [(4096, 1024), (37, 128), (5, 3584)])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rows, D):
    from repro_torch.kernels import rmsnorm as rn
    f32 = torch.float32
    x = _randn(cuda, rows, D, dtype=f32)
    s = 1 + 0.1 * _randn(cuda, D, dtype=f32)
    g = _randn(cuda, rows, D, dtype=f32)
    dx, ds = rn.rmsnorm_bwd(x, s, g)
    rx, rs = ref.rmsnorm_bwd(x, s, g)
    _assert_bwd_close(dx, rx)
    _assert_bwd_close(ds, rs)
    wide = _randn(cuda, rows, D + 64, dtype=f32)
    dx, ds = rn.rmsnorm_bwd(wide[:, :D], s, g)
    rx, rs = ref.rmsnorm_bwd(wide[:, :D], s, g)
    _assert_bwd_close(dx, rx)
    _assert_bwd_close(ds, rs)
    (a, b), (c, d) = rn.rmsnorm_pair_bwd(x, s, g, x[:3], s, g[:3])
    assert torch.equal(a, rn.rmsnorm_bwd(x, s, g)[0])
    _assert_bwd_close(d, ref.rmsnorm_bwd(x[:3], s, g[:3])[1])


# every norm width the card trains or may train (D, row stride or 0):
# qwen3-0.6b's block and q/k norms, deepseek's latent 512 read in rows of
# 576 and its 2048, gemma3's 5376, zamba2's 3584, mamba2's 2560, 4096,
# internvl2's and mixtral's 6144, and the reduced configs' 256, 64 and 32
RMS_BWD_WIDTHS = ((1024, 0), (128, 0), (512, 576), (2048, 0), (5376, 0),
                  (3584, 0), (2560, 0), (4096, 0), (6144, 0), (256, 0),
                  (64, 0), (32, 0))


def _rms_bwd_case(gen, rows, D, stride=0):
    wide = _randn(gen, rows, stride or D, dtype=torch.float32)
    s = 1 + 0.1 * _randn(gen, D, dtype=torch.float32)
    return wide[:, :D], s, _randn(gen, rows, D, dtype=torch.float32)


@pytest.mark.parametrize("D,stride", RMS_BWD_WIDTHS)
@pytest.mark.parametrize("rows", [1, 3, 37, 4099])
def test_rmsnorm_bwd_at_every_training_width(cuda, D, stride, rows):
    """dx and dscale against the plain version; one counted launch a
    call; two calls give the same bits."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, g = _rms_bwd_case(cuda, rows, D, stride)
    before = ops.launch_counts()["rmsnorm_bwd"]
    dx, ds = rn.rmsnorm_bwd(x, s, g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm_bwd"] == before + 1
    rx, rs = ref.rmsnorm_bwd(x, s, g)
    _assert_bwd_close(dx, rx)
    _assert_bwd_close(ds, rs)
    again = rn.rmsnorm_bwd(x, s, g)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])


@pytest.mark.parametrize("D", [1024, 128, 512, 5376, 1000, 5, 20000])
def test_rmsnorm_bwd_off_16_bytes_gives_the_aligned_bits(cuda, D):
    """A base one element off 16 bytes, a row stride of D + 1 and a
    scale off 16 bytes take the one-element path with the 16-byte path's
    bits; D = 1000 and 5 (4 does not divide them) and 20000 (past 8
    vectors a lane: the looping body) against the plain version."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, g = _rms_bwd_case(cuda, 37, D)
    dx, ds = rn.rmsnorm_bwd(x, s, g)
    rx, rs = ref.rmsnorm_bwd(x, s, g)
    _assert_bwd_close(dx, rx)
    _assert_bwd_close(ds, rs)
    off_s = _copy_at(s[None], offset=1)[0]
    for args in ((_copy_at(x, offset=1), s, _copy_at(g, offset=1)),
                 (_copy_at(x, pad=1), s, g), (x, off_s, g)):
        got = rn.rmsnorm_bwd(*args)
        assert torch.equal(got[0], dx) and torch.equal(got[1], ds)


@pytest.mark.parametrize("D,stride", [(128, 0), (1024, 0), (512, 576),
                                      (5376, 0)])
def test_rmsnorm_pair_bwd_equals_each_solo_launch(cuda, D, stride):
    """A pair's dx and dscale equal each tensor's own launch bit for bit,
    in either order, beside an empty tensor too (whose dscale is 0)."""
    from repro_torch.kernels import rmsnorm as rn
    x, sx, gx = _rms_bwd_case(cuda, 4099, D, stride)
    y, sy, gy = _rms_bwd_case(cuda, 37, D)
    solo_x, solo_y = rn.rmsnorm_bwd(x, sx, gx), rn.rmsnorm_bwd(y, sy, gy)
    a, b = rn.rmsnorm_pair_bwd(x, sx, gx, y, sy, gy)
    c, d = rn.rmsnorm_pair_bwd(y, sy, gy, x, sx, gx)
    for got, want in ((a, solo_x), (b, solo_y), (c, solo_y), (d, solo_x)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    e, f = rn.rmsnorm_pair_bwd(x[:0], sx, gx[:0], y, sy, gy)
    h, k = rn.rmsnorm_pair_bwd(y, sy, gy, x[:0], sx, gx[:0])
    for empty, live in ((e, f), (k, h)):
        assert empty[0].shape == (0, D) and not empty[1].any()
        assert torch.equal(live[0], solo_y[0])
        assert torch.equal(live[1], solo_y[1])


@pytest.mark.parametrize("name", ["qwen3-0.6b-reduced",
                                  "deepseek-v2-lite-16b-reduced",
                                  "gemma3-27b-reduced",
                                  "whisper-large-v3-reduced",
                                  "mamba2-2.7b-reduced",
                                  "zamba2-7b-reduced"])
def test_reduced_train_step_card_matches_cpu(cuda, name):
    """One step's loss and gradients on the card against the CPU from the
    same weights, and every attention, SSD scan and norm a kernel launch
    forward and backward."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import map_tree, unique_leaves
    cfg = get_config(name)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64))}
    if cfg.arch_type == "audio":
        batch["audio_frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    cpu_params = Model(cfg, device="cpu").init(seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        params = map_tree(lambda t: t.to(dev).requires_grad_(True),
                          cpu_params)
        leaves = unique_leaves(params)
        ops.reset_launch_counts()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (float(loss), [g.cpu() for g in grads],
                    ops.launch_counts())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-30)
    n = out["cuda"][2]
    kinds = Model(cfg, device="cpu").kinds
    assert n["flash_attention"] == n["flash_attention_bwd"]
    assert (n["flash_attention"] > 0) == (name != "mamba2-2.7b-reduced")
    assert n["ssd_scan"] == n["ssd_scan_bwd"] == kinds.count("ssm")
    assert n["rmsnorm"] == n["rmsnorm_bwd"]


# ---------------------------------------------------------------------------
# training in bfloat16: the backward kernels' bf16 bodies, the bf16
# forward's lse and a reduced bf16 train step
# ---------------------------------------------------------------------------
BF16_BWD_TOL = 2e-2     # of max|plain|: bf16 outputs, float32 sums


def _assert_bf16_close(got, want):
    assert got.dtype == want.dtype
    tol = BF16_BWD_TOL * max(float(want.float().abs().max()), 1e-30)
    assert float((got.float() - want.float()).abs().max()) <= tol


def _bf16_flash_both_ways(q, k, v, dout, **kw):
    """The bf16 forward (out with and without its lse: the same bits; the
    lse against the plain one on rows that see a key, -inf on a row that
    sees none, where the plain version's masked max gives -1e30) and
    backward against their plain versions on the kernel's own out and
    lse, two calls bit for bit; returns the kernels' (out, lse, dq, dk,
    dv)."""
    from repro_torch.kernels import flash_attention as fa
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    ro, rl = ref.flash_attention_lse(q, k, v, **kw)
    _assert_bf16_close(out, ro)
    seen = rl > -1e29
    _assert_bwd_close(lse[seen], rl[seen])
    assert bool((lse[~seen] == float("-inf")).all())
    before = ops.launch_counts()["flash_attention_bwd"]
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    for g, w in zip(grads, ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   **kw)):
        _assert_bf16_close(g, w)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    return (out, lse, *grads)


# chip_smoke.py's phase-2 shapes of the backward (qwen3-0.6b's training
# batch, gemma3's local window, MLA's K 192 / Kv 128, whisper's encoder, a
# ragged softcapped tail), zamba2's K = Kv = 112 and the widest tiles
@pytest.mark.parametrize("B,S,H,Hkv,K,Kv,causal,window,softcap", [
    (8, 512, 16, 8, 128, 128, True, 0, 0.0),
    (1, 1300, 32, 16, 128, 128, True, 1024, 0.0),
    (1, 512, 16, 16, 192, 128, True, 0, 0.0),
    (1, 1500, 20, 20, 64, 64, False, 0, 0.0),
    (2, 40, 16, 8, 128, 128, True, 0, 5.0),
    (1, 200, 32, 32, 112, 112, True, 0, 0.0),
    (1, 130, 4, 2, 256, 256, True, 40, 0.0),
])
def test_bf16_flash_backward_kernel_matches_plain(cuda, B, S, H, Hkv, K, Kv,
                                                  causal, window, softcap):
    bf = torch.bfloat16
    q = _randn(cuda, B, S, H, K, dtype=bf)
    k = _randn(cuda, B, S, Hkv, K, dtype=bf)
    v = _randn(cuda, B, S, Hkv, Kv, dtype=bf)
    dout = _randn(cuda, B, S, H, Kv, dtype=bf)
    _bf16_flash_both_ways(q, k, v, dout, causal=causal, window=window,
                          softcap=softcap)


@pytest.mark.parametrize("Sq,Skv", [(63, 63), (65, 65), (129, 129),
                                    (63, 129), (129, 65), (1, 50)])
@pytest.mark.parametrize("K,Kv", [(64, 64), (100, 112), (36, 16),
                                  (72, 32)])
def test_bf16_flash_bodies_at_their_tile_edges(cuda, Sq, Skv, K, Kv):
    """The bf16 forward's lse and the backward around the 64-row and
    64-key tile edges, queries right-aligned against longer and shorter
    key runs, K not a multiple of 16 (padded columns) and Kv padded to
    the tiles' width."""
    bf = torch.bfloat16
    q = _randn(cuda, 1, Sq, 4, K, dtype=bf)
    k = _randn(cuda, 1, Skv, 2, K, dtype=bf)
    v = _randn(cuda, 1, Skv, 2, Kv, dtype=bf)
    dout = _randn(cuda, 1, Sq, 4, Kv, dtype=bf)
    _bf16_flash_both_ways(q, k, v, dout)


@pytest.mark.parametrize("K", [128, 72, 5])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 33, 0.0), (True, 0, 30.0)])
def test_bf16_flash_bodies_on_rows_off_16_bytes(cuda, K, causal, window,
                                                softcap):
    """bf16 rows that do not start on 16 bytes take the element-by-element
    staging path, and give the bits of the 16-byte (cp.async) path."""
    bf = torch.bfloat16
    q = _randn(cuda, 2, 90, 4, K, dtype=bf)
    k = _randn(cuda, 2, 90, 2, K, dtype=bf)
    v = _randn(cuda, 2, 90, 2, 64, dtype=bf)
    dout = _randn(cuda, 2, 90, 4, 64, dtype=bf)
    kw = dict(causal=causal, window=window, softcap=softcap)
    aligned = _bf16_flash_both_ways(q, k, v, dout, **kw)
    off = _bf16_flash_both_ways(*(_off_16_bytes(t) for t in (q, k, v, dout)),
                                **kw)
    assert all(torch.equal(a, b) for a, b in zip(aligned, off))


RMS_BF16_PAIRS = ((torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32),
                  (torch.float32, torch.bfloat16))


def _rms_case_of(gen, rows, D, dtypes, stride=0):
    x, s, g = _rms_bwd_case(gen, rows, D, stride)
    return x.to(dtypes[0]), s.to(dtypes[1]), g.to(dtypes[0])


@pytest.mark.parametrize("dtypes", RMS_BF16_PAIRS, ids=str)
@pytest.mark.parametrize("D", [1024, 128, 512, 2048, 5376, 3584, 6144, 32])
@pytest.mark.parametrize("rows", [1, 37, 4099])
def test_bf16_rmsnorm_bwd_at_every_training_width(cuda, dtypes, D, rows):
    """dx in x's dtype and dscale in the scale's against the plain
    version; one counted launch a call; two calls give the same bits."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, g = _rms_case_of(cuda, rows, D, dtypes)
    before = ops.launch_counts()["rmsnorm_bwd"]
    dx, ds = rn.rmsnorm_bwd(x, s, g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm_bwd"] == before + 1
    rx, rs = ref.rmsnorm_bwd(x, s, g)
    _assert_bf16_close(dx, rx)
    _assert_bf16_close(ds, rs)
    again = rn.rmsnorm_bwd(x, s, g)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])


@pytest.mark.parametrize("dtypes", RMS_BF16_PAIRS, ids=str)
@pytest.mark.parametrize("D", [1024, 512, 1000, 5, 20000, 40000])
def test_bf16_rmsnorm_bwd_off_16_bytes_gives_the_aligned_bits(cuda, dtypes,
                                                              D):
    """bf16 rows one element off 16 bytes, a row stride of D + 1 and a
    scale off 16 bytes take the one-element path with the 16-byte path's
    bits; D = 1000 and 5 (8 does not divide them), 20000 and 40000
    (past 8 vectors a lane of bf16 or of float32: the looping body)
    against the plain version."""
    from repro_torch.kernels import rmsnorm as rn
    x, s, g = _rms_case_of(cuda, 37, D, dtypes)
    dx, ds = rn.rmsnorm_bwd(x, s, g)
    rx, rs = ref.rmsnorm_bwd(x, s, g)
    _assert_bf16_close(dx, rx)
    _assert_bf16_close(ds, rs)
    off_s = _copy_at(s[None], offset=1)[0]
    for args in ((_copy_at(x, offset=1), s, _copy_at(g, offset=1)),
                 (_copy_at(x, pad=1), s, g), (x, off_s, g)):
        got = rn.rmsnorm_bwd(*args)
        assert torch.equal(got[0], dx) and torch.equal(got[1], ds)


@pytest.mark.parametrize("dtypes", RMS_BF16_PAIRS, ids=str)
@pytest.mark.parametrize("D,stride", [(128, 0), (1024, 0), (512, 576)])
def test_bf16_rmsnorm_pair_bwd_equals_each_solo_launch(cuda, dtypes, D,
                                                       stride):
    """A bf16 pair's dx and dscale equal each tensor's own launch bit for
    bit, in either order."""
    from repro_torch.kernels import rmsnorm as rn
    x, sx, gx = _rms_case_of(cuda, 4099, D, dtypes, stride)
    y, sy, gy = _rms_case_of(cuda, 37, D, dtypes)
    solo_x, solo_y = rn.rmsnorm_bwd(x, sx, gx), rn.rmsnorm_bwd(y, sy, gy)
    a, b = rn.rmsnorm_pair_bwd(x, sx, gx, y, sy, gy)
    c, d = rn.rmsnorm_pair_bwd(y, sy, gy, x, sx, gx)
    for got, want in ((a, solo_x), (b, solo_y), (c, solo_y), (d, solo_x)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["qwen3-0.6b-reduced",
                                  "gemma3-27b-reduced",
                                  "whisper-large-v3-reduced",
                                  "internvl2-26b-reduced"])
def test_reduced_bf16_train_step_card_matches_cpu(cuda, name):
    """One bf16 step's loss (within 1e-3 relative) and gradients (each
    leaf within 5e-2 of max|CPU leaf|) on the card against the CPU from
    the same bf16 weights, and every attention and norm a kernel launch
    forward and backward. Not the MoE family: its top-k routing with
    capacity drops makes its bf16 gradients ill-conditioned (on the CPU
    alone, nudging 2 % of reduced deepseek's bf16 weights by one ulp moves
    its router's gradient by 8.8e-2 of max|leaf| at this batch), so a
    card-vs-CPU gate there reads routing flips, not the kernels; reduced
    deepseek is held in float32 by test_reduced_train_step_card_matches_cpu
    and in bf16 by chip_smoke.py's 18g at its own batch."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import map_tree, unique_leaves
    cfg = get_config(name)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64))}
    if cfg.arch_type == "audio":
        batch["audio_frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.vision_embed_dim)).astype(
                np.float32)
    cpu_params = Model(cfg, device="cpu").init(seed=0, dtype=torch.bfloat16)
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        params = map_tree(lambda t: t.to(dev).requires_grad_(True),
                          cpu_params)
        leaves = unique_leaves(params)
        ops.reset_launch_counts()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (float(loss), [g.cpu() for g in grads],
                    ops.launch_counts())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-3)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= 5e-2 * max(
            float(b.float().abs().max()), 1e-30)
    n = out["cuda"][2]
    assert n["flash_attention"] == n["flash_attention_bwd"] > 0
    assert n["rmsnorm"] == n["rmsnorm_bwd"]

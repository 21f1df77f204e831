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
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,K,window,softcap", [
    (1, 77, 77, 16, 8, 128, 0, 0.0),
    (2, 30, 95, 4, 2, 64, 0, 0.0),
    (1, 130, 130, 4, 4, 32, 17, 0.0),
    (1, 64, 64, 8, 2, 128, 0, 20.0),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Skv, H, Hkv, K,
                                    window, softcap):
    q = _randn(cuda, B, Sq, H, K, dtype=dtype)
    k = _randn(cuda, B, Skv, Hkv, K, dtype=dtype)
    v = _randn(cuda, B, Skv, Hkv, K, dtype=dtype)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    _assert_close(got, ref.flash_attention(q, k, v, window=window,
                                           softcap=softcap), dtype)


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
@pytest.mark.parametrize("S", [512, 77])
def test_flash_kernel_at_mla_widths(cuda, dtype, S):
    """MLA prefill: K = 192 (nope 128 + rope 64), Kv = 128, H = Hkv = 16."""
    q = _randn(cuda, 1, S, 16, 192, dtype=dtype)
    k = _randn(cuda, 1, S, 16, 192, dtype=dtype)
    v = _randn(cuda, 1, S, 16, 128, dtype=dtype)
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (1, S, 16, 128)
    _assert_close(got, ref.flash_attention(q, k, v), dtype)


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
    of the kernel's 8-row blocks; one launch a call."""
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
    """Why a paged engine prefills at least ``MIN_PREFILL_ROWS`` token rows
    on the card: at qwen3's down projection (K = 3072, N = 1024, bf16)
    cuBLAS gives the same rows other bits in a 16-row product than in a
    4096-row one, with its reduced-precision reduction allowed (torch's
    default) or not, so that setting is no way around the padding."""
    w = (0.03 * _randn(cuda, 3072, 1024, dtype=torch.float32)).bfloat16()
    x = _randn(cuda, 4096, 3072, dtype=torch.bfloat16)
    with _bf16_reduced_precision_reduction(reduction_allowed):
        assert not torch.equal(x[:16] @ w, (x @ w)[:16])


PREFILL_ROWS = (128, 129, 200, 256, 384, 512, 1000, 1024, 2048)
HEAD_ROWS = (1, 2, 3, 4, 8, 16)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "stablelm-1.6b"])
def test_prefill_gemms_give_a_row_the_same_bits_from_min_prefill_rows_on(
        cuda, name):
    """The projections of the models that share prefixes, at full width in
    bf16, give a row the same bits at every row count from
    ``MIN_PREFILL_ROWS`` on, wherever the row sits among them; the logits
    head, which a prefill computes at one row a prompt, at every count
    from 1. With the engine's padding, sharing on and off then agree bit
    for bit. (In float32 they do not: the same rows differ between 128
    and 4096 rows at these widths, so full-width float32 sharing is not
    bitwise on the card.)"""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import MIN_PREFILL_ROWS

    dtype = torch.bfloat16
    cfg = get_config(name)
    d, ff = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    bad = []

    def check(x, w, rows, what):
        full = x @ w
        for at in (0, 37):
            bad.extend((what, at, m) for m in rows
                       if not torch.equal(x[at:at + m] @ w, full[at:at + m]))

    for K, N in sorted({(d, q), (d, kv), (q, d), (d, ff), (ff, d)}):
        w = (K ** -0.5 * _randn(cuda, K, N, dtype=torch.float32)).to(dtype)
        check(_randn(cuda, 4096, K, dtype=dtype), w,
              [m for m in PREFILL_ROWS if m >= MIN_PREFILL_ROWS], (K, N))
    table = (d ** -0.5 * _randn(cuda, cfg.vocab_size, d,
                                dtype=torch.float32)).to(dtype)
    check(_randn(cuda, 256, d, dtype=dtype), table.T, HEAD_ROWS,
          ("head", d, cfg.vocab_size))
    assert not bad, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_over_context_and_suffix_equals_the_whole_prompt_bits(
        cuda, dtype):
    """The suffix prefill's attention (queries of the suffix against
    [cached context | suffix]) gives the whole-prompt prefill's rows bit
    for bit on the same keys and values: the kernel walks the keys in
    the same tiles from position 0 in both."""
    H, Hkv, K, ctx, n, whole, sb = 16, 8, 128, 256, 100, 512, 128
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

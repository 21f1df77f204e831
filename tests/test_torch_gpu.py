"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: on a host without a CUDA device every test here skips
(the check runs inside a fixture, so every pytest worker collects the
same tests). On the card: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``. Tolerances as in tests/test_kernels.py.
"""
from __future__ import annotations

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

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.cuda()
    gpu_params = to_card(params)
    out = []
    for model, p, dev in ((cpu_model, params, "cpu"),
                          (Model(cfg, device="cuda"), gpu_params, "cuda")):
        ops.reset_launch_counts()
        with Router(ThreadBackend(model, p, 2, config, device=dev),
                    device=dev) as router:
            handles = [router.submit(Request(*s)) for s in specs]
            out.append({h.rid: h.tokens() for h in handles})
        counts = ops.launch_counts()
        assert (min(counts.values()) > 0) == (dev == "cuda"), counts
    assert out[1] == out[0]

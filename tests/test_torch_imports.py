"""The port stands alone: every module of ``repro_torch`` imports with
``jax``, ``jaxlib`` and the ``repro`` package blocked, and its entry
points refuse to run on a host without a card unless told ``"cpu"``."""
from __future__ import annotations

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
ARCH = "qwen3-0.6b-reduced"


def _modules() -> list[str]:
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        names.append(".".join(parts))
    return names


def test_every_port_module_imports_with_jax_and_repro_blocked():
    assert len(_modules()) >= 20
    assert {"repro_torch.kernels.rmsnorm", "repro_torch.serving.child",
            "repro_torch.serving.faults", "repro_torch.serving.pool",
            "repro_torch.models.sampling",
            "repro_torch.core.testbed", "repro_torch.core.splitter",
            "repro_torch.core.energy_model", "repro_torch.core.scheduler",
            "repro_torch.core.containers",
            "repro_torch.serving.process_pool",
            "repro_torch.serving.adaptive"} <= set(_modules())
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {{name}}")
        sys.meta_path.insert(0, Blk())
        for mod in {_modules()!r}:
            importlib.import_module(mod)
        ops = sys.modules["repro_torch.kernels.ops"]
        assert {{"decode_attention_int8", "paged_decode_attention_int8",
                 "ssd_scan", "mla_decode_ctx", "rmsnorm"}} <= set(ops.COUNTERS)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("port imports ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "port imports ok" in out.stdout


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            top = words[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), line


@pytest.fixture
def cpu_only(monkeypatch):
    """This host's view — no card — made explicit, so the test means the
    same on a host that has one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_refuse_without_a_card(cpu_only):
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params, EngineConfig(n_slots=1, max_len=32))
    paged = EngineConfig(n_slots=1, max_len=32, cache="paged",
                         prefix_cache=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params, paged)
    assert ServingEngine(model, params, paged, device="cpu").paged
    config = EngineConfig(n_slots=1, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ThreadBackend(model, params, 1, config)
    backend = ThreadBackend(model, params, 1, config, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Router(backend)
    Router(backend, device="cpu").close()


def test_engine_refuses_params_on_another_device():
    cfg = get_config(ARCH)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    params["embed"]["table"] = params["embed"]["table"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(model, params, device="cpu")


def test_unported_configurations_raise():
    import dataclasses
    cfg = get_config(ARCH)
    for change in ({"sliding_window": 8}, {"kv_cache_dtype": "fp8"},
                   {"n_experts": 4, "sliding_window": 8},  # mixtral's
                   {"arch_type": "hybrid"}, {"act": "gelu"}):
        with pytest.raises(NotImplementedError, match="not ported"):
            Model(dataclasses.replace(cfg, **change), device="cpu")


def test_mamba2_is_accepted_and_its_paged_cache_is_not_ported():
    """mamba2 serves on both caches; its paged cache pages nothing (the
    state rows stay dense under the block accounting, as in JAX)."""
    cfg = get_config("mamba2-2.7b-reduced")
    model = Model(cfg, device="cpu")
    assert model.fam == "ssm"
    params = model.init(seed=0)
    cache = model.init_cache(2, 32)
    assert len(cache) == cfg.n_layers and set(cache[0]) == {"conv", "state"}
    assert cache[0]["state"].shape == (2, cfg.ssm_n_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state)
    ServingEngine(model, params, EngineConfig(n_slots=2, max_len=32),
                  device="cpu")
    paged = EngineConfig(n_slots=2, max_len=32, cache="paged")
    eng = ServingEngine(model, params, paged, device="cpu")
    assert eng.paged and eng.cache_backend._groups == []
    assert [set(g) for g in eng.cache_backend.tree] == [
        {"conv", "state"}] * cfg.n_layers
    ThreadBackend(model, params, 2, paged, device="cpu").close()


def test_int8_kv_cache_is_accepted_on_both_layouts():
    import dataclasses

    from repro_torch.models.cache import PagedLayout
    cfg = dataclasses.replace(get_config(ARCH), kv_cache_dtype="int8")
    model = Model(cfg, device="cpu")
    dense = model.init_cache(2, 32, torch.bfloat16)
    paged = model.init_cache(2, 32, torch.bfloat16,
                             layout=PagedLayout(16, 4))
    assert dense[0]["k"].dtype == paged[0]["k_pages"].dtype == torch.int8
    assert dense[0]["k_scale"].shape == (2, 32, cfg.n_kv_heads)
    assert paged[0]["v_scale_pages"].shape == (5, 16, cfg.n_kv_heads)
    assert paged[0]["v_scale_pages"].dtype == torch.float32


def test_port_init_is_seeded_and_shaped_like_the_reference():
    cfg = get_config(ARCH)
    model = Model(cfg, device="cpu")
    a, b = model.init(seed=7), model.init(seed=7)
    c = model.init(seed=8)
    wq = a["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert torch.equal(wq, b["layers"][0]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"][0]["attn"]["wq"])
    s = cfg.d_model ** -0.5
    assert float(wq.abs().max()) <= 2 * s
    assert abs(float(wq.std()) / s - 0.88) < 0.05   # truncated at 2 sigma
    assert len(a["layers"]) == cfg.n_layers and "lm_head" not in a
    logits = model.prefill(a, torch.zeros((1, 4), dtype=torch.int32),
                           model.init_cache(1, 8), logits_at=3)
    assert logits.shape == (1, cfg.vocab_size)
    assert np.isfinite(logits.numpy()).all()


def test_deepseek_is_accepted_on_both_layouts():
    from repro_torch.models.cache import PagedLayout
    cfg = get_config("deepseek-v2-lite-16b-reduced")
    model = Model(cfg, device="cpu")
    assert model.fam == "moe" and model.n_dense_layers == 1
    params = model.init(seed=0)
    assert "mlp" in params["layers"][0] and "moe" in params["layers"][1]
    dense = model.init_cache(2, 32, torch.bfloat16)
    paged = model.init_cache(2, 32, torch.bfloat16,
                             layout=PagedLayout(16, 4))
    assert dense[1]["ckv"].shape == (2, 32, cfg.kv_lora_rank)
    assert dense[1]["k_rope"].dtype == torch.bfloat16
    assert paged[0]["ckv_pages"].shape == (5, 16, cfg.kv_lora_rank)
    assert paged[1]["k_rope_pages"].shape == (5, 16, cfg.qk_rope_head_dim)
    assert paged[0]["table"] is paged[1]["table"]
    for conf in (EngineConfig(n_slots=2, max_len=32),
                 EngineConfig(n_slots=2, max_len=32, cache="paged",
                              prefix_cache=True)):
        eng = ServingEngine(model, params, conf, device="cpu")
        assert not eng._share           # no prefix sharing of latents

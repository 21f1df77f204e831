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
            "repro_torch.core.containers", "repro_torch.data.pipeline",
            "repro_torch.serving.process_pool",
            "repro_torch.serving.adaptive",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.llama31_8b",
            "repro_torch.configs.gemma3_27b",
            "repro_torch.configs.zamba2_7b",
            "repro_torch.configs.internvl2_26b",
            "repro_torch.configs.mixtral_8x22b",
            "repro_torch.configs.whisper_large_v3",
            "repro_torch.train.optimizer", "repro_torch.train.loop",
            "repro_torch.train.checkpoint",
            "repro_torch.launch.train"} <= set(_modules())
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
                 "ssd_scan", "mla_decode_ctx", "rmsnorm",
                 "flash_attention_bwd", "rmsnorm_bwd",
                 "ssd_scan_bwd"}} <= set(ops.COUNTERS)
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


def test_workload_and_launcher_modules_run_with_jax_and_repro_blocked():
    """The trace, SLO, replay and simulator modules and the serve launcher
    import without JAX or the reference package, and the device-free ones
    run: a preset synthesised, simulated under an SLO, its report out."""
    new = {"repro_torch.workload", "repro_torch.workload.traces",
           "repro_torch.workload.slo", "repro_torch.workload.replay",
           "repro_torch.workload.sim", "repro_torch.launch",
           "repro_torch.launch.serve"}
    assert new <= set(_modules())
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {{name}}")
        sys.meta_path.insert(0, Blk())
        for mod in {sorted(new)!r}:
            importlib.import_module(mod)
        from repro_torch.workload import SLOSpec, get_preset, synthesize
        from repro_torch.workload.sim import simulate
        trace = synthesize(get_preset("bursty"), seed=1)
        rep = simulate(trace, feasible_counts=[1, 2],
                       objective="energy_under_slo",
                       slo=SLOSpec.parse("interactive:0.5,batch:8.0"))
        assert rep.n_done + rep.n_shed + rep.n_failed == rep.n_requests
        sys.modules["repro_torch.launch.serve"]._parser(("qwen3-0.6b",))
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("workload imports ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "workload imports ok" in out.stdout


def test_new_families_serve_with_jax_and_repro_blocked():
    """The gemma, 8B and whisper configs load, and reduced gemma (a local
    ring that wraps beside a paged global layer) and reduced whisper (its
    frames in the request) serve on the CPU, without JAX or the reference
    package."""
    script = textwrap.dedent("""
        import importlib.abc, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {name}")
        sys.meta_path.insert(0, Blk())
        import numpy as np
        from repro_torch.configs.base import reduce_config
        from repro_torch.configs.registry import get_config
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import (EngineConfig, Request,
                                                ServingEngine)
        for name in ("qwen3-8b", "llama3.1-8b", "gemma3-27b",
                     "whisper-large-v3"):
            Model(get_config(name), device="cpu")
        cfg = reduce_config(get_config("gemma3-27b"), n_layers=3,
                            sliding_window=8)
        model = Model(cfg, device="cpu")
        eng = ServingEngine(model, model.init(seed=0), EngineConfig(
            n_slots=2, max_len=32, cache="paged", chunk_tokens=4),
            device="cpu")
        eng.submit(Request(0, np.arange(12, dtype=np.int32), 10))
        (done,) = eng.run()
        assert len(done.tokens) == 10
        cfg = get_config("whisper-large-v3-reduced")
        model = Model(cfg, device="cpu")
        eng = ServingEngine(model, model.init(seed=0), EngineConfig(
            n_slots=2, max_len=32, cache="paged", chunk_tokens=4),
            device="cpu")
        frames = np.zeros((cfg.encoder_seq, cfg.d_model), np.float32)
        eng.submit(Request(0, np.arange(12, dtype=np.int32), 10,
                           extras={"audio_frames": frames}))
        (done,) = eng.run()
        assert len(done.tokens) == 10
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("new families ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "new families ok" in out.stdout


def test_testbed_stream_and_video_example_run_with_jax_and_repro_blocked():
    """The detector testbed, the video stream and the video example import
    without JAX or the reference package, and without torch (spawned
    containers import them before they pin themselves); the detector then
    runs on the CPU over the stream's frames."""
    example = REPO / "examples" / "torch_serve_video_detection.py"
    for line in example.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro")
    script = textwrap.dedent(f"""
        import importlib.abc, importlib.util, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {{name}}")
        sys.meta_path.insert(0, Blk())
        from repro_torch.core import testbed as tb
        from repro_torch.data.pipeline import VideoRequestStream
        spec = importlib.util.spec_from_file_location("example",
                                                      {str(example)!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert "torch" not in sys.modules
        for name in ("P_IDLE_W", "P_CORE_W", "make_video",
                     "detector_weights", "weights_from_jax",
                     "detector_forward", "SplitRunResult", "run_split",
                     "run_single_container", "spawn_pinned"):
            assert hasattr(tb, name), name
        import torch
        frames = VideoRequestStream(3).frames()
        out = tb.detector_forward(
            [torch.from_numpy(w) for w in tb.detector_weights(0)],
            torch.from_numpy(frames))
        assert out.shape == (3, 18) and bool(torch.isfinite(out).all())
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("testbed imports ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "testbed imports ok" in out.stdout


def test_training_launcher_and_example_run_with_jax_and_repro_blocked():
    """``launch.train`` (one reduced step on the CPU), the train loop,
    optimizer and checkpoints, and ``examples/torch_train_lm.py`` (four
    reduced steps, its loss falling) run without JAX or the reference
    package."""
    example = REPO / "examples" / "torch_train_lm.py"
    for line in example.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro")
    script = textwrap.dedent(f"""
        import importlib.abc, importlib.util, sys, tempfile, os
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {{name}}")
        sys.meta_path.insert(0, Blk())
        from repro_torch.launch import train
        with tempfile.TemporaryDirectory() as out:
            report = train.main(["--reduced", "--device", "cpu", "--steps",
                                 "1", "--seq", "16", "--save",
                                 os.path.join(out, "ck")])
            assert len(report["loss"]) == 1
            spec = importlib.util.spec_from_file_location(
                "example", {str(example)!r})
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            res = mod.main(["--reduced", "--device", "cpu", "--steps", "4",
                            "--seq", "16", "--batch", "2", "--lr", "3e-3",
                            "--out", out])
            assert len(res["history"]) == 2
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("training imports ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "training imports ok" in out.stdout


NEW_EXAMPLES = ("torch_serve_requests.py", "torch_long_context.py",
                "torch_quickstart.py")


def test_analysis_roofline_and_examples_run_with_jax_and_repro_blocked():
    """``repro_torch.analysis`` and ``core.roofline`` import, and the
    serving, long-context and quickstart examples run reduced on the CPU
    (completions identical at 1, 2 and 4 containers; a constant SSM state;
    a falling loss, then four requests served), without JAX or the
    reference package."""
    examples = [REPO / "examples" / name for name in NEW_EXAMPLES]
    for example in examples:
        for line in example.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "jaxlib",
                                                      "repro")
    script = textwrap.dedent(f"""
        import importlib.abc, importlib.util, sys
        class Blk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked import of {{name}}")
        sys.meta_path.insert(0, Blk())
        from repro_torch.analysis import run_analyzers, host_sync, wire
        from repro_torch.core import roofline

        def load(path):
            spec = importlib.util.spec_from_file_location("example", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
        serve, long_ctx, quick = [load(p) for p in {[str(e) for e in
                                                     examples]!r}]
        cpu = ["--reduced", "--device", "cpu"]
        res = serve.main(cpu + ["--requests", "6", "--max-new", "4"])
        assert [r["n"] for r in res["rows"]] == [1, 2, 4]
        assert all(r["identical"] and r["chunk_tokens"] == 32
                   for r in res["rows"])
        res = long_ctx.main(cpu + ["--tokens", "6"])
        assert res["rows"]["mamba2-2.7b-reduced"]["per_token"] == 0
        assert res["rows"]["qwen3-0.6b-reduced"]["per_token"] > 0
        res = quick.main(cpu + ["--steps", "6"])
        assert res["chunk_tokens"] == 32
        assert [len(t) for t in res["completions"]] == [8] * 4
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        print("analysis, roofline and examples ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "analysis, roofline and examples ok" in out.stdout


def test_training_entry_points_default_to_cuda_and_refuse_without_a_card(
        cpu_only):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    example = REPO / "examples" / "torch_train_lm.py"
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_train_lm", example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--reduced", "--steps", "1"])


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            top = words[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), line


@pytest.mark.parametrize("script", ["profile_port.py", "ptxas_report.py",
                                    "prefill_turns.py"])
def test_port_scripts_import_nothing_of_jax_or_repro(script):
    """The scripts that read the port on a card import no JAX either."""
    src = (REPO / "scripts" / script).read_text()
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
    for change in ({"kv_cache_dtype": "fp8"}, {"arch_type": "audio"},
                   {"pos_embed": "learned"}, {"mlp_gated": False},
                   {"act": "relu"},
                   # a hybrid without its shared block, an image without
                   # a width: configurations no family serves
                   {"arch_type": "hybrid"}, {"n_vision_tokens": 8}):
        with pytest.raises(NotImplementedError, match="not ported"):
            Model(dataclasses.replace(cfg, **change), device="cpu")
    # served since the gemma slice: a window (mixtral's too), the
    # local/global pattern and the tanh gelu; since the zamba / internvl2
    # slice the hybrid family and a vision prefix
    for change in ({"sliding_window": 8}, {"local_global_pattern": 1},
                   {"n_experts": 4, "sliding_window": 8}, {"act": "gelu"},
                   {"arch_type": "hybrid", "shared_attn_every": 1,
                    "ssm_state": 16, "ssm_head_dim": 16},
                   {"n_vision_tokens": 8, "vision_embed_dim": 16}):
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

"""The port's H100 cost model (``core/roofline.py``), the scheduler's
``chunk_for`` and the engine's default chunk against the JAX package's.

The arithmetic is JAX's: ``model_flops``, ``prefill_flops`` and the
config's ``active_param_count`` / ``_encoder_layer_params`` equal JAX's
for every registry config; ``decode_step_seconds``,
``decode_chunk_tokens`` and ``chunk_for`` equal JAX's once JAX's module
reads the card's constants (a test-side patch of
``repro.core.roofline``, not an edit of the package); the engine, the
container budget and the process child resolve ``chunk_tokens=None`` by
JAX's rule."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES  # noqa: E402
from repro.configs.registry import ARCH_NAMES  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import containers as tcont  # noqa: E402
from repro_torch.core import roofline as troof  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import _engine_config_wire  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

BATCHES = (1, 4, 16)
CONTEXTS = (0, 2048)
OVERHEADS = (1e-4, 3e-4, 1e-3)
PORT_RULE = troof.decode_chunk_tokens


@pytest.fixture
def card_constants(monkeypatch):
    """JAX's roofline module reading the card's peak and bandwidth."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)


def test_the_constants_are_the_cards():
    assert troof.PEAK_FLOPS == 989e12 and troof.HBM_BW == 3.35e12
    assert 1e-5 < troof.DISPATCH_OVERHEAD_S < 1e-2
    for name in ("ICI_BW", "P_IDLE_W", "P_PEAK_W", "build_report",
                 "RooflineReport", "HEADER"):
        assert not hasattr(troof, name), name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_flops_equal_jax(arch):
    jc, tc = jax_config(arch), get_config(arch)
    assert tc.active_param_count() == jc.active_param_count()
    assert tc._encoder_layer_params() == jc._encoder_layer_params()
    assert tc.param_count() == jc.param_count()
    for shape in INPUT_SHAPES.values():
        mine = InputShape(shape.name, shape.seq_len, shape.global_batch,
                          shape.kind)
        assert troof.model_flops(tc, mine) == jroof.model_flops(jc, shape)
    for n, hit in ((1, 0), (512, 0), (512, 256), (100, 200)):
        assert troof.prefill_flops(tc, n, hit) == jroof.prefill_flops(
            jc, n, hit)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_and_chunk_equal_jax_under_the_cards_constants(
        arch, card_constants):
    jc, tc = jax_config(arch), get_config(arch)
    for b in BATCHES:
        for ctx in CONTEXTS:
            assert troof.decode_step_seconds(tc, b, context_tokens=ctx) \
                == jroof.decode_step_seconds(jc, b, context_tokens=ctx)
            for ov in OVERHEADS:
                assert troof.decode_chunk_tokens(
                    tc, b, overhead_s=ov, context_tokens=ctx) \
                    == jroof.decode_chunk_tokens(
                        jc, b, overhead_s=ov, context_tokens=ctx)
            # the default overhead is the card's constant
            assert troof.decode_chunk_tokens(tc, b, context_tokens=ctx) \
                == jroof.decode_chunk_tokens(
                    jc, b, overhead_s=troof.DISPATCH_OVERHEAD_S,
                    context_tokens=ctx)


@pytest.mark.parametrize("slo", [None, 0.5, 0.02])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-8b", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b", "gemma3-27b"])
def test_chunk_for_equals_jax(arch, slo, card_constants, monkeypatch):
    # JAX's chunk_for imports decode_chunk_tokens at call time: bind the
    # card's overhead into it
    monkeypatch.setattr(jroof, "decode_chunk_tokens", functools.partial(
        jroof.decode_chunk_tokens, overhead_s=troof.DISPATCH_OVERHEAD_S))
    kw = dict(objective="energy_under_slo", slo_ttfc_p95_s=slo) \
        if slo is not None else {}
    js = jsched.DivideAndSaveScheduler([1, 2, 4, 8], **kw)
    ts = tsched.DivideAndSaveScheduler([1, 2, 4, 8], **kw)
    assert ts.CHUNK_SLO_FRAC == js.CHUNK_SLO_FRAC == 0.25
    jc, tc = jax_config(arch), get_config(arch)
    for n in range(1, 9):
        for batch in (1, 4, 16, 64):
            for ctx in CONTEXTS:
                got = ts.chunk_for(tc, n, batch=batch, context_tokens=ctx)
                assert got == js.chunk_for(jc, n, batch=batch,
                                           context_tokens=ctx)
                assert 1 <= got <= 32


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_engine_chunk_rule_is_jaxs_at_full_width(arch, cache,
                                                 card_constants):
    """``engine_chunk_tokens`` = JAX's engine rule: the cost model at the
    engine's rows, over its horizon when paged; an explicit chunk wins."""
    jc, tc = jax_config(arch), get_config(arch)
    for n_slots, max_len in ((1, 512), (4, 2048), (8, 4096)):
        conf = EngineConfig(n_slots=n_slots, max_len=max_len, cache=cache)
        want = jroof.decode_chunk_tokens(
            jc, conf.n_rows, overhead_s=troof.DISPATCH_OVERHEAD_S,
            context_tokens=max_len if cache == "paged" else 0)
        assert troof.engine_chunk_tokens(tc, conf) == want
        # the container budget's chunk buffers hold the resolved chunk
        B = conf.n_rows
        assert tcont.chunk_buffer_bytes(tc, conf) == (5 * B + 6
                                                      + want * B) * 4
        explicit = dataclasses.replace(conf, chunk_tokens=7)
        assert troof.engine_chunk_tokens(tc, explicit) == 7


def test_reduced_configs_resolve_to_32():
    """On the CPU's reduced configs the card's rule gives the old default
    at every engine shape the port's tests build."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch + "-reduced")
        for n_slots in (1, 2, 3, 4, 8):
            for max_len in (32, 64, 128, 256, 512):
                for cache in ("dense", "paged"):
                    if cache == "paged" and max_len % 16:
                        continue
                    conf = EngineConfig(n_slots=n_slots, max_len=max_len,
                                        cache=cache)
                    assert troof.engine_chunk_tokens(cfg, conf) == 32, (
                        arch, conf)


@pytest.fixture(scope="module")
def pair():
    arch = "qwen3-0.6b-reduced"
    jm = JaxModel(jax_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_resolves_none_as_jaxs_engine(pair, cache, card_constants,
                                             monkeypatch):
    """Both engines built with ``chunk_tokens=None``: the same chunk, at
    the default overhead (32 on a reduced model) and at an overhead small
    enough that the rule lands inside [1, 32]."""
    jm, jp, tm, tp = pair
    conf = dict(n_slots=3, max_len=128, cache=cache)
    assert EngineConfig().chunk_tokens is None
    for ov in (troof.DISPATCH_OVERHEAD_S, 6e-7):
        monkeypatch.setattr(jeng, "decode_chunk_tokens", functools.partial(
            jroof.decode_chunk_tokens, overhead_s=ov))
        monkeypatch.setattr(troof, "decode_chunk_tokens", functools.partial(
            PORT_RULE, overhead_s=ov))
        je = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**conf))
        te = ServingEngine(tm, tp, EngineConfig(**conf), device="cpu")
        assert te.chunk_tokens == je.chunk_tokens
        if ov != troof.DISPATCH_OVERHEAD_S:
            assert 1 < te.chunk_tokens < 32
        else:
            assert te.chunk_tokens == 32


def test_none_crosses_the_pipe_and_the_child_resolves_it():
    """``chunk_tokens=None`` crosses to a process child as a primitive, and
    the config the child rebuilds from the wire dict resolves as the
    parent's does."""
    conf = EngineConfig(n_slots=2, max_len=64)
    wire = _engine_config_wire(conf)
    assert wire["chunk_tokens"] is None
    kw = dict(wire, dtype=getattr(torch, wire["dtype"]))
    cfg = get_config("qwen3-0.6b")
    assert troof.engine_chunk_tokens(cfg, EngineConfig(**kw)) \
        == troof.engine_chunk_tokens(cfg, conf)
    with pytest.raises(ValueError):
        EngineConfig(chunk_tokens=0)

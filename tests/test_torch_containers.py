"""The port's ``core/containers.py`` against the JAX package's, and its
card budget against the caches the port's engines really allocate.

``factorizations``, ``partition_indices``, ``kv_cache_bytes_per_token``,
``kv_block_bytes`` and ``feasible_counts`` equal JAX's on every config
of the port's registry (full and reduced, int8 variants included), as
does ``ArchConfig.param_count``. ``card_feasible_counts``'s cache term,
``engine_cache_bytes``, equals the summed bytes of a CPU engine's cache
tree for the dense, paged, int8 (both), MLA (both), SSM (both) and
whisper (dense, paged, int8 paged: the memory rows) cases,
and its chunk term the bytes of ``Model.chunk_buffers``. The properties
of ``tests/test_container_props.py`` run on both packages.
"""
from __future__ import annotations

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import containers as jcont  # noqa: E402
from repro.core import splitter as jsplit  # noqa: E402
from repro_torch.configs.registry import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import containers as tcont  # noqa: E402
from repro_torch.core import splitter as tsplit  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

NAMES = [n + s for n in ARCH_NAMES for s in ("", "-reduced")]
SIDES = {"jax": types.SimpleNamespace(cont=jcont, split=jsplit,
                                      cfg=jax_config),
         "port": types.SimpleNamespace(cont=tcont, split=tsplit,
                                       cfg=get_config)}


@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


def _pair(name: str, int8: bool = False):
    j, t = jax_config(name), get_config(name)
    if int8:
        j = dataclasses.replace(j, kv_cache_dtype="int8")
        t = dataclasses.replace(t, kv_cache_dtype="int8")
    return j, t


@pytest.mark.parametrize("name", NAMES)
def test_budgets_equal_jax_on_every_ported_config(name):
    for int8 in (False, True):
        j, t = _pair(name, int8)
        assert t.param_count() == j.param_count()
        for max_len in (64, 512, 4096):
            for dtype_bytes in (2, 4):
                kw = dict(max_len=max_len, dtype_bytes=dtype_bytes)
                assert (tcont.kv_cache_bytes_per_token(t, **kw)
                        == jcont.kv_cache_bytes_per_token(j, **kw))
                assert (tcont.kv_block_bytes(t, 16, **kw)
                        == jcont.kv_block_bytes(j, 16, **kw))
        for hbm in (1e9, 16e9, 80e9):
            for chips in (1, 8, 256):
                kw = dict(hbm_bytes=hbm, kv_blocks=64, max_len=512)
                assert (tcont.feasible_counts(t, chips, **kw)
                        == jcont.feasible_counts(j, chips, **kw))
                assert (tcont.feasible_counts(t, chips, hbm_bytes=hbm)
                        == jcont.feasible_counts(j, chips, hbm_bytes=hbm))


def test_the_port_leaves_out_the_mesh_builders():
    assert hasattr(jcont, "container_mesh")
    assert not hasattr(tcont, "container_mesh")
    assert not hasattr(tcont, "container_meshes")


def test_feasible_counts_memory_bounded(side):
    counts = side.cont.feasible_counts(side.cfg("qwen3-0.6b"), 256,
                                       hbm_bytes=1e9)
    assert counts == sorted(counts) and 1 in counts and 256 not in counts
    assert side.cont.feasible_counts(side.cfg("qwen3-0.6b-reduced"),
                                     8) == [1, 2, 4, 8]


# ---------------------------------------------------------------------------
# the card budget against real engines' caches
# ---------------------------------------------------------------------------
CACHE_CASES = {
    "dense": ("qwen3-0.6b-reduced", False, {}),
    "paged": ("qwen3-0.6b-reduced", False,
              {"cache": "paged", "max_seqs": 5}),
    "int8_dense": ("qwen3-0.6b-reduced", True, {}),
    "int8_paged": ("qwen3-0.6b-reduced", True,
                   {"cache": "paged", "max_blocks": 7}),
    "mla_dense": ("deepseek-v2-lite-16b-reduced", False, {}),
    "mla_paged": ("deepseek-v2-lite-16b-reduced", False,
                  {"cache": "paged", "max_seqs": 3, "max_blocks": 9}),
    "gemma_dense": ("gemma3-27b-reduced", False, {"max_len": 128}),
    "gemma_paged": ("gemma3-27b-reduced", False,
                    {"max_len": 128, "cache": "paged", "max_seqs": 3}),
    "gemma_int8_paged": ("gemma3-27b-reduced", True,
                         {"max_len": 128, "cache": "paged", "max_seqs": 3}),
    "ssm_dense": ("mamba2-2.7b-reduced", False, {}),
    "ssm_paged": ("mamba2-2.7b-reduced", False,
                  {"cache": "paged", "max_seqs": 6}),
    "hybrid_dense": ("zamba2-7b-reduced", False, {}),
    "hybrid_paged": ("zamba2-7b-reduced", False,
                     {"cache": "paged", "max_seqs": 5}),
    "vision_paged": ("internvl2-26b-reduced", False,
                     {"cache": "paged", "max_seqs": 3}),
    # whisper's memory rows beside its self attention's rows or pages,
    # in the model's dtype under an int8 cache too
    "audio_dense": ("whisper-large-v3-reduced", False, {}),
    "audio_paged": ("whisper-large-v3-reduced", False,
                    {"cache": "paged", "max_seqs": 5}),
    "audio_int8_paged": ("whisper-large-v3-reduced", True,
                         {"cache": "paged", "max_seqs": 5}),
}


def _tree_bytes(tree) -> int:
    """Bytes of every distinct tensor of a cache tree (the paged table,
    which every layer group refers to, once; a whisper layer's nested
    self group too)."""
    seen = {}

    def walk(t):
        if isinstance(t, (dict, list)):
            for v in (t.values() if isinstance(t, dict) else t):
                walk(v)
        else:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    walk(tree)
    return sum(seen.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_engine_cache_bytes_are_the_engines_own(case, dtype):
    arch, int8, extra = CACHE_CASES[case]
    cfg = get_config(arch)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = Model(cfg, device="cpu")
    config = EngineConfig(**{"n_slots": 3, "max_len": 64, "dtype": dtype,
                             "chunk_tokens": 8, **extra})
    eng = ServingEngine(model, model.init(seed=0), config, device="cpu")
    assert tcont.engine_cache_bytes(cfg, config) == _tree_bytes(
        eng.cache_backend.tree)
    buf = model.chunk_buffers(config.n_rows, config.chunk_tokens)
    # every buffer is a view of one int32 tensor
    assert tcont.chunk_buffer_bytes(config) == (
        buf["head"].untyped_storage().nbytes())


def test_card_feasible_counts_fit_one_weight_copy_and_n_engines():
    cfg = get_config("qwen3-0.6b")
    config = EngineConfig(n_slots=4, max_len=2048, dtype=torch.bfloat16,
                          chunk_tokens=32)
    weights = cfg.param_count() * 2
    per = tcont.container_bytes(cfg, config)
    assert per == (tcont.engine_cache_bytes(cfg, config)
                   + tcont.chunk_buffer_bytes(config) + 96 * 2 ** 20)
    # 80 GB: every power of two up to 4
    assert tcont.card_feasible_counts(
        cfg, config, card_bytes=80 * 10 ** 9, max_containers=4) == [1, 2, 4]
    assert tcont.card_feasible_counts(
        cfg, config, card_bytes=80 * 10 ** 9, max_containers=6) == [1, 2, 4]
    # a card that holds the weights and exactly two engines
    card = (weights + 2 * per) / (1 - 0.35)
    assert tcont.card_feasible_counts(
        cfg, config, card_bytes=card + 1, max_containers=8) == [1, 2]
    assert tcont.card_feasible_counts(
        cfg, config, card_bytes=(weights + per) / 0.5, max_containers=8,
        headroom=0.5) == [1]
    assert tcont.card_feasible_counts(
        cfg, config, card_bytes=weights, max_containers=8) == []


@given(st.integers(1, 1 << 40), st.integers(0, 5),
       st.floats(0.0, 0.9, allow_nan=False))
@settings(max_examples=100, deadline=None)
def test_card_feasible_counts_are_a_prefix_of_the_powers_of_two(
        card_bytes, k, headroom):
    cfg = get_config("qwen3-0.6b-reduced")
    config = EngineConfig(n_slots=2, max_len=64)
    counts = tcont.card_feasible_counts(cfg, config, card_bytes=card_bytes,
                                        max_containers=2 ** k,
                                        headroom=headroom)
    assert counts == [2 ** i for i in range(len(counts))]
    assert all(c <= 2 ** k for c in counts)


# ---------------------------------------------------------------------------
# tests/test_container_props.py, both packages
# ---------------------------------------------------------------------------
@given(st.integers(0, 10), st.one_of(st.none(), st.integers(1, 2048)))
@settings(max_examples=100, deadline=None)
def test_factorizations_enumerate_powers_of_two(k, max_containers):
    total = 2 ** k
    want = [n for n in (2 ** i for i in range(k + 1))
            if max_containers is None or n <= max_containers]
    for side in SIDES.values():
        specs = side.cont.factorizations(total, max_containers)
        assert [s.n_containers for s in specs] == want
        for s in specs:
            assert s.total_chips == total
            assert s.n_containers * s.chips_per_container == total
            assert s.mesh_shape == (s.n_containers, s.chips_per_container)


@given(st.integers(0, 10), st.integers(0, 10))
@settings(max_examples=100, deadline=None)
def test_partition_indices_disjoint_ordered_cover(k, j):
    total, n = 2 ** k, 2 ** min(j, k)
    for side in SIDES.values():
        parts = side.cont.partition_indices(total, n)
        assert len(parts) == n
        assert [i for part in parts for i in part] == list(range(total))
        assert {len(part) for part in parts} == {total // n}


def test_partition_rejects_indivisible_counts(side):
    for n in range(1, 65):
        if 96 % n == 0:
            assert len(side.cont.partition_indices(96, n)) == n
        else:
            with pytest.raises(ValueError):
                side.cont.partition_indices(96, n)


@given(st.floats(min_value=1e3, max_value=1e15, allow_nan=False,
                 allow_infinity=False),
       st.integers(0, 8),
       st.floats(min_value=0.0, max_value=0.9, allow_nan=False,
                 allow_infinity=False))
@settings(max_examples=100, deadline=None)
def test_feasible_counts_memory_bound_monotone(hbm, k, headroom):
    total = 2 ** k
    out = []
    for side in SIDES.values():
        counts = side.cont.feasible_counts(
            side.cfg("qwen3-0.6b-reduced"), total, hbm_bytes=hbm,
            activation_headroom=headroom)
        assert counts == [2 ** i for i in range(len(counts))]
        assert all(c <= total for c in counts)
        out.append(counts)
    assert out[0] == out[1]


@given(st.integers(0, 120), st.integers(1, 8), st.randoms())
@settings(max_examples=50, deadline=None)
def test_split_serve_combine_order_roundtrip(n_items, n, rnd):
    rids = list(range(n_items))
    for side in SIDES.values():
        served = []
        for seg in side.split.split(rids, n):
            finish = list(seg)
            rnd.shuffle(finish)
            comp = {rid: (rid, pos) for pos, rid in enumerate(finish)}
            served.append([comp[rid] for rid in seg])
        assert [rid for rid, _ in side.split.combine(served)] == rids

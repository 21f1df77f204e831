"""The paged cache over SSM state rows (``mamba2-2.7b-reduced``) against
the JAX package on the same weights.

As in JAX, a paged engine over an SSM model pages nothing: its cache tree
holds the dense conv and state rows, ``max_seqs`` of them, and admission
still reserves and frees blocks, so ``max_blocks`` bounds how many
sequences are resident. The counterparts of ``tests/test_paged_cache.py``'s
``test_paged_matches_dense_greedy`` and ``test_paged_block_exhaustion_
completes`` for mamba2: the port's paged engine = its dense engine = the
JAX paged engine, token for token, with more sequences in flight than the
dense engine has slots, and every block back after exhaustion.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.cache import PagedLayout  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import ThreadBackend  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.router import Router  # noqa: E402

ARCH = "mamba2-2.7b-reduced"
# test_paged_cache.py's ragged spec: every prompt within the reduced
# model's 32-position chunk, so the unpadded scan takes each length
SPEC = [(5, 4), (15, 3), (16, 5), (17, 2), (9, 6), (2, 1), (12, 8), (7, 5)]
DENSE = dict(n_slots=2, max_len=64)
PAGED = dict(n_slots=2, max_len=64, cache="paged", block_size=16)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _specs(plens_max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
            for i, (plen, mn) in enumerate(plens_max_new)]


def _serve_port(tm, tp, specs, **config):
    eng = ServingEngine(tm, tp, EngineConfig(**config), device="cpu")
    eng.submit_many([Request(i, p.copy(), mn) for i, p, mn in specs])
    return {c.rid: list(c.tokens) for c in eng.run()}, eng


def _serve_jax(jm, jp, specs, **config):
    eng = jeng.ServingEngine(jm, jp, jeng.EngineConfig(**config))
    eng.submit_many([jeng.Request(i, p.copy(), mn) for i, p, mn in specs])
    return {c.rid: list(c.tokens) for c in eng.run()}, eng


def test_init_cache_with_a_layout_gives_the_dense_state_rows(pair):
    _, _, tm, _ = pair
    dense = tm.init_cache(3, 64)
    paged = tm.init_cache(3, 64, layout=PagedLayout(16, 5))
    assert len(paged) == tm.cfg.n_layers
    for d, p in zip(dense, paged):
        assert set(p) == set(d) == {"conv", "state"}
        for k in d:
            assert p[k].shape == d[k].shape and p[k].shape[0] == 3
            assert not p[k].any()


def test_paged_matches_dense_and_jax_greedy(pair):
    jm, jp, tm, tp = pair
    specs = _specs(SPEC)
    dense, _ = _serve_port(tm, tp, specs, **DENSE)
    paged, eng = _serve_port(tm, tp, specs, **PAGED)
    want, jax_eng = _serve_jax(jm, jp, specs, **PAGED)
    assert paged == dense == want
    assert eng.peak_active > DENSE["n_slots"]
    assert eng.peak_active == jax_eng.peak_active
    # no paged group: the SSM rows are the whole tree, and never share
    cb = eng.cache_backend
    assert cb._groups == [] and not eng._share
    assert cb.allocator.n_free + cb.n_live_blocks == cb.layout.max_blocks


def test_paged_block_exhaustion_completes(pair):
    """Three blocks for 2-block requests: admission holds the queue head
    until a finish returns blocks, re-admits into freed rows, and every
    stream equals the dense engine's and JAX's."""
    jm, jp, tm, tp = pair
    tight = dict(PAGED, max_blocks=3)
    specs = _specs([(16, 4), (16, 4), (16, 4), (5, 2)], seed=1)
    want, _ = _serve_port(tm, tp, specs, **DENSE)
    got, eng = _serve_port(tm, tp, specs, **tight)
    ref, jax_eng = _serve_jax(jm, jp, specs, **tight)
    assert got == want == ref
    assert eng.peak_active <= 2 and eng.peak_active == jax_eng.peak_active
    cb = eng.cache_backend
    assert cb.allocator.n_free + sum(len(b) for b in cb._blocks) == 3


def test_a_freed_row_readmitted_gives_a_fresh_rows_stream(pair):
    """A row's state is written whole at admission: a request admitted
    into a row that served (and, idle, kept stepping) another gives the
    stream it gives on a fresh engine."""
    _, _, tm, tp = pair
    specs = _specs([(12, 6), (7, 3)], seed=2)
    eng = ServingEngine(tm, tp, EngineConfig(max_seqs=1, **PAGED),
                        device="cpu")
    for i, p, mn in specs:
        eng.submit(Request(i, p.copy(), mn))
    got = {c.rid: list(c.tokens) for c in eng.run()}
    assert eng.peak_active == 1
    for i, p, mn in specs:
        alone, _ = _serve_port(tm, tp, [(i, p, mn)], **PAGED)
        assert got[i] == alone[i]


def test_router_over_paged_ssm_containers_matches_dense(pair):
    _, _, tm, tp = pair
    specs = _specs(SPEC, seed=3)
    out = []
    for config in (DENSE, PAGED):
        backend = ThreadBackend(tm, tp, 2, config=EngineConfig(
            chunk_tokens=4, **config), device="cpu")
        with Router(backend, device="cpu") as router:
            hs = [router.submit(Request(i, p.copy(), mn))
                  for i, p, mn in specs]
            out.append({h.rid: h.tokens() for h in hs})
    assert out[0] == out[1]


class _ReplayedStep:
    """Stands in for the CUDA graph on the CPU: a replay runs the step."""

    def __init__(self, step):
        self.replay = step


def test_card_chunk_path_over_paged_ssm_rows_keeps_every_address(pair):
    """The card's chunk path with a stand-in graph over a paged SSM
    engine: the CPU engine's streams, one capture, and every cache leaf,
    weight and chunk buffer at its captured address through admissions,
    a cancel, the deferred free and re-admission into the freed row."""
    _, _, tm, tp = pair
    config = EngineConfig(chunk_tokens=4, max_seqs=3, **PAGED)
    plain = ServingEngine(tm, tp, config, device="cpu")
    card = ServingEngine(tm, tp, config, device="cpu")
    card._buf = tm.chunk_buffers(config.n_rows, config.chunk_tokens)
    captures = []

    def capture():
        captures.append(card.graph_replays)
        card._graph = _ReplayedStep(card._step)
        card._addresses = [t.data_ptr() for _, t in card.graph_leaves()]
    card._capture = capture
    specs = _specs([(9, 12), (20, 3), (5, 30), (17, 1), (30, 20), (4, 7)],
                   seed=4)
    streams = []
    for eng in (plain, card):
        eng.submit_many([Request(i, p.copy(), mn) for i, p, mn in specs])
        streams.append({c.rid: list(c.tokens) for c in eng.run()})
    assert streams[0] == streams[1]
    assert captures == [0] and card.graph_replays > 0
    leaves = card.graph_leaves()
    assert sum(p.startswith("cache") for p, _ in leaves) \
        == 2 * tm.cfg.n_layers
    card.submit(Request(10, specs[0][1].copy(), 12))
    card.submit(Request(11, specs[1][1].copy(), 12))
    card.step()
    card._check_addresses()
    assert card.cancel(10)
    card.cache_backend.flush()
    card.submit(Request(12, specs[2][1].copy(), 5))
    card.step()
    card._check_addresses()
    card.run()
    card._check_addresses()

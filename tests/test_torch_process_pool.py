"""One wave through the port's ``ProcessContainerPool(2)`` (two pinned
child processes, the paper's ``--cpus`` shares) against
``ContainerServingPool(2)`` (two engines as threads) and the JAX Router,
on the CPU.

Weights come from the JAX model's seeded init (qwen3-0.6b-reduced,
float32) and reach the children over their pipes in shared memory, the
path the card takes with CUDA IPC handles. Every wait on a child is
bounded: the backend's start and heartbeat timeouts fail a child that
does not answer, and the wave then raises instead of hanging.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import pool as tpool  # noqa: E402
from repro_torch.serving.backend import ProcessBackend  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request  # noqa: E402
from repro_torch.serving.process_pool import \
    ProcessContainerPool  # noqa: E402

ARCH = "qwen3-0.6b-reduced"
SLOTS, MAX_LEN, CHUNK = 2, 64, 4
TIMEOUT_S = 120.0          # any one wait on the children
SPECS = [(6, 3), (9, 4), (5, 2), (20, 7), (6, 1), (3, 5), (17, 5), (7, 6)]


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = bridge.from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def test_a_process_pool_wave_equals_the_thread_pool_and_jax(pair,
                                                            monkeypatch):
    monkeypatch.setattr(tpool, "_WAVE_SHIM_WARNED", True)
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(6)
    specs = [(i, rng.integers(0, 512, (plen,), dtype=np.int32), mn)
             for i, (plen, mn) in enumerate(SPECS)]
    config = EngineConfig(n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK)
    with jrouter.Router(jbackend.ThreadBackend(
            jm, jp, 2, config=jeng.EngineConfig(
                n_slots=SLOTS, max_len=MAX_LEN, chunk_tokens=CHUNK))) as jr:
        hs = [jr.submit(jeng.Request(i, p.copy(), mn)) for i, p, mn in specs]
        want = [h.tokens() for h in hs]

    threads = tpool.ContainerServingPool(tm, tp, 2, config, device="cpu")
    t_ordered, t_results, t_wall, t_energy = threads.serve_timed(
        [Request(i, p.copy(), mn) for i, p, mn in specs])
    threads.close()

    backend = ProcessBackend(tm.cfg, 2, config, params=tp, device="cpu",
                             allow_shared_cores=True,
                             start_timeout_s=TIMEOUT_S,
                             heartbeat_timeout_s=TIMEOUT_S)
    with ProcessContainerPool(tm.cfg, 2, backend=backend) as procs:
        p_ordered, p_results, p_wall, p_energy = procs.serve_timed(
            [Request(i, p.copy(), mn) for i, p, mn in specs])
        cores = procs.core_sets
    assert backend.workers is None                  # children reaped
    assert len(cores) == 2
    assert [c.rid for c in p_ordered] == [c.rid for c in t_ordered] \
        == [i for i, _, _ in specs]
    assert [list(c.tokens) for c in p_ordered] \
        == [list(c.tokens) for c in t_ordered] == want
    for results, wall, energy in ((t_results, t_wall, t_energy),
                                  (p_results, p_wall, p_energy)):
        assert [r.n_requests for r in results] == [4, 4]
        assert wall > 0 and energy == pytest.approx(
            sum(r.energy_j for r in results))
        assert sum(r.n_tokens for r in results) == sum(
            mn for _, _, mn in specs)
    with pytest.raises(ValueError, match="capacity"):
        ProcessContainerPool(tm.cfg, 3, backend=backend)

"""Container pool: the paper's method applied to serving, as waves.

A port of ``repro.serving.pool``. ``ContainerServingPool`` splits a wave
of independent requests into n segments (``core/splitter.py``), serves
each on one container of a ``ThreadBackend`` (one ServingEngine each, on
its own CUDA stream of the shared card) and combines the completions in
request order. ``serving/process_pool.ProcessContainerPool`` is the same
shim over a ``ProcessBackend`` (one pinned process per container, the
paper's ``docker run --cpus`` shares) and shares this module's per-wave
accounting through ``assemble_wave``. For request-level streaming
instead of waves, put a ``serving/router.Router`` in front of a backend.

Per-container accounting: each ContainerResult carries the container's
wall time, its busy time (wall its engine spent inside ``step()``), its
emitted tokens and tokens/s, p50/p95 completion latencies, and an energy
estimate from ``EnergyProxy``: the paper's two-term power model, a
baseline draw shared by the containers plus an activity draw
proportional to busy time. It is a proxy with JAX's constants, so both
packages' schedulers see the same objective; the card's own draw is not
read here. An idle container gives well-defined zeros.

There is no ``meshes`` argument: a card is not carved into sub-meshes.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import splitter
from repro_torch.serving.backend import ThreadBackend
from repro_torch.serving.engine import Completion, EngineConfig, Request

# the wave shims warn once a process (benchmark loops call them many
# times); tests reset this to re-arm the warning
_WAVE_SHIM_WARNED = False


def _warn_wave_shim(api: str) -> None:
    """One DeprecationWarning for the whole wave surface: ``serve_timed``
    and ``serve_wave`` batch a complete wave and block on the slowest
    container; ``Router.submit`` + ``CompletionHandle.stream()`` is the
    request-level replacement."""
    global _WAVE_SHIM_WARNED
    if _WAVE_SHIM_WARNED:
        return
    _WAVE_SHIM_WARNED = True
    warnings.warn(
        f"{api} is a legacy wave shim: it blocks until the slowest "
        "container drains. Prefer Router.submit(...) and stream the "
        "returned handle (serving/router.py)", DeprecationWarning,
        stacklevel=3)


@dataclasses.dataclass(frozen=True)
class EnergyProxy:
    """E = wall·idle_w + Σ_containers busy·active_w  (the paper's two-term
    power model: a package baseline plus per-container activity)."""
    idle_w: float = 40.0
    active_w: float = 7.0

    def container_energy(self, wave_wall_s: float, busy_s: float,
                         n_containers: int) -> float:
        """One container's share: its activity draw plus an equal share of
        the baseline draw over the wave."""
        return (self.active_w * busy_s
                + self.idle_w * wave_wall_s / max(n_containers, 1))


def percentiles(values: Sequence[float]) -> tuple[float, float]:
    """(p50, p95) of a sample, (0, 0) when empty, so an idle container or
    an empty window gives well-defined zeros instead of an error."""
    if not values:
        return 0.0, 0.0
    return (float(np.percentile(values, 50)),
            float(np.percentile(values, 95)))


def latency_percentiles(completions: Sequence[Completion]
                        ) -> tuple[float, float]:
    """(p50, p95) of completion latencies."""
    return percentiles([c.latency_s for c in completions])


@dataclasses.dataclass
class ContainerResult:
    container_id: int
    completions: list
    wall_s: float
    n_requests: int
    busy_s: float = 0.0
    energy_j: float = 0.0
    n_tokens: int = 0             # tokens emitted by this container
    tokens_per_s: float = 0.0     # n_tokens / wall_s
    latency_p50_s: float = 0.0    # median completion latency
    latency_p95_s: float = 0.0    # tail completion latency


def assemble_wave(out: Sequence[tuple], segments: Sequence[Sequence[Request]],
                  wall: float, energy: EnergyProxy
                  ) -> tuple[list[Completion], list[ContainerResult], float]:
    """The per-wave accounting every pool shares: raw per-container
    ``(completions, wall, busy, tokens)`` tuples become ContainerResults
    with energy and percentiles, and the completions return to request
    order (each segment in its submission order, the segments spliced
    back by the splitter). Returns ``(ordered, results, wave_energy_j)``."""
    n_containers = len(segments)
    results, total_e = [], 0.0
    for cid, ((comps, c_wall, c_busy, c_toks), seg) in enumerate(
            zip(out, segments)):
        e = energy.container_energy(wall, c_busy, n_containers)
        total_e += e
        p50, p95 = latency_percentiles(comps)
        results.append(ContainerResult(
            cid, comps, c_wall, len(seg), c_busy, e, c_toks,
            c_toks / c_wall if c_wall > 0 else 0.0, p50, p95))
    per_segment = []
    for res, seg in zip(results, segments):
        by_rid = {c.rid: c for c in res.completions}
        per_segment.append([by_rid[r.rid] for r in seg if r.rid in by_rid])
    return splitter.combine(per_segment), results, total_e


class ContainerServingPool:
    """Waves over ``n_containers`` engines of one ``ThreadBackend`` (or a
    given ``backend`` of that capacity), one ``config`` for all."""

    def __init__(self, model, params, n_containers: int,
                 config: EngineConfig | None = None, *,
                 concurrent: bool = True,
                 energy: EnergyProxy | None = None,
                 backend=None,
                 device: str | torch.device = "cuda"):
        self.n_containers = n_containers
        self.concurrent = concurrent
        self.energy = energy or EnergyProxy()
        if backend is None:
            backend = ThreadBackend(model, params, n_containers, config,
                                    concurrent=concurrent, device=device)
        elif backend.capacity != n_containers:
            raise ValueError(f"backend capacity {backend.capacity} != "
                             f"{n_containers} containers")
        self.backend = backend

    def serve_timed(self, requests: list[Request],
                    concurrent: bool | None = None
                    ) -> tuple[list[Completion], list[ContainerResult],
                               float, float]:
        """Serve a wave (submit all, drain); returns (ordered completions,
        per-container results, wave wall seconds, wave energy joules)."""
        _warn_wave_shim("ContainerServingPool.serve_timed")
        if concurrent is None:
            concurrent = self.concurrent
        segments = splitter.split(requests, self.n_containers)
        t0 = time.perf_counter()
        for cid, seg in enumerate(segments):
            self.backend.submit_many(cid, seg)
        out = self.backend.drain(concurrent=concurrent)
        wall = time.perf_counter() - t0
        ordered, results, energy = assemble_wave(out, segments, wall,
                                                 self.energy)
        return ordered, results, wall, energy

    def serve(self, requests: list[Request],
              concurrent: bool | None = None
              ) -> tuple[list[Completion], list[ContainerResult]]:
        ordered, results, _, _ = self.serve_timed(requests, concurrent)
        return ordered, results

    def close(self) -> None:
        """Release the backend (its engines, caches and graphs)."""
        self.backend.close()

"""Adaptive serving: the paper's online scheduler closed over the pool.

A port of ``repro.serving.adaptive``. The paper's conclusion calls for
"energy-efficient job schedulers that split input data, obtaining the
optimal number of containers in an online fashion".
``AdaptiveServingPool`` is that loop over waves: each wave is served by a
pool of the count the ``DivideAndSaveScheduler`` picked, the wave's
measured ``(n, wall, energy)`` goes back to the scheduler, and the next
wave runs at the new ``pick()``, among the feasible counts
(``core/containers.card_feasible_counts`` on a card).

Pools are cached per count, so once the scheduler settles every wave
reuses the same engines and their captured decode graphs. With
``isolation="process"`` the cached pools are ``ProcessContainerPool``s,
whose pinned children stay warm (spawn, torch import and capture paid
once a count). Every cached pool keeps its engines' caches on the card,
and ``card_feasible_counts`` budgets one pool, so ``max_cached_pools``
LRU-bounds the cache; an evicted pool is ``close()``d (for process
isolation that shuts its children down).

``SyntheticContainerPool`` is the simulator counterpart (paper §VI): a
pool whose time and energy come from closed-form profiles instead of a
device, for exercising the loop deterministically.

There is no ``submesh_devices``: a card is not carved into sub-meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.scheduler import DivideAndSaveScheduler, Objective
from repro_torch.serving.engine import Completion, EngineConfig, Request
from repro_torch.serving.pool import (ContainerResult, ContainerServingPool,
                                      latency_percentiles)


@dataclasses.dataclass
class WaveResult:
    wave: int
    n_containers: int
    wall_s: float
    energy_j: float
    n_requests: int
    n_tokens: int = 0             # tokens emitted across the wave
    tokens_per_s: float = 0.0     # wave decode throughput
    latency_p50_s: float = 0.0    # median completion latency in the wave
    latency_p95_s: float = 0.0    # tail completion latency in the wave


class AdaptiveServingPool:
    """Serve waves of requests, learning the optimal container count."""

    def __init__(self, model, params, feasible_counts: Sequence[int],
                 objective: Objective = "energy",
                 deadline_s: float | None = None,
                 epsilon: float = 0.0, seed: int = 0,
                 config: EngineConfig | None = None,
                 concurrent: bool = True,
                 scheduler: DivideAndSaveScheduler | None = None,
                 pool_factory: Callable[[int], Any] | None = None,
                 max_cached_pools: int | None = None,
                 isolation: str = "thread",
                 allow_shared_cores: bool = False,
                 device: str | torch.device = "cuda"):
        """``isolation``: ``"thread"`` (engines as threads of this
        process, on their own CUDA streams) or ``"process"`` (one pinned
        OS process per container, the paper's ``--cpus`` shares; the
        children map ``params`` over CUDA IPC on the card, shared memory
        on the CPU). ``max_cached_pools`` LRU-bounds the per-count pool
        cache; evicted pools are closed."""
        self.scheduler = scheduler or DivideAndSaveScheduler(
            list(feasible_counts), objective=objective,
            deadline_s=deadline_s, epsilon=epsilon, seed=seed)
        counts = getattr(self.scheduler, "feasible", list(feasible_counts))
        if isolation not in ("thread", "process"):
            raise ValueError(f"unknown isolation {isolation!r}")
        if isolation == "process" and not allow_shared_cores:
            # fail fast: a count past the core budget cannot be pairwise
            # disjoint, and would raise the first time it is probed
            from repro_torch.core.testbed import available_cores
            budget = len(available_cores())
            bad = [n for n in counts if n > budget]
            if bad:
                raise ValueError(
                    f"feasible counts {bad} exceed the {budget}-core "
                    "budget; drop them or pass allow_shared_cores=True")
        if pool_factory is None:
            if model is None:
                raise ValueError("need a model or a pool_factory")

            def pool_factory(n: int):
                if isolation == "process":
                    from repro_torch.serving.process_pool import \
                        ProcessContainerPool
                    return ProcessContainerPool(
                        model.cfg, n, config, params=params,
                        allow_shared_cores=allow_shared_cores,
                        device=device)
                return ContainerServingPool(model, params, n, config,
                                            concurrent=concurrent,
                                            device=device)
        self._pool_factory = pool_factory
        self._pools: dict[int, Any] = {}       # insertion order == LRU order
        self._max_cached = max_cached_pools
        self.history: list[WaveResult] = []

    def _pool(self, n: int):
        if n in self._pools:
            self._pools[n] = self._pools.pop(n)    # refresh LRU position
        else:
            self._pools[n] = self._pool_factory(n)
            if self._max_cached is not None:
                while len(self._pools) > max(self._max_cached, 1):
                    # the stalest count goes, and with it its engines'
                    # caches and graphs (or its warm child processes)
                    evicted = self._pools.pop(next(iter(self._pools)))
                    close = getattr(evicted, "close", None)
                    if close is not None:
                        close()
        return self._pools[n]

    def close(self) -> None:
        """Release every cached pool (shutting down any warm process
        containers). The pool stays usable: the next wave rebuilds."""
        pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            close = getattr(pool, "close", None)
            if close is not None:
                close()

    def serve_wave(self, requests: list[Request]) -> list[Completion]:
        n = self.scheduler.pick()
        ordered, _, wall, energy = self._pool(n).serve_timed(requests)
        self.scheduler.observe(n, wall, energy)
        n_tokens = sum(len(c.tokens) for c in ordered)
        p50, p95 = latency_percentiles(ordered)
        self.history.append(WaveResult(len(self.history), n, wall, energy,
                                       len(requests), n_tokens,
                                       n_tokens / wall if wall > 0 else 0.0,
                                       p50, p95))
        return ordered

    def serve(self, waves) -> list[list[Completion]]:
        return [self.serve_wave(w) for w in waves]

    @property
    def choice(self) -> int:
        """The exploitation-only choice (what a converged deployment
        would run)."""
        return self.scheduler.best()


class SyntheticContainerPool:
    """Pool stand-in with closed-form time/energy profiles (§VI-style
    simulation). ``serve_timed`` echoes the requests as empty completions
    and reports ``time_fn(n)`` / ``energy_fn(n)``."""

    def __init__(self, n_containers: int,
                 time_fn: Callable[[int], float],
                 energy_fn: Callable[[int], float] | None = None):
        self.n_containers = n_containers
        self._time_fn = time_fn
        self._energy_fn = energy_fn or (lambda n: time_fn(n) * 40.0)

    def serve_timed(self, requests: list[Request]
                    ) -> tuple[list[Completion], list[ContainerResult],
                               float, float]:
        n = self.n_containers
        wall = float(self._time_fn(n))
        energy = float(self._energy_fn(n))
        ordered = [Completion(r.rid, [], len(r.prompt)) for r in requests]
        per = [ContainerResult(cid, [], wall, 0, wall, energy / n)
               for cid in range(n)]
        return ordered, per, wall, energy

    def serve(self, requests):
        ordered, per, _, _ = self.serve_timed(requests)
        return ordered, per


def synthetic_pool_factory(time_fn: Callable[[int], float],
                           energy_fn: Callable[[int], float] | None = None
                           ) -> Callable[[int], SyntheticContainerPool]:
    return lambda n: SyntheticContainerPool(n, time_fn, energy_fn)

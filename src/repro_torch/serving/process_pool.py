"""Process-per-container serving pool: real OS-level CPU shares.

A port of ``repro.serving.process_pool``. The paper's mechanism is
``docker run --cpus=C/n``: each container is an OS-level share of the
device, not a thread in a shared runtime. ``ProcessContainerPool`` is a
thin wave shim over ``serving/backend.ProcessBackend`` (one pinned child
process per container): ``serve_timed`` = submit all + drain, with the
``ContainerResult`` / ``EnergyProxy`` / percentile accounting of
``pool.assemble_wave``, so it answers ``ContainerServingPool``'s calls.
For request-level streaming over the same children, put a
``serving/router.Router`` in front of a ``ProcessBackend`` instead.

Weights reach the children as ``ProcessBackend`` passes them: ``params``
(on the card every child maps the parent's one copy over CUDA IPC; on
the CPU through shared memory), ``params_path`` (a ``.npz`` from
``params.save_params``) or ``params_seed`` (each child draws
``Model.init(params_seed)``, the default with seed 0 when none is
given). There is no ``share_params``: the IPC handoff replaces it.

Spawn cost is real (an interpreter, the torch import, the engine build
and the first chunk's graph capture, seconds a child): the children
spawn before the first wave's clock starts and stay warm until
``close()``.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import splitter
from repro_torch.serving.backend import ProcessBackend
from repro_torch.serving.engine import Completion, EngineConfig, Request
from repro_torch.serving.pool import (ContainerResult, EnergyProxy,
                                      _warn_wave_shim, assemble_wave)

__all__ = ["ProcessContainerPool"]


class ProcessContainerPool:
    """``ContainerServingPool.serve_timed()``'s contract with one pinned
    OS process per container."""

    def __init__(self, cfg, n_containers: int,
                 config: EngineConfig | None = None, *,
                 params: dict | None = None,
                 params_seed: int | None = None,
                 params_path: str | None = None,
                 energy: EnergyProxy | None = None,
                 allow_shared_cores: bool = False,
                 start_timeout_s: float = 600.0,
                 backend: ProcessBackend | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.n_containers = n_containers
        self.energy = energy or EnergyProxy()
        if backend is None:
            if params is None and params_path is None and params_seed is None:
                params_seed = 0
            backend = ProcessBackend(
                cfg, n_containers, config, params=params,
                params_seed=params_seed, params_path=params_path,
                device=device, allow_shared_cores=allow_shared_cores,
                start_timeout_s=start_timeout_s)
        elif backend.capacity != n_containers:
            raise ValueError(f"backend capacity {backend.capacity} != "
                             f"{n_containers} containers")
        self.backend = backend

    @property
    def core_sets(self):
        return self.backend.core_sets

    def serve_timed(self, requests: list[Request],
                    concurrent: bool | None = None
                    ) -> tuple[list[Completion], list[ContainerResult],
                               float, float]:
        """Serve a wave; ``ContainerServingPool.serve_timed``'s contract.
        ``concurrent`` is accepted and ignored: processes always
        overlap."""
        _warn_wave_shim("ProcessContainerPool.serve_timed")
        del concurrent
        self.backend.warm()     # spawn cost stays outside the wave wall
        segments = splitter.split(requests, self.n_containers)
        t0 = time.perf_counter()
        for cid, seg in enumerate(segments):
            self.backend.submit_many(cid, seg)
        out = self.backend.drain()
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
        """Shut the warm children down (idempotent); an
        ``AdaptiveServingPool`` calls this on the pools it evicts."""
        self.backend.close()

    def __enter__(self) -> "ProcessContainerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

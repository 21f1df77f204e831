"""Convex time/energy/power models of container splitting (paper §VI).

The paper fits, per device, three models in the container count ``x``
(Table II, all normalised to the 1-container benchmark):

  TX2   time   0.026 x² − 0.21 x + 1.17      (convex quadratic)
  TX2   energy 0.015 x² − 0.12 x + 1.10
  TX2   power −0.016 x² + 0.12 x + 0.90      (concave — utilisation rises)
  Orin  time   0.33 + 1.77 e^(−0.98 x)       (saturating exponential)
  Orin  energy 0.59 + 1.14 e^(−1.03 x)
  Orin  power  1.85 − 1.24 e^(−0.38 x)

This module provides those reference models, fitting machinery for both
forms (pure numpy, no scipy) and the calibrated edge-device simulators.
The scheduler (scheduler.py) consumes fitted models to pick the optimal
container count online.

The port's own copy of ``repro.core.energy_model``: the same constants,
fits and simulators. It leaves out ``TpuSplitPoint``, whose step time
and power are a TPU's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# paper's reference values (Table II)
# ---------------------------------------------------------------------------
PAPER_REF = {
    "tx2": {"time_s": 325.0, "energy_j": 942.0, "power_w": 2.9, "cores": 4,
            "max_containers": 6},
    "orin": {"time_s": 54.0, "energy_j": 700.0, "power_w": 13.0, "cores": 12,
             "max_containers": 12},
}

PAPER_MODELS = {
    ("tx2", "time"): ("quad", (0.026, -0.21, 1.17)),
    ("tx2", "energy"): ("quad", (0.015, -0.12, 1.10)),
    ("tx2", "power"): ("quad", (-0.016, 0.12, 0.90)),
    ("orin", "time"): ("exp", (0.33, 1.77, 0.98)),
    ("orin", "energy"): ("exp", (0.59, 1.14, 1.03)),
    ("orin", "power"): ("exp", (1.85, -1.24, 0.38)),
}


def eval_model(kind: str, coef: Sequence[float], x) -> np.ndarray:
    x = np.asarray(x, dtype=float)
    if kind == "quad":
        a, b, c = coef
        return a * x * x + b * x + c
    a, b, lam = coef  # a + b * exp(-lam x)
    return a + b * np.exp(-lam * x)


@dataclasses.dataclass
class FittedModel:
    kind: str                 # "quad" | "exp"
    coef: tuple
    rmse: float

    def __call__(self, x):
        return eval_model(self.kind, self.coef, x)

    def argmin(self, n_max: int) -> int:
        xs = np.arange(1, n_max + 1)
        return int(xs[np.argmin(self(xs))])


def fit_quadratic(x: Sequence[float], y: Sequence[float]) -> FittedModel:
    x, y = np.asarray(x, float), np.asarray(y, float)
    A = np.stack([x * x, x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    rmse = float(np.sqrt(np.mean((A @ coef - y) ** 2)))
    return FittedModel("quad", tuple(coef), rmse)


def fit_exponential(x: Sequence[float], y: Sequence[float],
                    lam_grid: Sequence[float] | None = None) -> FittedModel:
    """Fit y = a + b·exp(−λx): grid over λ, linear lsq for (a, b)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    if lam_grid is None:
        lam_grid = np.linspace(0.05, 3.0, 120)
    best = None
    for lam in lam_grid:
        e = np.exp(-lam * x)
        A = np.stack([np.ones_like(x), e], axis=1)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        r = float(np.sqrt(np.mean((A @ coef - y) ** 2)))
        if best is None or r < best.rmse:
            best = FittedModel("exp", (coef[0], coef[1], float(lam)), r)
    return best


def fit_best(x, y) -> FittedModel:
    """Paper fits a quadratic on one device and an exponential on the other;
    pick whichever form fits the observations better."""
    q, e = fit_quadratic(x, y), fit_exponential(x, y)
    return q if q.rmse <= e.rmse else e


# ---------------------------------------------------------------------------
# edge-device simulator (for the paper-reproduction benchmarks)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EdgeDeviceModel:
    """Analytic model of a multi-core edge device running n containers.

    Mechanism (paper §IV/§VI): a single inference process saturates poorly —
    its effective parallel fraction ``f`` is limited (Amdahl), so a chunk of
    every core-second is stranded. n independent containers with C/n cores
    each raise utilisation: time falls, average power rises (the busy
    core-seconds ``W`` are invariant, so active-cores = W/T grows as T
    shrinks), and energy E = P_idle·T + p_core·W falls with T — exactly the
    paper's "power +84 %, energy −43 %" bookkeeping. Per-container overhead
    ``o`` and past-core-count thrash make both curves convex.
    """

    cores: int
    work_core_s: float            # busy core-seconds of the whole task
    parallel_frac: float          # Amdahl fraction of a single process
    container_overhead_s: float   # per-container startup/runtime overhead
    thrash_penalty: float = 0.05  # per container beyond core count
    p_idle_w: float = 1.5
    p_core_w: float = 0.5

    def single_container_time(self, cpus: float) -> float:
        """Fig. 1: one container with a fractional --cpus allocation."""
        c = max(cpus, 1e-2)
        f = self.parallel_frac
        eff = ((1 - f) + f / c) if c >= 1.0 else 1.0 / c
        return self.work_core_s * eff + self.container_overhead_s

    def time(self, n: int) -> float:
        """Fig. 3a: n containers, cores evenly split, data evenly split."""
        c = self.cores / n
        w = self.work_core_s / n
        f = self.parallel_frac
        t = w * ((1 - f) + f / c) if c >= 1.0 else w / c
        t += self.container_overhead_s
        if n > self.cores:
            t *= 1.0 + self.thrash_penalty * (n - self.cores)
        return t

    def active_cores(self, n: int) -> float:
        # container overhead is wait/IO, not compute: busy core-seconds are
        # the task's work itself, invariant in n
        return min(float(self.cores), self.work_core_s / self.time(n))

    def power(self, n: int) -> float:
        return self.p_idle_w + self.p_core_w * self.active_cores(n)

    def energy(self, n: int) -> float:
        return self.power(n) * self.time(n)


def tx2_model() -> EdgeDeviceModel:
    """Calibrated to Table II refs (325 s, 942 J, 2.9 W, 4 cores)."""
    return EdgeDeviceModel(cores=4, work_core_s=841.0, parallel_frac=0.85,
                           container_overhead_s=20.0, thrash_penalty=0.05,
                           p_idle_w=1.53, p_core_w=0.53)


def orin_model() -> EdgeDeviceModel:
    """Calibrated to Table II refs (54 s, 700 J, 13 W, 12 cores)."""
    return EdgeDeviceModel(cores=12, work_core_s=91.5, parallel_frac=0.55,
                           container_overhead_s=8.6, thrash_penalty=0.04,
                           p_idle_w=8.3, p_core_w=2.77)

"""Divide-and-Save scheduler: choose the container count online.

The paper's concluding proposal ("energy-efficient job schedulers that split
input data, obtaining the optimal number of containers in an online
fashion") implemented:

  * observe (n, time, energy) samples of completed jobs,
  * fit the paper's convex model forms (quadratic / saturating-exp,
    whichever fits better) to each metric,
  * pick argmin of the chosen objective over the *feasible* container
    counts (memory-bounded, cf. core/containers.py), with ε-greedy
    exploration so unvisited counts eventually get sampled.

Samples are measured: a serving window's wall time and its
``serving/pool.EnergyProxy`` energy.

**SLO objective** (``energy_under_slo``): the mean-optimal objectives
above ignore the tail, and edge traffic is bursty enough that a
mean-optimal split routinely violates p95 targets (ECORE's framing —
energy minimisation *subject to* per-class latency constraints). Beside
the two mean models the scheduler therefore keeps a **quantile model**:
per-window ttfc-p95 samples fitted over the container count with the
same convex machinery (``fit_best``) and the same RMSE trust check, and
``pick()`` then minimises energy over the counts whose *predicted* p95
meets ``slo_ttfc_p95_s``. ``chunk_for()`` co-optimises the decode chunk
length with the count: the H100 cost model's amortisation optimum
(``core/roofline.decode_chunk_tokens``), capped so one chunk's device
time cannot eat more than a fraction of the ttfc budget — a queued
arrival waits up to a full chunk before admission.

The port's own copy of ``repro.core.scheduler``: the same fits, trust
check, exploration and ``random.Random(seed)`` stream, so the same
observations give the same picks, and JAX's chunk rule over the card's
cost model (``core/roofline.py``).
"""
from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Literal

from repro_torch.core.energy_model import FittedModel, fit_best

Objective = Literal["energy", "time", "energy_under_deadline",
                    "energy_under_slo"]


@dataclasses.dataclass
class Observation:
    n: int
    time_s: float
    energy_j: float
    ttfc_p95_s: float | None = None   # window tail sample (SLO objective)


class DivideAndSaveScheduler:
    # fraction of the ttfc budget one fused decode chunk may occupy
    # before chunk_for caps it below the amortisation optimum
    CHUNK_SLO_FRAC = 0.25

    def __init__(self, feasible_counts: list[int],
                 objective: Objective = "energy",
                 deadline_s: float | None = None,
                 epsilon: float = 0.1, seed: int = 0,
                 slo_ttfc_p95_s: float | None = None):
        if not feasible_counts:
            raise ValueError("no feasible container counts")
        if objective == "energy_under_slo" and slo_ttfc_p95_s is None:
            raise ValueError("energy_under_slo needs slo_ttfc_p95_s")
        self.feasible = sorted(set(feasible_counts))
        self.objective = objective
        self.deadline = deadline_s
        self.slo_ttfc_p95_s = slo_ttfc_p95_s
        self.epsilon = epsilon
        self._rng = random.Random(seed)
        self._obs: list[Observation] = []
        self.time_model: FittedModel | None = None
        self.energy_model: FittedModel | None = None
        self.ttfc_model: FittedModel | None = None

    # ------------------------------------------------------------------
    def observe(self, n: int, time_s: float, energy_j: float,
                ttfc_p95_s: float | None = None) -> None:
        self._obs.append(Observation(n, time_s, energy_j, ttfc_p95_s))
        self._refit()

    def _refit(self) -> None:
        by_n: dict[int, list[Observation]] = defaultdict(list)
        for o in self._obs:
            by_n[o.n].append(o)
        if len(by_n) < 3:        # need 3 distinct counts to fit 3 params
            return
        xs = sorted(by_n)
        t = [sum(o.time_s for o in by_n[n]) / len(by_n[n]) for n in xs]
        e = [sum(o.energy_j for o in by_n[n]) / len(by_n[n]) for n in xs]
        self.time_model = fit_best(xs, t)
        self.energy_model = fit_best(xs, e)
        # the quantile model fits only counts that HAVE tail samples —
        # mean observations without ttfc (wave callers) leave it alone.
        # Per-count aggregation is a TAIL over the window tails, not a
        # mean: bursty traffic puts its violations in a minority of
        # windows, and averaging window p95s with the calm majority
        # would declare an under-provisioned count SLO-feasible
        qx = [n for n in xs
              if any(o.ttfc_p95_s is not None for o in by_n[n])]
        if len(qx) >= 3:
            q = [self._tail_of([o.ttfc_p95_s for o in by_n[n]
                                if o.ttfc_p95_s is not None])
                 for n in qx]
            self.ttfc_model = fit_best(qx, q)

    # ------------------------------------------------------------------
    def pick(self) -> int:
        unvisited = [n for n in self.feasible
                     if not any(o.n == n for o in self._obs)]
        if self.time_model is None or self.energy_model is None:
            # bootstrap: probe extremes then middle
            if unvisited:
                return unvisited[len(unvisited) // 2 if len(unvisited) > 2
                                 else 0]
            return self.feasible[0]
        if self.epsilon > 0 and self._rng.random() < self.epsilon:
            # explore unvisited counts first, then keep RE-sampling
            # visited ones: a window's time/energy depends on the
            # traffic phase the count happened to serve (a count probed
            # only during a burst looks permanently expensive), and
            # per-count means de-bias only if every count keeps
            # accumulating windows across phases
            return self._rng.choice(unvisited or self.feasible)
        return self._argmin()

    # fits worse than this (normalised rmse) fall back to observed means —
    # the paper's convex forms assume a small n range; a pod sweep over
    # n ∈ [1, 256] can be V-shaped and mislead a quadratic's argmin
    RMSE_TRUST = 0.15

    def _observed_mean(self, n: int, metric: str) -> float | None:
        vals = [getattr(o, metric) for o in self._obs if o.n == n
                and getattr(o, metric) is not None]
        return sum(vals) / len(vals) if vals else None

    # per-count aggregate of window-p95 samples: the 80th percentile of
    # the windows — see _refit for why not mean. Not the max either: a
    # count is "feasible" when ≥80% of its windows met the target, so a
    # rare shed-heavy burst window (loss-censored to the cap) does not
    # brand an otherwise-attaining count infeasible forever
    TAIL_FRAC = 0.8

    @classmethod
    def _tail_of(cls, vals: list) -> float:
        s = sorted(vals)
        return s[int(cls.TAIL_FRAC * (len(s) - 1))]

    def _observed_tail(self, n: int) -> float | None:
        vals = [o.ttfc_p95_s for o in self._obs
                if o.n == n and o.ttfc_p95_s is not None]
        return self._tail_of(vals) if vals else None

    def predict_ttfc_p95(self, n: int) -> float | None:
        """Predicted ttfc p95 at count ``n`` — the fitted quantile model
        when it exists and passes the RMSE trust check, the observed
        per-count tail of the window p95 samples otherwise (the "falls
        back to observations" contract the mean models also follow).
        None before any tail sample exists for ``n`` and no trusted fit
        covers it."""
        fitted = None
        if self.ttfc_model is not None:
            q_mean = self._overall_mean("ttfc_p95_s")
            trusted = (q_mean is not None and q_mean > 0
                       and self.ttfc_model.rmse / max(q_mean, 1e-9)
                       < self.RMSE_TRUST)
            fitted = float(self.ttfc_model(n)) if trusted else None
        if fitted is not None:
            return fitted
        return self._observed_tail(n)

    def _overall_mean(self, metric: str) -> float | None:
        vals = [getattr(o, metric) for o in self._obs
                if getattr(o, metric) is not None]
        return sum(vals) / len(vals) if vals else None

    def _argmin(self) -> int:
        t_mean = sum(o.time_s for o in self._obs) / max(len(self._obs), 1)
        e_mean = sum(o.energy_j for o in self._obs) / max(len(self._obs), 1)
        trust = (self.time_model.rmse / max(t_mean, 1e-9) < self.RMSE_TRUST
                 and self.energy_model.rmse / max(e_mean, 1e-9)
                 < self.RMSE_TRUST)

        def predict(n: int) -> tuple[float, float]:
            """(time, energy) for count n — fitted when the fit passed the
            trust check, observed means otherwise (same source everywhere,
            including the deadline-infeasible fallback below)."""
            t = float(self.time_model(n))
            e = float(self.energy_model(n))
            if not trust:  # poor fit: prefer the measured means
                t_obs = self._observed_mean(n, "time_s")
                e_obs = self._observed_mean(n, "energy_j")
                t = t_obs if t_obs is not None else t
                e = e_obs if e_obs is not None else e
            return t, e

        best_n, best_v = None, None
        for n in self.feasible:
            t, e = predict(n)
            if self.objective == "time":
                v = t
            elif self.objective == "energy":
                v = e
            elif self.objective == "energy_under_slo":
                # energy subject to the predicted tail meeting the SLO.
                # Counts with NO tail prediction yet stay candidates —
                # the bootstrap must not deadlock before quantile
                # samples exist
                q = self.predict_ttfc_p95(n)
                if q is not None and q > self.slo_ttfc_p95_s:
                    continue
                v = e
            else:  # energy under deadline
                if self.deadline is not None and t > self.deadline:
                    continue
                v = e
            if best_v is None or v < best_v:
                best_n, best_v = n, v
        if best_n is None:
            if self.objective == "energy_under_slo":
                # SLO infeasible everywhere: minimise the tail itself —
                # the least-bad violation, by the same trusted source
                best_n = min(self.feasible,
                             key=lambda n: self.predict_ttfc_p95(n))
            else:
                # deadline infeasible everywhere: fall back to the
                # fastest count by the SAME trusted source — consulting
                # the fitted model here when the trust check just
                # rejected it would hand an untrusted argmin straight to
                # the caller
                best_n = min(self.feasible, key=lambda n: predict(n)[0])
        return best_n

    def best(self) -> int:
        """Exploitation-only choice: the fitted argmin when models exist,
        else the best observed mean, else the smallest feasible count.
        Unlike ``pick()`` this never explores — it is what a converged
        deployment runs, and what the adaptive pool reports as its answer."""
        if self.time_model is not None and self.energy_model is not None:
            return self._argmin()
        metric = "time_s" if self.objective == "time" else "energy_j"
        means = {n: self._observed_mean(n, metric) for n in self.feasible}
        means = {n: v for n, v in means.items() if v is not None}
        if means:
            return min(means, key=means.get)
        return self.feasible[0]

    def chunk_for(self, cfg, n: int, *, batch: int = 1,
                  context_tokens: int = 0, max_chunk: int = 32) -> int:
        """Decode chunk length co-optimised with the container count:
        start from the cost model's amortisation optimum
        (``core/roofline.decode_chunk_tokens``) and, under an SLO, cap it
        so one fused chunk's device time stays under ``CHUNK_SLO_FRAC`` of
        the ttfc budget — a request admitted mid-stream waits up to one
        whole chunk of the slots ahead of it. ``n`` scales the
        per-container batch: splitting the same in-flight population over
        more containers shrinks each container's decode batch (and with
        it the optimal chunk)."""
        from repro_torch.core.roofline import (decode_chunk_tokens,
                                               decode_step_seconds)
        per_container = max(1, -(-batch // max(n, 1)))   # ceil div
        base = decode_chunk_tokens(cfg, per_container,
                                   context_tokens=context_tokens,
                                   max_chunk=max_chunk)
        if self.slo_ttfc_p95_s is None:
            return base
        t_tok = decode_step_seconds(cfg, per_container,
                                    context_tokens=context_tokens)
        budget = self.slo_ttfc_p95_s * self.CHUNK_SLO_FRAC
        cap = max(1, int(budget / max(t_tok, 1e-12)))
        return max(1, min(base, cap))

    @property
    def n_observations(self) -> int:
        return len(self._obs)

    def summary(self) -> dict:
        return {
            "feasible": self.feasible,
            "observations": len(self._obs),
            "time_model": (self.time_model.kind, self.time_model.coef)
            if self.time_model else None,
            "energy_model": (self.energy_model.kind, self.energy_model.coef)
            if self.energy_model else None,
            "ttfc_model": (self.ttfc_model.kind, self.ttfc_model.coef)
            if self.ttfc_model else None,
            "slo_ttfc_p95_s": self.slo_ttfc_p95_s,
            "choice": self.pick(),
        }

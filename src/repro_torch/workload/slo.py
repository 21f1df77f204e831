"""SLO specifications and the shared admission-policy arithmetic: the
port's own copy of ``repro.workload.slo``, arithmetic unchanged.

ECORE (PAPERS.md) frames edge serving as energy minimisation *subject
to* latency constraints per request class; this module is that
constraint vocabulary. An ``SLOSpec`` names priority classes, each with
a time-to-first-chunk p95 target, a rank (0 = most important) and a
queue share. Three consumers read it:

* the ``Router`` (serving/router.py) — priority-ordered dispatch,
  SLO-derived shed thresholds, per-tenant quotas, per-class window
  attainment;
* the ``DivideAndSaveScheduler`` (core/scheduler.py) — the binding
  class's target becomes the quantile constraint of the
  ``energy_under_slo`` objective;
* the virtual-time fleet simulator (workload/sim.py) — which calls the
  SAME threshold helpers below, so simulated scheduling claims exercise
  the real policy arithmetic, not a reimplementation.

``queue_limit`` / ``shed_ttfc_threshold`` are deliberately tiny pure
functions: single-sourcing them is what "SLO-derived shed thresholds"
means — nothing recomputes a threshold from a class target anywhere
else. All dataclasses here are frozen, picklable wire types.
Import-light (stdlib only; numpy inside ``class_window``).

``censored_ttfc_p95`` keeps JAX's arithmetic exactly, caveat included:
when fewer observations than the 95th rank exist it returns ``cap_s``
even if the cap lies below every observation (``ttfc=[2.0]``,
``n_lost=1``, ``cap_s=1.0`` gives 1.0). The Router and the simulator
pass cap = 2 x the target, so where this matters both values already
exceed the target, and keeping it keeps the scheduler's picks, and the
simulator's reports, equal to JAX's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One priority class. ``rank`` orders dispatch (0 first);
    ``queue_frac`` is the fraction of the router's ``max_queue`` this
    class may fill before it sheds — lower classes get smaller
    fractions, so overload degrades bottom-up instead of uniformly."""
    name: str = "default"
    ttfc_p95_s: float = 1.0
    rank: int = 0
    queue_frac: float = 1.0
    latency_p95_s: float | None = None

    def __post_init__(self):
        if self.ttfc_p95_s <= 0:
            raise ValueError(f"class {self.name!r}: ttfc_p95_s must be "
                             f"positive, got {self.ttfc_p95_s}")
        if not 0.0 < self.queue_frac <= 1.0:
            raise ValueError(f"class {self.name!r}: queue_frac must be in "
                             f"(0, 1], got {self.queue_frac}")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    classes: tuple = (SLOClass(),)

    def __post_init__(self):
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")

    def cls(self, name: str) -> SLOClass:
        """The class for a request's ``priority`` string. Unknown names
        map to the WORST class (highest rank): unlabelled traffic must
        not jump the queue."""
        for c in self.classes:
            if c.name == name:
                return c
        return max(self.classes, key=lambda c: c.rank)

    @property
    def constraint(self) -> SLOClass:
        """The binding class for the scheduler's quantile constraint:
        the tightest ttfc target."""
        return min(self.classes, key=lambda c: c.ttfc_p95_s)

    def names(self) -> tuple:
        return tuple(c.name for c in self.classes)

    @staticmethod
    def parse(text: str) -> "SLOSpec":
        """``"interactive:0.5,batch:4.0"`` → classes ranked in listed
        order, with queue shares stepping down 1.0, 0.5, 0.25… per rank
        (an optional third ``:frac`` field overrides the share)."""
        classes = []
        for rank, part in enumerate(p for p in text.split(",") if p):
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(
                    f"bad SLO class {part!r} (want name:ttfc_p95_s"
                    "[:queue_frac])")
            frac = float(fields[2]) if len(fields) == 3 \
                else 1.0 / (2 ** rank)
            classes.append(SLOClass(name=fields[0],
                                    ttfc_p95_s=float(fields[1]),
                                    rank=rank, queue_frac=frac))
        if not classes:
            raise ValueError(f"no SLO classes in {text!r}")
        return SLOSpec(classes=tuple(classes))


@dataclasses.dataclass(frozen=True)
class ClassWindow:
    """Per-class slice of one observation window (or of a whole replay
    report): counts, tails, and SLO attainment. ``attained`` is None
    when the class saw no completions (nothing to attain or violate)."""
    name: str = "default"
    n_done: int = 0
    n_shed: int = 0
    n_failed: int = 0
    ttfc_p50_s: float = 0.0
    ttfc_p95_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    target_ttfc_p95_s: float | None = None
    attained: bool | None = None


# ---------------------------------------------------------------------------
# the shared threshold arithmetic (Router AND simulator call these)
# ---------------------------------------------------------------------------
def queue_limit(cls: SLOClass, max_queue: int | None) -> int | None:
    """How many requests may be in flight before THIS class sheds:
    ``max_queue`` scaled by the class's queue share (≥1 so a class is
    never statically locked out). None = unbounded."""
    if max_queue is None:
        return None
    return max(1, int(max_queue * cls.queue_frac))


# headroom over a class's target before admission control sheds it:
# sheds exist to stop hopeless overload, not to enforce the target —
# shedding AT the target throws away arrivals that would still have
# completed within their deadlines (the scheduler enforces the target
# by picking a feasible container count, not by dropping work)
SHED_HEADROOM = 2.0


def shed_ttfc_threshold(cls: SLOClass,
                        override: float | None) -> float | None:
    """The ttfc-p95 level past which this class sheds new arrivals: an
    explicit router-wide ``shed_p95_s`` wins; otherwise the class's own
    SLO target with ``SHED_HEADROOM`` slack — once the tail is that far
    past the promise, admitting more of the class only deepens the
    violation."""
    return override if override is not None \
        else SHED_HEADROOM * cls.ttfc_p95_s


def censored_ttfc_p95(ttfc: list, n_lost: int,
                      cap_s: float) -> float | None:
    """p95 of a class's ttfc **counting lost arrivals as violations**
    (value ``cap_s``, the censoring cap — e.g. 2× the class target).
    ``n_lost`` is shed + failed: admission control pins the *admitted*
    p95 near the shed threshold and deadline expiry removes exactly the
    requests that waited longest, so both losses censor the tail — drop
    them from the sample and every container count looks SLO-feasible
    to the scheduler. None with no observations at all."""
    total = len(ttfc) + n_lost
    if total == 0:
        return None
    k = max(0, -(-95 * total // 100) - 1)   # ceil(0.95·total) - 1
    s = sorted(ttfc)
    return float(s[k]) if k < len(s) else float(cap_s)


def class_window(cls: SLOClass | None, name: str,
                 ttfc: list, latency: list,
                 n_shed: int = 0, n_failed: int = 0) -> ClassWindow:
    """Assemble one per-class window summary from raw samples (shared
    by the Router's window rotation and the replay reports)."""
    import numpy as np
    p = (lambda v, q: float(np.percentile(v, q)) if v else 0.0)
    target = cls.ttfc_p95_s if cls is not None else None
    p95 = p(ttfc, 95)
    return ClassWindow(
        name=name, n_done=len(latency), n_shed=n_shed, n_failed=n_failed,
        ttfc_p50_s=p(ttfc, 50), ttfc_p95_s=p95,
        latency_p50_s=p(latency, 50), latency_p95_s=p(latency, 95),
        target_ttfc_p95_s=target,
        attained=(p95 <= target if target is not None and ttfc else None))

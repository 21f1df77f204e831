"""Fault-injection harness for the serving stack (test-only); a copy of
``repro.serving.faults``.

The divide-and-save premise only pays off if splitting work across
containers doesn't multiply failure modes — so failures must be
*rehearsable*. A ``FaultPlan`` is a picklable script of faults that the
backends execute against themselves under test-only flags:

    plan = FaultPlan((Fault("kill", container_id=0, after_steps=2),))
    backend = ProcessBackend(cfg, 2, params=params, fault_plan=plan, ...)

Fault kinds (per container):

* ``"kill"`` — the container dies abruptly after ``after_steps`` engine
  macro-steps. Process containers ``os._exit`` with
  ``EXIT_FAULT_KILL`` (no cleanup — a real crash); elsewhere the
  engine raises ``InjectedFault`` out of ``step()``.
* ``"error"`` — the engine raises ``InjectedFault`` from ``step()``
  (process children report it over the pipe and exit
  ``EXIT_STEP_ERROR`` — the ordinary-exception failure class).
* ``"drop_replies"`` — process children silently discard their next
  ``count`` event flushes (simulated message loss on the reply pipe;
  the request looks in-flight forever, which is exactly what
  per-request deadlines exist to catch).
* ``"delay_replies"`` — process children sleep ``delay_s`` before each
  of their next ``count`` event flushes (a slow/contended pipe).
* ``"refuse_blocks"`` — the engine's paged-cache admission sees
  ``count`` refused block allocations (simulated pool exhaustion:
  requests stall in the queue until a deadline or the fault drains).

Faults are scoped to a container *incarnation* (0 = the original child,
1 = its first respawn, ...; ``incarnation=None`` applies to every one),
so a chaos test can kill incarnation 0 and assert the respawned child
serves cleanly — or kill every incarnation and assert the circuit
breaker trips.

This module must stay import-light: process children unpickle plans
BEFORE their pinned torch import, so nothing here may pull in torch or
the engine.
"""
from __future__ import annotations

import dataclasses

# Child exit codes, one per failure class, so a dead child's exitcode
# says *why* it died (surfaced in the ContainerFailure message). 0 stays
# the clean ("close",) shutdown; negative exitcodes are signals.
EXIT_STARTUP = 3        # failed before serving (import/params/engine init)
EXIT_PIPE_LOST = 4      # reply pipe broke mid-serve (parent gone?)
EXIT_STEP_ERROR = 5     # engine.step() raised; state unrecoverable
EXIT_FAULT_KILL = 6     # injected FaultPlan kill

EXIT_CLASSES = {
    EXIT_STARTUP: "startup failure",
    EXIT_PIPE_LOST: "reply pipe lost",
    EXIT_STEP_ERROR: "engine step error",
    EXIT_FAULT_KILL: "injected fault kill",
}


def describe_exitcode(code: int | None) -> str:
    """Human string for a child exitcode (``ContainerFailure`` messages)."""
    if code is None:
        return "exit code unknown"
    if code < 0:
        return f"killed by signal {-code}"
    return f"exit {code} ({EXIT_CLASSES.get(code, 'unclassified')})"


class InjectedFault(RuntimeError):
    """Raised out of ``engine.step()`` by an armed injector — thread
    containers surface it like any engine error; process children map
    ``kind='kill'`` to a hard ``os._exit`` instead."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"injected fault: {fault.kind} on container "
                         f"{fault.container_id} after "
                         f"{fault.after_steps} steps")
        self.fault = fault


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault. ``after_steps`` counts the target container's
    engine macro-steps within the incarnation; ``count`` bounds how many
    times a repeating fault (drop/delay/refuse) fires (None = forever)."""
    kind: str
    container_id: int
    after_steps: int = 0
    count: int | None = None
    delay_s: float = 0.0
    incarnation: int | None = 0

    _KINDS = ("kill", "error", "drop_replies", "delay_replies",
              "refuse_blocks")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self._KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A picklable script of ``Fault``s, shipped to backends (and across
    the spawn boundary into process children) under test-only flags."""
    faults: tuple = ()

    def for_container(self, container_id: int,
                      incarnation: int = 0) -> tuple:
        return tuple(f for f in self.faults
                     if f.container_id == container_id
                     and (f.incarnation is None
                          or f.incarnation == incarnation))


class FaultInjector:
    """Per-container, per-incarnation executor of a plan's faults.

    The engine calls ``on_step(step_no)`` at the top of every macro-step
    (raises ``InjectedFault`` for kill/error faults) and
    ``refuse_alloc()`` at each paged block allocation; process children
    additionally consult ``drop_reply()`` / ``reply_delay()`` around
    their event flushes. Stateless engines pass ``None`` instead of an
    injector — every hook is a no-op in that case.
    """

    def __init__(self, plan: FaultPlan | None, container_id: int,
                 incarnation: int = 0):
        faults = (plan.for_container(container_id, incarnation)
                  if plan is not None else ())
        self._step_faults = [f for f in faults
                             if f.kind in ("kill", "error")]
        self._drop = [f.count if f.count is not None else -1
                      for f in faults if f.kind == "drop_replies"]
        self._delay = [[f.count if f.count is not None else -1, f.delay_s]
                       for f in faults if f.kind == "delay_replies"]
        self._refuse = [f.count if f.count is not None else -1
                        for f in faults if f.kind == "refuse_blocks"]
        self._steps = 0

    @property
    def armed(self) -> bool:
        return bool(self._step_faults or self._drop or self._delay
                    or self._refuse)

    def on_step(self, step_no: int | None = None) -> None:
        """Called at the top of every engine macro-step; raises
        ``InjectedFault`` once a kill/error fault's step threshold is
        crossed."""
        self._steps = self._steps + 1 if step_no is None else step_no
        for f in self._step_faults:
            if self._steps > f.after_steps:
                raise InjectedFault(f)

    def refuse_alloc(self) -> bool:
        """True while a refuse_blocks fault still has budget — admission
        must treat the pool as exhausted."""
        for i, left in enumerate(self._refuse):
            if left != 0:
                if left > 0:
                    self._refuse[i] = left - 1
                return True
        return False

    def drop_reply(self) -> bool:
        """True when the next reply flush should be silently discarded."""
        for i, left in enumerate(self._drop):
            if left != 0:
                if left > 0:
                    self._drop[i] = left - 1
                return True
        return False

    def reply_delay(self) -> float:
        """Seconds to sleep before the next reply flush (0.0 = none)."""
        for entry in self._delay:
            if entry[0] != 0:
                if entry[0] > 0:
                    entry[0] -= 1
                return entry[1]
        return 0.0

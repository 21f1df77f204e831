"""Typed per-request serving events (a copy of the ``repro.serving.events``
types the port emits).

Per request the stream is one or more ``ChunkEvent``s — the first carries
the prefill sample and marks time-to-first-chunk, each later one a fused
decode chunk's tokens — then exactly one terminal event: ``DoneEvent``
with the finished ``Completion``, or ``FailedEvent``; a request that
admission sheds gets a single ``RejectedEvent`` instead. A
``RetryEvent`` marks a re-dispatch after the request was lost with its
container: the chunks before it belong to the aborted attempt.
``ContainerFailure`` is the container-scoped record a supervising
backend (``ThreadBackend``, ``ProcessBackend``) returns from ``poll()``.
Events are frozen, picklable dataclasses, and this module imports no
torch: process children unpickle it before theirs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union


@dataclasses.dataclass(frozen=True)
class ChunkEvent:
    """Tokens for one request that materialised in one engine macro-step
    (admission prefill sample, or a fused decode chunk's share)."""
    rid: int
    container_id: int
    tokens: tuple
    time_s: float


@dataclasses.dataclass(frozen=True)
class DoneEvent:
    """Terminal event: the request's completion (a
    ``serving.engine.Completion``), emitted exactly once, after every one
    of its ChunkEvents."""
    rid: int
    container_id: int
    completion: Any
    time_s: float


@dataclasses.dataclass(frozen=True)
class RetryEvent:
    """The request was lost to a container failure and re-dispatched to
    ``container_id`` (its new home) as attempt ``attempt`` (1 = first
    retry). Chunks streamed before this event belong to the aborted
    attempt: the retried prefill restarts from the prompt, so consumers
    reset their accumulation here instead of seeing silently replayed
    tokens."""
    rid: int
    container_id: int
    attempt: int
    reason: str
    time_s: float


@dataclasses.dataclass(frozen=True)
class FailedEvent:
    """Terminal event: the request ended without a completion.
    ``kind`` ∈ {"deadline", "container", "cancelled"}."""
    rid: int
    container_id: int
    kind: str
    reason: str
    time_s: float


@dataclasses.dataclass(frozen=True)
class RejectedEvent:
    """Terminal event: admission control shed this request instead of
    queueing it (the in-flight bound ``max_queue`` reached, or the ttfc
    tail over the shed threshold). ``retry_after_s`` is the Router's
    backpressure hint; ``kind`` ∈ {"queue", "slo"} names the threshold
    that tripped and ``priority`` the request's class ("default" without
    SLO classes)."""
    rid: int
    reason: str
    retry_after_s: float
    time_s: float
    container_id: int = -1        # never dispatched
    kind: str = "queue"
    priority: str = "default"


@dataclasses.dataclass(frozen=True)
class ContainerFailure:
    """Container-scoped typed failure: the container died (``"dead"``),
    raised from ``engine.step()`` (``"error"``), went silent (``"hung"``)
    or failed to start (``"start"``). ``lost_rids`` were in flight there."""
    container_id: int
    kind: str
    message: str
    time_s: float
    exitcode: int | None = None
    lost_rids: tuple = ()


Event = Union[ChunkEvent, DoneEvent, RetryEvent, FailedEvent,
              RejectedEvent, ContainerFailure]

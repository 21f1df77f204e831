"""Typed per-request serving events (a copy of the ``repro.serving.events``
types this slice emits).

Per request the stream is one or more ``ChunkEvent``s — the first carries
the prefill sample and marks time-to-first-chunk, each later one a fused
decode chunk's tokens — then exactly one terminal event: ``DoneEvent``
with the finished ``Completion``, or ``FailedEvent``. ``ContainerFailure``
is the container-scoped record a supervising backend returns from
``poll()``; this slice's backend has no supervision yet and raises
instead, but the type is kept so the event vocabulary matches the JAX
package's. Events are frozen, picklable dataclasses.
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
class FailedEvent:
    """Terminal event: the request ended without a completion.
    ``kind`` ∈ {"deadline", "container", "cancelled"}."""
    rid: int
    container_id: int
    kind: str
    reason: str
    time_s: float


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


Event = Union[ChunkEvent, DoneEvent, FailedEvent, ContainerFailure]

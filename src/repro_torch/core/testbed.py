"""The pinned-process harness of the paper's containers (a copy of the
harness part of ``repro.core.testbed``).

``docker run --cpus=C/n`` becomes an OS process pinned to a disjoint set
of C/n cores with ``os.sched_setaffinity``, applied BEFORE the child
imports torch: torch sizes its intra-op thread pool from the process's
cpuset at first import, as XLA does, so the affinity has to come first.
``assign_core_sets`` carves the host's cores into one set per container
(pairwise disjoint, by construction and by assertion), ``spawn_pinned``
starts ``body(conn, *args)`` in a fresh ``spawn`` process that pins
itself in ``_pinned_main`` before it runs the body.

This module imports no torch: spawn pickles ``_pinned_main`` by
reference, so the child imports this module at bootstrap, before any
affinity is applied.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Callable, Sequence


def available_cores() -> list[int]:
    """Cores this process may use — ``sched_getaffinity`` where it exists
    (Linux: respects cgroup/container cpusets), ``cpu_count`` elsewhere so
    non-Linux dev hosts still get a sane carve-up (children then run
    unpinned, see ``_pinned_main``)."""
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:
        return list(range(os.cpu_count() or 1))


def assign_core_sets(n_containers: int, total_cores: int | None = None,
                     avail: Sequence[int] | None = None,
                     allow_shared: bool = False) -> list[frozenset[int]]:
    """Carve the host's cores into one set per container — the
    ``docker run --cpus`` allocation as explicit cpusets.

    With ``n_containers <= cores`` the sets are contiguous, equal-size
    (``cores // n``) and pairwise disjoint; disjointness is asserted, not
    assumed, because it IS the isolation claim every measurement rests on.
    With more containers than cores the request is contradictory unless
    ``allow_shared=True``, which degrades to round-robin single-core sets
    (kernel time-slicing — the fractional-share analogue).
    """
    if n_containers <= 0:
        raise ValueError("n_containers must be positive")
    if avail is None:
        avail = available_cores()
    else:
        avail = sorted(set(avail))
    if total_cores is not None:
        if total_cores <= 0:
            raise ValueError("total_cores must be positive")
        avail = avail[:total_cores]
    total = len(avail)
    if n_containers > total:
        if not allow_shared:
            raise ValueError(
                f"{n_containers} containers over {total} cores cannot have "
                "pairwise-disjoint core sets; reduce n_containers or pass "
                "allow_shared=True to accept round-robin time-shared cores "
                "(the --cpus < 1 fractional-share analogue)")
        return [frozenset({avail[i % total]}) for i in range(n_containers)]
    cpc = total // n_containers
    sets = [frozenset(avail[i * cpc:(i + 1) * cpc])
            for i in range(n_containers)]
    seen: set[int] = set()
    for s in sets:
        if len(s) != cpc or seen & s:
            raise AssertionError(
                "core assignment produced overlapping or ragged sets")
        seen |= s
    return sets


def _pinned_main(cores: Sequence[int], body: Callable, conn, args) -> None:
    """Child entry point: affinity FIRST, then the body (whose torch import
    sizes the intra-op pool from the already-restricted cpuset)."""
    try:
        os.sched_setaffinity(0, set(cores))
    except (AttributeError, OSError):   # non-Linux dev hosts: run unpinned
        pass
    body(conn, *args)


def spawn_pinned(body: Callable, cores: Sequence[int], args: tuple = (),
                 ctx=None):
    """Spawn ``body(conn, *args)`` in a fresh process pinned to ``cores``
    before torch can initialise. Returns ``(process, parent_conn)``.

    ``body`` must be a module-level (picklable) function in a module that
    imports no torch, and must do its torch import inside itself; ``args``
    must unpickle without torch too (send tensors over the pipe after the
    child has pinned itself). The spawn start method is the only one: a
    forked child cannot use CUDA.
    """
    ctx = ctx or mp.get_context("spawn")
    if ctx.get_start_method() != "spawn":
        raise ValueError("spawn_pinned needs the spawn start method (a "
                         "forked child cannot use CUDA)")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_pinned_main,
                       args=(sorted(cores), body, child, args))
    proc.start()
    child.close()
    return proc, parent

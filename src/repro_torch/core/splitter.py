"""Workload splitting (paper §V step 1) — the "divide" in Divide and Save.

The port's own copy of ``repro.core.splitter`` (numpy only), so the port
imports nothing of the JAX package.

A splittable workload is a sequence of independent units (video frames in
the paper; inference requests here). ``split`` cuts it into n contiguous,
maximally-equal segments; ``combine`` restores the original order. The
invariant tested by hypothesis: combine(split(w, n)) == w for every n, and
segment sizes differ by at most 1.
"""
from __future__ import annotations

from typing import Sequence, TypeVar

import numpy as np

T = TypeVar("T")


def segment_sizes(n_items: int, n_segments: int) -> list[int]:
    if n_segments <= 0:
        raise ValueError("n_segments must be positive")
    base, rem = divmod(n_items, n_segments)
    return [base + (1 if i < rem else 0) for i in range(n_segments)]


def split(items: Sequence[T], n_segments: int) -> list[list[T]]:
    sizes = segment_sizes(len(items), n_segments)
    out, i = [], 0
    for s in sizes:
        out.append(list(items[i:i + s]))
        i += s
    return out


def combine(segments: Sequence[Sequence[T]]) -> list[T]:
    out: list[T] = []
    for seg in segments:
        out.extend(seg)
    return out


def split_array(x: np.ndarray, n_segments: int, axis: int = 0) -> list[np.ndarray]:
    """Split an array of independent units (frames / requests) along axis."""
    sizes = segment_sizes(x.shape[axis], n_segments)
    idx = np.cumsum(sizes)[:-1]
    return np.split(x, idx, axis=axis)


def combine_arrays(parts: Sequence[np.ndarray], axis: int = 0) -> np.ndarray:
    return np.concatenate(list(parts), axis=axis)

"""Summaries shared by the Router and the pools (the port's own copy of the
numpy-only parts of ``repro.serving.pool`` it needs so far).

``percentiles`` is the one guard every latency-ish summary goes through:
the Router's ttfc shed threshold today, window statistics once the
adaptive loop is ported.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def percentiles(values: Sequence[float]) -> tuple[float, float]:
    """(p50, p95) of a sample, (0, 0) when empty, so an idle container or
    an empty window gives well-defined zeros instead of an error."""
    if not values:
        return 0.0, 0.0
    return (float(np.percentile(values, 50)),
            float(np.percentile(values, 95)))

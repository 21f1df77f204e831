"""Trace-driven workload subsystem (the port's counterpart of
``repro.workload``): seeded arrival-process + length generators
(``traces``), SLO class vocabulary and the shared admission arithmetic
(``slo``), an open-loop replayer over the port's Router (``replay``) and
its deterministic virtual-time twin (``sim``)."""
from repro_torch.workload.slo import ClassWindow, SLOClass, SLOSpec
from repro_torch.workload.traces import (PRESETS, Trace, TraceRequest,
                                         TraceSpec, get_preset,
                                         load_or_synthesize, synthesize)

__all__ = [
    "ClassWindow", "SLOClass", "SLOSpec",
    "PRESETS", "Trace", "TraceRequest", "TraceSpec",
    "get_preset", "load_or_synthesize", "synthesize",
]

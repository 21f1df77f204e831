"""Serving stack: Router → ThreadBackend → ServingEngine over the dense
KV cache (ported from ``repro.serving``)."""

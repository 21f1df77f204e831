"""Serving stack: Router → ThreadBackend → ServingEngine over the dense or
the paged KV cache (ported from ``repro.serving``)."""

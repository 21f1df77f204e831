"""Serving stack: Router → ThreadBackend or ProcessBackend (pinned child
processes) → ServingEngine over the dense or the paged KV cache (ported
from ``repro.serving``). Import-light on purpose: spawned children import
this package before they pin themselves."""

"""Serving stack: Router → ThreadBackend or ProcessBackend (pinned child
processes) → ServingEngine over the dense or the paged KV cache (ported
from ``repro.serving``). Import-light on purpose: spawned children import
this package before they pin themselves, so the two protocols it exports,
``ContainerBackend`` (the Router's contract with a backend) and
``CacheBackend`` (the engine's contract with a cache), resolve from their
home modules on first access, as JAX's package resolves them."""
from __future__ import annotations

import importlib

__all__ = ["ContainerBackend", "CacheBackend"]

_HOME = {"ContainerBackend": "repro_torch.serving.backend",
         "CacheBackend": "repro_torch.serving.cache"}


def __getattr__(name: str):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(__all__) | set(globals()))

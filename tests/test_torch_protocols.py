"""The port's two serving protocols against JAX's.

``repro_torch.serving`` exports ``ContainerBackend`` (the Router's
contract with a backend) and ``CacheBackend`` (the engine's contract with
a cache), copies of JAX's ``runtime_checkable`` protocols with the same
members. ``ThreadBackend`` and ``ProcessBackend`` (on the CPU, one
spawned child) are ``ContainerBackend`` instances; the dense and paged
caches of engines over bf16, int8 and MLA trees are ``CacheBackend``
instances; ``DenseCache``'s block accounting returns what JAX's returns,
and ``view`` is the tree both caches hand the model. The package stays
import-light: the protocols resolve on first access.
"""
from __future__ import annotations

import dataclasses
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import backend as jbackend  # noqa: E402
from repro.serving import cache as jcache  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.backend import (ProcessBackend,  # noqa: E402
                                         ThreadBackend)
from repro_torch.serving.cache import DenseCache, PagedCache  # noqa: E402
from repro_torch.serving.engine import (EngineConfig,  # noqa: E402
                                        ServingEngine)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b-reduced"
CONFIG = dict(n_slots=2, max_len=64, chunk_tokens=4)


def _members(proto) -> dict:
    """A protocol's own members: its annotated attributes and each
    method's parameters."""
    out = {name: "attribute" for name in proto.__annotations__}
    for name, fn in vars(proto).items():
        if inspect.isfunction(fn) and not name.startswith("_"):
            out[name] = list(inspect.signature(fn).parameters)
    return out


@pytest.mark.parametrize("ours, theirs", [
    (serving.ContainerBackend, jbackend.ContainerBackend),
    (serving.CacheBackend, jcache.CacheBackend)])
def test_protocols_have_jaxs_members(ours, theirs):
    assert _members(ours) == _members(theirs)
    assert ours.__doc__ == theirs.__doc__
    for name, fn in vars(theirs).items():
        if inspect.isfunction(fn):
            assert getattr(ours, name).__doc__ == fn.__doc__, name


def test_serving_package_stays_import_light():
    """Importing the package loads no torch; the protocols load their
    home modules on first access."""
    script = ("import sys\nimport repro_torch.serving as s\n"
              "assert 'torch' not in sys.modules\n"
              "assert s.ContainerBackend.__name__ == 'ContainerBackend'\n"
              "assert s.CacheBackend.__name__ == 'CacheBackend'\n"
              "assert sorted(s.__all__) == ['CacheBackend', "
              "'ContainerBackend']\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    with pytest.raises(AttributeError):
        serving.ServingEngine  # noqa: B018


def test_thread_and_process_backends_are_container_backends():
    model = Model(get_config(ARCH), device="cpu")
    params = model.init(seed=0)
    thread = ThreadBackend(model, params, 2, EngineConfig(**CONFIG),
                           device="cpu")
    try:
        assert isinstance(thread, serving.ContainerBackend)
    finally:
        thread.close()
    proc = ProcessBackend(model.cfg, 1, EngineConfig(**CONFIG),
                          params_seed=0, device="cpu",
                          start_timeout_s=120.0)
    try:
        assert isinstance(proc, serving.ContainerBackend)
        # the optional fault surface the Router discovers with getattr
        for backend in (thread, proc):
            assert callable(backend.alive) and callable(backend.cancel)
            assert isinstance(backend.failures, list)
    finally:
        proc.close()
    assert not isinstance(object(), serving.ContainerBackend)


def _engine(cfg, cache: str, dtype=torch.float32) -> ServingEngine:
    model = Model(cfg, device="cpu")
    kw = dict(cache="paged", block_size=16, max_seqs=2) \
        if cache == "paged" else {}
    return ServingEngine(model, model.init(seed=0, dtype=dtype),
                         EngineConfig(dtype=dtype, **CONFIG, **kw),
                         device="cpu")


TREES = {  # what each engine's cache holds
    "bf16": (ARCH, torch.bfloat16, None),
    "int8": (ARCH, torch.float32, "int8"),
    "mla": ("deepseek-v2-lite-16b-reduced", torch.float32, None),
}


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("tree", list(TREES))
def test_engine_caches_are_cache_backends(tree, cache):
    name, dtype, kv = TREES[tree]
    cfg = get_config(name)
    if kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    eng = _engine(cfg, cache, dtype)
    backend = eng.cache_backend
    assert isinstance(backend, DenseCache if cache == "dense"
                      else PagedCache)
    assert isinstance(backend, serving.CacheBackend)
    assert backend.view() is backend.tree
    leaves = [t for g in backend.view() for t in g.values()]
    if tree == "int8":
        assert any(t.dtype == torch.int8 for t in leaves)
    if tree == "bf16":
        assert any(t.dtype == torch.bfloat16 for t in leaves)
    if tree == "mla":
        assert any(k.startswith("ckv") for g in backend.view() for k in g)


def test_dense_cache_accounting_returns_jaxs_values():
    """Every protocol call on a dense cache returns what JAX's DenseCache
    returns (a row is its own reservation) and leaves the tree as it
    was."""
    tree = [{"k": torch.zeros(2, 8, 1, 4), "v": torch.zeros(2, 8, 1, 4)}]
    ours = DenseCache(tree, 2)
    theirs = jcache.DenseCache({"k": np.zeros((2, 8, 1, 4))}, 2, None, {})
    for call, args in (("can_admit", (10_000,)), ("alloc", (0, 8)),
                       ("alloc", (1, 10_000)), ("append", (0,)),
                       ("append", (1, 3)), ("free", (0,)), ("flush", ())):
        assert getattr(ours, call)(*args) == getattr(theirs, call)(*args), \
            call
    assert ours.view() is tree and theirs.view() is theirs.tree
    assert all(not t.any() for g in tree for t in g.values())
    assert isinstance(theirs, jcache.CacheBackend)
    assert not isinstance(np.zeros(3), serving.CacheBackend)

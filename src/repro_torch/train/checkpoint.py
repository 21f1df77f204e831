"""Checkpoints in the reference's format (``repro.train.checkpoint``): one
flat ``.npz`` whose keys are the ``::``-joined paths of a tree's leaves
(dict keys, list indices), beside a ``.meta.json`` sidecar. A file one
package writes, the other restores.

``save`` and ``restore`` take nested dicts (and lists) of tensors, numpy
arrays or numbers. The port's parameters go through JAX's stacked layout
(``params.to_numpy`` / ``from_numpy``) so a checkpoint of either package
has the same keys: ``state_to_numpy`` / ``state_from_numpy`` do that for
the parameters and the optimizer state together.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.params import from_numpy, to_numpy

_SEP = "::"


def _items(tree: Any, path: tuple = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _final(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, meta: dict | None = None) -> None:
    """Write ``tree``'s leaves to ``path`` (``.npz`` appended unless given)
    and ``meta`` to its ``.meta.json``; the file is written under a
    temporary name and moved into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _array(v) for k, v in _items(tree)})
    os.replace(tmp, _final(path))
    with open(_final(path) + ".meta.json", "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)


def _rebuild(like: Any, flat: dict, path: tuple = ()):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, path + (str(i),))
                          for i, v in enumerate(like))
    key = _SEP.join(path)
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if arr.shape != shape:
        raise ValueError(f"{key}: shape {arr.shape} != {shape}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr.copy()).to(device=like.device,
                                               dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr)


def restore(path: str, like: Any) -> Any:
    """The tree at ``path`` in the structure, dtypes and devices of
    ``like``; raises ``KeyError`` for a missing leaf and ``ValueError``
    for a shape that differs."""
    with np.load(_final(path)) as data:
        flat = dict(data)
    return _rebuild(like, flat)


def load_meta(path: str) -> dict:
    with open(_final(path) + ".meta.json") as f:
        return json.load(f)


def state_to_numpy(cfg: ArchConfig, params: dict,
                   opt_state: dict | None = None) -> dict:
    """The parameters (and the optimizer state) in JAX's stacked layout:
    ``{"params": ..., "opt": {"m", "v", "step"}}``."""
    tree = {"params": to_numpy(cfg, params)}
    if opt_state is not None:
        tree["opt"] = {"m": to_numpy(cfg, opt_state["m"]),
                       "v": to_numpy(cfg, opt_state["v"]),
                       "step": np.int32(opt_state["step"])}
    return tree


def state_from_numpy(cfg: ArchConfig, tree: dict, *,
                     device: str | torch.device = "cuda",
                     dtype: torch.dtype | None = None) -> tuple:
    """``state_to_numpy``'s inverse: ``(params, opt_state or None)`` on
    ``device`` (the moments float32)."""
    params = from_numpy(cfg, tree["params"], device=device, dtype=dtype)
    if "opt" not in tree:
        return params, None
    opt = tree["opt"]
    return params, {
        "m": from_numpy(cfg, opt["m"], device=device, dtype=torch.float32),
        "v": from_numpy(cfg, opt["v"], device=device, dtype=torch.float32),
        "step": int(opt["step"])}

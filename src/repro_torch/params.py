"""The weight bridge: numpy parameter trees into the port's layout.

``from_numpy`` is the only way weights cross from the JAX package to the
port. It takes the nested dict of numpy arrays that ``repro`` keeps (the
layout ``repro.serving.backend.save_params`` writes: ``embed``,
``final_norm``, optional ``lm_head`` and a ``stack`` whose leaves carry a
leading layer axis: ``{ln1, attn, ln2, mlp}`` for the dense family,
``{ln, mamba}`` for the SSM family) and returns the port's parameter
dict, with each stacked (L, ...) leaf split into per-layer tensors. The
bytes are kept exactly (bfloat16 included) unless a ``dtype`` cast is
asked for; a Mamba2 block's float32 leaves (``models.ssm.F32_LEAVES``)
stay float32 under any cast, as the reference keeps them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import check_supported
from repro_torch.models.ssm import F32_LEAVES


def _tensor(a: Any, device: torch.device,
            dtype: torch.dtype | None) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the raw 16-bit words
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _convert(tree: Any, device: torch.device, dtype, layer: int | None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, None if k in F32_LEAVES else dtype,
                            layer) for k, v in tree.items()}
    return _tensor(tree if layer is None else tree[layer], device, dtype)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def from_numpy(cfg: ArchConfig, tree: dict, *,
               device: str | torch.device = "cuda",
               dtype: torch.dtype | None = None) -> dict:
    """Port parameters for ``cfg`` from a nested dict of numpy arrays."""
    check_supported(cfg)
    dev = resolve_device(device)
    need = {"embed", "final_norm", "stack"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(tree) != need:
        raise ValueError(f"{cfg.name}: parameter groups {sorted(tree)}, "
                         f"expected {sorted(need)}")
    table = np.shape(tree["embed"]["table"])
    if table != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed table {table}, expected "
                         f"{(cfg.vocab_size, cfg.d_model)}")
    depths = {np.shape(a)[0] for a in _leaves(tree["stack"])}
    if depths != {cfg.n_layers}:
        raise ValueError(f"{cfg.name}: stacked leaves have leading axes "
                         f"{sorted(depths)}, expected {cfg.n_layers}")
    params = {k: _convert(v, dev, dtype, None)
              for k, v in tree.items() if k != "stack"}
    params["layers"] = [_convert(tree["stack"], dev, dtype, layer)
                        for layer in range(cfg.n_layers)]
    return params

"""The weight bridge: numpy parameter trees into the port's layout.

``from_numpy`` is the only way weights cross from the JAX package to the
port. It takes the nested dict of numpy arrays that ``repro`` keeps (the
layout ``repro.serving.backend.save_params`` writes: ``embed``,
``final_norm``, optional ``lm_head`` and a ``stack`` whose leaves carry a
leading layer axis: ``{ln1, attn, ln2, mlp}`` for the dense family,
``{ln, mamba}`` for the SSM family, ``{ln1, attn, ln2, moe}`` for the MoE
family, whose ``n_dense_layers`` leading dense layers come as a second
group ``dense0`` of the dense family's layout) and returns the port's
parameter dict, with each stacked (L, ...) leaf split into per-layer
tensors, ``dense0``'s first. An expert weight keeps its leading E axis.
The bytes are kept exactly (bfloat16 included) unless a ``dtype`` cast
is asked for; a Mamba2 block's float32 leaves (``models.ssm.F32_LEAVES``)
and the MoE router (``models.moe.F32_LEAVES``) stay float32 under any
cast, as the reference keeps them.

``save_params`` writes the port's parameters back into that stacked
layout as one ``.npz`` (a leaf a key, its path joined by ``/``; bfloat16
leaves as their 16-bit words under a ``@bfloat16`` suffix), and
``load_params`` reads such a file through ``from_numpy``: the weight
handoff of a ``ProcessBackend(params_path=...)``.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe, ssm
from repro_torch.models.model import check_supported, family

F32_LEAVES = ssm.F32_LEAVES + moe.F32_LEAVES


def _tensor(a: Any, device: torch.device,
            dtype: torch.dtype | None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):       # a bfloat16 leaf of load_params
        t = a.contiguous().clone().to(device)
        return t if dtype is None else t.to(dtype)
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
    n_dense = cfg.n_dense_layers if family(cfg) == "moe" else 0
    # stacked groups in layer order, with their depths
    groups = {"dense0": n_dense} if n_dense else {}
    groups["stack"] = cfg.n_layers - n_dense
    need = {"embed", "final_norm", *groups} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(tree) != need:
        raise ValueError(f"{cfg.name}: parameter groups {sorted(tree)}, "
                         f"expected {sorted(need)}")
    table = np.shape(tree["embed"]["table"])
    if table != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed table {table}, expected "
                         f"{(cfg.vocab_size, cfg.d_model)}")
    for name, depth in groups.items():
        depths = {np.shape(a)[0] for a in _leaves(tree[name])}
        if depths != {depth}:
            raise ValueError(f"{cfg.name}: {name} leaves have leading axes "
                             f"{sorted(depths)}, expected {depth}")
    params = {k: _convert(v, dev, dtype, None)
              for k, v in tree.items() if k not in groups}
    params["layers"] = [_convert(tree[name], dev, dtype, layer)
                        for name, depth in groups.items()
                        for layer in range(depth)]
    return params


_BF16 = "@bfloat16"


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def save_params(params: dict, path: str | os.PathLike) -> str:
    """Write the port's parameters (``Model.init`` or ``from_numpy``) to
    ``path`` as ``.npz`` in the stacked layout ``from_numpy`` takes: the
    per-layer dicts stacked along a leading layer axis into ``stack``
    (and, for an MoE model, its leading dense layers into ``dense0``).
    The bytes are kept exactly. Returns the path."""
    layers = params["layers"]
    groups: dict[str, list] = {}
    for p in layers:
        # an MoE model's leading dense layers (their MLP is "mlp") are
        # dense0, its MoE layers the stack; any other model is one stack
        name = ("dense0" if "mlp" in p and any("moe" in q for q in layers)
                else "stack")
        groups.setdefault(name, []).append(p)
    tree = {k: v for k, v in params.items() if k != "layers"}
    for name, group in groups.items():
        tree[name] = _stack(group)
    arrays = {}
    for key, t in _flat(tree):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arrays[key + _BF16] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            arrays[key] = t.numpy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return str(path)


def _stack(group: list) -> dict:
    first = group[0]
    return {k: (_stack([p[k] for p in group]) if isinstance(v, dict)
                else torch.stack([p[k] for p in group]))
            for k, v in first.items()}


def load_params(cfg: ArchConfig, path: str | os.PathLike, *,
                device: str | torch.device = "cuda",
                dtype: torch.dtype | None = None) -> dict:
    """The parameters a ``save_params`` file holds, on ``device``, through
    ``from_numpy`` (so with its checks and its ``dtype`` rule)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            if key.endswith(_BF16):
                key = key[:-len(_BF16)]
                a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = a
    return from_numpy(cfg, tree, device=device, dtype=dtype)

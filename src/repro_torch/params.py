"""The weight bridge: numpy parameter trees into the port's layout.

``from_numpy`` is the only way weights cross from the JAX package to the
port. It takes the nested dict of numpy arrays that ``repro`` keeps (the
layout ``repro.serving.backend.save_params`` writes: ``embed``,
``final_norm``, optional ``lm_head`` and a ``stack`` whose leaves carry a
leading layer axis: ``{ln1, attn, ln2, mlp}`` for the dense family,
``{ln, mamba}`` for the SSM family, ``{ln1, attn, ln2, moe}`` for the MoE
family, whose ``n_dense_layers`` leading dense layers come as a second
group ``dense0`` of the dense family's layout; the gemma family's dense
layers come as ``super: {local: (n_super, k, ...), global: (n_super,
...)}`` for its super-blocks of k local layers and one global, and
``rem: (n_rem, ...)`` for the local layers left over; the zamba family's
come as ``super: {ssm: (n_super, k, ...)}`` for its super-blocks of k SSM
layers, ``shared`` (no layer axis) for the one attention block every
super-block applies, and ``rem: (n_rem, ...)`` for the SSM layers left
over; a vision model adds ``vis_proj: {w1, w2}``; whisper's decoder
layers come as the ``stack`` of ``{ln1, self_attn, ln2, cross_attn, ln3,
mlp}``, beside ``enc_stack`` (its encoder layers, the dense family's
layout) and ``enc_norm``) and returns the port's parameter dict, with each stacked leaf split into per-layer tensors in
layer order (``dense0``'s first; each super-block's locals, then its
global, then ``rem``; for zamba each super-block's SSM layers, then the
shared block, converted once and the same dict at every application;
whisper's encoder layers into ``enc_layers``).
An expert weight keeps its leading E axis.
The bytes are kept exactly (bfloat16 included) unless a ``dtype`` cast
is asked for; a Mamba2 block's float32 leaves (``models.ssm.F32_LEAVES``)
and the MoE router (``models.moe.F32_LEAVES``) stay float32 under any
cast, as the reference keeps them.

``save_params`` writes the port's parameters back into that stacked
layout (a gemma or zamba model's given its config) as one ``.npz`` (a leaf a key, its path joined by ``/``; bfloat16
leaves as their 16-bit words under a ``@bfloat16`` suffix), and
``load_params`` reads such a file through ``from_numpy``: the weight
handoff of a ``ProcessBackend(params_path=...)``. ``to_numpy`` is
``from_numpy``'s inverse, the same stacked layout as numpy arrays (how a
test holds the port's gradients and updated parameters against JAX's).
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


def _convert(tree: Any, device: torch.device, dtype,
             layer: tuple[int, ...] = ()):
    if isinstance(tree, dict):
        return {k: _convert(v, device, None if k in F32_LEAVES else dtype,
                            layer) for k, v in tree.items()}
    return _tensor(tree[layer] if layer else tree, device, dtype)


def _layout(cfg: ArchConfig) -> tuple[dict, list]:
    """The stacked groups of ``cfg``'s tree, each path (a tuple of keys)
    with the leading axes of its leaves, and each port layer's (path,
    index into those axes), in layer order; an application of zamba's
    shared block is ``(("shared",), None)``: that group has no layer
    axis."""
    if family(cfg) == "zamba":
        k = cfg.shared_attn_every
        n_super = cfg.n_layers // k
        n_rem = cfg.n_layers - n_super * k
        groups = {("super", "ssm"): (n_super, k)}
        order = [slot for i in range(n_super)
                 for slot in [(("super", "ssm"), (i, j)) for j in range(k)]
                 + [(("shared",), None)]]
        if n_rem:
            groups[("rem",)] = (n_rem,)
            order += [(("rem",), (i,)) for i in range(n_rem)]
        return groups, order
    if family(cfg) == "gemma":
        k = cfg.local_global_pattern
        n_super = cfg.n_layers // (k + 1)
        n_rem = cfg.n_layers - n_super * (k + 1)
        groups = {("super", "local"): (n_super, k),
                  ("super", "global"): (n_super,)}
        order = [slot for i in range(n_super)
                 for slot in [(("super", "local"), (i, j))
                              for j in range(k)]
                 + [(("super", "global"), (i,))]]
        if n_rem:
            groups[("rem",)] = (n_rem,)
            order += [(("rem",), (i,)) for i in range(n_rem)]
        return groups, order
    n_dense = cfg.n_dense_layers if family(cfg) == "moe" else 0
    groups = {("dense0",): (n_dense,)} if n_dense else {}
    groups[("stack",)] = (cfg.n_layers - n_dense,)
    return groups, [(path, (i,)) for path, (n,) in groups.items()
                    for i in range(n)]


# whisper's stacked encoder layers
_ENC = ("enc_stack",)


def _at(tree: dict, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


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
    groups, order = _layout(cfg)
    n_enc = cfg.n_encoder_layers if family(cfg) == "whisper" else 0
    if n_enc:
        groups[_ENC] = (n_enc,)
    tops = {path[0] for path in groups}
    shared = any(index is None for _, index in order)
    need = ({"embed", "final_norm", *tops}
            | (set() if cfg.tie_embeddings else {"lm_head"})
            | ({"shared"} if shared else set())
            | ({"vis_proj"} if cfg.n_vision_tokens else set())
            | ({"enc_norm"} if n_enc else set()))
    if set(tree) != need:
        raise ValueError(f"{cfg.name}: parameter groups {sorted(tree)}, "
                         f"expected {sorted(need)}")
    table = np.shape(tree["embed"]["table"])
    if table != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed table {table}, expected "
                         f"{(cfg.vocab_size, cfg.d_model)}")
    for path, axes in groups.items():
        found = {tuple(np.shape(a)[:len(axes)])
                 for a in _leaves(_at(tree, path))}
        if found != {axes}:
            raise ValueError(f"{cfg.name}: {'/'.join(path)} leaves have "
                             f"leading axes {sorted(found)}, expected "
                             f"{axes}")
    params = {k: _convert(v, dev, dtype)
              for k, v in tree.items() if k not in tops}
    block = params.pop("shared", None)
    params["layers"] = [block if index is None
                        else _convert(_at(tree, path), dev, dtype, index)
                        for path, index in order]
    if n_enc:
        params["enc_layers"] = [_convert(_at(tree, _ENC), dev, dtype, (i,))
                                for i in range(n_enc)]
    return params


_BF16 = "@bfloat16"


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _stacked(params: dict, cfg: ArchConfig | None) -> dict:
    """The port's parameters in the stacked layout ``from_numpy`` takes
    (``save_params``' rule for ``cfg``), as a tree of tensors."""
    layers = params["layers"]
    tree = {k: v for k, v in params.items()
            if k not in ("layers", "enc_layers")}
    if "enc_layers" in params:
        tree[_ENC[0]] = _stack(params["enc_layers"],
                               (len(params["enc_layers"]),))
    if cfg is not None:
        groups, order = _layout(cfg)
        names = [path for path, _ in order]
        for p, (group, index) in zip(layers, order):
            if index is None:
                tree[group[0]] = p
    else:
        # an MoE model's leading dense layers (their MLP is "mlp") are
        # dense0, its MoE layers the stack; any other model is one stack
        moe_model = any("moe" in q for q in layers)
        names = [("dense0",) if "mlp" in p and moe_model else ("stack",)
                 for p in layers]
        groups = {n: (names.count(n),) for n in dict.fromkeys(names)}
    members: dict[tuple, list] = {}
    for p, name in zip(layers, names):
        members.setdefault(name, []).append(p)
    for name, axes in groups.items():
        node = tree
        for k in name[:-1]:
            node = node.setdefault(k, {})
        node[name[-1]] = _stack(members[name], axes)
    return tree


def save_params(params: dict, path: str | os.PathLike,
                cfg: ArchConfig | None = None) -> str:
    """Write the port's parameters (``Model.init`` or ``from_numpy``) to
    ``path`` as ``.npz`` in the stacked layout ``from_numpy`` takes: the
    per-layer dicts stacked along a leading layer axis into ``stack``
    (and, for an MoE model, its leading dense layers into ``dense0``),
    or, given the gemma or zamba config ``cfg``, into its ``super`` and
    ``rem`` groups, zamba's shared block once as ``shared`` (without
    ``cfg`` such a model would be written as one ``stack``, which
    ``load_params`` refuses); whisper's ``enc_layers`` into
    ``enc_stack``. The bytes are kept exactly. Returns the path."""
    tree = _stacked(params, cfg)
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


def to_numpy(cfg: ArchConfig, params: dict) -> dict:
    """The inverse of ``from_numpy``: the port's parameters for ``cfg`` (or
    any tree of their shape, such as their gradients or an optimizer's
    moments) as JAX's stacked tree of numpy arrays, copied off the device,
    so they compare with JAX's leaf by leaf. ``to_numpy(cfg,
    from_numpy(cfg, tree))`` equals a float32 ``tree`` bit for bit; a
    bfloat16 leaf comes back as float32 (exactly its values: numpy has
    no bfloat16)."""
    check_supported(cfg)

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(tree):
        return ({k: walk(v) for k, v in tree.items()}
                if isinstance(tree, dict) else leaf(tree))
    return walk(_stacked(params, cfg))


def _stack(group: list, axes: tuple[int, ...]) -> dict:
    """The leaves of ``group``'s layer dicts stacked in order, the
    leading axis reshaped to ``axes``."""
    first = group[0]
    return {k: (_stack([p[k] for p in group], axes) if isinstance(v, dict)
                else torch.stack([p[k] for p in group]).reshape(
                    *axes, *v.shape))
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

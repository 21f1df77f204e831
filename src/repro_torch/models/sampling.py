"""Categorical sampling: Gumbel-max over the full vocabulary, from a random
stream held as device state.

JAX samples with ``jax.random.categorical``, the argmax of ``logits`` plus
Gumbel noise; the port does the same, with no temperature and no
renormalisation. Its random stream is a ``key``: a (2,) int64 tensor
``[seed, draw]``. A pick reads the noise of draw ``draw`` and the caller
advances ``draw`` by one, as JAX splits its key once a pick. The noise of
element ``e`` (row-major over the logits) at a draw is a counter-based
hash of ``(seed, draw, e)`` computed with tensor ops, so it needs no
generator object: a CUDA graph that captures a pick reads the key from
memory at every replay and draws new noise once the step has advanced it,
and a replayed step gives the eager step's bits. A row's noise depends on
its row index, not on how many rows the logits have, so a prefill batch
padded with extra rows samples its real rows as the unpadded batch would.

The hash is a 32-bit integer mixer (16, 0x21f0aaad, 15, 0x735a2d97, 15)
applied three times: over ``e``, then over that ``^ seed``, then over
that ``^ draw``. The seed and the draw each enter after a mixing round:
xored into the raw counter, a seed would only permute one field (the
noise of seed ``s`` at element ``e`` would be seed 0's at ``e ^ s``), so
two seeds would sample tokens related by xor. Its values are kept below
2**32 in int64 tensors, and both multipliers are below 2**31, so no
product overflows. The top 24 bits give a uniform in (0, 1).
``seed`` and ``draw`` are taken modulo 2**32, and the logits of one pick
may hold at most 2**32 elements.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def new_key(seed: int, draw: int = 0,
            device: str | torch.device = "cpu") -> torch.Tensor:
    """The stream's state ``[seed, draw]`` as a (2,) int64 tensor."""
    return torch.tensor([seed & M32, draw & M32], dtype=torch.int64,
                        device=device)


def uniform(key: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) float32 uniforms in (0, 1) of draw ``key[1]``."""
    if rows * cols > M32 + 1:
        raise ValueError(f"{rows} x {cols} elements exceed one draw")
    e = torch.arange(rows * cols, dtype=torch.int64,
                     device=key.device).view(rows, cols)
    x = _mix(_mix(e) ^ key[0:1])
    x = _mix(x ^ (key[1:2] & M32))
    return ((x >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def gumbel_argmax(logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """One categorical sample per row of ``logits`` (rows, V): the argmax
    of ``logits`` (in float32) plus the Gumbel noise of draw ``key[1]``.
    The caller advances the key."""
    rows, cols = logits.shape
    g = -torch.log(-torch.log(uniform(key, rows, cols)))
    return torch.argmax(logits.float() + g, dim=-1)

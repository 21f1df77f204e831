"""Device dispatch for the kernels, and their launch counts.

The models call these, never a kernel or a plain version directly. The
tensor's device decides: a CPU tensor takes the plain PyTorch version in
``kernels.ref``; a CUDA tensor launches the hand-written kernel, whose
wrapper raises on anything the kernel does not take. There is no other
switch and no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

COUNTERS = {"flash_attention": _fa.launches,
            "decode_attention": _da.launches,
            "paged_decode_attention": _pa.launches,
            "decode_attention_int8": _da.int8_launches,
            "paged_decode_attention_int8": _pa.int8_launches,
            "ssd_scan": _ssd.launches,
            "mla_decode_ctx": _mla.launches,
            "rmsnorm": _rn.launches}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _scales(k_scale, v_scale) -> tuple:
    """Both scales (an int8 cache) or neither (a cache in q's type)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both K and V scales or neither")
    return () if k_scale is None else (k_scale, v_scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Prefill attention; see ``kernels.ref.flash_attention``."""
    if _on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def decode_attention(q, k, v, valid, *, softcap: float = 0.0,
                     k_scale=None, v_scale=None):
    """Single-token decode attention; see ``kernels.ref.decode_attention``.
    Scales mean an int8 cache, which takes the int8 kernel."""
    scales = _scales(k_scale, v_scale)
    if _on_cpu(q, k, v, valid, *scales):
        return ref.decode_attention(q, k, v, valid, softcap=softcap,
                                    k_scale=k_scale, v_scale=v_scale)
    if scales:
        return _da.decode_attention_int8(q, k, v, valid, *scales,
                                         softcap=softcap)
    return _da.decode_attention(q, k, v, valid, softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, table, lengths, *,
                           softcap: float = 0.0, k_scale_pages=None,
                           v_scale_pages=None):
    """Single-token decode over the paged cache; see
    ``kernels.ref.paged_decode_attention``. Scale pages mean int8 pages,
    which take the int8 kernel."""
    scales = _scales(k_scale_pages, v_scale_pages)
    if _on_cpu(q, k_pages, v_pages, table, lengths, *scales):
        return ref.paged_decode_attention(
            q, k_pages, v_pages, table, lengths, softcap=softcap,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    if scales:
        return _pa.paged_decode_attention_int8(
            q, k_pages, v_pages, *scales, table, lengths, softcap=softcap)
    return _pa.paged_decode_attention(q, k_pages, v_pages, table, lengths,
                                      softcap=softcap)


def ssd_scan(x, dt, A, B_, C_, D, *, chunk: int = 64):
    """Mamba2 SSD chunked scan; see ``kernels.ref.ssd_scan``."""
    if _on_cpu(x, dt, A, B_, C_, D):
        return ref.ssd_scan(x, dt, A, B_, C_, D, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, B_, C_, D, chunk=chunk)


def mla_decode_ctx(q_lat, q_rope, ckv, k_rope, valid, *, scale: float):
    """Absorbed-MLA decode in the latent space; see
    ``kernels.ref.mla_decode_ctx``."""
    if _on_cpu(q_lat, q_rope, ckv, k_rope, valid):
        return ref.mla_decode_ctx(q_lat, q_rope, ckv, k_rope, valid,
                                  scale=scale)
    return _mla.mla_decode_ctx(q_lat, q_rope, ckv, k_rope, valid,
                               scale=scale)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis; see ``kernels.ref.rmsnorm``."""
    if _on_cpu(x, scale):
        return ref.rmsnorm(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: c.value for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()

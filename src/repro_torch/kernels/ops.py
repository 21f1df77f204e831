"""Device dispatch for the kernels, and their launch counts.

The models call these, never a kernel or a plain version directly. The
tensor's device decides: a CPU tensor takes the plain PyTorch version in
``kernels.ref``; a CUDA tensor launches the hand-written kernel, whose
wrapper raises on anything the kernel does not take. There is no other
switch and no fallback.

Where autograd records (grad enabled and an input that requires grad),
``flash_attention``, ``rmsnorm``, ``rmsnorm_pair`` and ``ssd_scan`` run
through a ``torch.autograd.Function`` whose forward keeps what the
backward reads and whose backward is the gradient kernel on the card
(``flash_attention_bwd`` and ``rmsnorm_bwd``: float32 and bfloat16;
``ssd_scan_bwd``: float32) and its plain version on the CPU, so the CPU
trains through the same wiring the card does. Without grad the serving calls are unchanged, bit for
bit. On the card a bfloat16 ``ssd_scan`` refuses to run where autograd
records rather than return an output with no gradient kernel behind it.
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
            "rmsnorm": _rn.launches,
            "flash_attention_bwd": _fa.bwd_launches,
            "rmsnorm_bwd": _rn.bwd_launches,
            "ssd_scan_bwd": _ssd.bwd_launches}


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


def _records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps q, k, v, out
    and each row's log-sum-exp; the backward recomputes the probabilities
    from them (``repro.kernels.flash_ref``'s custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        if _on_cpu(q, k, v):
            out, lse = ref.flash_attention_lse(q, k, v, causal=causal,
                                               window=window, softcap=softcap)
        else:
            out, lse = _fa.flash_attention(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (ref.flash_attention_bwd if q.device.type == "cpu"
               else _fa.flash_attention_bwd)
        return (*bwd(q, k, v, out, lse, dout.contiguous(), **ctx.masks),
                None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Prefill attention; see ``kernels.ref.flash_attention``."""
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
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


def decode_cross_attention(q, k, v, valid, *, softcap: float = 0.0):
    """One query token against a fixed, wholly valid memory (whisper's
    cross attention at decode), routed through ``decode_attention`` as
    JAX routes it. q: (B, H, hd); k/v: (B, S_mem, Hkv, hd); ``valid``
    the all-true (B, S_mem) bool mask the caller keeps (one tensor for
    every layer of a step)."""
    return decode_attention(q, k, v, valid, softcap=softcap)


class _SsdScan(torch.autograd.Function):
    """The SSD scan with its gradient: the forward keeps its six inputs,
    the backward recomputes the chunk states from them. The final state's
    gradient reaches the backward as None where nothing reads the state
    (training drops it), and stays None down to the kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C_, D)
        ctx.chunk = chunk
        if _on_cpu(x, dt, A, B_, C_, D):
            return ref.ssd_scan(x, dt, A, B_, C_, D, chunk=chunk)
        return _ssd.ssd_scan(x, dt, A, B_, C_, D, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_, C_, D = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        bwd = ref.ssd_scan_bwd if x.device.type == "cpu" else _ssd.ssd_scan_bwd
        return (*bwd(x, dt, A, B_, C_, D, dy, dstate, chunk=ctx.chunk),
                None)


def ssd_scan(x, dt, A, B_, C_, D, *, chunk: int = 64):
    """Mamba2 SSD chunked scan; see ``kernels.ref.ssd_scan``."""
    if _records(x, dt, A, B_, C_, D):
        if not _on_cpu(x, dt, A, B_, C_, D) and x.dtype != torch.float32:
            raise NotImplementedError(
                f"ssd_scan: no backward kernel on the card for {x.dtype} "
                "(ssd_scan_bwd is float32 only; bfloat16 trains on the "
                "CPU)")
        return _SsdScan.apply(x, dt, A, B_, C_, D, chunk)
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


# A Function's forward runs with grad off, so ``rmsnorm`` and
# ``rmsnorm_pair`` called there take their serving dispatch.
class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        bwd = ref.rmsnorm_bwd if x.device.type == "cpu" else _rn.rmsnorm_bwd
        return (*bwd(x, scale, g, ctx.eps), None)


class _RmsNormPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, x_scale, y, y_scale, eps):
        ctx.save_for_backward(x, x_scale, y, y_scale)
        ctx.eps = eps
        return rmsnorm_pair(x, x_scale, y, y_scale, eps)

    @staticmethod
    def backward(ctx, gx, gy):
        x, x_scale, y, y_scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx = ref.rmsnorm_bwd(x, x_scale, gx, ctx.eps)
            dy = ref.rmsnorm_bwd(y, y_scale, gy, ctx.eps)
        else:
            dx, dy = _rn.rmsnorm_pair_bwd(x, x_scale, gx, y, y_scale, gy,
                                          ctx.eps)
        return (*dx, *dy, None)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis; see ``kernels.ref.rmsnorm``."""
    if _records(x, scale):
        return _RmsNorm.apply(x, scale, eps)
    if _on_cpu(x, scale):
        return ref.rmsnorm(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


def rmsnorm_pair(x, x_scale, y, y_scale, eps: float = 1e-6):
    """``(rmsnorm(x, x_scale, eps), rmsnorm(y, y_scale, eps))``: on the card
    one launch over both (one width and dtype), each row with the bits a
    single ``rmsnorm`` gives it; on the CPU the plain version twice."""
    if _records(x, x_scale, y, y_scale):
        return _RmsNormPair.apply(x, x_scale, y, y_scale, eps)
    if _on_cpu(x, x_scale, y, y_scale):
        return ref.rmsnorm(x, x_scale, eps), ref.rmsnorm(y, y_scale, eps)
    return _rn.rmsnorm_pair(x, x_scale, y, y_scale, eps)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name: the kernels that ran, so a
    captured CUDA graph's count once for each replay, not at its capture
    (``build.capture_tally``, ``build.add_launches``)."""
    return {name: c.value for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()

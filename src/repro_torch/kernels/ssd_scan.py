"""The Mamba2 SSD scan on the card: the wrapper of ``csrc/ssd_scan.cu``,
which replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``,
and of its float32 backward ``csrc/ssd_scan_bwd.cu`` (JAX differentiates
its jnp oracle ``ref.ssd_scan_seq`` instead).

``ssd_scan`` and ``ssd_scan_bwd`` take CUDA tensors only and launch the
kernel or raise; ``kernels.ops`` sends CPU tensors to the plain versions
(``kernels.ref.ssd_scan``, ``kernels.ref.ssd_scan_bwd``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256      # ds the kernel's shared memory holds
BWD_MAX_STATE = 128  # ds the backward's shared memory holds
MAX_GRID = 65535     # heads and batch rows are grid dimensions

launches = LaunchCounter()
bwd_launches = LaunchCounter()


def check_cuda(fn: str, tensors: dict) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on the first
    one's device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor on "
                             f"{dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_args(fn: str, tensors: dict, dtypes: tuple, max_state: int,
                chunk: int) -> None:
    """Raise unless ``tensors`` (x, dt, A, B_, C_, D and, for the
    backward, dy and dstate) are contiguous CUDA tensors on x's device of
    matching shapes, x, dt, B_ and C_ (and dy, dstate) of one dtype of
    ``dtypes``, A and D float32, and ds, nh and B in the kernel's range;
    ``chunk`` clamped to S must divide it."""
    x, dt, A, B_, C_, D = (tensors[k] for k in ("x", "dt", "A", "B_", "C_",
                                                "D"))
    check_cuda(fn, tensors)
    for name in tensors:
        if name in ("A", "D"):
            if tensors[name].dtype != torch.float32:
                raise TypeError(f"{fn}: {name} must be float32, got "
                                f"{tensors[name].dtype}")
        elif tensors[name].dtype != x.dtype or x.dtype not in dtypes:
            raise TypeError(f"{fn}: x, dt, B_ and C_"
                            f"{', dy and dstate' if 'dy' in tensors else ''}"
                            f" must share one dtype of {dtypes}; got x "
                            f"{x.dtype}, {name} {tensors[name].dtype}")
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError(f"{fn}: x and B_ must be 4-d")
    Bb, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    dy, dstate = tensors.get("dy"), tensors.get("dstate")
    if (dt.shape != (Bb, S, nh) or A.shape != (nh,) or D.shape != (nh,)
            or B_.shape[:2] != (Bb, S) or C_.shape != B_.shape
            or ng < 1 or nh % ng
            or (dy is not None and dy.shape != x.shape)
            or (dstate is not None and dstate.shape != (Bb, nh, hd, ds))):
        raise ValueError(
            f"{fn}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B_ {tuple(B_.shape)}, C_ "
            f"{tuple(C_.shape)}, D {tuple(D.shape)}"
            + "".join(f", {k} {tuple(tensors[k].shape)}"
                      for k in ("dy", "dstate") if k in tensors)
            + " do not match (need nh % ng == 0)")
    if not 1 <= ds <= max_state or nh > MAX_GRID or Bb > MAX_GRID:
        raise ValueError(f"{fn}: ds={ds} (1...{max_state}), nh={nh} "
                         f"and B={Bb} (<= {MAX_GRID}) out of the kernel's "
                         "range")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"{fn}: S={S} is not a multiple of chunk={chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, nh, hd); dt: (B, S, nh); B_/C_: (B, S, ng, ds), all
    contiguous CUDA tensors of one dtype (float32 or bfloat16); A, D:
    (nh,) contiguous float32 on the same device. Returns (y (B, S, nh,
    hd), final state (B, nh, hd, ds)) in x's dtype. ``chunk`` is clamped
    to S and must divide it, as the Pallas kernel asserts; the kernel's
    own tiling does not depend on it. One call runs three CUDA kernels
    (chunk states, the pass over them, the outputs; bfloat16 on its
    tensor-core body, float32 as split TF32) over float32 scratch from
    here, and counts as one launch."""
    _check_args("ssd_scan", {"x": x, "dt": dt, "A": A, "B_": B_, "C_": C_,
                             "D": D}, DTYPES, MAX_STATE, chunk)
    Bb, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    ext, bf16 = extension(), x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    state = torch.empty((Bb, nh, hd, ds), dtype=x.dtype, device=x.device)
    # float32 scratch (both bodies): C.B^T per chunk and group; a decay,
    # the running sums and an (hd, ds) state per chunk and head
    work = torch.empty((ext.ssd_scan_work_floats(Bb, S, nh, hd, ng, ds),),
                       dtype=torch.float32, device=x.device)
    err = ext.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
        work.data_ptr(), Bb, S, nh, hd, ng, ds, bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "ssd_scan")
    launches.add()
    return y, state


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_: torch.Tensor, C_: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, dstate: torch.Tensor | None = None, *,
                 chunk: int = 64) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, ddt, dA, dB_, dC_, dD)`` of ``ssd_scan`` given
    ``dy`` (B, S, nh, hd) and the final state's gradient ``dstate`` (B,
    nh, hd, ds), or None for none (no zero tensor is made: the kernel
    reads a null pointer as 0). Every tensor a contiguous float32 CUDA
    tensor on one device, ds at most BWD_MAX_STATE; ``chunk`` clamped to S
    must divide it, as in the forward, whose 64-position cut the kernel
    keeps. One call runs five CUDA kernels (the forward's chunk states
    with each chunk's own part of the state's gradient; the passes over
    them, forward and in reverse; dx, ddt and the chunks' dA, dD a block
    per (chunk, head, batch row); dB and dC over runs of a group's heads;
    the fixed-order sums of the runs' and chunks' partials) over float32
    scratch from here, and counts as one launch."""
    tensors = {"x": x, "dt": dt, "A": A, "B_": B_, "C_": C_, "D": D,
               "dy": dy}
    if dstate is not None:
        tensors["dstate"] = dstate
    _check_args("ssd_scan_bwd", tensors, (torch.float32,), BWD_MAX_STATE,
                chunk)
    Bb, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    ext = extension()
    grads = [torch.empty_like(t) for t in (x, dt, A, B_, C_, D)]
    # the chunk states, the state's gradient a chunk, per-chunk vectors
    # and the partial sums
    work = torch.empty((ext.ssd_scan_bwd_work_floats(Bb, S, nh, hd, ng, ds),),
                       dtype=torch.float32, device=x.device)
    err = ext.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), D.data_ptr(), dy.data_ptr(),
        0 if dstate is None else dstate.data_ptr(),
        *(g.data_ptr() for g in grads), work.data_ptr(), Bb, S, nh, hd, ng,
        ds, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "ssd_scan_bwd")
    bwd_launches.add()
    return tuple(grads)

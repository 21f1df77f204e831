"""The Mamba2 SSD scan on the card: the wrapper of ``csrc/ssd_scan.cu``,
which replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``.

``ssd_scan`` takes CUDA tensors only and launches the kernel or raises;
``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.ssd_scan``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256      # ds the kernel's shared memory holds
MAX_GRID = 65535     # heads and batch rows are grid dimensions

launches = LaunchCounter()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, nh, hd); dt: (B, S, nh); B_/C_: (B, S, ng, ds), all
    contiguous CUDA tensors of one dtype (float32 or bfloat16); A, D:
    (nh,) contiguous float32 on the same device. Returns (y (B, S, nh,
    hd), final state (B, nh, hd, ds)) in x's dtype. ``chunk`` is clamped
    to S and must divide it, as the Pallas kernel asserts; the kernel's
    own tiling does not depend on it. In bfloat16 one call runs three CUDA
    kernels (chunk states, the pass over them, the outputs) and counts as
    one launch; float32 runs one."""
    tensors = {"x": x, "dt": dt, "A": A, "B_": B_, "C_": C_, "D": D}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    for name in ("dt", "B_", "C_"):
        if tensors[name].dtype != x.dtype or x.dtype not in DTYPES:
            raise TypeError(f"ssd_scan: x, dt, B_ and C_ must share one "
                            f"dtype of {DTYPES}; got x {x.dtype}, {name} "
                            f"{tensors[name].dtype}")
    for name in ("A", "D"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{tensors[name].dtype}")
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError("ssd_scan: x and B_ must be 4-d")
    Bb, S, nh, hd = x.shape
    ng, ds = B_.shape[2], B_.shape[3]
    if (dt.shape != (Bb, S, nh) or A.shape != (nh,) or D.shape != (nh,)
            or B_.shape[:2] != (Bb, S) or C_.shape != B_.shape
            or ng < 1 or nh % ng):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B_ {tuple(B_.shape)}, C_ "
            f"{tuple(C_.shape)}, D {tuple(D.shape)} do not match (need "
            "nh % ng == 0)")
    if not 1 <= ds <= MAX_STATE or nh > MAX_GRID or Bb > MAX_GRID:
        raise ValueError(f"ssd_scan: ds={ds} (1...{MAX_STATE}), nh={nh} "
                         f"and B={Bb} (<= {MAX_GRID}) out of the kernel's "
                         "range")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of "
                         f"chunk={chunk}")
    ext, bf16 = extension(), x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    state = torch.empty((Bb, nh, hd, ds), dtype=x.dtype, device=x.device)
    # the bfloat16 body's float32 scratch: C.B^T per chunk and group; a
    # decay, the running sums and an (hd, ds) state per chunk and head
    work = torch.empty((ext.ssd_scan_work_floats(Bb, S, nh, hd, ng, ds,
                                                 bf16),),
                       dtype=torch.float32, device=x.device)
    err = ext.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
        work.data_ptr(), Bb, S, nh, hd, ng, ds, bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "ssd_scan")
    launches.add()
    return y, state

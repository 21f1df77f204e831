"""RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``, which replaces
the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.

``rmsnorm`` takes CUDA tensors only and launches the kernel or raises;
``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.rmsnorm``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
MAX_WARP_D = 512        # widths the kernel gives one warp a row
MAX_GRID = 2 ** 31 - 1  # rows are (D > 512) the grid's x dimension

launches = LaunchCounter()


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x as a (rows, D) view with unit column stride, and its row stride.
    Rows may be strided (a slice of a wider row, as the MLA latent
    ``dkv[..., :r]``) but must be evenly spaced; anything else raises
    rather than being copied."""
    D = x.shape[-1]
    try:
        x2 = x.view(-1, D)
    except RuntimeError as e:
        raise ValueError(
            f"rmsnorm: x of shape {tuple(x.shape)} and strides "
            f"{x.stride()} is not evenly spaced rows") from e
    if D > 1 and x2.stride(1) != 1:
        raise ValueError(f"rmsnorm: x's last axis must be contiguous, "
                         f"stride {x2.stride(1)}")
    row_stride = x2.stride(0) if x2.shape[0] > 1 else D
    if row_stride < D:
        raise ValueError(f"rmsnorm: rows overlap (row stride {row_stride} "
                         f"< D={D})")
    return x2, row_stride


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) CUDA tensor, float32 or bfloat16, rows evenly spaced
    with a contiguous last axis; scale: (D,) contiguous, float32 or
    bfloat16, on x's device. Returns a contiguous tensor of x's shape and
    dtype: x * rsqrt(mean(x²) + eps) * scale in float32."""
    for name, t in (("x", x), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"rmsnorm: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"rmsnorm: {name} dtype {t.dtype}; need one of "
                            f"{DTYPES}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"rmsnorm: x of shape {tuple(x.shape)} has no "
                         "row to normalise")
    D = x.shape[-1]
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be contiguous ({D},), got "
                         f"{tuple(scale.shape)}")
    x2, row_stride = _rows(x)
    rows = x2.shape[0]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    blocks = rows if D > MAX_WARP_D else -(-rows // 8)
    if blocks > MAX_GRID:
        raise ValueError(f"rmsnorm: {rows} rows of D={D} exceed the grid")
    err = extension().rmsnorm(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
        row_stride, float(eps), x.dtype == torch.bfloat16,
        scale.dtype == torch.bfloat16,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "rmsnorm")
    launches.add()
    return out

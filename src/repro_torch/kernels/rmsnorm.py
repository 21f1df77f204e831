"""RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``, which replaces
the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``, and of
``csrc/rmsnorm_bwd.cu``, its gradient (JAX differentiates the plain
``repro.models.layers.rmsnorm_fwd``; no Pallas kernel), for every dtype
pair the forward takes.

``rmsnorm`` and ``rmsnorm_pair`` take CUDA tensors only and launch the
kernel or raise; ``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.rmsnorm``) instead. ``rmsnorm_pair`` normalises two tensors
of one width and type (a layer's q and k norms) in one launch, each row
with exactly the bits ``rmsnorm`` gives it. ``rmsnorm_bwd`` and
``rmsnorm_pair_bwd`` are their gradients, one call each (the pair's
over both tensors, as its forward): a rows pass that writes dx and one
partial row of dscale a block, then a pass that adds the partials in a
fixed order. ``bwd_partition`` splits a tensor's rows into blocks from
its row count and width alone.

``layout`` picks the kernel's lane layout from the width and the type
alone, which fixes a row's bits; ``_launch`` picks the 16-byte path or the
one-element path of the same kernel from the addresses, which does not.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
VEC_BYTES = 16      # a lane's loads and stores on the vector path
MAX_SLOTS = 8       # 16-byte vectors a lane holds in registers
# (warps a row, the most vectors a lane at that many warps), in the order
# ``layout`` tries them: few vectors a lane keep a warp's chain short
WARP_SLOTS = ((1, 1), (2, 1), (4, 2), (8, MAX_SLOTS))

launches = LaunchCounter()
bwd_launches = LaunchCounter()
BWD_BLOCK_WARPS = 8  # warps a block of the backward's rows pass
BWD_MAX_BLOCKS = 256  # the most blocks of one tensor in the backward


@functools.lru_cache(maxsize=None)
def layout(D: int, itemsize: int) -> tuple[int, int]:
    """(W, N) for rows of ``D`` elements of ``itemsize`` bytes: the first
    W of ``WARP_SLOTS`` whose lanes hold a row in at most its vectors a
    lane, and N, the 16-byte vectors a lane needs rounded up to a power
    of two. A row wider than ``MAX_SLOTS`` vectors a lane of 8 warps gets
    N > ``MAX_SLOTS``: the kernel then loops one element at a time."""
    vectors = -(-D // (VEC_BYTES // itemsize))
    for W, cap in WARP_SLOTS:
        n = -(-vectors // (32 * W))
        if n <= cap:
            return W, 1 << (n - 1).bit_length()
    return W, n


def check_cuda(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    for what, t in ((name, x), (f"{name}'s scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"rmsnorm: {what} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")


def _rows(name: str, x: torch.Tensor,
          scale: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x as a (rows, D) view with unit column stride, and its row stride,
    after checking both tensors. Rows may be strided (a slice of a wider
    row, as the MLA latent ``dkv[..., :r]``) but must be evenly spaced;
    anything else raises rather than being copied."""
    check_cuda(name, x, scale)
    for what, t in ((name, x), (f"{name}'s scale", scale)):
        if t.dtype not in DTYPES:
            raise TypeError(f"rmsnorm: {what} dtype {t.dtype}; need one of "
                            f"{DTYPES}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"rmsnorm: {name} of shape {tuple(x.shape)} has no "
                         "row to normalise")
    D = x.shape[-1]
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: {name}'s scale must be contiguous "
                         f"({D},), got {tuple(scale.shape)}")
    try:
        x2 = x.view(-1, D)
    except RuntimeError as e:
        raise ValueError(
            f"rmsnorm: {name} of shape {tuple(x.shape)} and strides "
            f"{x.stride()} is not evenly spaced rows") from e
    if D > 1 and x2.stride(1) != 1:
        raise ValueError(f"rmsnorm: {name}'s last axis must be contiguous, "
                         f"stride {x2.stride(1)}")
    row_stride = x2.stride(0) if x2.shape[0] > 1 else D
    if row_stride < D:
        raise ValueError(f"rmsnorm: {name}'s rows overlap (row stride "
                         f"{row_stride} < D={D})")
    return x2, row_stride


def _launch(segments, eps: float) -> None:
    """One launch over one or two (x2, row_stride, scale, out) segments of
    one D, type and scale type; out is contiguous, of x2's rows. The rows
    take 16-byte loads where they fit in registers, every row's base and
    the scale lie on 16 bytes and vectors tile a row; else the same layout
    one element at a time."""
    x2, _, scale, _ = segments[0]
    D, isz = x2.shape[1], x2.element_size()
    W, N = layout(D, isz)
    args, addresses = [], D * isz
    for x, row_stride, s, out in segments:
        px, ps = x.data_ptr(), s.data_ptr()
        addresses |= px | ps | row_stride * isz
        args += (px, ps, out.data_ptr(), x.shape[0], row_stride)
    args += (0,) * (10 - len(args))          # no second tensor: rows1 = 0
    vec = N <= MAX_SLOTS and addresses % VEC_BYTES == 0
    err = extension().rmsnorm(
        *args, D, float(eps), x2.dtype == torch.bfloat16,
        scale.dtype == torch.bfloat16, W, N, vec,
        torch.cuda.current_stream(x2.device).cuda_stream)
    check_launch(err, "rmsnorm")
    launches.add()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) CUDA tensor, float32 or bfloat16, rows evenly spaced
    with a contiguous last axis; scale: (D,) contiguous, float32 or
    bfloat16, on x's device. Returns a contiguous tensor of x's shape and
    dtype: x * rsqrt(mean(x²) + eps) * scale in float32."""
    x2, row_stride = _rows("x", x, scale)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        _launch([(x2, row_stride, scale, out)], eps)
    return out


def rmsnorm_pair(x: torch.Tensor, x_scale: torch.Tensor, y: torch.Tensor,
                 y_scale: torch.Tensor,
                 eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rmsnorm(x, x_scale, eps), rmsnorm(y, y_scale, eps))`` in one
    launch, bit for bit: x and y as ``rmsnorm`` takes them, of one width
    and dtype, their scales of one dtype, on one device."""
    x2, x_stride = _rows("x", x, x_scale)
    y2, y_stride = _rows("y", y, y_scale)
    if y.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device} and y on {y.device}")
    if (y2.shape[1], y.dtype, y_scale.dtype) != (x2.shape[1], x.dtype,
                                                   x_scale.dtype):
        raise ValueError(
            f"rmsnorm: a pair needs one width, dtype and scale dtype; got "
            f"D={x2.shape[1]} {x.dtype} scale {x_scale.dtype} and "
            f"D={y2.shape[1]} {y.dtype} scale {y_scale.dtype}")
    outs = (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(y.shape, dtype=y.dtype, device=y.device))
    segments = [segment for segment in ((x2, x_stride, x_scale, outs[0]),
                                        (y2, y_stride, y_scale, outs[1]))
                if segment[0].shape[0]]
    if segments:
        _launch(segments, eps)
    return outs


def bwd_groups(D: int, itemsize: int = 4) -> tuple[int, int, int, int]:
    """(W, N, R, U) of the backward's rows pass at width ``D`` for rows of
    ``itemsize``-byte elements: the forward's lane layout (W warps a row,
    N vectors a lane), R = ``BWD_BLOCK_WARPS`` / W groups a block and U
    rows a group holds in flight (4 / N at N <= 2, else 1). Rows past
    ``MAX_SLOTS`` vectors a lane take the looping body: one 8-warp group,
    one row at a time."""
    W, N = layout(D, itemsize)
    return W, N, BWD_BLOCK_WARPS // W, 4 // N if N <= 2 else 1


@functools.lru_cache(maxsize=None)
def bwd_partition(rows: int, D: int) -> tuple[int, int]:
    """(per, blocks): the backward's blocks of one tensor of ``rows`` rows
    of width ``D``. Block b owns rows [b·per, (b + 1)·per), walked R·U rows
    at a time (``bwd_groups``); per is the fewest multiple of the float32
    layout's R·U that needs at most ``BWD_MAX_BLOCKS`` blocks (a bfloat16
    block walks its own R·U, its last step maybe partial). A function of
    (rows, D) alone, so a tensor's dscale has the same bits alone and in
    a pair."""
    _, _, R, U = bwd_groups(D)
    step = R * U
    if rows == 0:
        return step, 0
    per = step * -(-(-(-rows // step)) // BWD_MAX_BLOCKS)
    return per, -(-rows // per)


def _bwd_segment(name: str, x: torch.Tensor, scale: torch.Tensor,
                 g: torch.Tensor):
    """(x2, row_stride, scale, g2, dx) of one tensor of the backward: x
    and its scale as ``rmsnorm`` takes them (float32 or bfloat16 each),
    and its output's gradient ``g`` of x's shape and dtype (made
    contiguous)."""
    x2, row_stride = _rows(name, x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: {name}'s gradient "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}, "
                         f"expected {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return x2, row_stride, scale, g.contiguous().view(-1, x2.shape[1]), dx


def _bwd_launch(segments, eps: float) -> torch.Tensor:
    """One call of the backward (two launches: rows, then dscale) over one
    or two segments of one width, dtype and scale dtype: writes each
    segment's dx and returns the (n_segments, D) dscale rows, in the
    scale's dtype, that the kernel writes whole (0 for a segment without
    rows). The rows take 16-byte loads where every base and row stride
    lies on 16 bytes and a vector's V elements divide D."""
    x0, scale0 = segments[0][0], segments[0][2]
    D, isz, dev = x0.shape[1], x0.element_size(), x0.device
    W, N, _, _ = bwd_groups(D, isz)
    args, blocks, addresses = [], 0, D * isz
    for x2, row_stride, scale, g2, dx in segments:
        rows = x2.shape[0]
        per, n = bwd_partition(rows, D)
        ptrs = (x2.data_ptr(), scale.data_ptr(), g2.data_ptr(),
                dx.data_ptr())
        if rows:
            for q in ptrs:
                addresses |= q
            addresses |= row_stride * isz
        args += (*ptrs, rows, row_stride, per, n)
        blocks += n
    args += (0,) * (16 - len(args))       # no second tensor: rows1 = 0
    partial = torch.empty((blocks, D), dtype=torch.float32, device=dev)
    dscale = torch.empty((len(segments), D), dtype=scale0.dtype, device=dev)
    vec = N <= MAX_SLOTS and addresses % VEC_BYTES == 0
    err = extension().rmsnorm_bwd(
        *args, D, float(eps), W, N, vec, partial.data_ptr(),
        dscale.data_ptr(), len(segments), x0.dtype == torch.bfloat16,
        scale0.dtype == torch.bfloat16,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "rmsnorm_bwd")
    bwd_launches.add()
    return dscale


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of ``rmsnorm(x, scale, eps)`` given the output's
    gradient ``g`` (x's dtype): CUDA tensors, x and scale as ``rmsnorm``
    takes them (a strided slice too; float32 or bfloat16 each). dx is
    contiguous, of x's shape and dtype; dscale, in scale's dtype, sums
    every row in float32 in a fixed order (per-block partial rows, then
    the blocks in order; no atomics, the same bits every run), each
    rounded once."""
    seg = _bwd_segment("x", x, scale, g)
    return seg[4], _bwd_launch([seg], eps)[0]


def rmsnorm_pair_bwd(x: torch.Tensor, x_scale: torch.Tensor,
                     gx: torch.Tensor, y: torch.Tensor,
                     y_scale: torch.Tensor, gy: torch.Tensor,
                     eps: float = 1e-6) -> tuple:
    """The gradients of ``rmsnorm_pair`` in one call: ``((dx, dx_scale),
    (dy, dy_scale))`` given the gradients ``gx`` and ``gy`` of its two
    outputs; x and y of one width, dtype and scale dtype, as the pair's
    forward takes them. Each tensor's dx and dscale have the bits of its
    own ``rmsnorm_bwd``."""
    sx = _bwd_segment("x", x, x_scale, gx)
    sy = _bwd_segment("y", y, y_scale, gy)
    if (y.device != x.device
            or (sy[0].shape[1], y.dtype, y_scale.dtype)
            != (sx[0].shape[1], x.dtype, x_scale.dtype)):
        raise ValueError(
            f"rmsnorm_bwd: a pair needs one width, device, dtype and scale "
            f"dtype; got D={sx[0].shape[1]} {x.dtype} scale "
            f"{x_scale.dtype} on {x.device} and D={sy[0].shape[1]} "
            f"{y.dtype} scale {y_scale.dtype} on {y.device}")
    dscale = _bwd_launch([sx, sy], eps)
    return (sx[4], dscale[0]), (sy[4], dscale[1])

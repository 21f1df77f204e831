"""Absorbed-MLA decode on the card: the wrapper of ``csrc/mla_decode.cu``,
which replaces the Pallas TPU kernel
``repro/kernels/mla_decode.py::mla_decode_ctx``.

``mla_decode_ctx`` takes CUDA tensors only and launches the kernel or
raises; ``kernels.ops`` sends CPU tensors to the plain version
(``kernels.ref.mla_decode_ctx``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, extension

DTYPES = (torch.float32, torch.bfloat16)
LATENT_WIDTHS = (32, 64, 128, 256, 512)   # r the kernel is instantiated for
MAX_ROPE = 256                            # dr, a multiple of 4
MAX_HEADS = 16                            # one warp per head in a block
SPLIT = 64                                # positions a block walks

launches = LaunchCounter()


def mla_decode_ctx(q_lat: torch.Tensor, q_rope: torch.Tensor,
                   ckv: torch.Tensor, k_rope: torch.Tensor,
                   valid: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q_lat: (B, H, r); q_rope: (B, H, dr); ckv: (B, S, r); k_rope:
    (B, S, dr); valid: (B, S) bool. All contiguous CUDA tensors on one
    device, q/ckv/k_rope of one dtype (float32 or bfloat16), ckv 16-byte
    aligned. Any S.
    Returns the latent context (B, H, r) in that dtype; a row with no
    valid position gives 0."""
    name = "mla_decode_ctx"
    tensors = {"q_lat": q_lat, "q_rope": q_rope, "ckv": ckv,
               "k_rope": k_rope, "valid": valid}
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.device != q_lat.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on "
                             f"{q_lat.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg in ("q_rope", "ckv", "k_rope"):
        if tensors[arg].dtype != q_lat.dtype or q_lat.dtype not in DTYPES:
            raise TypeError(f"{name}: q_lat, q_rope, ckv and k_rope must "
                            f"share one dtype of {DTYPES}; got q_lat "
                            f"{q_lat.dtype}, {arg} {tensors[arg].dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be bool, got {valid.dtype}")
    if q_lat.dim() != 3 or ckv.dim() != 3:
        raise ValueError(f"{name}: need q_lat (B,H,r), q_rope (B,H,dr), "
                         "ckv (B,S,r), k_rope (B,S,dr), valid (B,S)")
    B, H, r = q_lat.shape
    S, dr = ckv.shape[1], q_rope.shape[-1]
    if (q_rope.shape != (B, H, dr) or ckv.shape != (B, S, r)
            or k_rope.shape != (B, S, dr) or valid.shape != (B, S)):
        raise ValueError(
            f"{name}: shapes q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, k_rope "
            f"{tuple(k_rope.shape)}, valid {tuple(valid.shape)} do not match")
    if (r not in LATENT_WIDTHS or dr % 4 or dr > MAX_ROPE
            or not 1 <= H <= MAX_HEADS):
        raise ValueError(f"{name}: no kernel for r={r} (one of "
                         f"{LATENT_WIDTHS}), dr={dr} (a multiple of 4 up "
                         f"to {MAX_ROPE}), H={H} (1...{MAX_HEADS})")
    if ckv.data_ptr() % 16:
        raise ValueError(f"{name}: ckv must be 16-byte aligned (the kernel "
                         "reads it in 16-byte loads)")
    out = torch.empty((B, H, r), dtype=q_lat.dtype, device=q_lat.device)
    if B == 0:
        return out
    # each split's per-head context, max and normaliser, merged by a
    # second pass
    work = torch.empty((B * -(-S // SPLIT) * H * (r + 2),),
                       dtype=torch.float32, device=q_lat.device)
    err = extension().mla_decode_ctx(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        k_rope.data_ptr(), valid.data_ptr(), out.data_ptr(), work.data_ptr(),
        B, S, H, r, dr, float(scale), SPLIT, q_lat.dtype == torch.bfloat16,
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    check_launch(err, name)
    launches.add()
    return out

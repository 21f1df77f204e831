"""The H100 cost model of a decode step and of the fused decode chunk.

The port's counterpart of ``repro.core.roofline``: the same arithmetic
(``model_flops``, ``prefill_flops``, ``decode_step_seconds``,
``decode_chunk_tokens``) and defaults, over the card's own constants.

    a decode step's device time = max(2·N_active·B / PEAK_FLOPS,
                                      (weight bytes + KV bytes) / HBM_BW)

and the chunk is the smallest length whose one fixed cost a chunk
(``DISPATCH_OVERHEAD_S``) stays under ``overhead_frac`` of the chunk's
device time, clamped to ``[1, max_chunk]``.

``DISPATCH_OVERHEAD_S`` is the port engine's per-chunk fixed cost: the
intercept ``a`` of a chunk's wall ``a + b·n_tokens`` through
``ServingEngine.step`` (the slot state's host-to-device copy, the first
replay's enqueue into an idle pipeline, the device-to-host read that
drains it and the host bookkeeping around them), which ``chip_smoke.py``
phase 19a measures and holds this constant to within 2×.

The dry-run report (``build_report``, ``RooflineReport``, ``HEADER``)
reads HLO from TPU compilations and stays out of the port, as do the
inter-chip link rate and the chip power figures of the TPU model.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig, InputShape

# NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi name, power.limit), H100 SXM
# data sheet: dense bf16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700.00 W: the port engine's fixed cost of one
# decode chunk, seconds (chip_smoke.py phase 19a: the intercept of a
# chunk's wall against its steps, qwen3-0.6b bf16, 4 rows, max_len 2048;
# read between 1.1 ms in a fresh process and 2.2 ms after the script's
# earlier phases, so the constant sits between them, within 2x of both)
DISPATCH_OVERHEAD_S = 1.6e-3


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """6·N·D for training, 2·N·D for inference (fwd only), N = active params.

    D = tokens processed this step: B×S for train/prefill, B for decode.
    Encoder-decoder archs process the encoder's frame tokens with the
    encoder params separately (and not at all during decode).
    """
    n = cfg.active_param_count()
    n_enc = 0
    if cfg.n_encoder_layers:
        n_enc = cfg._encoder_layer_params() * cfg.n_encoder_layers
        n -= n_enc
    factor = 6.0 if shape.kind == "train" else 2.0
    if shape.kind == "decode":
        return factor * n * shape.global_batch       # encoder not rerun
    d_dec = shape.global_batch * shape.seq_len
    d_enc = shape.global_batch * cfg.encoder_seq
    return factor * (n * d_dec + n_enc * d_enc)


def prefill_flops(cfg: ArchConfig, n_tokens: int,
                  hit_tokens: int = 0) -> float:
    """Forward FLOPs of one prefill: ``2·N_active`` per token actually
    executed. ``hit_tokens`` is the prefix-cache hit length: those
    positions are served from cached K/V and never enter the prefill, so
    they cost nothing here."""
    return 2.0 * cfg.active_param_count() * max(n_tokens - hit_tokens, 0)


def decode_step_seconds(cfg: ArchConfig, batch: int = 1, *,
                        context_tokens: int = 0) -> float:
    """Device seconds of ONE decode iteration (the roofline max of its
    compute and memory terms): a batch-``batch`` step streams the
    weights once and computes ``2·N_active·B`` FLOPs;
    ``context_tokens`` adds the per-step KV-cache read. This is the
    per-token quantum both ``decode_chunk_tokens`` (amortisation) and
    the scheduler's SLO chunk cap (admission-latency bound) price."""
    flops = 2.0 * cfg.active_param_count() * batch
    bytes_ = 2.0 * cfg.param_count()          # bf16 weight stream per step
    if context_tokens:
        from repro_torch.core.containers import kv_cache_bytes_per_token
        bytes_ += batch * context_tokens * kv_cache_bytes_per_token(
            cfg, max_len=context_tokens)
    return max(flops / PEAK_FLOPS, bytes_ / HBM_BW)


def decode_chunk_tokens(cfg: ArchConfig, batch: int = 1, *,
                        overhead_s: float = DISPATCH_OVERHEAD_S,
                        overhead_frac: float = 0.1,
                        max_chunk: int = 32,
                        context_tokens: int = 0) -> int:
    """Decode chunk length from arithmetic intensity: the smallest chunk
    that keeps the per-chunk fixed cost under ``overhead_frac`` of the
    chunk's device time, clamped to ``[1, max_chunk]`` (admission latency
    bounds the top: a queued request waits up to one chunk).

    ``context_tokens > 0`` adds the KV-cache stream to the memory term: a
    paged engine runs many in-flight sequences, so each decode step also
    reads up to ``batch × context × bytes/token`` of cache.
    """
    t_tok = decode_step_seconds(cfg, batch, context_tokens=context_tokens)
    amortised = overhead_s * (1.0 - overhead_frac) / overhead_frac
    return max(1, min(max_chunk, math.ceil(amortised / max(t_tok, 1e-12))))


def engine_chunk_tokens(cfg: ArchConfig, engine_config) -> int:
    """The chunk length an engine of ``engine_config`` decodes with: its
    ``chunk_tokens``, or, when that is None, ``decode_chunk_tokens`` at
    the engine's rows (``n_rows``) over its horizon when paged (dense
    rows: the weights alone), as JAX's engine resolves it. The engine,
    its chunk buffers' budget and every container count read it here."""
    if engine_config.chunk_tokens is not None:
        return engine_config.chunk_tokens
    return decode_chunk_tokens(
        cfg, engine_config.n_rows,
        context_tokens=(engine_config.max_len
                        if engine_config.cache == "paged" else 0))

"""Architecture configuration dataclass (a copy of ``repro.configs.base``).

The port keeps its own copy so it imports nothing of the JAX package; the
fields and ``reduce_config`` match the original exactly (the tests compare
them field by field), so a ``-reduced`` name means the same shapes on both
sides.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture description (model-card faithful)."""

    name: str
    arch_type: ArchType
    source: str  # citation bracket from the assignment

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # ---- attention options ----
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    partial_rotary_factor: float = 1.0
    sliding_window: int = 0          # 0 = full attention
    local_global_pattern: int = 0    # k => k local layers per 1 global layer
    attn_logit_softcap: float = 0.0
    # "model" keeps the cache in the activation dtype; "int8" stores k/v
    # quantised (per-token-per-head absmax scales) and dequantises per tile
    # inside the decode kernel — halves the decode memory-roofline term
    # (§Perf, beyond-paper; the paper's workload is inference-bound too)
    kv_cache_dtype: str = "model"

    # ---- MLA (DeepSeek) ----
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ----
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0          # leading dense (non-MoE) layers
    router_aux_loss_coef: float = 0.0
    # capacity factors: train uses GShard-style drops; eval uses a roomier
    # buffer (E/K makes eval provably dropless — used by the reduced
    # test configs so prefill/decode match the full forward exactly)
    moe_train_cf: float = 1.25
    moe_eval_cf: float = 2.0
    # dispatch groups (0/1 = one global dispatch). Set to the data-axis size
    # for shard-local dispatch: the position-in-expert cumsum and the
    # (E, C, d) scatter stay within each data shard, so GSPMD emits an
    # all-to-all at the group boundary instead of all-reducing the whole
    # dispatch buffer per layer (§Perf iteration 1 — 104 GB/layer → ~0).
    moe_dispatch_groups: int = 0

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # ---- hybrid (Zamba2) ----
    shared_attn_every: int = 0       # apply the weight-shared block every k SSM layers

    # ---- encoder-decoder (Whisper) ----
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # fixed frame count from the (stubbed) frontend
    cross_attention: bool = False

    # ---- VLM (InternVL2) ----
    n_vision_tokens: int = 0
    vision_embed_dim: int = 0        # dim of the stubbed patch embeddings

    # ---- misc ----
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: Literal["silu", "gelu"] = "silu"
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    mlp_gated: bool = True
    pos_embed: Literal["rope", "learned"] = "rope"

    # ------------------------------------------------------------------
    @property
    def is_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_windows(self) -> list[int]:
        """Each layer's attention window in the port's layer order (0:
        the full horizon). The gemma family (``local_global_pattern`` =
        k) runs ``n_layers // (k + 1)`` super-blocks of k local layers
        and one global, then the remaining ``n_layers mod (k + 1)``
        layers local, as ``repro.models.model.Model`` lays them out; any
        other family gives every layer ``sliding_window``."""
        gemma = (self.local_global_pattern > 0 and not self.is_moe
                 and self.arch_type not in ("audio", "hybrid", "ssm"))
        if not gemma:
            return [self.sliding_window] * self.n_layers
        per = self.local_global_pattern + 1
        n_super = self.n_layers // per
        return ([self.sliding_window] * (per - 1) + [0]) * n_super + [
            self.sliding_window] * (self.n_layers - n_super * per)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count, as the JAX package computes it (the
        container budgets of ``core/containers.py`` size weights by it)."""
        d = self.d_model
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        if self.is_moe and self.n_dense_layers:
            # leading dense layers use the dense FFN width, not the experts
            n += self._dense_layer_params() * self.n_dense_layers
            n += self._decoder_layer_params() * (self.n_layers
                                                 - self.n_dense_layers)
        else:
            n += self._decoder_layer_params() * self.n_layers
        if self.shared_attn_every:
            n += self._dense_layer_params()           # the shared block
        if self.n_encoder_layers:
            n += self._dense_layer_params() * self.n_encoder_layers
        if self.n_vision_tokens:
            n += self.vision_embed_dim * d + d * d    # projector (2 layer)
        return n + d                                  # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k routed only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        routed_all = self.n_experts * 3 * d * self.moe_d_ff
        routed_active = self.n_experts_per_tok * 3 * d * self.moe_d_ff
        return self.param_count() - (routed_all - routed_active) * (
            self.n_layers - self.n_dense_layers
        )

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
            n = d * self.n_heads * qk_head                       # q proj
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)  # kv down
            n += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_head_dim + self.v_head_dim)          # kv up
            return n + self.n_heads * self.v_head_dim * d         # o proj
        hd = self.head_dim
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)       # q, k and v, o

    def _mlp_params(self, d_ff: int) -> int:
        # gate+up+down when gated (SwiGLU); up+down otherwise
        return (3 if self.mlp_gated else 2) * self.d_model * d_ff

    def _decoder_layer_params(self) -> int:
        d = self.d_model
        if self.arch_type in ("ssm", "hybrid"):
            # Mamba2 block: in_proj (x, z, B, C, dt), conv, out_proj, norms
            di, ds, ng = self.d_inner, self.ssm_state, self.ssm_n_groups
            nh = self.ssm_n_heads
            n = d * (2 * di + 2 * ng * ds + nh)   # in_proj
            n += (di + 2 * ng * ds) * self.ssm_conv_width  # conv1d
            n += di * d                            # out_proj
            return n + 2 * nh + di + d             # A_log, D, norm, rmsnorm
        n = self._attn_params() + 2 * d            # attn + 2 norms
        if self.cross_attention:
            n += self._attn_params() + d           # cross-attn + 3rd norm
        if self.is_moe:
            n += d * self.n_experts                               # router
            n += self.n_experts * self._mlp_params(self.moe_d_ff)
            n += self.n_shared_experts * self._mlp_params(self.moe_d_ff)
        else:
            n += self._mlp_params(self.d_ff)
        return n

    def _dense_layer_params(self) -> int:
        """A dense attention + MLP layer with its two norms (an MoE model's
        leading layers, a shared block, an encoder layer)."""
        return (self._attn_params() + self._mlp_params(self.d_ff)
                + 2 * self.d_model)

    def _encoder_layer_params(self) -> int:
        # encoder layer: self-attn + mlp; decoder cross-attn params are part
        # of decoder layer count via cross_attention flag
        return self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One workload input shape (``core/roofline.model_flops`` prices it)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


def reduce_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-testable reduced variant of the same architecture family."""
    d = min(cfg.d_model, 256)
    heads = max(2, min(cfg.n_heads, 4))
    kv = heads if cfg.n_kv_heads == cfg.n_heads else max(1, heads // 2)
    base = dict(
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
    )
    if cfg.is_moe:
        ne, nk = min(cfg.n_experts, 4), min(cfg.n_experts_per_tok, 2)
        base.update(
            n_experts=ne,
            n_experts_per_tok=nk,
            moe_d_ff=min(cfg.moe_d_ff, 128),
            n_dense_layers=min(cfg.n_dense_layers, 1),
            moe_eval_cf=ne / nk,  # dropless => decode == forward exactly
        )
    if cfg.is_ssm:
        base.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=16,
                    ssm_chunk=32)
    if cfg.shared_attn_every:
        base.update(shared_attn_every=1, d_ff=min(cfg.d_ff, 512))
    if cfg.n_encoder_layers:
        base.update(n_encoder_layers=2, encoder_seq=16)
    if cfg.n_vision_tokens:
        base.update(n_vision_tokens=8, vision_embed_dim=64)
    if cfg.mla:
        base.update(kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32,
                    v_head_dim=32, head_dim=48)
    if cfg.sliding_window:
        base.update(sliding_window=min(cfg.sliding_window, 64))
    if cfg.local_global_pattern:
        # 1 local + 1 global per super-block so 2 layers exercise the
        # scanned super-block path (n_super=1) instead of leaving it empty
        base.update(local_global_pattern=1)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **base)

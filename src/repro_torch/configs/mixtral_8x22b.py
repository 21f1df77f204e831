"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, SWA (per assignment)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,            # kept for reference; MoE layers use moe_d_ff
    vocab_size=32_768,
    sliding_window=4096,   # assignment bracket lists SWA
    n_experts=8,
    n_experts_per_tok=2,
    moe_d_ff=16384,
    router_aux_loss_coef=0.01,
    moe_dispatch_groups=16,  # shard-local dispatch (§Perf iter 1/4)
    rope_theta=1_000_000.0,
)

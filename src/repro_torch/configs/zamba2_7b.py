"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + weight-shared attention block.

81 Mamba2 layers; a single weight-shared (attention + MLP) block is applied
every 6 SSM layers (per-application LoRA adapters from the model card are
omitted, as in the JAX package's config).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    shared_attn_every=6,
)

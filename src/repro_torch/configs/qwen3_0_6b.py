"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family] — dense, GQA kv=8, qk_norm.

Per the model card head_dim is 128 even though 16*128 != d_model (q/k/v
projections are rectangular); we keep that faithful.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B (0.6B sibling)",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk_norm."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

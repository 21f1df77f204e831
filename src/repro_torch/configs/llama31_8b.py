"""Llama-3.1-8B [hf:meta-llama/Llama-3.1-8B]: dense GQA with a 500k rope
theta, nothing else new (one config file of the dense family; JAX lists
it as an extra architecture).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.1-8b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.1-8B (extra, not assigned)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=500_000.0,
)

"""Gemma3-27B [hf:google/gemma-3-1b-pt family] — 5 local : 1 global, 128k ctx."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt (27B sibling)",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_pattern=5,   # 5 local layers per 1 global layer
    act="gelu",
)

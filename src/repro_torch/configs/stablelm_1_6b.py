"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — dense MHA, partial rotary."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    partial_rotary_factor=0.25,
    norm_type="layernorm",
)

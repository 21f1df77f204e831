"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,       # -> 80 SSD heads
    ssm_n_groups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

"""InternVL2-26B [arXiv:2404.16821] — InternViT (stubbed) + InternLM2-20B backbone.

The vision frontend is a stub, as in the JAX package: a request carries
precomputed patch embeddings (n_vision_tokens, vision_embed_dim) as
``extras["vision_embeds"]``, which a 2-layer projector maps into the LM
embedding space.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    n_vision_tokens=256,
    vision_embed_dim=3200,   # InternViT-6B width
    rope_theta=1_000_000.0,
)

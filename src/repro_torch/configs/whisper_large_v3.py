"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder; mel + conv
frontend stubbed, as in the JAX package.

A request carries the 1500 post-conv frame embeddings (encoder_seq,
d_model) float32 as ``extras["audio_frames"]``. The encoder sees those
frames; the decoder sees the prompt tokens and attends over the
encoder's output through cross attention. ``pos_embed="learned"`` names
absolute positions: like JAX, the port adds a fixed sinusoid (no
parameter) to the frames and to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=32,             # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    n_encoder_layers=32,
    encoder_seq=1500,
    cross_attention=True,
    act="gelu",
    tie_embeddings=True,
    norm_type="layernorm",
    mlp_gated=False,
    pos_embed="learned",
)

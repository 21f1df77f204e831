"""DeepSeek-V2-Lite-16B [arXiv:2405.04434] — MLA kv_lora=512, 64 routed
experts top-6 + 2 shared, one leading dense layer."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,           # qk_nope 128 + rope 64
    d_ff=10944,             # first (dense) layer FFN
    vocab_size=102_400,
    mla=True,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    n_dense_layers=1,
    router_aux_loss_coef=0.003,
    moe_dispatch_groups=16,
)

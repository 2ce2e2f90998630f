"""Qwen3-MoE 235B-A22B: 128 experts top-8, QK-norm
[hf:Qwen/Qwen3-235B-A22B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    activation="swiglu",
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    subquadratic=False,
)

REDUCED = CONFIG.replace(
    name="qwen3-moe-235b-a22b-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, moe_d_ff=64, vocab_size=256,
    num_experts=8, num_experts_per_tok=2, moe_group_size=64,
)

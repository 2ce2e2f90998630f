"""Granite-MoE 3B-a800m: 40 experts top-8, fine-grained d_ff=512
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    activation="swiglu",
    num_experts=40,
    num_experts_per_tok=8,
    moe_d_ff=512,
    subquadratic=False,
)

REDUCED = CONFIG.replace(
    name="granite-moe-3b-a800m-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, moe_d_ff=64, vocab_size=256,
    num_experts=8, num_experts_per_tok=2, moe_group_size=64,
)

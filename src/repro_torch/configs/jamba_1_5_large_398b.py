"""Jamba-1.5-Large 398B: Mamba+attention 1:7 interleave with MoE 16e top-2
[arXiv:2403.19887].  SSD layers stand in for Jamba's Mamba-1 blocks."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    rope=False,  # Jamba uses no positional encoding in attention
    activation="swiglu",
    attn_period=8,  # one attention layer per 8 (1:7)
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=128,
    ssm_groups=1,
    ssm_conv=4,
    subquadratic=True,  # hybrid => long_500k runs
)

REDUCED = CONFIG.replace(
    name="jamba-1.5-large-398b-reduced", num_layers=4, attn_period=4,
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    moe_d_ff=128, vocab_size=256, num_experts=4, num_experts_per_tok=2,
    ssm_state=16, ssm_headdim=16, ssd_chunk=16, moe_group_size=64,
)

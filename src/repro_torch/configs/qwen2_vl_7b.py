"""Qwen2-VL 7B backbone: GQA + M-RoPE, dynamic-resolution frontend stubbed
[arXiv:2409.12191]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    activation="swiglu",
    frontend="patch",
    subquadratic=False,
)

REDUCED = CONFIG.replace(
    name="qwen2-vl-7b-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=32, mrope_sections=(4, 6, 6), d_ff=128,
    vocab_size=256,
)

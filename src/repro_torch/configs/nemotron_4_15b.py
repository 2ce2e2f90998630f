"""Nemotron-4 15B: dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    rope_theta=1e4,
    activation="squared_relu",
    norm="layernorm",
    subquadratic=False,
)

REDUCED = CONFIG.replace(
    name="nemotron-4-15b-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
)

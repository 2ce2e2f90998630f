"""Whisper-tiny backbone: encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].  RoPE stands in for Whisper's sinusoidal/learned
positions (backbone-structural equivalence)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers
    enc_layers=4,
    encdec=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    activation="gelu",
    norm="layernorm",
    frontend="audio",
    subquadratic=False,
)

REDUCED = CONFIG.replace(
    name="whisper-tiny-reduced", num_layers=2, enc_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
)

"""H2O-Danube 1.8B: llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    attn_type="swa",
    window=4096,
    rope_theta=1e4,
    activation="swiglu",
    subquadratic=True,  # SWA => sub-quadratic => long_500k runs
)

REDUCED = CONFIG.replace(
    name="h2o-danube-1.8b-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, window=32,
)

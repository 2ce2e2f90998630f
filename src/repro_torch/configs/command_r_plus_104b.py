"""Command R+ 104B: dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-plus]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    rope_theta=75e6,
    activation="swiglu",
    norm="layernorm",  # Cohere uses LayerNorm (no bias folded into scale here)
    subquadratic=False,
)

REDUCED = CONFIG.replace(
    name="command-r-plus-104b-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
)

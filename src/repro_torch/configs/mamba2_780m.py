"""Mamba2-780M: attention-free SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,  # attention-free; placeholders
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_conv=4,
    tie_embeddings=True,
    subquadratic=True,  # attn-free => long_500k runs
)

REDUCED = CONFIG.replace(
    name="mamba2-780m-reduced", num_layers=2, d_model=64, ssm_state=16,
    ssm_headdim=16, vocab_size=256, ssd_chunk=16,
)

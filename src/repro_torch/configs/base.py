"""ModelConfig: one dataclass describes every assigned architecture.

families: dense | moe | ssm | hybrid | vlm | audio

The port of the JAX package's ``repro/configs/base.py``, field for field:
the port's models run every family (``models/model.py``), and every config
and its parameter counts equal the reference's.
"""

from __future__ import annotations

import dataclasses


def ssm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels) of an SSM layer (the JAX
    package's ``repro/models/ssm.py::ssm_dims``)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, nheads, conv_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention
    attn_type: str = "full"  # full | swa
    window: int | None = None
    attn_q_chunk: int = 2048  # query-chunked exact attention; 0 = naive
    kv_quant: bool = False  # int8 KV cache with per-(token,head) scales
    rope: bool = True
    rope_theta: float = 1e4
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False

    # ffn
    activation: str = "swiglu"

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int | None = None
    moe_group_size: int = 512
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssd_chunk: int = 128

    # hybrid interleave (Jamba): one attn layer per `attn_period` layers,
    # MoE FFN on odd in-group indices (16e top-2), dense FFN elsewhere.
    attn_period: int = 0  # 0 = not hybrid

    # encoder-decoder (Whisper)
    encdec: bool = False
    enc_layers: int = 0

    # frontend stubs
    frontend: str | None = None  # "patch" (vlm) | "audio" (whisper)

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    linear_backend: str = "dense"  # dense | mvu_w8a8 | mvu_w4a8 | mvu_w4a4 | mvu_binary
    remat: bool = True
    dtype: str = "bfloat16"
    scan_unroll: bool = False  # unroll layer scans (dry-run cost extrapolation)
    seq_sharded_acts: bool = False  # Megatron-SP: shard residual stream seq over "model"

    # long-context applicability (sub-quadratic path available?)
    subquadratic: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_hybrid(self) -> bool:
        return self.attn_period > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def param_count(self) -> int:
        """Approximate total parameters (for 6ND MODEL_FLOPS accounting)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d

        def ffn_params(ff):
            mats = 3 if self.activation in ("swiglu", "geglu") else 2
            return mats * d * ff

        if self.family == "ssm":
            d_inner, nheads, conv_dim = ssm_dims(self)
            per = (
                d * (2 * d_inner + 2 * self.ssm_groups * self.ssm_state + nheads)
                + self.ssm_conv * conv_dim
                + d_inner * d
                + 3 * nheads
                + d_inner
            )
            layers = self.num_layers * per
        elif self.is_hybrid:
            d_inner, nheads, conv_dim = ssm_dims(self)
            ssm_per = (
                d * (2 * d_inner + 2 * self.ssm_groups * self.ssm_state + nheads)
                + self.ssm_conv * conv_dim + d_inner * d + 3 * nheads + d_inner
            )
            n_attn = self.num_layers // self.attn_period
            n_ssm = self.num_layers - n_attn
            n_moe = self.num_layers // 2
            n_dense = self.num_layers - n_moe
            layers = (
                n_attn * attn
                + n_ssm * ssm_per
                + n_moe * (self.num_experts * ffn_params(self.moe_d_ff) + d * self.num_experts)
                + n_dense * ffn_params(self.d_ff)
            )
        elif self.is_moe:
            layers = self.num_layers * (
                attn + self.num_experts * ffn_params(self.moe_d_ff) + d * self.num_experts
            )
        else:
            enc = self.enc_layers if self.encdec else 0
            layers = (self.num_layers + enc) * (attn + ffn_params(self.d_ff))
            if self.encdec:  # cross-attention per decoder layer
                layers += self.num_layers * attn
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE top-k counting) for 6*N_active*D."""
        if not (self.is_moe or self.is_hybrid):
            return self.param_count
        d = self.d_model

        def ffn_params(ff):
            mats = 3 if self.activation in ("swiglu", "geglu") else 2
            return mats * d * ff

        full = self.param_count
        if self.is_hybrid:
            n_moe = self.num_layers // 2
        else:
            n_moe = self.num_layers
        inactive = n_moe * (self.num_experts - self.num_experts_per_tok) * ffn_params(self.moe_d_ff)
        return int(full - inactive)

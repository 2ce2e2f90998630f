"""The port's LM config registry (``repro_torch.configs``) against the JAX
package's: every architecture's ``CONFIG`` and ``REDUCED`` equal field for
field, with the same parameter counts."""

import dataclasses

import pytest

import repro.configs as jax_configs
import repro.models.ssm as jax_ssm
import repro_torch.configs as port_configs
from repro_torch.configs import base


def test_registry_equals_jax():
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_reduced("gpt-5")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_config_equals_jax(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    want, got = getattr(jax_configs, get)(arch), getattr(port_configs, get)(arch)
    assert isinstance(got, base.ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("is_moe", "is_hybrid", "param_count", "active_param_count"):
        assert getattr(got, prop) == getattr(want, prop), prop
    if got.family in ("ssm", "hybrid"):
        assert base.ssm_dims(got) == jax_ssm.ssm_dims(want)
    # replace() keeps the two in step
    assert dataclasses.asdict(got.replace(d_model=128, dtype="float32")) == dataclasses.asdict(
        want.replace(d_model=128, dtype="float32"))


def test_yi_9b_at_full_width():
    """The configuration chip_smoke serves: 48 x 4096, 32 / 4 heads of 128,
    d_ff 11008, vocab 64000, bfloat16, about 8.8 B parameters."""
    cfg = port_configs.get_config("yi-9b")
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        "dense", 48, 4096, 32, 4, 128, 11008, 64000, "bfloat16")
    assert cfg.param_count == 8_829_009_920

"""Architecture registry of the port: a copy of the JAX package's ten.

Every config of the JAX package's registry, field for field: the dense
attention decoders, the MoE decoders, jamba's hybrid of Mamba, attention
and MoE, xlstm's mLSTM/sLSTM stack, and the audio (sinusoidal positions)
and vision (M-RoPE) backbones that take frontend embeddings.
``get_config(name)`` returns the published config;
``get_config(name, smoke=True)`` the reduced same-family config of the CPU
parity tests; ``card_config(name)`` the published widths at the depth one
80 GB card holds, ``card_train_config(name)`` at the depth and expert count
it trains.
"""

from repro_torch.configs.base import (
    CARD_LAYERS,
    SHAPES,
    Block,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    card_config,
    card_train_config,
    get_config,
    list_configs,
)

# Import order = registry order. Each module registers (full, smoke).
from repro_torch.configs import (  # noqa: F401  isort: skip
    xlstm_1_3b,
    jamba_v0_1_52b,
    qwen2_vl_7b,
    codeqwen1_5_7b,
    minicpm_2b,
    starcoder2_15b,
    nemotron_4_340b,
    moonshot_v1_16b_a3b,
    qwen2_moe_a2_7b,
    musicgen_large,
)

ARCHS = list_configs()

__all__ = [
    "ARCHS",
    "CARD_LAYERS",
    "SHAPES",
    "Block",
    "ModelConfig",
    "ShapeSpec",
    "applicable_shapes",
    "card_config",
    "card_train_config",
    "get_config",
    "list_configs",
]

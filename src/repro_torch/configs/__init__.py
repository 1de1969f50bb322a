"""Architecture registry of the port: the configs its slice serves.

A copy of the JAX package's registry restricted to the stacks the port
runs: the dense attention decoders and jamba's hybrid of Mamba, attention
and MoE. ``get_config(name)`` returns the published config;
``get_config(name, smoke=True)`` the reduced same-family config of the CPU
parity tests; ``card_config(name)`` the published widths at the depth one
80 GB card holds.
"""

from repro_torch.configs.base import (
    CARD_LAYERS,
    SHAPES,
    Block,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    card_config,
    get_config,
    list_configs,
)

# Import order = registry order. Each module registers (full, smoke).
from repro_torch.configs import (  # noqa: F401  isort: skip
    codeqwen1_5_7b,
    jamba_v0_1_52b,
    minicpm_2b,
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
    "get_config",
    "list_configs",
]

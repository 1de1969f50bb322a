"""Architecture registry of the port: the configs its slice serves.

A copy of the JAX package's registry restricted to the dense attention
stacks the port runs. ``get_config(name)`` returns the published config;
``get_config(name, smoke=True)`` the reduced same-family config of the CPU
parity tests.
"""

from repro_torch.configs.base import (
    SHAPES,
    Block,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    get_config,
    list_configs,
)

# Import order = registry order. Each module registers (full, smoke).
from repro_torch.configs import (  # noqa: F401  isort: skip
    codeqwen1_5_7b,
    minicpm_2b,
)

ARCHS = list_configs()

__all__ = [
    "ARCHS",
    "SHAPES",
    "Block",
    "ModelConfig",
    "ShapeSpec",
    "applicable_shapes",
    "get_config",
    "list_configs",
]

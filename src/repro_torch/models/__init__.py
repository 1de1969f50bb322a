"""The dense decoder of the port, mirroring the JAX package's models."""

from repro_torch.models.model import (
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_numpy,
)

__all__ = ["count_params", "decode_step", "forward", "init_cache", "init_params",
           "params_from_numpy"]

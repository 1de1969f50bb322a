"""Serve and prefill steps of the port (the training step comes later).

``make_serve_step`` returns ``step(params, cache, batch) -> (logits, cache)``;
``make_prefill_step`` returns ``step(params, batch) -> logits``, the
prompt-scoring forward that runs attention through the flash kernel. Both
resolve their device once, when they are made.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M

Params = Any

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg: ModelConfig, *, device: Any = None):
    device = resolve_device(device)

    def serve_step(params: Params, cache: Params, batch: dict[str, torch.Tensor]):
        return M.decode_step(cfg, params, cache, batch["tokens"], device=device)

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, device: Any = None):
    """Inference prefill: forward only, returns logits (no optimizer)."""
    device = resolve_device(device)

    def prefill_step(params: Params, batch: dict[str, torch.Tensor]):
        return M.forward(cfg, params, batch["tokens"],
                         positions=batch.get("positions"), device=device)

    return prefill_step

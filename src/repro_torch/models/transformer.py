"""Residual block assembly and the decoder stack.

A block is (pre-norm → mixer → residual, pre-norm → mlp → residual) with the
mixer/mlp kinds taken from the config's repeating pattern. The port runs
attention mixers with dense MLPs; the other kinds are not ported yet.

The stack's parameters are always the per-layer layout of the JAX package's
``scan_layers=False``: ``stack[i][j]`` is period i, position j. The JAX
package's period-stacked layout (``scan_layers=True``) is unstacked when it
is carried over (:func:`repro_torch.models.model.params_from_numpy`); an
eager PyTorch loop over layers needs no scan.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import Block, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

Params = dict[str, Any]


def _check_block(blk: Block) -> None:
    if blk.mixer != "attn" or blk.mlp not in ("dense", "none"):
        raise NotImplementedError(
            f"block ({blk.mixer}, {blk.mlp}) is not ported yet: the port runs "
            "attention mixers with dense MLPs")


def init_block(cfg: ModelConfig, blk: Block, gen: torch.Generator, dtype, device) -> Params:
    _check_block(blk)
    p: Params = {"ln1": init_norm(cfg, dtype, device),
                 "mixer": attn.init_attention(cfg, gen, dtype, device)}
    if blk.mlp != "none":
        p["ln2"] = init_norm(cfg, dtype, device)
        p["mlp"] = init_mlp(cfg, gen, dtype, device)
    return p


def apply_block(cfg: ModelConfig, blk: Block, p: Params, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train/prefill) block."""
    _check_block(blk)
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attn.attention_forward(cfg, p["mixer"], h, positions)
    if blk.mlp != "none":
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x


def apply_block_decode(cfg: ModelConfig, blk: Block, p: Params, x: torch.Tensor,
                       cache: Params, cache_len: Any) -> tuple[torch.Tensor, Params]:
    _check_block(blk)
    h = apply_norm(cfg, p["ln1"], x)
    h, cache = attn.attention_decode(cfg, p["mixer"], h, cache, cache_len)
    x = x + h
    if blk.mlp != "none":
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, cache


def init_stack(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> list[list[Params]]:
    period = len(cfg.pattern)
    return [[init_block(cfg, cfg.pattern[j], gen, dtype, device) for j in range(period)]
            for _ in range(cfg.n_periods)]


def apply_stack(cfg: ModelConfig, stack: list[list[Params]], x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    for per in stack:
        for j, p in enumerate(per):
            x = apply_block(cfg, cfg.pattern[j], p, x, positions)
    return x


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> list[list[Params]]:
    for blk in cfg.pattern:
        _check_block(blk)
    period = len(cfg.pattern)
    return [[attn.init_kv_cache(cfg, batch, max_len, dtype, device) for _ in range(period)]
            for _ in range(cfg.n_periods)]


def apply_stack_decode(cfg: ModelConfig, stack: list[list[Params]],
                       caches: list[list[Params]], x: torch.Tensor,
                       cache_len: Any) -> tuple[torch.Tensor, list[list[Params]]]:
    new_caches = []
    for per_p, per_c in zip(stack, caches):
        row = []
        for j, (p, c) in enumerate(zip(per_p, per_c)):
            x, c = apply_block_decode(cfg, cfg.pattern[j], p, x, c, cache_len)
            row.append(c)
        new_caches.append(row)
    return x, new_caches

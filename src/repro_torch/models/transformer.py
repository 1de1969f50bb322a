"""Residual block assembly and the decoder stack.

A block is (pre-norm → mixer → residual, pre-norm → mlp → residual) with the
mixer/mlp kinds taken from the config's repeating pattern: attention, Mamba,
mLSTM or sLSTM mixers with dense, MoE or no MLPs, as in the JAX package.
The full-sequence stack returns the MoE load-balancing loss summed over its
blocks in fp32, beside the activations, as the JAX package's does; under
``remat="full"`` each period (xlstm's 8 blocks, jamba's 8, one block of the
others) is recomputed in the backward pass (``torch.utils.checkpoint``), the
JAX package's ``jax.checkpoint`` per period, and under ``remat="dots"`` too,
its matmuls' outputs kept from the forward.

The stack's parameters are always the per-layer layout of the JAX package's
``scan_layers=False``: ``stack[i][j]`` is period i, position j. The JAX
package's period-stacked layout (``scan_layers=True``) is unstacked when it
is carried over (:func:`repro_torch.models.model.params_from_numpy`); an
eager PyTorch loop over layers needs no scan.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import Block, ModelConfig
from repro_torch.core.trace import span
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

Params = dict[str, Any]


_INIT = {"attn": attn.init_attention, "mamba": mb.init_mamba, "mlstm": xl.init_mlstm,
         "slstm": xl.init_slstm}


def _check_block(blk: Block) -> None:
    if blk.mixer not in _INIT or blk.mlp not in ("dense", "moe", "none"):
        raise ValueError(f"unknown block ({blk.mixer}, {blk.mlp}): mixers are "
                         f"{sorted(_INIT)}, MLPs dense, moe or none")


def init_block(cfg: ModelConfig, blk: Block, gen: torch.Generator, dtype, device) -> Params:
    _check_block(blk)
    p: Params = {"ln1": init_norm(cfg, dtype, device),
                 "mixer": _INIT[blk.mixer](cfg, gen, dtype, device)}
    if blk.mlp != "none":
        init = init_mlp if blk.mlp == "dense" else moe_mod.init_moe
        p["ln2"] = init_norm(cfg, dtype, device)
        p["mlp"] = init(cfg, gen, dtype, device)
    return p


#: each mixer's and MLP's span (:mod:`repro_torch.core.trace`), by the
#: config's own names: its pre-norm, its body and its residual add
SPANS = {k: f"repro_torch.model.{k}" for k in (*_INIT, "dense", "moe")}


def _apply_mlp(cfg: ModelConfig, blk: Block, p: Params,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(x + mlp(norm(x)), the MoE aux loss or None)."""
    if blk.mlp == "none":
        return x, None
    with span(SPANS[blk.mlp]):
        h = apply_norm(cfg, p["ln2"], x)
        if blk.mlp == "dense":
            return x + apply_mlp(cfg, p["mlp"], h), None
        y, aux = moe_mod.moe_forward(cfg, p["mlp"], h)
        return x + y, aux


def apply_block(cfg: ModelConfig, blk: Block, p: Params, x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence (train/prefill) block: (x, its MoE aux loss or None)."""
    _check_block(blk)
    with span(SPANS[blk.mixer]):
        h = apply_norm(cfg, p["ln1"], x)
        if blk.mixer == "attn":
            h = attn.attention_forward(cfg, p["mixer"], h, positions)
        elif blk.mixer == "mamba":
            h = mb.mamba_forward(cfg, p["mixer"], h)
        elif blk.mixer == "mlstm":
            h = xl.mlstm_forward(cfg, p["mixer"], h)
        else:
            h = xl.slstm_forward(cfg, p["mixer"], h)
        x = x + h
    return _apply_mlp(cfg, blk, p, x)


def apply_block_decode(cfg: ModelConfig, blk: Block, p: Params, x: torch.Tensor,
                       cache: Params, cache_len: Any) -> tuple[torch.Tensor, Params]:
    _check_block(blk)
    with span(SPANS[blk.mixer]):
        h = apply_norm(cfg, p["ln1"], x)
        if blk.mixer == "attn":
            h, cache = attn.attention_decode(cfg, p["mixer"], h, cache, cache_len)
        elif blk.mixer == "mamba":
            h, cache = mb.mamba_decode(cfg, p["mixer"], h, cache)
        elif blk.mixer == "mlstm":
            h, cache = xl.mlstm_decode(cfg, p["mixer"], h, cache)
        else:
            h, cache = xl.slstm_decode(cfg, p["mixer"], h, cache)
        x = x + h
    return _apply_mlp(cfg, blk, p, x)[0], cache


def init_block_cache(cfg: ModelConfig, blk: Block, batch: int, max_len: int, dtype,
                     device) -> Params:
    _check_block(blk)
    if blk.mixer == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device)
    if blk.mixer == "mamba":
        return mb.init_mamba_cache(cfg, batch, dtype, device)
    if blk.mixer == "mlstm":
        return xl.init_mlstm_cache(cfg, batch, device)       # fp32 state
    return xl.init_slstm_cache(cfg, batch, device)


def init_stack(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> list[list[Params]]:
    period = len(cfg.pattern)
    return [[init_block(cfg, cfg.pattern[j], gen, dtype, device) for j in range(period)]
            for _ in range(cfg.n_periods)]


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the config's rematerialisation, where a gradient is
    being taken: ``"full"`` recomputes it in the backward pass, saving only
    its inputs; ``"dots"`` recomputes it too but keeps its matmuls' outputs
    (:class:`repro_torch.kernels.ops.KeptProducts`), so only the rest runs
    again; ``"none"`` calls it. Any other value raises ``ValueError``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}: 'none', 'dots' or 'full'")
    context_fn = (ops.KeptProducts.contexts if cfg.remat == "dots"
                  else torch.utils.checkpoint.noop_context_fn)

    def run(x, aux, per):
        if torch.is_grad_enabled() and x.requires_grad:
            return torch.utils.checkpoint.checkpoint(fn, x, aux, per, use_reentrant=False,
                                                     context_fn=context_fn)
        return fn(x, aux, per)

    return run


def apply_stack(cfg: ModelConfig, stack: list[list[Params]], x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All layers, one period at a time. Returns (x, the MoE aux losses
    summed in fp32)."""

    def one_period(h, aux, per):
        for j, p in enumerate(per):
            h, a = apply_block(cfg, cfg.pattern[j], p, h, positions)
            if a is not None:
                aux = aux + a
        return h, aux

    body = _remat(cfg, one_period)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for per in stack:
        x, aux = body(x, aux, per)
    return x, aux


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> list[list[Params]]:
    period = len(cfg.pattern)
    return [[init_block_cache(cfg, cfg.pattern[j], batch, max_len, dtype, device)
             for j in range(period)]
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

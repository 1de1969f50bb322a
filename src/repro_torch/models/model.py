"""Top-level LM: init, forward, decode — the port's public model API.

Parameters are plain dicts of tensors with the JAX package's key names
(``embed``/``stack``/``final_norm``), the stack in the per-layer layout (see
:mod:`repro_torch.models.transformer`). Every entry point runs on the CUDA
card unless it is given ``device="cpu"``; the parameters must live on that
device. Weights made by the JAX package's init come over through
:func:`params_from_numpy`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    lm_head,
)

Params = dict[str, Any]

__all__ = ["init_params", "params_from_numpy", "count_params", "forward",
           "init_cache", "decode_step", "default_positions", "torch_dtype"]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_rope(cfg: ModelConfig) -> None:
    if cfg.rope_type not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.rope_type} positions are not ported yet")


def _on(params: Params, device: Any) -> torch.device:
    """Resolve ``device`` and check the parameters live there."""
    device = resolve_device(device)
    where = params["embed"]["tokens"].device
    if where != device:
        raise ValueError(f"parameters live on {where}, not on {device}")
    return device


def init_params(cfg: ModelConfig, seed: int = 0, *, device: Any = None) -> Params:
    """Random parameters with the JAX package's scales, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    _check_rope(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "embed": init_embedding(cfg, gen, dtype, device),
        "stack": tf.init_stack(cfg, gen, dtype, device),
        "final_norm": init_norm(cfg, dtype, device),
    }


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree: Params, device: Any = None) -> Params:
    """The port's parameters from the JAX parameter pytree as numpy arrays.

    Takes both of the JAX package's stack layouts: the per-layer list of
    ``scan_layers=False`` (``stack[i][j]``) and the period-stacked arrays of
    ``scan_layers=True`` (``stack[j]`` with a leading ``n_periods`` axis).
    Arrays may arrive as float32 (bf16 weights viewed as float32 to cross
    through numpy); they are cast to the config's dtype, which for bf16
    values is exact.
    """
    device = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, dtype)

    stack = tree["stack"]
    if cfg.scan_layers:
        stack = [[_tree_map(lambda a, i=i: np.asarray(a, np.float32)[i], stack[j])
                  for j in range(len(cfg.pattern))]
                 for i in range(cfg.n_periods)]
    if len(stack) != cfg.n_periods or any(len(per) != len(cfg.pattern) for per in stack):
        raise ValueError(f"stack layout does not match {cfg.name}'s "
                         f"{cfg.n_periods} periods of {len(cfg.pattern)}")
    return {
        "embed": _tree_map(conv, tree["embed"]),
        "stack": _tree_map(conv, stack),
        "final_norm": _tree_map(conv, tree["final_norm"]),
    }


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of :func:`init_params`' tree, from the config alone
    (equal to the JAX package's leaf count)."""
    d, hd = cfg.d_model, cfg.head_dim_
    norm = d * (2 if cfg.norm_type == "layernorm" else 1)
    total = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2) + norm
    for _, blk in cfg.blocks():
        tf._check_block(blk)
        total += norm + d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
        if blk.mlp != "none":
            mult = 3 if cfg.mlp_activation in ("swiglu", "geglu") else 2
            total += norm + mult * d * cfg.d_ff
    return total


def default_positions(batch: int, seq: int, device: Any) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int64, device=device)[None].expand(batch, seq)


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    device: Any = None,
) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V)."""
    _check_rope(cfg)
    device = _on(params, device)
    tokens = torch.as_tensor(tokens, device=device)
    x = embed_tokens(params["embed"], tokens)
    b, s, _ = x.shape
    if positions is None:
        positions = default_positions(b, s, device)
    x = tf.apply_stack(cfg, params["stack"], x, positions)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_head(cfg, params["embed"], x)


# -- decoding -------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device: Any = None) -> Params:
    """KV caches for ``batch`` sequences of up to ``max_len`` positions.

    ``len`` is a Python int (every lane at the same position) — or, set by a
    caller, a (B,) int tensor for lanes at mixed positions.
    """
    device = resolve_device(device)
    return {
        "layers": tf.init_stack_cache(cfg, batch, max_len, torch_dtype(cfg), device),
        "len": 0,
    }


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of :func:`init_cache`'s tensors, plus the JAX package's int32
    length scalar — the cache scratch the serve plans budget."""
    itemsize = torch_dtype(cfg).itemsize
    per_layer = 2 * batch * max_len * cfg.num_kv_heads * cfg.head_dim_ * itemsize
    return per_layer * cfg.num_layers + 4


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    tokens: torch.Tensor,     # (B, S) — S = 1 or a prefill chunk
    *,
    device: Any = None,
) -> tuple[torch.Tensor, Params]:
    """One serve step: logits for the next token(s) + updated cache.

    ``tokens`` may carry S > 1 positions at once (chunked prefill), and
    ``cache["len"]`` may be a ``(B,)`` tensor for lanes at mixed positions.
    The cache tensors are updated in place.
    """
    _check_rope(cfg)
    device = _on(params, device)
    x = embed_tokens(params["embed"], torch.as_tensor(tokens, device=device))
    s = x.shape[1]
    cache_len = cache["len"]
    x, new_layers = tf.apply_stack_decode(cfg, params["stack"], cache["layers"], x,
                                          cache_len)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits, {"layers": new_layers, "len": cache_len + s}

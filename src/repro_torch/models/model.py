"""Top-level LM: init, forward, loss, decode — the port's public model API.

Parameters are plain dicts of tensors with the JAX package's key names
(``embed``/``stack``/``final_norm``), the stack in the per-layer layout (see
:mod:`repro_torch.models.transformer`). Every entry point runs on the CUDA
card unless it is given ``device="cpu"``; the parameters must live on that
device. Weights made by the JAX package's init come over through
:func:`params_from_numpy`. The VLM and audio configs take precomputed
frontend embeddings (the JAX package's stub) through ``embeds=``, the
others token ids; positions are made when not given (M-RoPE's text mode:
the three axes equal).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import span
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    lm_head,
    sinusoidal_positions,
)

Params = dict[str, Any]

__all__ = ["init_params", "abstract_params", "abstract_cache", "params_from_numpy", "opt_state_from_numpy", "count_params",
           "forward", "loss_fn", "init_cache", "cache_bytes", "decode_step",
           "default_positions", "torch_dtype"]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "embed": init_embedding(cfg, gen, dtype, device),
        "stack": tf.init_stack(cfg, gen, dtype, device),
        "final_norm": init_norm(cfg, dtype, device),
    }


def abstract_params(cfg: ModelConfig) -> Params:
    """:func:`init_params`' tree with every leaf a fake tensor: the shapes
    and dtypes, no storage (a dry run at any size)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_params(cfg, 0, device="cpu")


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    """:func:`init_cache`'s tree with every tensor leaf a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_cache(cfg, batch, max_len, device="cpu")


def _tree_map(fn, tree: Any, key: str | None = None) -> Any:
    """Map ``fn(leaf, key)`` over a tree of dicts and lists; ``key`` is the
    name of the dict entry that holds the leaf (or its list)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, key) for v in tree]
    return fn(tree, key)


#: parameter leaves the JAX init keeps in float32 whatever the config's dtype
FP32_LEAVES = frozenset({"router"})


def params_from_numpy(cfg: ModelConfig, tree: Params, device: Any = None) -> Params:
    """The port's parameters from the JAX parameter pytree as numpy arrays.

    Takes both of the JAX package's stack layouts: the per-layer list of
    ``scan_layers=False`` (``stack[i][j]``) and the period-stacked arrays of
    ``scan_layers=True`` (``stack[j]`` with a leading ``n_periods`` axis).
    Arrays may arrive as float32 (bf16 weights viewed as float32 to cross
    through numpy). Each leaf gets the dtype the JAX init gives it: the MoE
    router stays float32, every other leaf takes the config's dtype (for
    bf16 values an exact cast).
    """
    device = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(a: Any, key: str | None) -> torch.Tensor:
        to = torch.float32 if key in FP32_LEAVES else dtype
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, to)

    return _from_numpy(cfg, tree, conv)


def _from_numpy(cfg: ModelConfig, tree: Params, conv) -> Params:
    """A parameter-shaped numpy tree in the port's layout, each leaf through
    ``conv(array, key)``; a period-stacked stack is unstacked."""
    stack = tree["stack"]
    if cfg.scan_layers:
        stack = [[_tree_map(lambda a, _k, i=i: np.asarray(a, np.float32)[i], stack[j])
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


def opt_state_from_numpy(cfg: ModelConfig, state: dict[str, Any],
                         device: Any = None) -> dict[str, Any]:
    """The port's AdamW state from the JAX package's (``AdamW.init`` or a
    stepped state) as numpy arrays: the fp32 moments in the parameters'
    layout and the int step (:class:`repro_torch.optim.adamw.AdamW`)."""
    device = resolve_device(device)

    def conv(a: Any, _key: str | None) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {"m": _from_numpy(cfg, state["m"], conv), "v": _from_numpy(cfg, state["v"], conv),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=device)}


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of :func:`init_params`' tree, from the config alone
    in Python integers (equal to the JAX package's leaf count)."""
    d, hd, h = cfg.d_model, cfg.head_dim_, cfg.num_heads
    norm = d * (2 if cfg.norm_type == "layernorm" else 1)
    mult = 3 if cfg.mlp_activation in ("swiglu", "geglu") else 2
    total = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2) + norm
    for _, blk in cfg.blocks():
        tf._check_block(blk)
        total += norm
        if blk.mixer == "attn":
            total += d * h * hd * 2 + 2 * d * cfg.num_kv_heads * hd
        elif blk.mixer == "mamba":
            di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
            # w_in, conv_w + conv_b, w_x, w_dt, dt_bias + d_skip, a_log, w_out
            total += (d * 2 * di + (cfg.ssm_d_conv + 1) * di + di * (dtr + 2 * ds)
                      + dtr * di + 2 * di + di * ds + di * d)
        elif blk.mixer == "mlstm":
            di = cfg.mlstm_expand * d
            # w_up, w_z, w_down; wq, wk, wv (h, dh, dh); w_if and if_bias
            total += 3 * d * di + 3 * di * (di // h) + di * 2 * h + 2 * h
        else:
            # w_in, r (h, dh, 4dh), bias, w_out
            total += 4 * d * d + 4 * d * (d // h) + 4 * d + d * d
        if blk.mlp == "dense":
            total += norm + mult * d * cfg.d_ff
        elif blk.mlp == "moe":
            e, ff = cfg.moe_experts, cfg.moe_d_ff
            total += norm + d * e + e * mult * d * ff + mult * d * cfg.moe_shared_experts * ff
    return total


def default_positions(cfg: ModelConfig, batch: int, seq: int, device: Any) -> torch.Tensor:
    """0 .. seq-1 for every row, (B, S); (3, B, S) for M-RoPE, the three
    axes equal (text)."""
    pos = torch.arange(seq, dtype=torch.int64, device=device)[None].expand(batch, seq)
    return pos.expand(3, batch, seq) if cfg.rope_type == "mrope" else pos


def _inputs(cfg: ModelConfig, params: Params, tokens: Any, embeds: Any,
            device: torch.device) -> torch.Tensor:
    """The stack's input: the token embeddings or the given frontend
    embeddings in the config's dtype. Exactly one of the two."""
    if (tokens is None) == (embeds is None):
        raise ValueError("pass exactly one of tokens / embeds")
    with span("repro_torch.model.embed"):
        if embeds is None:
            return embed_tokens(params["embed"], torch.as_tensor(tokens, device=device))
        return torch.as_tensor(embeds, device=device).to(torch_dtype(cfg))


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head: (B, S, d) -> logits (B, S, V)."""
    with span("repro_torch.model.head"):
        return lm_head(cfg, params["embed"], apply_norm(cfg, params["final_norm"], x))


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor | None = None,
    *,
    embeds: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    device: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens (B, S) or frontend embeds (B, S, d) ->
    (logits (B, S, V), moe_aux). ``positions``: (B, S), or (3, B, S) for
    M-RoPE; sinusoidal configs add their embedding of the (first axis of
    the) positions to the input."""
    device = _on(params, device)
    x = _inputs(cfg, params, tokens, embeds, device)
    b, s, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, b, s, device)
    positions = torch.as_tensor(positions, device=device)
    if cfg.rope_type == "sinusoidal":
        pos2d = positions if positions.dim() == 2 else positions[0]
        x = x + sinusoidal_positions(cfg.d_model, pos2d).to(x.dtype)
    x, aux = tf.apply_stack(cfg, params["stack"], x, positions)
    return _head(cfg, params, x), aux


def loss_fn(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor | None,
    labels: torch.Tensor,
    *,
    embeds: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    aux_weight: float = 0.01,
    denom: torch.Tensor | None = None,
    device: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Causal-LM cross entropy (+ MoE aux). labels = next-token ids, -1 = pad.

    The JAX package's arithmetic: fp32 logits, CE per position as
    logsumexp minus the true logit, averaged over the labelled positions,
    and ``ce + aux_weight·aux``. The true logit is gathered, where the
    reference contracts with a one-hot (the same value: one product of 1.0,
    the rest of 0.0). Returns ``(total, {"loss", "ce", "moe_aux"})``.
    ``denom`` replaces the count of labelled positions the CE sum is divided
    by: a data-parallel rank passes the count over every rank's shard.
    """
    logits, aux = forward(cfg, params, tokens, embeds=embeds, positions=positions,
                          device=device)
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe[..., None])[..., 0]
    nll = lse - true_logit
    denom = torch.clamp(valid.sum() if denom is None else denom, min=1)
    ce = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
    total = ce + aux_weight * aux
    return total, {"loss": total, "ce": ce, "moe_aux": aux}


# -- decoding -------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device: Any = None) -> Params:
    """Per-layer caches for ``batch`` sequences of up to ``max_len``
    positions: K/V for attention layers, the conv window and fp32 state for
    Mamba layers, the fp32 states of the xLSTM layers (mLSTM's C, n, m;
    sLSTM's c, n, h, m).

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
    length scalar — the cache scratch the serve plans budget. An attention
    layer holds K and V (B, max_len, Hkv, hd) in the config's dtype; a Mamba
    layer its conv window (B, K-1, d_inner) in the config's dtype and its
    state h (B, d_inner, d_state) in fp32; an mLSTM layer C (B, H, dh, dh),
    n (B, H, dh) and m (B, H) in fp32; an sLSTM layer four (B, H, d/H) fp32
    states."""
    itemsize = torch_dtype(cfg).itemsize
    total = 4
    for _, blk in cfg.blocks():
        tf._check_block(blk)
        if blk.mixer == "attn":
            total += 2 * batch * max_len * cfg.num_kv_heads * cfg.head_dim_ * itemsize
        elif blk.mixer == "mamba":
            di = cfg.ssm_d_inner
            total += batch * (cfg.ssm_d_conv - 1) * di * itemsize
            total += batch * di * cfg.ssm_d_state * 4
        elif blk.mixer == "mlstm":
            h = cfg.num_heads
            dh = cfg.mlstm_expand * cfg.d_model // h
            total += batch * h * (dh * dh + dh + 1) * 4
        else:
            total += 4 * batch * cfg.d_model * 4
    return total


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    tokens: torch.Tensor | None = None,   # (B, S) — S = 1 or a prefill chunk
    *,
    embeds: torch.Tensor | None = None,   # (B, S, d) for the vlm/audio stubs
    device: Any = None,
) -> tuple[torch.Tensor, Params]:
    """One serve step: logits for the next token(s) + updated cache.

    ``tokens`` (or ``embeds``) may carry S > 1 positions at once (chunked
    prefill — attention-only stacks: the recurrent mixers take one token
    per step), and ``cache["len"]`` may be a ``(B,)`` tensor for lanes at
    mixed positions. The KV caches are updated in place; a recurrent
    layer's cache is replaced by its new state.
    """
    device = _on(params, device)
    x = _inputs(cfg, params, tokens, embeds, device)
    s = x.shape[1]
    cache_len = cache["len"]
    if s > 1 and any(b.mixer != "attn" for b in cfg.pattern):
        raise ValueError(
            "multi-token decode chunks need an attention-only stack; "
            f"{cfg.name} has recurrent mixers")
    if cfg.rope_type == "sinusoidal":
        steps = torch.arange(s, device=device)
        if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
            pos = cache_len.to(device, torch.int64)[:, None] + steps[None]
        else:
            pos = (int(cache_len) + steps)[None].expand(x.shape[0], s)
        x = x + sinusoidal_positions(cfg.d_model, pos).to(x.dtype)
    x, new_layers = tf.apply_stack_decode(cfg, params["stack"], cache["layers"], x,
                                          cache_len)
    logits = _head(cfg, params, x)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits, {"layers": new_layers, "len": cache_len + s}

"""Shared neural layers: norms, activations, positions, MLPs, embeddings.

Parameters are plain dicts of tensors with the JAX package's key names.
Weights are stored in the config dtype (bf16 by default); norms, softmax and
accumulation run in fp32. Initialisation draws from a ``torch.Generator``
with the JAX package's scales (its numbers differ: carry the JAX weights over
with :func:`repro_torch.models.model.params_from_numpy` to compare).
"""

from __future__ import annotations

import itertools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = dict[str, Any]


# -- norms -------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dtype, device) -> Params:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis, the same bits whatever the rows.

    One reduction over a whole row of a few thousand takes a launch shape
    that follows the number of rows (PyTorch's CUDA reduction sizes its
    blocks by both), so a row summed alone and in a batch of 8 round
    differently. Summed as rows of 64 and then over those partial sums, each
    reduction has a fixed block shape whatever the rows (64 values, or at
    most 32 per warp), so a decode lane's norm is the one it gets served
    alone."""
    d = xf.shape[-1]
    sq = xf.square()
    if d % 64 or d == 64:
        return sq.mean(dim=-1, keepdim=True)
    return sq.unflatten(-1, (d // 64, 64)).sum(-1).sum(-1, keepdim=True) / d


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = _mean_square(xf)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    elif cfg.norm_type == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(cfg.norm_type)
    return out.to(x.dtype)


# -- activations ---------------------------------------------------------------


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "squared_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


# -- rotary / positional embeddings -------------------------------------------


def rope_freqs(cfg: ModelConfig, device) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,)."""
    hd = cfg.head_dim_
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate (B, S, H, D) by per-token positions.

    positions: (B, S) for plain RoPE, (3, B, S) for M-RoPE (temporal, h, w)
    — Qwen2-VL's multimodal rotary embedding: the head-dim frequency bands
    are split into ``mrope_sections`` and each section takes its angle from
    its own position axis. Text tokens carry equal values on the three
    axes, where M-RoPE is RoPE.
    """
    inv = rope_freqs(cfg, x.device)                        # (hd/2,)
    if cfg.rope_type == "mrope":
        if positions.dim() != 3:
            raise ValueError("mrope needs positions (3, B, S)")
        angles = positions[..., None].float() * inv        # (3, B, S, hd/2)
        sections = list(cfg.mrope_sections)
        if sum(sections) != inv.shape[0]:
            raise ValueError(
                f"mrope sections {sections} must sum to head_dim/2 = {inv.shape[0]}")
        bounds = [0] + list(itertools.accumulate(sections))
        theta = torch.cat([angles[axis, :, :, lo:hi]
                           for axis, (lo, hi) in enumerate(zip(bounds, bounds[1:]))], dim=-1)
    else:
        theta = positions[..., None].float() * inv         # (B, S, hd/2)
    cos = torch.cos(theta)[:, :, None, :]                  # (B, S, 1, hd/2)
    sin = torch.sin(theta)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(d_model: int, positions: torch.Tensor) -> torch.Tensor:
    """(B, S) int positions -> (B, S, d_model) fp32 sinusoidal embedding
    (musicgen)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- dense MLP -----------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, device, scale_axis: int = 0):
    fan_in = shape[scale_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w / math.sqrt(fan_in)).to(dtype)


def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype, device,
             d_ff: int | None = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_up": _dense_init(gen, (cfg.d_model, d_ff), dtype, device),
        "w_down": _dense_init(gen, (d_ff, cfg.d_model), dtype, device),
    }
    if cfg.mlp_activation in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(gen, (cfg.d_model, d_ff), dtype, device)
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    up = ops_matmul(x, p["w_up"])
    if cfg.mlp_activation == "swiglu":
        h = F.silu(ops_matmul(x, p["w_gate"])) * up
    elif cfg.mlp_activation == "geglu":
        h = F.gelu(ops_matmul(x, p["w_gate"]), approximate="tanh") * up
    else:
        h = activation(cfg.mlp_activation, up)
    return ops_matmul(h, p["w_down"])


def ops_matmul(x: torch.Tensor, w: torch.Tensor, *, b_layout: str = "kn") -> torch.Tensor:
    """Batched (..., d) @ (d, f) — or, with ``b_layout="nk"``, (..., d) @ wᵀ
    for w stored (f, d) — through the BSPS matmul: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors. Where a gradient is wanted
    it goes through :class:`repro_torch.kernels.ops.Matmul`, whose backward
    runs both products on the kernel too."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = ops.Matmul.apply(x2, w, b_layout, x.dtype)
    else:
        out = ops.matmul(x2, w, out_dtype=x.dtype, b_layout=b_layout)
    return out.reshape(*lead, out.shape[-1])


# -- embeddings ----------------------------------------------------------------


def init_embedding(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    v = cfg.padded_vocab
    tok = torch.randn((v, cfg.d_model), generator=gen, dtype=torch.float32, device=device)
    p = {"tokens": (tok * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, v), dtype, device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: the same gather forward, but its backward
    # sums each row's gradient in a fixed order on the CPU and the card, where
    # indexing's (index_put_ with accumulate) adds rows with atomics on the
    # CPU's threads, so two equal train steps could differ in the last bits
    return F.embedding(tokens.long(), p["tokens"])


def lm_head(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        # x·Eᵀ on the kernel, the (V, d) embedding read as its (n, k) B: a
        # packed decode step's rows round as each would alone (a library
        # product picks its algorithm by the rows), and no (d, V) copy exists
        return ops_matmul(x, p["tokens"], b_layout="nk")
    return ops_matmul(x, p["head"])

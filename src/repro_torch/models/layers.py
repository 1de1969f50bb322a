"""Shared neural layers: norms, activations, positions, MLPs, embeddings.

Parameters are plain dicts of tensors with the JAX package's key names.
Weights are stored in the config dtype (bf16 by default); norms, softmax and
accumulation run in fp32. Initialisation draws from a ``torch.Generator``
with the JAX package's scales (its numbers differ: carry the JAX weights over
with :func:`repro_torch.models.model.params_from_numpy` to compare).
"""

from __future__ import annotations

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


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
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
    """Rotate (B, S, H, D) by per-token positions (B, S).

    M-RoPE (the JAX package's ``mrope`` branch) is not ported yet.
    """
    if cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    inv = rope_freqs(cfg, x.device)
    theta = positions[..., None].float() * inv            # (B, S, hd/2)
    cos = torch.cos(theta)[:, :, None, :]                  # (B, S, 1, hd/2)
    sin = torch.sin(theta)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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


def ops_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched (..., d) @ (d, f) through the BSPS matmul: the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors."""
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]), w, out_dtype=x.dtype)
    return out.reshape(*lead, w.shape[-1])


# -- embeddings ----------------------------------------------------------------


def init_embedding(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    v = cfg.padded_vocab
    tok = torch.randn((v, cfg.d_model), generator=gen, dtype=torch.float32, device=device)
    p = {"tokens": (tok * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, v), dtype, device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tokens"][tokens.long()]


def lm_head(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        # a plain product, as the JAX package leaves this einsum to XLA
        return torch.matmul(x, p["tokens"].T)
    return ops_matmul(x, p["head"])

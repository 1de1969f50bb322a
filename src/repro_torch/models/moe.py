"""Mixture-of-Experts MLP with sort-based dispatch (GShard/Switch semantics).

Tokens pick their top-k experts; the (token, choice) pairs are sorted by
expert id, each expert takes up to ``capacity = ceil(T·k/E · capacity_factor)``
of them in that order (overflow dropped — GShard behaviour), the experts run
as one batched product over a (E, capacity, d) buffer, and the results come
back weighted by the renormalised router probabilities. Shared experts run
densely on every token. The Switch load-balancing loss is returned beside
the output.

Dispatch runs per data-parallel group, as in the JAX package: ``G`` =
:func:`repro_torch.distributed.ctx.dp_size` groups of B/G contiguous rows
when G divides B, else one; the capacity is per group and the aux loss the
mean over the groups. Inside an explicit data-parallel step each rank holds
one group (``ctx.shard_local``). The router is fp32 whatever the config's
dtype. The combine gathers each token's k contributions and adds them in
expert order — the order of the reference's scatter of expert-sorted
updates — with no atomics, so two runs on the card agree bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.models.layers import _dense_init

Params = dict[str, Any]

__all__ = ["init_moe", "moe_forward", "moe_forward_dense", "route_hook"]

_route_hook: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None


@contextlib.contextmanager
def route_hook(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> Iterator[None]:
    """Within the block, every routing calls ``fn(probs, top_e)`` with the
    router's probabilities (T, E) and its top-k expert ids (T, k), and routes
    each token to the ids ``fn`` returns, at their probabilities. A hook
    that returns ``top_e`` records the routes a path takes; one that returns
    recorded ids replays them on another path, so that two paths that round
    differently can be compared without a near tie choosing other experts."""
    global _route_hook
    prev, _route_hook = _route_hook, fn
    try:
        yield
    finally:
        _route_hook = prev


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, e, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    gated = cfg.mlp_activation in ("swiglu", "geglu")
    p = {
        "router": _dense_init(gen, (d, e), torch.float32, device),
        "w_up": _dense_init(gen, (e, d, ff), dtype, device, scale_axis=1),
        "w_down": _dense_init(gen, (e, ff, d), dtype, device, scale_axis=1),
    }
    if gated:
        p["w_gate"] = _dense_init(gen, (e, d, ff), dtype, device, scale_axis=1)
    if cfg.moe_shared_experts:
        sff = cfg.moe_shared_experts * ff
        p["shared_up"] = _dense_init(gen, (d, sff), dtype, device)
        p["shared_down"] = _dense_init(gen, (sff, d), dtype, device)
        if gated:
            p["shared_gate"] = _dense_init(gen, (d, sff), dtype, device)
    return p


def _act(cfg: ModelConfig, p: Params, x: torch.Tensor, prefix: str) -> torch.Tensor:
    """Expert MLP body for the routed (``w_``: x (E, T, d), batched over
    experts) or the shared (``shared_``: x (T, d)) weights."""
    up = torch.matmul(x, p[f"{prefix}up"])
    if cfg.mlp_activation in ("swiglu", "geglu"):
        g = torch.matmul(x, p[f"{prefix}gate"])
        g = F.silu(g) if cfg.mlp_activation == "swiglu" else F.gelu(g, approximate="tanh")
        return g * up
    if cfg.mlp_activation == "gelu":
        return F.gelu(up, approximate="tanh")
    r = F.relu(up)
    return r * r  # squared_relu


def _route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """(probs, top_p renormalised, top_e, aux) for tokens xt (T, d)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(torch.matmul(xt.float(), router), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    if _route_hook is not None:
        top_e = _route_hook(probs, top_e)
        top_p = torch.gather(probs, -1, top_e)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    counts = torch.bincount(top_e.reshape(-1), minlength=e).float()
    aux = e * torch.sum((counts / (xt.shape[0] * k)) * probs.mean(0))
    return probs, top_p, top_e, aux


def _dispatch_group(cfg: ModelConfig, router: torch.Tensor, x_g: torch.Tensor,
                    capacity: int):
    """Top-k dispatch of one group: (T, d) -> (buf (E, cap, d), combine
    meta, aux)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    t, d = x_g.shape
    _, top_p, top_e, aux = _route(cfg, router, x_g)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(t, device=x_g.device).repeat_interleave(k)[order]
    group_start = torch.searchsorted(se, torch.arange(e, device=x_g.device), side="left")
    rank = torch.arange(t * k, device=x_g.device) - group_start[se]
    keep = rank < capacity
    # each kept (expert, rank) slot is written once: an assignment, no sum
    buf = torch.zeros((e * capacity, d), dtype=x_g.dtype, device=x_g.device)
    buf[(se * capacity + rank)[keep]] = x_g[st[keep]]
    # per (token, choice): its slot in the buffer, or -1 where it was dropped
    slot = torch.full((t * k,), -1, dtype=torch.long, device=x_g.device)
    slot[order] = torch.where(keep, se * capacity + rank, -1)
    return buf.reshape(e, capacity, d), (slot.reshape(t, k), top_p, top_e), aux


def _combine(out: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor,
             top_e: torch.Tensor, dtype) -> torch.Tensor:
    """y (T, d): each token's kept contributions out[slot]·p, cast to
    ``dtype``, added in expert order from zero."""
    t, k = slot.shape
    kept = slot >= 0
    contrib = out[slot.clamp(min=0)].float() * top_p[..., None]        # (T, k, d)
    contrib = torch.where(kept[..., None], contrib, 0.0).to(dtype)
    by_expert = torch.argsort(top_e, dim=-1, stable=True)
    y = torch.zeros((t, out.shape[-1]), dtype=dtype, device=out.device)
    for j in range(k):
        y = y + contrib[torch.arange(t, device=out.device), by_expert[:, j]]
    return y


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Top-k routed + shared experts, one
    dispatch per DP group; overflow beyond a group's capacity is dropped."""
    b, s, d = x.shape
    g = ctx.dp_size()
    if g <= 1 or b % g != 0:
        g = 1
    t = (b // g) * s
    capacity = max(1, int(math.ceil(t * cfg.moe_top_k / cfg.moe_experts
                                    * cfg.moe_capacity_factor)))
    ys, auxes = [], []
    for xg in x.reshape(g, t, d):
        buf, (slot, top_p, top_e), aux = _dispatch_group(cfg, p["router"], xg, capacity)
        out_e = torch.matmul(_act(cfg, p, buf, "w_"), p["w_down"])     # (E, cap, d)
        ys.append(_combine(out_e.reshape(-1, d), slot, top_p, top_e, x.dtype))
        auxes.append(aux)
    y = torch.cat(ys)
    if cfg.moe_shared_experts:
        xt = x.reshape(b * s, d)
        y = y + torch.matmul(_act(cfg, p, xt, "shared_"), p["shared_down"]).to(x.dtype)
    return y.reshape(b, s, d), torch.stack(auxes).mean()


def moe_forward_dense(cfg: ModelConfig, p: Params,
                      x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert on every token, masked combine (tests only)."""
    b, s, d = x.shape
    e = cfg.moe_experts
    xt = x.reshape(-1, d)
    probs, top_p, top_e, aux = _route(cfg, p["router"], xt)
    combine = torch.zeros_like(probs).scatter_add_(1, top_e, top_p)
    h = _act(cfg, p, xt[None].expand(e, *xt.shape), "w_")
    out_e = torch.matmul(h, p["w_down"])                               # (E, T, d)
    y = torch.einsum("etd,te->td", out_e.float(), combine).to(x.dtype)
    if cfg.moe_shared_experts:
        y = y + torch.matmul(_act(cfg, p, xt, "shared_"), p["shared_down"]).to(x.dtype)
    return y.reshape(b, s, d), aux

"""Mamba (selective SSM) mixer for the jamba hybrid architecture.

Sequence mixing is a BSPS stream over sequence chunks: the recurrent state
(d_inner × d_state) is the resident local state, the sequence is the
stream. Three paths, as in the JAX package:

* ``kernel``  — :func:`repro_torch.kernels.ops.selective_scan`: the CUDA
                kernel on the card, its plain version on the CPU (``auto``
                takes this path);
* ``chunked`` — the portable chunked scan: a loop over chunks, the
                recurrence expanded in closed form within each chunk;
* ``oracle``  — the per-step plain scan (tests).

The projections are plain products, as the JAX package leaves these
einsums to XLA outside any Pallas kernel. Decode is one recurrent step in
torch ops, as the JAX package writes it in jnp.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import _dense_init

Params = dict[str, Any]

__all__ = ["init_mamba", "chunked_selective_scan", "mamba_forward", "init_mamba_cache",
           "mamba_decode"]


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, di, ds, dtr = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
    # A initialised to -(1..ds) per channel (S4D-real), stored as log
    a_init = torch.arange(1, ds + 1, dtype=torch.float32, device=device).expand(di, ds)
    conv_w = torch.randn((cfg.ssm_d_conv, di), generator=gen, dtype=torch.float32,
                         device=device) * 0.1
    return {
        "w_in": _dense_init(gen, (d, 2 * di), dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_x": _dense_init(gen, (di, dtr + 2 * ds), dtype, device),
        "w_dt": _dense_init(gen, (dtr, di), dtype, device),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),  # softplus^-1(0.01)
        "a_log": torch.log(a_init).to(dtype),
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "w_out": _dense_init(gen, (di, d), dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over (B, S, di) with kernel (K, di).

    If ``state`` (B, K-1, di) is given (decode), it is the left context.
    """
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    # sum_k w[k] * x[t - (K-1) + k] — small K: unrolled adds, no conv primitive
    out = sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def chunked_selective_scan(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a: torch.Tensor, d: torch.Tensor,
    *,
    chunk: int = 128,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Portable chunked selective scan. Returns (y fp32, final state).

    Within a chunk the recurrence is expanded in closed form with cumulative
    decays (dense einsums); across chunks the (B, di, ds) state is carried —
    one hyperstep per chunk. All math fp32.
    """
    bsz, seq, di = x.shape
    ds = a.shape[1]
    ck = min(chunk, seq)
    pad = (-seq) % ck
    if pad:
        x, dt, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (x, dt, b, c))
    nc = x.shape[1] // ck
    xf = x.reshape(bsz, nc, ck, di).float()
    dtf = dt.reshape(bsz, nc, ck, di).float()
    bf = b.reshape(bsz, nc, ck, ds).float()
    cf = c.reshape(bsz, nc, ck, ds).float()
    af = a.float()
    h = torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for n in range(nc):
        xc, dtc, bc, cc = xf[:, n], dtf[:, n], bf[:, n], cf[:, n]   # (B, ck, ·)
        # log-decay per (t, di, ds): dA[t] = dt[t] ⊙ A, cumulative within the chunk
        cum = torch.cumsum(dtc[..., None] * af, dim=1)               # (B, ck, di, ds)
        # the carried state's part: exp(cum_t) ⊙ h
        y_state = torch.einsum("btis,bis,bts->bti", torch.exp(cum), h, cc)
        # within the chunk: y_t += Σ_{s<=t} exp(cum_t - cum_s) dt_s B_s x_s · C_t,
        # expanded as u_s = exp(-cum_s) ⊙ (dt_s x_s ⊗ B_s) with the per-chunk
        # max of -cum subtracted for safety
        m = torch.amax(-cum, dim=1, keepdim=True)                   # (B, 1, di, ds)
        u = torch.exp(-cum - (-m)) * (dtc * xc)[..., None] * bc[:, :, None, :]
        upre = torch.cumsum(u, dim=1)                                # prefix sums over s
        y_intra = torch.einsum("btis,bts->bti", torch.exp(cum - m) * upre, cc)
        ys.append(y_state + y_intra)
        # state update: h' = exp(cum_T) h + Σ_s exp(cum_T - cum_s) dt_s x_s B_s
        last = cum[:, -1][:, None]                                   # (B, 1, di, ds)
        h = torch.exp(last[:, 0]) * h + (torch.exp(last - m) * upre[:, -1:])[:, 0]
    y = torch.stack(ys, dim=1).reshape(bsz, nc * ck, di)
    y = y + x.float() * d.float()
    if pad:
        y = y[:, :seq]
    return y, h


def _project(cfg: ModelConfig, p: Params, xin: torch.Tensor):
    """(dt fp32, B, C) of the conv'd stream: the x projection, dt's low-rank
    projection and softplus."""
    dtr, ds = cfg.dt_rank, cfg.ssm_d_state
    proj = torch.matmul(xin, p["w_x"])
    dt_low, bmat, cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt_low, p["w_dt"]) + p["dt_bias"].float())
    return dt, bmat, cmat


def mamba_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Full-sequence mamba mixer. x: (B, S, d) -> (B, S, d)."""
    xin, z = torch.matmul(x, p["w_in"]).chunk(2, dim=-1)
    xin = F.silu(_causal_conv(xin, p["conv_w"].to(xin.dtype), p["conv_b"]))
    dt, bmat, cmat = _project(cfg, p, xin)
    a = -torch.exp(p["a_log"].float())
    if impl in ("auto", "kernel"):
        y = ops.selective_scan(xin.contiguous(), dt.to(xin.dtype), bmat.contiguous(),
                               cmat.contiguous(), a, p["d_skip"].float())
    elif impl == "oracle":
        y = ref.ssm_scan_ref(xin, dt, bmat, cmat, a, p["d_skip"])
    elif impl == "chunked":
        y, _ = chunked_selective_scan(xin, dt, bmat, cmat, a, p["d_skip"])
    else:
        raise ValueError(f"unknown mamba impl {impl!r}")
    y = y.to(x.dtype) * F.silu(z)
    return torch.matmul(y, p["w_out"])


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
    }


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Params) -> tuple[torch.Tensor, Params]:
    """Single-token recurrent step. x: (B, 1, d). Returns a new cache."""
    xin, z = torch.matmul(x, p["w_in"]).chunk(2, dim=-1)
    conv_state = torch.cat([cache["conv"], xin.to(cache["conv"].dtype)], dim=1)
    xin = F.silu(_causal_conv(xin, p["conv_w"].to(xin.dtype), p["conv_b"],
                              state=cache["conv"]))
    dt, bmat, cmat = _project(cfg, p, xin)                           # dt (B, 1, di)
    a = -torch.exp(p["a_log"].float())
    x_t = xin[:, 0].float()
    da = torch.exp(dt[:, 0, :, None] * a)                            # (B, di, ds)
    h = da * cache["h"] + (dt[:, 0] * x_t)[..., None] * bmat[:, 0, None, :].float()
    y = torch.einsum("bis,bs->bi", h, cmat[:, 0].float()) + p["d_skip"].float() * x_t
    y = y[:, None].to(x.dtype) * F.silu(z)
    return torch.matmul(y, p["w_out"]), {"conv": conv_state[:, 1:], "h": h}

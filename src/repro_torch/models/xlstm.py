"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), arXiv:2405.04517.

The mLSTM is a gated linear attention with a per-head matrix memory C: in
BSPS terms the (dh × dh) state is the resident local token and the sequence
streams past it in chunks, as in the Mamba mixer. It runs in the JAX
package's stabilised chunked form: the running log-gate maximum m is carried
across chunks (the xLSTM paper's stabiliser state, App. A), so the block is
linear in the sequence length.

The sLSTM has per-unit scalar memories (c, n, m) and a block-diagonal
(per-head) recurrence h_{t-1} → gates_t, which is sequential: the input
projections of every step are hoisted out of the loop, so each step is the
(dh × 4dh) per-head product and the gates.

The JAX package writes every product here as a jnp einsum, and no Pallas
kernel backs this module. The port runs the large plain projections on the
BSPS matmul (:func:`repro_torch.models.layers.ops_matmul`: the kernel on the
card), as it does the attention projections: mLSTM's ``w_up``, ``w_z`` and
``w_down``, sLSTM's ``w_in`` and ``w_out``. The per-head q/k/v, the gate
projection ``w_if`` (2·H columns), sLSTM's recurrent ``r`` and the chunk
arithmetic are torch ops. Gates, the stabiliser m and the states (C, n) are
fp32; both blocks carry their own projections (xlstm-1.3b has d_ff = 0).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, ops_matmul

Params = dict[str, Any]

__all__ = ["init_mlstm", "mlstm_forward", "mlstm_step_ref", "init_mlstm_cache", "mlstm_decode",
           "init_slstm", "slstm_forward", "init_slstm_cache", "slstm_decode"]

_NEG = -1e30    # the stabiliser's start and a padded step's input gate


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(heads, mLSTM inner width, its head width)."""
    di = cfg.mlstm_expand * cfg.d_model
    return cfg.num_heads, di, di // cfg.num_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d = cfg.d_model
    h, di, dh = _dims(cfg)
    bias = torch.cat([torch.zeros((h,)), torch.full((h,), 3.0)])
    return {
        "w_up": _dense_init(gen, (d, di), dtype, device),
        "w_z": _dense_init(gen, (d, di), dtype, device),
        # block-diagonal per-head q/k/v (xLSTM's proj_blocksize)
        "wq": _dense_init(gen, (h, dh, dh), dtype, device, scale_axis=1),
        "wk": _dense_init(gen, (h, dh, dh), dtype, device, scale_axis=1),
        "wv": _dense_init(gen, (h, dh, dh), dtype, device, scale_axis=1),
        "w_if": _dense_init(gen, (di, 2 * h), dtype, device),
        "if_bias": bias.to(device, dtype),
        "w_down": _dense_init(gen, (di, d), dtype, device),
    }


def _mlstm_qkvgates(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """q, k (scaled by dh^-1/2), v (B, S, H, dh) and the input gate's raw
    value and the forget gate's log-sigmoid (B, S, H), all fp32; and the
    output gate's input z (B, S, di) in x's dtype."""
    b, s, _ = x.shape
    h, _, dh = _dims(cfg)
    xu = ops_matmul(x, p["w_up"])
    z = ops_matmul(x, p["w_z"])
    xh = xu.reshape(b, s, h, dh)
    q = torch.einsum("bshd,hde->bshe", xh, p["wq"]).float()
    k = torch.einsum("bshd,hde->bshe", xh, p["wk"]).float() * dh ** -0.5
    v = torch.einsum("bshd,hde->bshe", xh, p["wv"]).float()
    raw = torch.einsum("bsi,ie->bse", xu, p["w_if"]).float() + p["if_bias"].float()
    i_raw, f_raw = raw.chunk(2, dim=-1)
    log_f = -F.softplus(-f_raw)  # log sigmoid
    return q, k, v, i_raw, log_f, z


def _mlstm_chunk_step(carry, qb, kb, vb, ib, fb):
    """One hyperstep: consume a chunk of the sequence stream.

    carry: C̃ (B, H, dh, dh), ñ (B, H, dh), m (B, H), the exp(-m)-scaled state;
    qb, kb, vb (B, ck, H, dh); ib, fb (B, ck, H).
    """
    C, n, m = carry
    csum = torch.cumsum(fb, dim=1)                                  # (B, ck, H)
    total = csum[:, -1]                                             # (B, H)

    # intra-chunk log-weights D[t, s] = csum_t - csum_s + i_s (s ≤ t)
    dmat = csum[:, :, None] - csum[:, None, :] + ib[:, None, :, :]  # (B, t, s, H)
    ck = csum.shape[1]
    tri = torch.ones((ck, ck), dtype=torch.bool, device=csum.device).tril()
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    # per-row stabiliser: the previous running max decayed to t vs the intra max
    m_row = torch.maximum(m[:, None] + csum, dmat.amax(dim=2))      # (B, ck, H)

    w = torch.exp(dmat - m_row[:, :, None]).permute(0, 3, 1, 2)    # (B, H, t, s)
    pw = torch.einsum("bthd,bshd->bhts", qb, kb) * w
    y_intra = torch.einsum("bhts,bshd->bthd", pw, vb)
    n_intra = pw.sum(-1).transpose(1, 2)                            # (B, t, H)

    decay_t = torch.exp(m[:, None] + csum - m_row)                  # (B, ck, H)
    y_state = torch.einsum("bthd,bhde->bthe", qb, C) * decay_t[..., None]
    n_state = torch.einsum("bthd,bhd->bth", qb, n) * decay_t

    denom = torch.maximum((n_intra + n_state).abs(), torch.exp(-m_row))
    out = (y_intra + y_state) / denom[..., None]                    # (B, ck, H, dh)

    # advance the state to the chunk's end
    src = total[:, None] - csum + ib                                # (B, ck, H)
    m_new = torch.maximum(m + total, src.amax(dim=1))
    src_w = torch.exp(src - m_new[:, None])
    decay_s = torch.exp(m + total - m_new)
    # Σ_s w_s k_s ⊗ v_s with the weights folded into k first: a pairwise
    # einsum over three operands would form the (B, ck, H, dh, dh) outer
    # product before summing over s
    kw = kb * src_w[..., None]
    C_new = decay_s[..., None, None] * C + torch.einsum("bshd,bshe->bhde", kw, vb)
    n_new = decay_s[..., None] * n + kw.sum(1)
    return (C_new, n_new, m_new), out


def _zero_state(b: int, h: int, dh: int, device) -> tuple[torch.Tensor, ...]:
    return (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            torch.full((b, h), _NEG, dtype=torch.float32, device=device))


def mlstm_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """Full-sequence mLSTM block. x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    h, di, dh = _dims(cfg)
    q, k, v, i_raw, log_f, z = _mlstm_qkvgates(cfg, p, x)
    ck = min(chunk, s)
    pad = (-s) % ck
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=_NEG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    carry = _zero_state(b, h, dh, x.device)
    outs = []
    for c0 in range(0, s + pad, ck):
        cut = slice(c0, c0 + ck)
        carry, o = _mlstm_chunk_step(carry, q[:, cut], k[:, cut], v[:, cut], i_raw[:, cut],
                                     log_f[:, cut])
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(b, s + pad, di)[:, :s]
    out = out.to(x.dtype) * F.silu(z)
    return ops_matmul(out, p["w_down"])


def _mlstm_cell(C, n, m, qt, kt, vt, it, ft):
    """One stabilised recurrent step: qt, kt, vt (B, H, dh); it, ft (B, H).
    Returns the new (C, n, m) and the normalised output (B, H, dh)."""
    m_new = torch.maximum(ft + m, it)
    fs = torch.exp(ft + m - m_new)
    is_ = torch.exp(it - m_new)
    C = fs[..., None, None] * C + is_[..., None, None] * kt[..., :, None] * vt[..., None, :]
    n = fs[..., None] * n + is_[..., None] * kt
    y = torch.einsum("bhd,bhde->bhe", qt, C)
    nq = (qt * n).sum(-1)
    denom = torch.maximum(nq.abs(), torch.exp(-m_new))
    return C, n, m_new, y / denom[..., None]


def mlstm_step_ref(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-timestep oracle (tests): the stabilised recurrent form."""
    b, s, _ = x.shape
    h, di, dh = _dims(cfg)
    q, k, v, i_raw, log_f, z = _mlstm_qkvgates(cfg, p, x)
    C, n, m = _zero_state(b, h, dh, x.device)
    ys = []
    for t in range(s):
        C, n, m, y = _mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t], i_raw[:, t], log_f[:, t])
        ys.append(y)
    out = torch.stack(ys, dim=1).reshape(b, s, di)
    out = out.to(x.dtype) * F.silu(z)
    return ops_matmul(out, p["w_down"])


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> Params:
    h, _, dh = _dims(cfg)
    C, n, m = _zero_state(batch, h, dh, device)
    return {"C": C, "n": n, "m": m}


def mlstm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Params) -> tuple[torch.Tensor, Params]:
    """Single-token recurrent update. x: (B, 1, d). Returns a new cache."""
    q, k, v, i_raw, log_f, z = _mlstm_qkvgates(cfg, p, x)
    C, n, m, y = _mlstm_cell(cache["C"], cache["n"], cache["m"], q[:, 0], k[:, 0], v[:, 0],
                             i_raw[:, 0], log_f[:, 0])
    out = y.reshape(x.shape[0], 1, -1).to(x.dtype) * F.silu(z)
    return ops_matmul(out, p["w_down"]), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {
        "w_in": _dense_init(gen, (d, 4 * d), dtype, device),
        "r": _dense_init(gen, (h, dh, 4 * dh), dtype, device, scale_axis=1),
        "bias": torch.zeros((4 * d,), dtype=dtype, device=device),
        "w_out": _dense_init(gen, (d, d), dtype, device),
    }


def _slstm_step(p_r: torch.Tensor, carry, g_t: torch.Tensor):
    """carry: (c, n, h, m) each (B, H, dh); g_t: the step's input gates
    (B, H, 4dh), precomputed. Returns the new carry and h."""
    c, n, h, m = carry
    raw = g_t + torch.einsum("bhd,hde->bhe", h, p_r)
    z_r, i_r, f_r, o_r = raw.chunk(4, dim=-1)                      # (B, H, dh)
    log_f = -F.softplus(-f_r)
    m_new = torch.maximum(log_f + m, i_r)
    i_s = torch.exp(i_r - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_r)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_r) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_gates(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Every step's input gates, (B, S, H, 4dh) fp32, each head's z, i, f, o
    side by side."""
    b, s, d = x.shape
    h = cfg.num_heads
    g = (ops_matmul(x, p["w_in"]) + p["bias"]).float()
    return g.reshape(b, s, 4, h, d // h).transpose(2, 3).reshape(b, s, h, 4 * (d // h))


def slstm_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence sLSTM block. x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    h = cfg.num_heads
    gates = _slstm_gates(cfg, p, x)
    p_r = p["r"].float()
    cache = init_slstm_cache(cfg, b, x.device)
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    hs = []
    for t in range(s):
        carry, h_t = _slstm_step(p_r, carry, gates[:, t])
        hs.append(h_t)
    out = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return ops_matmul(out, p["w_out"])


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> Params:
    h = cfg.num_heads
    dh = cfg.d_model // h
    zeros = lambda: torch.zeros((batch, h, dh), dtype=torch.float32, device=device)  # noqa: E731
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, h, dh), _NEG, dtype=torch.float32, device=device)}


def slstm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Params) -> tuple[torch.Tensor, Params]:
    """Single-token recurrent update. x: (B, 1, d). Returns a new cache."""
    b, _, d = x.shape
    g = _slstm_gates(cfg, p, x)[:, 0]
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, hh, m), h_new = _slstm_step(p["r"].float(), carry, g)
    out = ops_matmul(h_new.reshape(b, 1, d).to(x.dtype), p["w_out"])
    return out, {"c": c, "n": n, "h": hh, "m": m}

"""Plain PyTorch versions of the port's CUDA kernels.

Each mirrors its kernel's arithmetic — fp32 accumulation, one cast at the
end — with no blocking, streaming or online renormalisation, as the JAX
package's ``kernels/ref.py`` does for its Pallas kernels. The kernel wrappers
use them for tensors that lie on the CPU (the CPU tests and the CPU path of
the port); on the card they are what ``chip_smoke.py`` holds each kernel
against. No code on the main path calls them with CUDA tensors.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "dot_ref", "attention_ref", "attention_ref_lse", "ssm_scan_ref",
           "ssm_scan_tape_ref", "ssm_scan_bwd_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None, *, a_layout: str = "mk",
               b_layout: str = "kn") -> torch.Tensor:
    """C = A·B in fp32, cast once. ``a_layout="km"`` takes A as its (k, m)
    transpose, ``b_layout="nk"`` B as its (n, k) transpose, as the kernel
    reads them."""
    out_dtype = out_dtype or a.dtype
    a = a.T if a_layout == "km" else a
    b = b.T if b_layout == "nk" else b
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def dot_ref(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.dot(v.float(), u.float())


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Dense softmax attention with GQA. q: (B,Hq,Sq,D), k/v: (B,Hkv,Skv,D).

    When Sq < Skv the queries are the last Sq positions (decode semantics):
    ``q_offset = Skv - Sq``.
    """
    return attention_ref_lse(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def attention_ref_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref` and each row's log-sum-exp of its scaled,
    masked scores (natural log, (B, Hq, Sq) fp32) — what the flash kernel's
    ``return_lse`` writes and the backward pass recomputes the
    probabilities from."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype), lse


def ssm_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a: torch.Tensor, d: torch.Tensor,
) -> torch.Tensor:
    """Sequential selective scan, one step per position, all in fp32 (fp64
    for fp64 inputs) with one cast to ``x``'s dtype at the end.

    x, dt: (B, L, d_inner); b, c: (B, L, d_state); a: (d_inner, d_state);
    d: (d_inner,). The state h (B, d_inner, d_state) starts at 0 per row.
    """
    xf, dtf, bf, cf, af, df = _widen(x, dt, b, c, a, d)
    bsz, seq, d_inner = x.shape
    h = xf.new_zeros((bsz, d_inner, a.shape[1]))
    ys = []
    for t in range(seq):
        dt_t, x_t = dtf[:, t], xf[:, t]                            # (B, di)
        da = torch.exp(dt_t[..., None] * af)                       # (B, di, ds)
        h = da * h + (dt_t * x_t)[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, cf[:, t]) + df * x_t)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype)


def ssm_scan_tape_ref(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, a: torch.Tensor, segment: int,
) -> torch.Tensor:
    """The checkpoint tape the forward kernel writes for the backward, by
    :func:`ssm_scan_ref`'s walk: the state h after every ``segment``
    positions but the last, (B, ceil(L / segment) - 1, d_inner, d_state)
    in fp32 (fp64 for fp64 inputs)."""
    xf, dtf, bf, af = _widen(x, dt, b, a)
    bsz, seq, d_inner = x.shape
    h = xf.new_zeros((bsz, d_inner, a.shape[1]))
    tape = []
    for t in range(seq - 1):
        dt_t = dtf[:, t]
        h = torch.exp(dt_t[..., None] * af) * h + (dt_t * xf[:, t])[..., None] * bf[:, t, None, :]
        if (t + 1) % segment == 0:
            tape.append(h)
    return torch.stack(tape, dim=1) if tape else h.new_zeros((bsz, 0, *h.shape[1:]))


def _widen(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The operands in fp32, or fp64 where any is fp64 (``gradcheck``)."""
    wide = torch.float32
    for t in ts:
        wide = torch.promote_types(wide, t.dtype)
    return [t.to(wide) for t in ts]


def ssm_scan_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, dΔ, dB, dC, dA, dD)`` of :func:`ssm_scan_ref`
    for the output gradient ``dy``, by an explicit reverse-time walk in fp32
    (fp64 for fp64 inputs), each cast once to its input's dtype.

    The walk recomputes every state h_t forward, then carries
    g_t = C_t·dy_t + exp(Δ_{t+1}A) ⊙ g_{t+1} (the gradient of the loss with
    respect to h_t) from the last position to the first and accumulates

        dx_t = D·dy_t + Δ_t·Σ_s g_t B_t
        dΔ_t = Σ_s g_t ⊙ (A ⊙ exp(Δ_t A) ⊙ h_{t-1} + B_t x_t)
        dB_t = Σ_i g_t Δ_t x_t          dC_t = Σ_i dy_t h_t
        dA   = Σ_{b,t} g_t Δ_t exp(Δ_t A) h_{t-1}
        dD   = Σ_{b,t} dy_t x_t

    (sums over s are over states, over i over channels).
    """
    xf, dtf, bf, cf, af, df, dyf = _widen(x, dt, b, c, a, d, dy)
    bsz, seq, d_inner = x.shape
    h = xf.new_zeros((bsz, d_inner, a.shape[1]))
    hs = []
    for t in range(seq):
        da = torch.exp(dtf[:, t, :, None] * af)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    dx, ddt, db, dc = (torch.zeros_like(v) for v in (xf, dtf, bf, cf))
    da_sum, dd_sum = torch.zeros_like(af), torch.zeros_like(df)
    carry = torch.zeros_like(h)                        # exp(Δ_{t+1}A) ⊙ g_{t+1}
    for t in reversed(range(seq)):
        x_t, dt_t, dy_t = xf[:, t], dtf[:, t], dyf[:, t]          # (B, di)
        e = torch.exp(dt_t[..., None] * af)                       # (B, di, ds)
        g = cf[:, t, None, :] * dy_t[..., None] + carry
        geh = g * e * (hs[t - 1] if t else torch.zeros_like(g))
        gb = (g * bf[:, t, None, :]).sum(-1)                      # (B, di)
        dx[:, t] = df * dy_t + dt_t * gb
        ddt[:, t] = (geh * af).sum(-1) + x_t * gb
        db[:, t] = (g * (dt_t * x_t)[..., None]).sum(1)
        dc[:, t] = (dy_t[..., None] * hs[t]).sum(1)
        da_sum += (geh * dt_t[..., None]).sum(0)
        dd_sum += (dy_t * x_t).sum(0)
        carry = g * e
    return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(b.dtype), dc.to(c.dtype),
            da_sum.to(a.dtype), dd_sum.to(d.dtype))

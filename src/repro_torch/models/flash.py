"""Flash attention with a backward pass: the forward kernel plus the two-pass
FlashAttention-2 backward, as ``torch.autograd.Function``.

The counterpart of the JAX package's ``models/flash.py`` (its
``flash_attention_vjp``): the forward runs the flash kernel
(:func:`repro_torch.kernels.ops.attention` with ``return_lse=True``: the CUDA
kernel on the card, :func:`repro_torch.kernels.ref.attention_ref_lse` on the
CPU) and saves only (q, k, v, out, lse); the backward recomputes the block
probabilities from lse in two passes — pass A: dq, scanning KV blocks per Q
tile; pass B: dk and dv, scanning Q tiles per KV block — with the causal
bounds structural (each Q tile's scan stops at the diagonal, each KV block's
starts at the first Q tile that sees it). GQA folds the query heads as
(Hkv, group), so K/V are reused across the group without a repeat.

The reference's backward is jnp, not a Pallas kernel, so its counterpart is
torch ops, in fp32 with one cast per gradient at the end, tiled as the
reference tiles (1024 × 1024 by default). Queries sit at the end of the keys
(``q_offset = Skv - Sq``), as the kernel places them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

__all__ = ["FlashAttention", "flash_attention"]

BLOCK_Q = BLOCK_KV = 1024


def _bounds(causal: bool, q_offset: int, tile_end_q: int, n_kv: int, block_kv: int) -> int:
    """Number of KV blocks a Q tile ending at (global) row ``tile_end_q``
    needs."""
    if not causal:
        return n_kv
    last_k = q_offset + tile_end_q  # last visible key position + 1
    return min(n_kv, max(1, math.ceil(last_k / block_kv)))


def _fold(q: torch.Tensor, k: torch.Tensor):
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    return q.reshape(b, hkv, g, sq, d), (b, hq, hkv, g, sq, d)


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, sm_scale: float,
               block_q: int, block_kv: int):
    """(dq, dk, dv) of softmax attention from its saved forward (out, lse),
    the two passes of the reference's ``_flash_bwd``."""
    qg, (b, hq, hkv, g, sq, d) = _fold(q, k)
    skv = k.shape[2]
    q_offset = skv - sq
    dev = q.device
    bq, bk = min(block_q, sq), min(block_kv, skv)
    pad_k = (-skv) % bk
    kf, vf = k.float(), v.float()
    if pad_k:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad_k))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad_k))
    n_kv = kf.shape[2] // bk
    kb = kf.reshape(b, hkv, n_kv, bk, d)
    vb = vf.reshape(b, hkv, n_kv, bk, d)
    lse = lse.reshape(b, hkv, g, sq)

    og = out.reshape(b, hkv, g, sq, d).float()
    dog = dout.reshape(b, hkv, g, sq, d).float()
    delta = (og * dog).sum(-1)                                   # (B, Hkv, g, Sq)

    # ---- pass A: dq, scanning KV blocks per Q tile ----------------------------
    dqs = []
    for t0 in range(0, sq, bq):
        tq = min(bq, sq - t0)
        qt = qg[:, :, :, t0:t0 + tq].float()
        lt, dt, dot_ = lse[..., t0:t0 + tq], delta[..., t0:t0 + tq], dog[:, :, :, t0:t0 + tq]
        q_pos = q_offset + t0 + torch.arange(tq, device=dev)
        dq_t = torch.zeros((b, hkv, g, tq, d), dtype=torch.float32, device=dev)
        for idx in range(_bounds(causal, q_offset, t0 + tq, n_kv, bk)):
            k_blk, v_blk = kb[:, :, idx], vb[:, :, idx]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qt, k_blk) * sm_scale
            k_pos = idx * bk + torch.arange(bk, device=dev)
            mask = k_pos[None, :] < skv
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            p = torch.where(mask, torch.exp(s - lt[..., None]), 0.0)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dot_, v_blk)
            ds = p * (dp - dt[..., None]) * sm_scale
            dq_t = dq_t + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_blk)
        dqs.append(dq_t)
    dq = torch.cat(dqs, dim=3).reshape(b, hq, sq, d).to(q.dtype)

    # ---- pass B: dk/dv, scanning Q tiles per KV block ---------------------------
    n_q = math.ceil(sq / bq)
    pad_q = n_q * bq - sq

    def padq(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 4) + (0, pad_q)) if pad_q else t

    qtiles = padq(qg.float()).reshape(b, hkv, g, n_q, bq, d)
    ltiles = padq(lse).reshape(b, hkv, g, n_q, bq)
    dtiles = padq(delta).reshape(b, hkv, g, n_q, bq)
    dotiles = padq(dog).reshape(b, hkv, g, n_q, bq, d)
    dks, dvs = [], []
    for j in range(n_kv):
        k_blk, v_blk = kb[:, :, j], vb[:, :, j]
        k_pos = j * bk + torch.arange(bk, device=dev)
        first = max(0, (j * bk - q_offset) // bq) if causal else 0
        dk_j = torch.zeros((b, hkv, bk, d), dtype=torch.float32, device=dev)
        dv_j = torch.zeros_like(dk_j)
        for ti in range(first, n_q):
            qt, lt = qtiles[:, :, :, ti], ltiles[:, :, :, ti]
            dt, dot_ = dtiles[:, :, :, ti], dotiles[:, :, :, ti]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qt, k_blk) * sm_scale
            q_pos = q_offset + ti * bq + torch.arange(bq, device=dev)
            mask = (k_pos[None, :] < skv) & (q_pos[:, None] < q_offset + sq)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            p = torch.where(mask, torch.exp(s - lt[..., None]), 0.0)
            dv_j = dv_j + torch.einsum("bhgqk,bhgqd->bhkd", p, dot_)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dot_, v_blk)
            ds = p * (dp - dt[..., None]) * sm_scale
            dk_j = dk_j + torch.einsum("bhgqk,bhgqd->bhkd", ds, qt)
        dks.append(dk_j)
        dvs.append(dv_j)
    dk = torch.cat(dks, dim=2)[:, :, :skv].to(k.dtype)
    dv = torch.cat(dvs, dim=2)[:, :, :skv].to(v.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Softmax attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D): the flash
    kernel forward, saving (q, k, v, out, lse), and :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, sm_scale: float | None = None,
                block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV):
        sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
        out, lse = ops.attention(q, k, v, causal=causal, sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """:class:`FlashAttention` where a gradient is wanted; otherwise the
    kernel alone (no lse written, no tensors saved)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, sm_scale)
    return ops.attention(q, k, v, causal=causal, sm_scale=sm_scale)

"""GQA attention: streamed (flash) prefill + KV-cache decode.

Three inner implementations, all BSPS streamings of the KV sequence (resident
Q token, KV stream, online-softmax state):

* ``kernel``    — the flash kernel (:func:`repro_torch.kernels.ops.attention`):
                  the CUDA kernel on the card, its plain version on the CPU;
* ``blockwise`` — online softmax over KV chunks in torch ops (linear memory
                  in sequence length);
* ``dense``     — materialised S² reference (tests, short sequences).

Decode reads the cache with :func:`dense_cache_attention`, torch ops, as the
JAX package reads it with jnp. The projections run on the BSPS matmul (the
kernel on the card), and the full-sequence forward's attention through
:class:`repro_torch.models.flash.FlashAttention`, so a train step
differentiates through both kernels.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import _dense_init, apply_rope, ops_matmul

Params = dict[str, Any]

_NEG = -1e30
DECODE_CHUNK = 8192     # cache positions a single-token read forms its products over at once


def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    return {
        "wq": _dense_init(gen, (d, h * hd), dtype, device),
        "wk": _dense_init(gen, (d, hkv * hd), dtype, device),
        "wv": _dense_init(gen, (d, hkv * hd), dtype, device),
        "wo": _dense_init(gen, (h * hd, d), dtype, device),
    }


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    # on the kernel, where the JAX package leaves these einsums to XLA: one
    # summation order for every m ≤ 8, so a packed decode lane rounds as
    # the request would alone
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = ops_matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = ops_matmul(x, p["wk"]).reshape(b, s, hkv, hd)
    v = ops_matmul(x, p["wv"]).reshape(b, s, hkv, hd)
    if cfg.rope_type in ("rope", "mrope"):
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def _valid_mask(kv_valid_len: Any, k_pos: torch.Tensor) -> torch.Tensor:
    """(B|1, 1, Skv) mask of cache positions below ``kv_valid_len`` (an int
    or a (B,) tensor of per-lane lengths)."""
    if isinstance(kv_valid_len, torch.Tensor) and kv_valid_len.dim() == 1:
        return k_pos[None, None, :] < kv_valid_len[:, None, None]
    return (k_pos < kv_valid_len)[None, None, :]


def blockwise_attention(
    q: torch.Tensor,        # (B, Hq, Sq, D)
    k: torch.Tensor,        # (B, Hkv, Skv, D)
    v: torch.Tensor,        # (B, Hkv, Skv, D)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_valid_len: Any = None,
    block_kv: int = 512,
) -> torch.Tensor:
    """Online-softmax attention, KV consumed as a stream of chunks.

    GQA folds query heads as (Hkv, group) — K/V tokens are reused across the
    group without materialising a repeat. ``kv_valid_len`` masks a
    partially-filled cache.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = d ** -0.5
    bk = min(block_kv, skv)
    qg = q.reshape(b, hkv, group, sq, d).float()
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hkv, group, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=q.device)
    # a ragged tail is masked like the JAX package's zero padding
    valid = skv if kv_valid_len is None else kv_valid_len
    for start in range(0, skv, bk):
        k_blk = k[:, :, start:start + bk].float()
        v_blk = v[:, :, start:start + bk].float()
        if k_blk.shape[2] < bk:
            pad = bk - k_blk.shape[2]
            k_blk = torch.nn.functional.pad(k_blk, (0, 0, 0, pad))
            v_blk = torch.nn.functional.pad(v_blk, (0, 0, 0, pad))
        s_ = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_blk) * scale
        k_pos = start + torch.arange(bk, device=q.device)
        mask = torch.ones((sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        mask = mask[None] & _valid_mask(valid, k_pos)        # (1|B, sq, bk)
        s_ = torch.where(mask[:, None, None], s_, torch.full_like(s_, _NEG))
        m_new = torch.maximum(m, s_.amax(dim=-1))
        p_ = torch.exp(s_ - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p_.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bhgqk,bhkd->bhgqd", p_, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def dense_cache_attention(
    q: torch.Tensor,              # (B, Hq, Sq, D) — Sq is tiny (decode)
    k: torch.Tensor,              # (B, Hkv, Skv, D) — the cache
    v: torch.Tensor,
    *,
    kv_valid_len: Any,
    q_offset: int = 0,
) -> torch.Tensor:
    """Decode attention reading the cache exactly once (no chunk stream).

    ``kv_valid_len`` may be an int (every lane at the same position — the
    single-request serve path) or a ``(B,)`` tensor (a packed batch of
    requests at mixed positions).

    A single-token step (Sq = 1) takes both products as elementwise products
    summed over their last, contiguous axis, whose reduction has one block
    shape for any batch (more than 16 rows): a packed lane gets the bits it
    gets alone, where a batched library product may pick another algorithm
    by the batch. The products are formed :data:`DECODE_CHUNK` cache
    positions at a time, and the output's partial sums added chunk by chunk
    in order, so the fp32 temporaries stay B·Hq·D·DECODE_CHUNK·4 bytes at
    any context; a cache of at most one chunk is summed in one reduction.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    chunks = [(c, min(c + DECODE_CHUNK, skv)) for c in range(0, skv, DECODE_CHUNK)]
    if sq == 1:
        parts = [(qg[..., None, :] * k[:, :, None, None, c0:c1]).sum(-1) for c0, c1 in chunks]
        s = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)) * d ** -0.5
    else:
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * d ** -0.5
    k_pos = torch.arange(skv, device=q.device)
    mask = _valid_mask(kv_valid_len, k_pos)               # (B|1, 1, Skv)
    if sq > 1:
        causal = (torch.arange(sq, device=q.device) + q_offset)[:, None] >= k_pos[None, :]
        mask = mask & causal[None]
    mask = mask.expand(b, sq, skv)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    if sq == 1:
        out = None
        vt = v.transpose(-1, -2)[:, :, None, None]        # (B, Hkv, 1, 1, D, Skv)
        for c0, c1 in chunks:
            # the products laid out (…, d, chunk), so the sum runs along memory
            prod = torch.empty((b, hkv, g, sq, d, c1 - c0), dtype=torch.float32,
                               device=q.device)
            torch.mul(p[..., None, c0:c1], vt[..., c0:c1], out=prod)
            part = prod.sum(-1)
            del prod                # freed before the next chunk's is made
            out = part if out is None else out + part
    else:
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_core(
    cfg: ModelConfig,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid_len: Any = None,
    impl: str = "auto",
) -> torch.Tensor:
    """(B, S, H, D)-layout wrapper choosing the inner implementation.

    ``auto`` takes the flash kernel for the full-sequence forward
    (``kv_valid_len is None``), as the JAX package does on its TPU — through
    :class:`~repro_torch.models.flash.FlashAttention`, differentiable on both
    devices — and the blockwise stream over a partially filled cache.
    """
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # -> (B, H, S, D)
    if impl == "auto":
        impl = "kernel"
    if impl == "kernel" and kv_valid_len is None:
        out = flash_attention(qt, kt, vt, causal=causal)
    elif impl == "dense":
        if kv_valid_len is not None:
            raise ValueError("dense impl does not support cache masking")
        out = ref.attention_ref(qt, kt, vt, causal=causal)
    else:
        out = blockwise_attention(qt, kt, vt, causal=causal, q_offset=q_offset,
                                  kv_valid_len=kv_valid_len)
    return out.transpose(1, 2)


def attention_forward(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill). ``positions``
    is (B, S), or (3, B, S) for M-RoPE."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = attention_core(cfg, q, k, v, causal=True, impl=impl)
    return ops_matmul(out.reshape(b, s, -1), p["wo"])


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Params:
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
    }


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,          # (B, S, d) — S = 1 (decode) or a prefill chunk
    cache: Params,
    cache_len: Any,           # int, or a (B,) int tensor for packed lanes
    *,
    impl: str = "auto",
) -> tuple[torch.Tensor, Params]:
    """One decode step: write k/v at ``cache_len``, attend over the cache.

    * **chunked prefill** — ``x`` carries S > 1 prompt tokens at once (int
      ``cache_len``); the chunk attends causally within itself plus over the
      cache.
    * **packed lanes** — ``cache_len`` is a ``(B,)`` tensor: each lane sits at
      its own position, with per-lane RoPE positions, cache writes and
      validity masks. Per-lane lengths require S = 1.

    Under M-RoPE every lane's position goes to all three axes, as for text.

    The cache is written in place (slice assignment / ``index_put_``) where
    the JAX package makes an updated copy with ``dynamic_update_slice``; the
    returned dict holds the same tensors.
    """
    b, s, _ = x.shape
    per_lane = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if per_lane and s != 1:
        raise ValueError("per-lane cache_len requires single-token steps")
    if per_lane:
        positions = cache_len.to(torch.int64)[:, None]                 # (B, 1)
    else:
        positions = (int(cache_len) + torch.arange(s, device=x.device))[None].expand(b, s)
    if cfg.rope_type == "mrope":
        positions = positions.expand(3, b, s)   # text: the three axes equal
    q, k, v = _project_qkv(cfg, p, x, positions)
    ck, cv = cache["k"], cache["v"]
    if per_lane:
        lanes = torch.arange(b, device=x.device)
        ck.index_put_((lanes, cache_len.to(torch.int64)), k[:, 0].to(ck.dtype))
        cv.index_put_((lanes, cache_len.to(torch.int64)), v[:, 0].to(cv.dtype))
        valid, q_offset = cache_len + s, 0
    else:
        start = int(cache_len)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        valid, q_offset = start + s, start
    if impl in ("auto", "dense"):
        out = dense_cache_attention(
            q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
            kv_valid_len=valid, q_offset=q_offset).transpose(1, 2)
    else:
        out = attention_core(cfg, q, ck, cv, causal=s > 1, kv_valid_len=valid,
                             q_offset=q_offset, impl=impl)
    y = ops_matmul(out.reshape(b, s, -1), p["wo"])
    return y, {"k": ck, "v": cv}

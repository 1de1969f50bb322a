"""Streaming (flash) attention as a BSPS algorithm: plan and CUDA wrapper.

Attention *is* a pseudo-streaming algorithm in the paper's sense: for each
resident Q token (a block of queries), the K/V sequence is a stream of tokens
consumed one block per hyperstep, with the online-softmax statistics
(m, l, acc) as the persistent local state — the analogue of the paper's
partial sum α_s in Algorithm 1. Causal masking uses the *pseudo*-streaming
property: KV tokens strictly above the diagonal are skipped. GQA is expressed
through the K/V token index maps (q-head h reads kv-head h // group).

:func:`attention_plan` is the JAX package's plan, grid (batch, q_heads,
q_blocks, kv_blocks) with kv sequential. On the card the three parallel axes
are the CUDA grid and each block loops over its KV blocks; the kernel's
blocks are 64 queries by 64 keys.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.kernels import pipeline, ref

__all__ = ["flash_attention", "attention_plan", "BLOCK_Q", "BLOCK_KV"]

BLOCK_Q = BLOCK_KV = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def attention_plan(
    b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
    *,
    block_q: int, block_kv: int,
    causal: bool = True, q_offset: int = 0, dtype=torch.bfloat16,
) -> StreamPlan:
    """StreamPlan for GQA flash attention on padded (sq, skv).

    Per hyperstep: one (block_q × block_kv) score tile — two products
    (QKᵀ and PV, 4·bq·bkv·d FLOPs) plus ~10·bq·bkv vector ops for the online
    softmax. Causal hypersteps whose KV token lies strictly above the diagonal
    cost 0 (the token is skipped, not computed on).
    """
    if sq % block_q or skv % block_kv:
        raise ValueError(f"({sq},{skv}) must be padded to ({block_q},{block_kv})")
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    n_q, n_kv = sq // block_q, skv // block_kv
    tile_flops = (4.0 * d + 10.0) * block_q * block_kv

    def flops(b_, h, i, j):
        if causal and j * block_kv > i * block_q + q_offset + block_q - 1:
            return 0.0
        return tile_flops

    if causal:
        # exact fraction of unskipped tiles (q_offset matters: decode rows
        # sit at the end of the key sequence; negative offsets can mask
        # entire rows, hence the clamp at 0)
        computed = sum(
            max(0, min(n_kv, (i * block_q + q_offset + block_q - 1) // block_kv + 1))
            for i in range(n_q)
        )
        mean_flops = tile_flops * computed / (n_q * n_kv)
    else:
        mean_flops = tile_flops

    return StreamPlan(
        name=f"attn_b{b}h{hq}.{hkv}_{sq}x{skv}x{d}_b{block_q}.{block_kv}",
        grid=(b, hq, n_q, n_kv),
        inputs=(
            TokenSpec("Q", (1, 1, block_q, d),
                      lambda b_, h, i, j: (b_, h, i, 0),
                      dtype=dtype, full_shape=(b, hq, sq, d)),
            TokenSpec("K", (1, 1, block_kv, d),
                      lambda b_, h, i, j, g=group: (b_, h // g, j, 0),
                      dtype=dtype, full_shape=(b, hkv, skv, d)),
            TokenSpec("V", (1, 1, block_kv, d),
                      lambda b_, h, i, j, g=group: (b_, h // g, j, 0),
                      dtype=dtype, full_shape=(b, hkv, skv, d)),
        ),
        outputs=(
            # one O block streams up per resident Q block
            TokenSpec("O", (1, 1, block_q, d),
                      lambda b_, h, i, j: (b_, h, i, 0),
                      dtype=dtype, full_shape=(b, hq, sq, d), direction="up"),
        ),
        scratch=(
            ScratchSpec("m", (block_q, 1), torch.float32),
            ScratchSpec("l", (block_q, 1), torch.float32),
            ScratchSpec("acc", (block_q, d), torch.float32),
        ),
        dimension_semantics=("parallel", "parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=flops,
        mean_flops_per_hyperstep=mean_flops,
    )


@functools.lru_cache(maxsize=256)
def _plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, causal: bool,
          q_offset: int, dtype: torch.dtype) -> StreamPlan:
    pad = lambda x, blk: -(-x // blk) * blk
    return attention_plan(b, hq, hkv, pad(sq, BLOCK_Q), pad(skv, BLOCK_KV), d,
                          block_q=BLOCK_Q, block_kv=BLOCK_KV, causal=causal,
                          q_offset=q_offset, dtype=dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Streaming attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).

    Hq must be a multiple of Hkv (GQA). When Sq < Skv the queries are placed
    at the *end* of the key sequence for causal masking. CUDA tensors go to
    the kernel (float32 or bfloat16, head dim 64 or 128, any strides with a
    contiguous head dim); CPU tensors to
    :func:`repro_torch.kernels.ref.attention_ref`. The result on the card is
    a (B, Hq, Sq, D) view of a (B, Sq, Hq, D) buffer, the layout the model
    reads it back in.
    """
    b, hq, sq, d = q.shape
    bk_, hkv, skv, dk = k.shape
    if k.shape != v.shape or bk_ != b or dk != d:
        raise ValueError(f"bad attention shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {_HEAD_DIMS}, not {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a contiguous head dimension")
    q_offset = skv - sq  # decode: queries are the last sq positions
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if b == 0 or sq == 0:
        return o
    launch = pipeline.lower(_plan(b, hq, hkv, sq, skv, d, causal, q_offset, q.dtype),
                            "bsps_flash", q.device)
    strides = torch.tensor([t.stride(i) for t in (q, k, v, o) for i in range(3)],
                           dtype=torch.int64)
    pipeline.launch(launch, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), hq, hkv, sq, skv, d, q_offset, int(causal),
                    float(sm_scale), _DTYPES[q.dtype], strides.data_ptr())
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

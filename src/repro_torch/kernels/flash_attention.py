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
blocks are 64 queries by 64 keys. bf16 runs on the tensor cores
(``mma.sync``, K/V double-buffered by ``cp.async``), fp32 in exact fp32
FMAs on the CUDA cores (no TF32; both products register-tiled from k-major
shared tiles, K/V streamed by ``cp.async`` too);
``csrc/flash_attention.cu`` describes both. Both are built for the head dims
:data:`HEAD_DIMS`; any other head dim up to 256 runs at the next of them,
its Q, K and V zero-padded (:func:`kernel_head_dim`, :func:`pad_head_dim`):
zero columns leave every score as it is and give zero output columns, which
are cut off.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.core.roofline import KernelCost, counted
from repro_torch.kernels import pipeline, ref

__all__ = ["flash_attention", "attention_plan", "cost", "causal_pairs", "kernel_head_dim",
           "pad_head_dim", "variant_name", "kernel_attrs", "BLOCK_Q", "BLOCK_KV", "HEAD_DIMS"]

BLOCK_Q = BLOCK_KV = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the kernels are built for
HEAD_DIMS = (16, 32, 64, 128, 192, 256)


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


def kernel_head_dim(d: int) -> int:
    """The head dim the kernel runs head dim ``d`` at: the least of
    :data:`HEAD_DIMS` not below it. Above 256 raises ``ValueError``."""
    for dk in HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(f"flash_attention takes head dims up to {HEAD_DIMS[-1]}, not {d}")


def variant_name(dtype: torch.dtype, d_run: int) -> str:
    """The kernel instance a launch runs, e.g. ``"bf16.d64"``: its dtype and
    the head dim it runs at; ``flash_attention.launches_by_variant`` counts
    launches by it."""
    return f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}.d{d_run}"


def pad_head_dim(t: torch.Tensor, dk: int) -> torch.Tensor:
    """``t`` with its last (head) dim zero-padded to ``dk``: ``t`` itself
    when it is ``dk`` wide, else a contiguous copy, the launch's staging."""
    return t if t.shape[-1] == dk else torch.nn.functional.pad(t, (0, dk - t.shape[-1]))


def kernel_attrs(d: int, dtype: torch.dtype, device: torch.device) -> dict[str, int]:
    """The kernel's ``registers`` and ``spill_bytes`` a thread,
    ``smem_bytes`` a block and ``blocks_per_sm`` at instantiated head dim
    ``d`` and ``dtype`` on ``device``, as the CUDA runtime reports them."""
    regs, spill, smem, blocks = pipeline.kernel_attrs("bsps_flash_attrs", device, d,
                                                      _DTYPES[dtype])
    return {"registers": regs, "spill_bytes": spill, "smem_bytes": smem,
            "blocks_per_sm": blocks}


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary (the bf16 kernel's
    ``cp.async`` copies)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.stride(i) * size % 16 == 0 for i in range(3))


def causal_pairs(sq: int, skv: int) -> int:
    """The (query, key) pairs causal masking keeps, the queries the last
    ``sq`` of ``skv`` positions: query i sees keys 0 .. skv - sq + i."""
    lo = max(1, skv - sq + 1)
    return skv * (skv + 1) // 2 - (lo - 1) * lo // 2


def cost(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, itemsize: int, *,
         causal: bool = True, lse: bool = False) -> KernelCost:
    """Attention's work: two products (QKᵀ and PV, 4·d operations) on each
    (query, key) pair causal masking keeps, bf16 on the tensor cores for
    2-byte operands; Q, K, V read once and O written once, and with ``lse``
    the fp32 log-sum-exp of each row."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    return KernelCost(4.0 * b * hq * d * pairs, float(nbytes + (4 * b * hq * sq if lse else 0)),
                      "bf16" if itemsize == 2 else "fp32")


def _call_cost(q, k, v, *, causal=True, sm_scale=None, return_lse=False):
    b, hq, sq, d = q.shape
    return cost(b, hq, k.shape[1], sq, k.shape[2], d, q.element_size(), causal=causal,
                lse=return_lse)


@counted("flash_attention", _call_cost)
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Streaming attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).

    Hq must be a multiple of Hkv (GQA). When Sq < Skv the queries are placed
    at the *end* of the key sequence for causal masking. CUDA tensors go to
    the kernel (float32 or bfloat16, head dim up to 256, any strides with a
    contiguous head dim; bf16 rows 16-byte aligned; a head dim outside
    :data:`HEAD_DIMS` runs zero-padded to the next, ``sm_scale`` still
    ``d ** -0.5`` of the given d); CPU tensors to
    :func:`repro_torch.kernels.ref.attention_ref`. The result on both devices
    is a (B, Hq, Sq, D) view of a (B, Sq, Hq, D) buffer, the layout the model
    reads it back in (so the torch ops after it move the same bytes).
    ``return_lse=True`` also returns each row's log-sum-exp, (B, Hq, Sq)
    fp32 (:func:`ref.attention_ref_lse` on the CPU).
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
        out, lse = ref.attention_ref_lse(q, k, v, causal=causal, sm_scale=sm_scale)
        out = out.transpose(1, 2).contiguous().transpose(1, 2)
        return (out, lse) if return_lse else out
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    d_run = kernel_head_dim(d)
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a contiguous head dimension")
    q, k, v = (pad_head_dim(t, d_run) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and not all(_rows_aligned(t) for t in (q, k, v)):
        raise ValueError("bf16 flash_attention copies 16-byte rows: base addresses and "
                         "batch, head and sequence strides must be multiples of 16 bytes")
    q_offset = skv - sq  # decode: queries are the last sq positions
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    o = out if d_run == d else torch.empty((b, sq, hq, d_run), dtype=q.dtype,
                                           device=q.device).transpose(1, 2)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or sq == 0:
        return (out, lse) if return_lse else out
    launch = pipeline.lower(_plan(b, hq, hkv, sq, skv, d_run, causal, q_offset, q.dtype),
                            "bsps_flash", q.device)
    strides = torch.tensor([t.stride(i) for t in (q, k, v, o) for i in range(3)],
                           dtype=torch.int64)
    pipeline.launch(launch, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), hq, hkv, sq, skv, d_run, q_offset, int(causal),
                    float(sm_scale), _DTYPES[q.dtype], strides.data_ptr(),
                    None if lse is None else lse.data_ptr())
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant_name(q.dtype, d_run)] += 1
    if o is not out:      # the zero columns cut off
        out.copy_(o[..., :d])
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(
    (variant_name(t, d) for t in _DTYPES for d in HEAD_DIMS), 0)

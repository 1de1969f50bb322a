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

:func:`flash_attention_bwd` is the bf16 backward on the card: two kernels
(pass A: dq and each row's delta, scanning the KV blocks per Q tile; pass
B: dk and dv, scanning the group's Q tiles per KV block), with two plans
(:func:`attention_bwd_plans`), no atomics and the same head dims and
padding. Its plain version is the torch-op ``_flash_bwd`` of
``models/flash.py``, which the autograd Function takes for CPU and fp32
tensors.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.core.roofline import KernelCost, counted
from repro_torch.kernels import pipeline, ref

__all__ = ["flash_attention", "flash_attention_bwd", "attention_plan", "attention_bwd_plans",
           "bwd_tiles", "cost", "bwd_cost", "causal_pairs", "kernel_head_dim", "pad_head_dim",
           "variant_name", "kernel_attrs", "bwd_kernel_attrs", "BLOCK_Q", "BLOCK_KV",
           "HEAD_DIMS"]

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


def bwd_tiles(d: int) -> tuple[int, int, int]:
    """``(keys, queries, splits)`` of the backward kernels at instantiated
    head dim ``d`` (``BwdTile`` in ``csrc/flash_attention.cu``): the keys
    pass A streams a step past its 64 queries (32 above D 128, where the dq
    accumulator takes D / 2 registers a lane), the queries pass B streams a
    step past its 64 keys (32 from D 128), and the blocks a KV block's dk and
    dv columns are split over (2 above D 128)."""
    return (32 if d > 128 else 64, 32 if d >= 128 else 64, 2 if d > 128 else 1)


@functools.lru_cache(maxsize=256)
def attention_bwd_plans(
    b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
    *,
    causal: bool = True, q_offset: int = 0, dtype=torch.bfloat16,
) -> tuple[StreamPlan, StreamPlan]:
    """The backward's two StreamPlans at instantiated head dim ``d``, each
    on ``(sq, skv)`` padded to its own pass's tiles (:func:`bwd_tiles`).

    Pass A, grid (batch, q_heads, q_blocks, kv_blocks) with kv sequential:
    each block streams K and V past its resident Q, dO and O tile (S, dP and
    dq: 6·d FLOPs a pair) and writes dq and the rows' delta once; its
    scratch is the dq accumulator. Pass B, grid (batch, kv_heads, kv_blocks,
    group, q_blocks) with the last two sequential: each block streams the
    group's Q, dO, lse and delta tiles past its resident K and V block (S,
    dP, dv and dk: 8·d FLOPs a pair) and writes dk and dv once; its scratch
    is their accumulators. Causal hypersteps wholly above the diagonal cost
    0 (pass A stops at it, pass B starts at the first Q tile that sees the
    block).
    """
    nk, qb, _ = bwd_tiles(d)
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv

    def kept(q0: int, q_rows: int, k0: int) -> bool:       # the tile pair has a kept pair
        return not causal or k0 <= q0 + q_rows - 1 + q_offset

    def rows(name, block, index, full, direction="down", dt=dtype):
        return TokenSpec(name, block, index, dtype=dt, full_shape=full, direction=direction)

    n_q, n_kv = -(-sq // BLOCK_Q), -(-skv // nk)
    sq_a, skv_a = n_q * BLOCK_Q, n_kv * nk
    fa = 6.0 * d * BLOCK_Q * nk
    kept_a = sum(kept(i * BLOCK_Q, BLOCK_Q, j * nk) for i in range(n_q) for j in range(n_kv))
    dq_plan = StreamPlan(
        name=f"attn_bwd_dq_b{b}h{hq}.{hkv}_{sq}x{skv}x{d}_b{BLOCK_Q}.{nk}",
        grid=(b, hq, n_q, n_kv),
        inputs=(
            rows("Q", (1, 1, BLOCK_Q, d), lambda b_, h, i, j: (b_, h, i, 0), (b, hq, sq_a, d)),
            rows("dO", (1, 1, BLOCK_Q, d), lambda b_, h, i, j: (b_, h, i, 0), (b, hq, sq_a, d)),
            rows("O", (1, 1, BLOCK_Q, d), lambda b_, h, i, j: (b_, h, i, 0), (b, hq, sq_a, d)),
            rows("lse", (1, 1, BLOCK_Q), lambda b_, h, i, j: (b_, h, i), (b, hq, sq_a),
                 dt=torch.float32),
            rows("K", (1, 1, nk, d), lambda b_, h, i, j, g=group: (b_, h // g, j, 0),
                 (b, hkv, skv_a, d)),
            rows("V", (1, 1, nk, d), lambda b_, h, i, j, g=group: (b_, h // g, j, 0),
                 (b, hkv, skv_a, d)),
        ),
        outputs=(
            rows("dQ", (1, 1, BLOCK_Q, d), lambda b_, h, i, j: (b_, h, i, 0), (b, hq, sq_a, d),
                 "up"),
            rows("delta", (1, 1, BLOCK_Q), lambda b_, h, i, j: (b_, h, i), (b, hq, sq_a), "up",
                 torch.float32),
        ),
        scratch=(ScratchSpec("dq", (BLOCK_Q, d), torch.float32),),
        dimension_semantics=("parallel", "parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=lambda b_, h, i, j: fa if kept(i * BLOCK_Q, BLOCK_Q, j * nk) else 0.0,
        mean_flops_per_hyperstep=fa * kept_a / (n_q * n_kv),
    )

    n_qb, n_kvb = -(-sq // qb), -(-skv // BLOCK_KV)
    sq_b, skv_b = n_qb * qb, n_kvb * BLOCK_KV
    fb = 8.0 * d * qb * BLOCK_KV
    kept_b = sum(kept(t * qb, qb, j * BLOCK_KV) for j in range(n_kvb) for t in range(n_qb))
    q_tile = lambda b_, h, j, hg, t, g=group: (b_, h * g + hg, t, 0)
    q_rows = lambda b_, h, j, hg, t, g=group: (b_, h * g + hg, t)
    kv_block = lambda b_, h, j, hg, t: (b_, h, j, 0)
    dkv_plan = StreamPlan(
        name=f"attn_bwd_dkv_b{b}h{hq}.{hkv}_{sq}x{skv}x{d}_b{qb}.{BLOCK_KV}",
        grid=(b, hkv, n_kvb, group, n_qb),
        inputs=(
            rows("K", (1, 1, BLOCK_KV, d), kv_block, (b, hkv, skv_b, d)),
            rows("V", (1, 1, BLOCK_KV, d), kv_block, (b, hkv, skv_b, d)),
            rows("Q", (1, 1, qb, d), q_tile, (b, hq, sq_b, d)),
            rows("dO", (1, 1, qb, d), q_tile, (b, hq, sq_b, d)),
            rows("lse", (1, 1, qb), q_rows, (b, hq, sq_b), dt=torch.float32),
            rows("delta", (1, 1, qb), q_rows, (b, hq, sq_b), dt=torch.float32),
        ),
        outputs=(
            rows("dK", (1, 1, BLOCK_KV, d), kv_block, (b, hkv, skv_b, d), "up"),
            rows("dV", (1, 1, BLOCK_KV, d), kv_block, (b, hkv, skv_b, d), "up"),
        ),
        scratch=(ScratchSpec("dk", (BLOCK_KV, d), torch.float32),
                 ScratchSpec("dv", (BLOCK_KV, d), torch.float32)),
        dimension_semantics=("parallel", "parallel", "parallel", "arbitrary", "arbitrary"),
        flops_per_hyperstep=lambda b_, h, j, hg, t: fb if kept(t * qb, qb, j * BLOCK_KV) else 0.0,
        mean_flops_per_hyperstep=fb * kept_b / (n_qb * n_kvb),
    )
    return dq_plan, dkv_plan


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


def bwd_kernel_attrs(d: int, pass_: str, device: torch.device) -> dict[str, int]:
    """The bf16 backward kernel's attributes (as :func:`kernel_attrs`) at
    instantiated head dim ``d``: ``pass_`` is ``"dq"`` (pass A) or ``"dkv"``
    (pass B)."""
    regs, spill, smem, blocks = pipeline.kernel_attrs("bsps_flash_bwd_attrs", device, d,
                                                      ("dq", "dkv").index(pass_))
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


def bwd_cost(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, itemsize: int, *,
             causal: bool = True) -> KernelCost:
    """The backward's work: the scores again, dP, dS's two products and dV,
    10·d operations on each kept pair (what the function needs; the kernel's
    second recomputation of S and dP in pass B, its price for writing every
    gradient once without atomics, is its design and is not counted); Q, K,
    V, O, dO and the fp32 lse read and dQ, dK, dV written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * skv * d) * itemsize + 4 * b * hq * sq
    return KernelCost(10.0 * b * hq * d * pairs, float(nbytes),
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


def _bwd_call_cost(q, k, v, out, lse, dout, *, causal=True, sm_scale=None):
    b, hq, sq, d = q.shape
    return bwd_cost(b, hq, k.shape[1], sq, k.shape[2], d, q.element_size(), causal=causal)


@counted("flash_attention_bwd", _bwd_call_cost)
def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` for the output gradient
    ``dout``, from the forward's ``out`` and ``lse`` (``return_lse=True``).

    bf16 CUDA tensors only: q, out, dout (B, Hq, Sq, D), k, v (B, Hkv, Skv,
    D), any strides with a contiguous head dim and 16-byte aligned rows (dout,
    whose layout is autograd's, is copied contiguous where it has neither),
    lse (B, Hq, Sq) fp32 contiguous; queries at the end of the keys, as the
    forward places them; a head dim outside :data:`HEAD_DIMS` runs
    zero-padded, as the forward's. Each gradient comes back in its input's
    layout and dtype, the same bits on every run and at every batch size.
    Anything else raises: the plain version (fp32, CPU) is the torch-op
    ``_flash_bwd`` of ``models/flash.py``. One call launches the two passes
    and counts once.
    """
    b, hq, sq, d = q.shape
    bk_, hkv, skv, dk_ = k.shape
    if (k.shape != v.shape or bk_ != b or dk_ != d or out.shape != q.shape
            or dout.shape != q.shape or lse.shape != (b, hq, sq)):
        raise ValueError(f"bad attention backward shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, out {tuple(out.shape)}, lse {tuple(lse.shape)}, "
                         f"dout {tuple(dout.shape)}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    tensors = (q, k, v, out, lse, dout)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention_bwd runs on CUDA tensors, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, out, dout)) or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd takes bfloat16 q, k, v, out, dout and a float32 lse")
    if not lse.is_contiguous() or any(t.stride(3) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention_bwd needs a contiguous lse and head dimension")
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    d_run = kernel_head_dim(d)
    if dout.stride(3) != 1 or not _rows_aligned(dout):
        dout = dout.contiguous()
    run = [pad_head_dim(t, d_run) for t in (q, k, v, out, dout)]
    if not all(_rows_aligned(t) for t in run):
        raise ValueError("flash_attention_bwd copies 16-byte rows: base addresses and batch, "
                         "head and sequence strides must be multiples of 16 bytes")
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    if not (b and sq and skv):
        return tuple(g.zero_() for g in grads)
    grads_run = grads if d_run == d else tuple(torch.empty_like(t) for t in run[:3])
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    q_offset = skv - sq
    strides = torch.tensor([t.stride(i) for t in (*run, *grads_run) for i in range(3)],
                           dtype=torch.int64)
    plan_dq, plan_dkv = attention_bwd_plans(b, hq, hkv, sq, skv, d_run, causal=causal,
                                            q_offset=q_offset)
    qr, kr, vr, outr, doutr = run
    shape_args = (hq, hkv, sq, skv, d_run, q_offset, int(causal), float(sm_scale),
                  strides.data_ptr())
    pipeline.launch(pipeline.lower(plan_dq, "bsps_flash_bwd_dq", q.device), q.device,
                    qr.data_ptr(), kr.data_ptr(), vr.data_ptr(), outr.data_ptr(),
                    doutr.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    grads_run[0].data_ptr(), *shape_args)
    pipeline.launch(pipeline.lower(plan_dkv, "bsps_flash_bwd_dkv", q.device), q.device,
                    qr.data_ptr(), kr.data_ptr(), vr.data_ptr(), doutr.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), grads_run[1].data_ptr(),
                    grads_run[2].data_ptr(), *shape_args)
    flash_attention_bwd.launches += 1
    if grads_run is not grads:      # the zero columns cut off
        for g, g_run in zip(grads, grads_run):
            g.copy_(g_run[..., :d])
    return grads


flash_attention_bwd.launches = 0

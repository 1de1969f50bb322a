"""BSPS block-streamed matmul (paper §3.2, the outer level): plan and wrapper.

Paper §3.2 computes C = A·B with outer blocks *streamed* from external memory.
On the card the outer level is device memory → shared memory: the plan's
(i, j) output tiles are the CUDA grid, and the K dimension is the token
stream each block runs in order — block (i, j, s) of A/B is the token of
hyperstep s, staged in shared memory while the tensor cores work on the
previous one. The fp32 accumulator tile is the persistent local state (the
paper's C_ij block). Token reuse (``MOVE(Σ, -M)``) is the non-injective index
maps: A's tile (i, s) is fetched again for every j.

:func:`matmul_plan` with ``split_k=1`` is exactly the JAX package's plan.
When the output tiles alone cannot fill the card — decode, where m is the
batch — the K stream is split over a third "parallel" axis (``split_k``):
each split streams its share of K into an fp32 partial tile, and a closing
launch sums the partials and casts.

The kernel has three variants (``csrc/streamed_matmul.cu``), and
:func:`variant_for` picks one from the shapes, strides and alignment alone:

* ``"decode"`` — m ≤ 16: a 16×64×64 ``wmma`` tile with split K;
* ``"wgmma"`` — m > 16 when TMA can describe both operands (base addresses
  16-byte aligned, row strides multiples of 16 bytes): 128×128 output tiles,
  K streamed 64 at a time by TMA through an ``mbarrier`` ring into
  ``wgmma``, no split;
* ``"wmma"`` — m > 16 otherwise: a 64×64×32 ``wmma`` tile.

A build, encode or launch that fails raises; nothing falls back to another
variant. ``streamed_matmul.launches_by_variant`` counts launches per variant.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.kernels import pipeline, ref

__all__ = ["streamed_matmul", "matmul_plan", "variant_for", "split_for", "VARIANTS"]

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (block_m, block_n, block_k) of each kernel variant; block_m names it to the C side
VARIANTS = {"decode": (16, 64, 64), "wgmma": (128, 128, 64), "wmma": (64, 64, 32)}
_TMA_ALIGN = 16   # bytes: TMA's base-address and row-stride granule


def matmul_plan(
    m: int, k: int, n: int,
    *,
    block_m: int, block_n: int, block_k: int,
    dtype=torch.bfloat16, out_dtype=None, split_k: int = 1,
) -> StreamPlan:
    """StreamPlan for C = A·B, shapes (m, k) × (k, n).

    Ragged shapes are rounded up to block multiples (the paper: "padding with
    zeros if necessary") — the plan describes the padded problem. Grid
    (i, j, s): s is the hyperstep stream over K; A's map (i, s) ignores j
    (token reuse), B's map (s, j) ignores i.

    ``split_k > 1`` (which must divide the K tile count) gives grid
    (split, i, j, s) = (parallel, parallel, parallel, arbitrary): split ``sp``
    streams K tiles ``sp·S .. sp·S + S - 1`` and writes an fp32 partial tile
    of the (split, m, n) partial sums.
    """
    m = -(-m // block_m) * block_m
    n = -(-n // block_n) * block_n
    k = -(-k // block_k) * block_k
    out_dtype = out_dtype or dtype
    scratch = (ScratchSpec("acc", (block_m, block_n), torch.float32),)
    flops = 2.0 * block_m * block_n * block_k
    if split_k == 1:
        return StreamPlan(
            name=f"matmul_{m}x{k}x{n}_b{block_m}.{block_n}.{block_k}",
            grid=(m // block_m, n // block_n, k // block_k),
            inputs=(
                TokenSpec("A", (block_m, block_k), lambda i, j, s: (i, s),
                          dtype=dtype, full_shape=(m, k)),
                TokenSpec("B", (block_k, block_n), lambda i, j, s: (s, j),
                          dtype=dtype, full_shape=(k, n)),
            ),
            outputs=(
                # the finished C block streams *up* when (i, j) moves on
                TokenSpec("C", (block_m, block_n), lambda i, j, s: (i, j),
                          dtype=out_dtype, full_shape=(m, n), direction="up"),
            ),
            scratch=scratch,
            dimension_semantics=("parallel", "parallel", "arbitrary"),
            flops_per_hyperstep=flops,
        )
    k_tiles = k // block_k
    if k_tiles % split_k:
        raise ValueError(f"split_k={split_k} does not divide {k_tiles} K tiles")
    per = k_tiles // split_k
    return StreamPlan(
        name=f"matmul_{m}x{k}x{n}_b{block_m}.{block_n}.{block_k}_s{split_k}",
        grid=(split_k, m // block_m, n // block_n, per),
        inputs=(
            TokenSpec("A", (block_m, block_k),
                      lambda sp, i, j, s, S=per: (i, sp * S + s),
                      dtype=dtype, full_shape=(m, k)),
            TokenSpec("B", (block_k, block_n),
                      lambda sp, i, j, s, S=per: (sp * S + s, j),
                      dtype=dtype, full_shape=(k, n)),
        ),
        outputs=(
            TokenSpec("C_partial", (1, block_m, block_n),
                      lambda sp, i, j, s: (sp, i, j), dtype=torch.float32,
                      full_shape=(split_k, m, n), direction="up"),
        ),
        scratch=scratch,
        dimension_semantics=("parallel", "parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=flops,
    )


def variant_for(m: int, a_addr: int, lda: int, b_addr: int, ldb: int) -> str:
    """The kernel variant for C = A·B with m rows, bf16 A at address
    ``a_addr`` with row stride ``lda`` elements and B at ``b_addr`` with row
    stride ``ldb``.

    m ≤ 16 is decode; otherwise ``"wgmma"`` when TMA can describe both
    operands — each base address 16-byte aligned and each row stride
    (``lda·2``, ``ldb·2`` bytes) a multiple of 16 — and ``"wmma"`` when not.
    """
    if m <= VARIANTS["decode"][0]:
        return "decode"
    if all(x % _TMA_ALIGN == 0 for x in (a_addr, b_addr, 2 * lda, 2 * ldb)):
        return "wgmma"
    return "wmma"


def split_for(tiles: int, k_tiles: int, sms: int) -> int:
    """How many ways to split the K stream so ``tiles`` output tiles fill
    ``sms`` multiprocessors about four blocks deep: the largest divisor of
    ``k_tiles`` not above the shortfall (1 when the tiles fill the card)."""
    want = math.ceil(4 * sms / tiles)
    return max(d for d in range(1, min(want, k_tiles) + 1) if k_tiles % d == 0)


@functools.lru_cache(maxsize=256)
def _plan(m: int, k: int, n: int, tile: tuple[int, int, int], out_dtype: torch.dtype,
          split: int) -> StreamPlan:
    bm, bn, bk = tile
    return matmul_plan(m, k, n, block_m=bm, block_n=bn, block_k=bk,
                       dtype=torch.bfloat16, out_dtype=out_dtype, split_k=split)


def streamed_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B with BSPS block streaming. Shapes (m, k) x (k, n) -> (m, n).

    CUDA tensors go to the kernel, in the variant :func:`variant_for` names:
    bf16 operands whose rows are contiguous, output bf16 or float32. CPU
    tensors go to :func:`repro_torch.kernels.ref.matmul_ref`.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"streamed_matmul runs on CUDA or CPU tensors, not {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"streamed_matmul takes bfloat16 operands, got {a.dtype}, {b.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"streamed_matmul writes bfloat16 or float32, not {out_dtype}")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("streamed_matmul needs operands with contiguous rows")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return c.zero_()
    variant = variant_for(m, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0))
    tile = VARIANTS[variant]
    bm, bn, bk = tile
    split = 1 if variant == "wgmma" else split_for(
        math.ceil(m / bm) * math.ceil(n / bn), math.ceil(k / bk), pipeline.sm_count(a.device))
    launch = pipeline.lower(_plan(m, k, n, tile, out_dtype, split), "bsps_matmul", a.device)
    partials = (torch.empty((split, m, n), dtype=torch.float32, device=a.device)
                if split > 1 else None)
    pipeline.launch(launch, a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    None if partials is None else partials.data_ptr(),
                    m, n, k, a.stride(0), b.stride(0), n, bm, _OUT_DTYPES[out_dtype])
    streamed_matmul.launches += 1
    streamed_matmul.launches_by_variant[variant] += 1
    return c


streamed_matmul.launches = 0
streamed_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)

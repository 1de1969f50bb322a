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
batch — the K stream is split over the blocks of a thread-block cluster
(:func:`decode_plan`), whose partials are summed inside the launch: no
variant writes a partial tensor or launches twice. ``split_k > 1`` keeps
the plan of the same split with the partials streamed up as tokens, which
the plan lint verifies.

The kernel has six variants (``csrc/streamed_matmul.cu``), and
:func:`variant_for` picks one from the dtype, shapes, strides and alignment
alone — five for bf16 operands:

* ``"decode"`` — m ≤ 16 when TMA can describe B (base 16-byte aligned, rows
  a multiple of 16 bytes apart) and A's K share fits a block
  (:func:`decode_fits`): 128-column tiles of B streamed by TMA in stages of
  64 k-rows through a 4-stage ``mbarrier`` ring into ``mma.sync`` (Cᵀ = Bᵀ·Aᵀ,
  the weight on the 16-row side), K split over a thread-block cluster of
  :func:`decode_split` blocks whose partials are summed through distributed
  shared memory: one launch per product, :func:`decode_plan`;
* ``"decode_deep"`` — m ≤ 16 when TMA can describe B and A's K share does
  not fit a block: the decode kernel with A streamed beside B, each ring
  stage holding A's m × 64 slice of its K tile, so no k is too deep; the
  same products and cluster sum, one launch, the K split of
  :func:`deep_split` (:func:`decode_plan` with ``deep=True``);
* ``"wgmma"`` — m > 16 when TMA can describe both operands: 128×128 output
  tiles, K streamed 64 at a time by TMA through an ``mbarrier`` ring into
  ``wgmma``, no split;
* ``"wgmma_cp"`` — m > 16 otherwise: ``wgmma``'s kernel whose two producer
  warpgroups copy each stage themselves into the bytes the TMA boxes would
  write (an aligned operand by 16-byte ``cp.async``; an unaligned one's
  rows as the aligned words under them, staged in shared memory ahead and
  shifted into place), so the consumers are ``wgmma``'s: one launch;
* ``"decode_cp"`` — m ≤ 16 when TMA cannot describe B: ``decode_deep``'s
  kernel whose four producer warps copy B's stages (an unaligned chunk
  shifted out of the aligned words under it in registers), with
  :func:`deep_split`'s cluster split and sum: one launch;

and one for fp32 operands, at any m:

* ``"simt_f32"`` — exact fp32 FMAs, fp32 accumulation, no TF32 (the JAX
  kernel multiplies fp32 operands at ``preferred_element_type=f32``): a
  256×128 tile per block, K streamed 32 at a time by a producer warpgroup's
  ``cp.async`` copies through a 3-stage ``mbarrier`` ring to two consumer
  warpgroups, a 16×8 register tile per consumer thread, each output's K
  terms summed in ascending k in one chain; all three layouts.

Operand layouts. ``b_layout="nk"`` takes B as its (n, k) transpose, k
contiguous: the tied LM head x·Eᵀ reads the (V, d) embedding so, and the
input gradient dC·Wᵀ reads a (k, n) weight so, with no copy. The decode
variants stream such a B by TMA boxes over its rows and reads them with
``ldmatrix`` untransposed; ``wgmma`` takes it as the K-major operand.
``a_layout="km"`` takes A as its (k, m) transpose, m contiguous — the
weight gradient Aᵀ·dC reads the activations so — for bf16 on ``wgmma``
only, as its M-major operand. One operand at a time is transposed. A
transposed bf16 operand needs TMA (16-byte base and row stride); the
copy variants take the default layouts only, so the wrapper stages an
operand of a transposed product that TMA cannot describe into a padded,
aligned copy (:func:`tma_rows`, the launch's staging: a roofline count
leaves it out) and the product runs on a TMA variant. ``simt_f32``
takes fp32 operands in all three layouts at any stride: an operand stored
with k contiguous is copied 4 bytes at a time, transposed into its k-major
tile. The plans describe the same tokens in every layout: only their order
in memory differs.

A build, encode or launch that fails raises; nothing falls back to another
variant. :func:`forced_variant` says which variant a caller may force.
``streamed_matmul.launches_by_variant`` counts launches per variant,
``streamed_matmul.launches_by_layout`` per (a_layout, b_layout).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.core.roofline import KernelCost, counted
from repro_torch.kernels import pipeline, ref

__all__ = ["streamed_matmul", "matmul_plan", "decode_plan", "variant_for", "forced_variant",
           "tma_rows", "decode_split", "deep_split", "decode_fits", "kernel_attrs", "cost",
           "VARIANTS", "LAYOUTS"]

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the (a_layout, b_layout) pairs the kernel takes, and their code on the C side
LAYOUTS = {("mk", "kn"): 0, ("mk", "nk"): 1, ("km", "kn"): 2}
#: (block_m, block_n, block_k) of each kernel variant, in the C side's code
#: order; the decode variants' block_m is the most rows they take
VARIANTS = {"decode": (16, 128, 64), "wgmma": (128, 128, 64), "wgmma_cp": (128, 128, 64),
            "decode_cp": (16, 128, 64), "simt_f32": (256, 128, 32),
            "decode_deep": (16, 128, 64)}
_CODES = {name: i for i, name in enumerate(VARIANTS)}
#: the copy variants (no TMA; default layouts only), and the variants the
#: rule picks that each may be forced onto
_COPY_VARIANTS = ("wgmma_cp", "decode_cp")
_FORCIBLE = {"decode_cp": ("decode", "decode_deep"), "wgmma_cp": ("wgmma",)}
_TMA_ALIGN = 16   # bytes: TMA's base-address and row-stride granule
DECODE_STAGES = 4              # the decode variants' ring of 16 KB weight stages
DECODE_MAX_SPLIT = 8           # the portable thread-block cluster size
DECODE_A_MAX = 64 * 1024       # bytes of A's K share one block may hold
_DECODE_A_PAD = 8              # bf16 past each row of the share (bank spread)
# the block's shared memory beside the ring and the A share: 1 KB of swizzle
# alignment and the mbarriers; and what the SM reserves per block
_DECODE_SMEM_EXTRA = 1024 + 64
_SM_BLOCK_RESERVE = 1024
SM_SMEM = 233472               # bytes of shared memory per SM on Hopper (228 KB)


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


def decode_plan(m: int, k: int, n: int, split: int, *,
                out_dtype=torch.bfloat16, deep: bool = False) -> StreamPlan:
    """Launch plan of the decode variants for C = A·B, (m, k) × (k, n), m ≤ 16.

    Grid (column tile j, split sp, hyperstep s) = (parallel, parallel,
    arbitrary): the ``split`` blocks of column tile j form one cluster, block
    sp streams K tiles ``sp·S .. sp·S + S - 1`` (S = ⌈k tiles / split⌉) of
    B's 128-column panel j. In ``decode``, A's whole K share (m, S·64) is
    loaded once per block; with ``deep`` (``decode_deep``) A streams beside
    B, its (m, 64) token of hyperstep s in the same ring stage as B's. All
    ``split`` blocks own C's tile j: their partials are summed inside the
    cluster, so C streams up once per tile and no partial tensor exists.
    Scratch: the ring of weight boxes, and the A share or (``deep``) the
    ring's A slices of :func:`_rows` of m rows.
    """
    _, bn, bk = VARIANTS["decode"]
    tiles, k_tiles = -(-n // bn), -(-k // bk)
    per = -(-k_tiles // split)
    if not 1 <= split <= min(DECODE_MAX_SPLIT, k_tiles) or (split - 1) * per >= k_tiles:
        raise ValueError(f"bad decode split {split} of {k_tiles} K tiles")
    k_pad = split * per * bk
    if deep:
        a_token = TokenSpec("A", (m, bk), lambda j, sp, s, S=per: (0, sp * S + s),
                            dtype=torch.bfloat16, full_shape=(m, k_pad))
        a_scratch = ScratchSpec("A_ring", (DECODE_STAGES, _rows(m), bk + _DECODE_A_PAD),
                                torch.bfloat16)
    else:
        a_token = TokenSpec("A", (m, per * bk), lambda j, sp, s: (0, sp),
                            dtype=torch.bfloat16, full_shape=(m, k_pad))
        a_scratch = ScratchSpec("A_share", (m, per * bk + _DECODE_A_PAD), torch.bfloat16)
    return StreamPlan(
        name=f"matmul_decode{'_deep' if deep else ''}_{m}x{k}x{n}_s{split}",
        grid=(tiles, split, per),
        inputs=(
            a_token,
            TokenSpec("B", (bk, bn), lambda j, sp, s, S=per: (sp * S + s, j),
                      dtype=torch.bfloat16, full_shape=(k_pad, tiles * bn)),
        ),
        outputs=(
            TokenSpec("C", (m, bn), lambda j, sp, s: (0, j), dtype=out_dtype,
                      full_shape=(m, tiles * bn), direction="up"),
        ),
        scratch=(ScratchSpec("ring", (DECODE_STAGES, bk, bn), torch.bfloat16), a_scratch),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=2.0 * m * bn * bk,
    )


def _a_share_bytes(m: int, k_tiles: int, split: int) -> int:
    bk = VARIANTS["decode"][2]
    return m * (-(-k_tiles // split) * bk + _DECODE_A_PAD) * 2


def _rows(m: int) -> int:
    """The rows the decode variant's choices are made for: m rounded up to
    its 8-row mma side. Every m of one kernel instance (1-8 or 9-16) gets
    one K split, so one summation order: a packed step's rows round as the
    same rows would alone."""
    return 8 * -(-m // 8)


def decode_fits(m: int, k: int) -> bool:
    """Whether A's K share, sized for :func:`_rows` of m, fits one decode
    block at the widest cluster: one answer for every m of an instance, so
    m = 1 .. 8 all take the decode variant or all take ``decode_deep``."""
    k_tiles = -(-k // VARIANTS["decode"][2])
    return _a_share_bytes(_rows(m), k_tiles, min(DECODE_MAX_SPLIT, k_tiles)) <= DECODE_A_MAX


def _blocks_per_sm(a_bytes: int) -> int:
    """Decode blocks an SM holds at once beside ``a_bytes`` of A."""
    _, bn, bk = VARIANTS["decode"]
    smem = DECODE_STAGES * bk * bn * 2 + a_bytes + _DECODE_SMEM_EXTRA + _SM_BLOCK_RESERVE
    return max(1, SM_SMEM // smem)


def _deep_blocks_per_sm(m: int) -> int:
    """``decode_deep`` blocks an SM holds at once: the ring's A slices are
    sized for :func:`_rows` of m and do not depend on k or the split."""
    bk = VARIANTS["decode_deep"][2]
    return _blocks_per_sm(DECODE_STAGES * _rows(m) * (bk + _DECODE_A_PAD) * 2)


def _fill_split(tiles: int, k_tiles: int, sms: int, splits, blocks_per_sm) -> int:
    """The largest of ``splits`` whose ``tiles`` clusters fill at most 7/8 of
    the card's slots (``blocks_per_sm(split)`` an SM), else the first;
    trimmed so no block of a cluster gets an empty K share."""
    split = splits[0]
    for s in splits:
        if 8 * tiles * s <= 7 * sms * blocks_per_sm(s):
            split = s
    return -(-k_tiles // -(-k_tiles // split))


def decode_split(m: int, n: int, k: int, sms: int) -> int:
    """Cluster size (the K split) of the decode variant on ``sms``
    multiprocessors: the largest split (at most 8 and at most the K tiles)
    whose blocks fill at most 7/8 of the slots the card holds at once, so
    every block's ring is in flight from the start and no short second wave
    trails (7/8: a cluster must fit inside one GPC); 1 when the column tiles
    alone overfill the card. A split whose A share overflows a block is
    never taken. Then trimmed so no block of the cluster gets an empty
    share. The A share is sized at :func:`_rows` of m, so that m = 1 and
    m = 8 take one split (one summation order); where no split holds that
    many rows' share (:func:`decode_fits` is false) it raises."""
    _, bn, bk = VARIANTS["decode"]
    tiles, k_tiles = -(-n // bn), -(-k // bk)
    m = _rows(m)
    fits = [s for s in range(1, min(DECODE_MAX_SPLIT, k_tiles) + 1)
            if _a_share_bytes(m, k_tiles, s) <= DECODE_A_MAX]
    if not fits:
        raise ValueError(f"A's K share of {m} rows at k = {k} overflows a decode block")
    return _fill_split(tiles, k_tiles, sms, fits,
                       lambda s: _blocks_per_sm(_a_share_bytes(m, k_tiles, s)))


def deep_split(m: int, n: int, k: int, sms: int) -> int:
    """Cluster size (the K split) of ``decode_deep`` on ``sms``
    multiprocessors, by :func:`decode_split`'s rule: the largest split (at
    most 8 and at most the K tiles) whose blocks fill at most 7/8 of the
    slots the card holds at once, counted with ``decode_deep``'s shared
    memory (:func:`_deep_blocks_per_sm`), then trimmed so no block gets an
    empty share. A function of :func:`_rows` of m, n, k and ``sms`` only, so
    m = 1 .. 8 (and m = 9 .. 16) take one split: one summation order."""
    _, bn, bk = VARIANTS["decode_deep"]
    tiles, k_tiles = -(-n // bn), -(-k // bk)
    per_sm = _deep_blocks_per_sm(m)
    return _fill_split(tiles, k_tiles, sms, range(1, min(DECODE_MAX_SPLIT, k_tiles) + 1),
                       lambda s: per_sm)


def _check_layouts(a_layout: str, b_layout: str) -> None:
    if (a_layout, b_layout) not in LAYOUTS:
        raise ValueError(f"layouts a={a_layout!r}, b={b_layout!r}: the kernel takes "
                         f"{sorted(LAYOUTS)}")


def variant_for(m: int, a_addr: int, lda: int, b_addr: int, ldb: int, k: int, *,
                a_layout: str = "mk", b_layout: str = "kn",
                dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel variant for C = A·B with m rows and depth k, A of ``dtype``
    at address ``a_addr`` with row stride ``lda`` elements and B at
    ``b_addr`` with row stride ``ldb``, each the stride between the rows of
    the operand as it is stored ((m, k) or (k, m) for A, (k, n) or (n, k)
    for B).

    fp32 operands take ``"simt_f32"`` at any m, in every layout and at any
    stride. For bf16, TMA can describe an operand whose base address is
    16-byte aligned and whose row stride (``lda·2``, ``ldb·2`` bytes) is a
    multiple of 16. m ≤ 16 is ``"decode"`` when TMA can describe B and A's
    K share fits a block (:func:`decode_fits`; A is read with plain loads),
    ``"decode_deep"`` when TMA can describe B and the share does not fit,
    ``"decode_cp"`` when TMA cannot describe B; m > 16 is ``"wgmma"``
    when TMA can describe both operands and ``"wgmma_cp"`` when not. A bf16
    (k, m) A always takes ``"wgmma"``. A transposed bf16 operand that the
    chosen variant cannot read raises ``ValueError`` (:func:`streamed_matmul`
    stages such operands with :func:`tma_rows` first).
    """
    _check_layouts(a_layout, b_layout)
    if dtype == torch.float32:
        return "simt_f32"
    b_tma = b_addr % _TMA_ALIGN == 0 and 2 * ldb % _TMA_ALIGN == 0
    a_tma = a_addr % _TMA_ALIGN == 0 and 2 * lda % _TMA_ALIGN == 0
    if a_layout == "km" or m > VARIANTS["decode"][0]:
        variant = "wgmma" if a_tma and b_tma else "wgmma_cp"
    else:
        variant = (("decode" if decode_fits(m, k) else "decode_deep") if b_tma
                   else "decode_cp")
    if variant in _COPY_VARIANTS and (a_layout, b_layout) != ("mk", "kn"):
        raise ValueError(f"a={a_layout!r}, b={b_layout!r} operands need TMA: 16-byte "
                         f"aligned bases and row strides (lda {lda}, ldb {ldb} elements)")
    return variant


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (2-D, on the card) with contiguous rows a multiple of 16 bytes
    apart from a 16-byte aligned base, as TMA reads an operand: ``t`` itself,
    or a view of a padded copy. The logits' gradient needs the copy (a
    vocabulary of 122,753 bf16 is 245,506 bytes a row)."""
    width = _TMA_ALIGN // t.element_size()
    if t.stride(1) == 1 and t.stride(0) % width == 0 and t.data_ptr() % _TMA_ALIGN == 0:
        return t
    rows, cols = t.shape
    buf = torch.empty((rows, -(-cols // width) * width), dtype=t.dtype, device=t.device)
    buf[:, :cols].copy_(t)
    return buf[:, :cols]


def forced_variant(variant: str | None, picked: str, a_layout: str = "mk",
                   b_layout: str = "kn") -> str:
    """The variant a call runs when its caller names ``variant`` and
    :func:`variant_for` picks ``picked``: ``picked`` for ``None`` or itself;
    in the default layouts, ``"decode_cp"`` where the rule picks
    ``"decode"`` or ``"decode_deep"`` and ``"wgmma_cp"`` where it picks
    ``"wgmma"`` (the copy producers on operands TMA could read, as
    ``chip_smoke.py`` times them). Any other name raises ``ValueError``."""
    if variant is None or variant == picked:
        return picked
    if (a_layout, b_layout) == ("mk", "kn") and picked in _FORCIBLE.get(variant, ()):
        return variant
    raise ValueError(f"variant {variant!r} cannot take a product that the rule gives "
                     f"{picked!r} (a={a_layout!r}, b={b_layout!r})")


def kernel_attrs(variant: str, m: int, device: torch.device,
                 out_dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """``registers`` and ``spill_bytes`` a thread, ``smem_bytes`` a block
    and ``blocks_per_sm`` of ``variant``'s kernel instance for ``m`` rows
    (``"wgmma"``, ``"wgmma_cp"``, ``"decode_deep"`` or ``"decode_cp"``;
    default layouts, ``out_dtype`` output) on ``device``, as the CUDA
    runtime reports them."""
    regs, spill, smem, blocks = pipeline.kernel_attrs("bsps_matmul_attrs", device,
                                                      _CODES[variant], m,
                                                      _OUT_DTYPES[out_dtype])
    return {"registers": regs, "spill_bytes": spill, "smem_bytes": smem,
            "blocks_per_sm": blocks}


@functools.lru_cache(maxsize=256)
def _decode_plan(m: int, k: int, n: int, split: int, out_dtype: torch.dtype,
                 deep: bool) -> StreamPlan:
    return decode_plan(m, k, n, split, out_dtype=out_dtype, deep=deep)


@functools.lru_cache(maxsize=256)
def _plan(m: int, k: int, n: int, tile: tuple[int, int, int], out_dtype: torch.dtype,
          dtype: torch.dtype) -> StreamPlan:
    bm, bn, bk = tile
    return matmul_plan(m, k, n, block_m=bm, block_n=bn, block_k=bk,
                       dtype=dtype, out_dtype=out_dtype)


def cost(m: int, k: int, n: int, itemsize: int, out_itemsize: int | None = None) -> KernelCost:
    """C = A·B's work, (m, k) × (k, n): 2mkn operations (bf16 on the tensor
    cores for 2-byte operands, else fp32), A and B read once and C written
    once, (mk + kn)·itemsize + mn·out_itemsize bytes."""
    out_itemsize = out_itemsize or itemsize
    return KernelCost(2.0 * m * k * n, float((m * k + k * n) * itemsize + m * n * out_itemsize),
                      "bf16" if itemsize == 2 else "fp32")


def _call_cost(a, b, *, out_dtype=None, a_layout="mk", b_layout="kn", variant=None):
    m, k = a.shape if a_layout == "mk" else a.shape[::-1]
    n = b.shape[1] if b_layout == "kn" else b.shape[0]
    return cost(m, k, n, a.element_size(), (out_dtype or a.dtype).itemsize)


@counted("streamed_matmul", _call_cost)
def streamed_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    out_dtype: torch.dtype | None = None, a_layout: str = "mk",
                    b_layout: str = "kn", variant: str | None = None) -> torch.Tensor:
    """C = A @ B with BSPS block streaming: (m, k) x (k, n) -> (m, n), A given
    as (m, k) (``a_layout="mk"``) or as its (k, m) transpose (``"km"``), B as
    (k, n) (``b_layout="kn"``) or as its (n, k) transpose (``"nk"``).

    CUDA tensors go to the kernel, in the variant :func:`variant_for` names:
    bf16 or fp32 operands (both the same) whose stored rows are contiguous,
    output bf16 or float32 (rows n elements apart, n odd or even). CPU
    tensors go to :func:`repro_torch.kernels.ref.matmul_ref`.

    ``variant=`` forces a copy variant where :func:`forced_variant` allows
    it (``"decode_cp"`` where the rule gives a decode variant, ``"wgmma_cp"``
    where it gives ``"wgmma"``, in the default layouts); any other forced
    variant raises ``ValueError``.
    """
    _check_layouts(a_layout, b_layout)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape if a_layout == "mk" else a.shape[::-1]
    kb, n = b.shape if b_layout == "kn" else b.shape[::-1]
    if k != kb:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} ({a_layout}) x "
                         f"{tuple(b.shape)} ({b_layout})")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype=out_dtype, a_layout=a_layout, b_layout=b_layout)
    if a.device.type != "cuda":
        raise ValueError(f"streamed_matmul runs on CUDA or CPU tensors, not {a.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"streamed_matmul takes two bfloat16 or two float32 operands, got "
                        f"{a.dtype}, {b.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"streamed_matmul writes bfloat16 or float32, not {out_dtype}")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("streamed_matmul needs operands with contiguous rows")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return c.zero_()
    if a.dtype == torch.bfloat16 and (a_layout, b_layout) != ("mk", "kn"):
        a, b = tma_rows(a), tma_rows(b)     # only the TMA variants read these layouts
    picked = variant_for(m, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), k,
                         a_layout=a_layout, b_layout=b_layout, dtype=a.dtype)
    variant = forced_variant(variant, picked, a_layout, b_layout)
    if variant in ("decode", "decode_deep", "decode_cp"):
        deep = variant != "decode"      # decode_cp: decode_deep's consumers and split
        split = (deep_split if deep else decode_split)(m, n, k, pipeline.sm_count(a.device))
        plan = _decode_plan(m, k, n, split, out_dtype, deep)
    else:
        plan = _plan(m, k, n, VARIANTS[variant], out_dtype, a.dtype)
    launch = pipeline.lower(plan, "bsps_matmul", a.device)
    pipeline.launch(launch, a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    m, n, k, a.stride(0), b.stride(0), n, _CODES[variant],
                    LAYOUTS[a_layout, b_layout], _OUT_DTYPES[out_dtype])
    streamed_matmul.launches += 1
    streamed_matmul.launches_by_variant[variant] += 1
    streamed_matmul.launches_by_layout[a_layout, b_layout] += 1
    return c


streamed_matmul.launches = 0
streamed_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
streamed_matmul.launches_by_layout = dict.fromkeys(LAYOUTS, 0)

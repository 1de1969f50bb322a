"""Mamba selective scan as a BSPS chunked stream (jamba's SSM layers): plan
and CUDA wrapper.

The recurrence
    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t ⊙ B_t) x_t ,   y_t = C_t·h_t + D ⊙ x_t
runs over a stream of sequence chunks (tokens): each hyperstep stages one
chunk of (x, Δ, B, C), advances the recurrent state h — the persistent local
state of the paper — and emits the chunk of y. Only the O(L·d) streams move
over the memory link, never the O(L·d·n) expanded state.

:func:`ssm_plan` is the JAX package's plan: grid (batch, n_chunks), both
"arbitrary", A and D resident (rate 0), h as scratch. On the card the scan
is independent per channel, so ``block_d`` gives the launch plan: grid
(batch, channel tiles, n_chunks) = ("parallel", "parallel", "arbitrary").
The kernel splits each channel's states over a group of lanes of a
128-thread block (:func:`lanes_for`: 2, 4 or 8), so a tile holds
``128 / lanes`` channels, and stages at most ``STAGE_BYTES`` of each
channel's x per chunk (64 bf16 or 32 fp32 positions, double buffered), so
the launch plan's chunk is that stage (:func:`launch_geometry`): the chunk
only sizes the stage, and the result is the same bits for any chunk.
Each tile streams its share of x, Δ and y — together the JAX plan's words
when the tile divides d_inner — and each (row, tile) block reads its rows
of A and D once; the chunk's B_t and C_t, shared by every channel of a row,
are read once per tile.

The backward (:func:`ssm_scan_bwd`, entry ``bsps_ssm_scan_bwd``, plan
:func:`ssm_bwd_plan`) has a geometry of its own (:func:`bwd_geometry`):
256-thread blocks of 4 states a lane, a tile of 64 channels at d_state 16,
the same for every batch size. Under autograd the forward kernel also
writes a checkpoint tape, the state after every :data:`SEGMENT` positions;
the backward walks the segments in reverse, recomputes each segment's
states and decays from its checkpoint in registers and carries ∂L/∂h back
through them, one exponential per (position, channel, state). dB and dC
sum over channels: each block sums its tile's on chip and writes one fp32
partial per tile, dA and dD one per row, and a second kernel of the same
launch sums the partials in a fixed order, so the gradients are the same
bits for every batch and run. :func:`bwd_work_shapes` is the one
description of the tape and the partials. :class:`SelectiveScan` makes the
scan differentiable: :func:`ssm_scan` goes through it where a gradient is
being taken.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.core.roofline import KernelCost, counted
from repro_torch.kernels import pipeline, ref

__all__ = ["ssm_scan", "ssm_scan_with_tape", "ssm_scan_bwd", "SelectiveScan", "ssm_plan",
           "ssm_bwd_plan", "cost", "bwd_cost", "SSM_FLOPS", "SSM_BWD_FLOPS", "bwd_geometry", "bwd_work_shapes", "bwd_kernel_attrs",
           "launch_geometry", "lanes_for", "LANE_CHOICES", "STAGE_BYTES", "MIN_WARPS_PER_SM",
           "SEGMENT", "BWD_STAGE"]

_THREADS = 128        # threads per block of the CUDA kernel
#: lanes per channel the kernel is built for; each lane holds d_state / lanes
#: of the channel's state
LANE_CHOICES = (2, 4, 8)
#: warps per SM below which the serial walk's latency shows (lanes_for)
MIN_WARPS_PER_SM = 6
#: bytes of each channel's x per shared-memory stage: 64 bf16 or 32 fp32
#: positions (at most the kernel's kMaxStage, 64)
STAGE_BYTES = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_D_STATES = (8, 16)
#: positions per checkpoint segment: under autograd the forward stores the
#: state after every SEGMENT positions to the backward's tape (the kernels'
#: kSeg, which both entries check)
SEGMENT = 8
#: the backward's block: BWD_THREADS threads of BWD_STATES states a lane
#: (the kernel's kBwdThreads and kSpl, which its entry checks through the tile)
BWD_THREADS = 256
BWD_STATES = 4
#: positions per stage of the backward: two segments (the kernel's kStage)
BWD_STAGE = 16


def ssm_plan(
    bsz: int, seq: int, d_inner: int, d_state: int,
    *,
    chunk: int, dtype=torch.float32, param_dtype=torch.float32,
    block_d: int | None = None, tape: bool = False,
) -> StreamPlan:
    """StreamPlan for the chunked selective scan on a padded sequence.

    ~10·d_inner·d_state FLOPs per scanned position (exp/decay, state update,
    output contraction), times ``chunk`` positions per hyperstep.
    ``param_dtype`` prices the resident A/D operands, which the model keeps
    in fp32 even for bf16 activation streams.

    ``block_d=None`` is the JAX package's plan. ``block_d`` gives the CUDA
    launch plan: channel tiles of ``block_d`` (the last one ragged, padded
    in the plan) as a second "parallel" axis, the state a
    (block_d, d_state) scratch per tile. ``tape`` adds the backward's
    checkpoint tape to the launch plan's outputs, at
    :func:`bwd_work_shapes`' shape: each chunk writes the states at its
    segments' ends.
    """
    if seq % chunk:
        raise ValueError(f"seq {seq} must be padded to chunk {chunk}")
    if block_d is None:
        return StreamPlan(
            name=f"ssm_b{bsz}_{seq}x{d_inner}x{d_state}_c{chunk}",
            grid=(bsz, seq // chunk),
            inputs=(
                TokenSpec("x", (1, chunk, d_inner), lambda i, j: (i, j, 0),
                          dtype=dtype, full_shape=(bsz, seq, d_inner)),
                TokenSpec("dt", (1, chunk, d_inner), lambda i, j: (i, j, 0),
                          dtype=dtype, full_shape=(bsz, seq, d_inner)),
                TokenSpec("B", (1, chunk, d_state), lambda i, j: (i, j, 0),
                          dtype=dtype, full_shape=(bsz, seq, d_state)),
                TokenSpec("C", (1, chunk, d_state), lambda i, j: (i, j, 0),
                          dtype=dtype, full_shape=(bsz, seq, d_state)),
                # A and D are resident operands: rate 0 (fetched once,
                # hyperstep 0, single-buffered)
                TokenSpec("A", (d_inner, d_state), lambda i, j: (0, 0),
                          dtype=param_dtype, full_shape=(d_inner, d_state), rate=0),
                TokenSpec("D", (1, d_inner), lambda i, j: (0, 0),
                          dtype=param_dtype, full_shape=(1, d_inner), rate=0),
            ),
            outputs=(
                # each finished y chunk streams up as the cursor moves on
                TokenSpec("y", (1, chunk, d_inner), lambda i, j: (i, j, 0),
                          dtype=dtype, full_shape=(bsz, seq, d_inner), direction="up"),
            ),
            scratch=(ScratchSpec("h", (d_inner, d_state), torch.float32),),
            dimension_semantics=("arbitrary", "arbitrary"),
            flops_per_hyperstep=10.0 * chunk * d_inner * d_state,
        )
    tiles = math.ceil(d_inner / block_d)
    d_pad = tiles * block_d
    outputs = [TokenSpec("y", (1, chunk, block_d), lambda i, k, j: (i, j, k),
                         dtype=dtype, full_shape=(bsz, seq, d_pad), direction="up")]
    h_ckpt = bwd_work_shapes(bsz, seq, d_pad, d_state)["h_ckpt"]
    if tape and h_ckpt[1]:
        outputs.append(TokenSpec("h_ckpt", (1, max(1, chunk // SEGMENT), block_d, d_state),
                                 lambda i, k, j: (i, j, k, 0), dtype=torch.float32,
                                 full_shape=h_ckpt, direction="up"))
    return StreamPlan(
        name=f"ssm_b{bsz}_{seq}x{d_pad}x{d_state}_c{chunk}_d{block_d}" + ("_tape" if tape else ""),
        grid=(bsz, tiles, seq // chunk),
        inputs=(
            TokenSpec("x", (1, chunk, block_d), lambda i, k, j: (i, j, k),
                      dtype=dtype, full_shape=(bsz, seq, d_pad)),
            TokenSpec("dt", (1, chunk, block_d), lambda i, k, j: (i, j, k),
                      dtype=dtype, full_shape=(bsz, seq, d_pad)),
            TokenSpec("B", (1, chunk, d_state), lambda i, k, j: (i, j, 0),
                      dtype=dtype, full_shape=(bsz, seq, d_state)),
            TokenSpec("C", (1, chunk, d_state), lambda i, k, j: (i, j, 0),
                      dtype=dtype, full_shape=(bsz, seq, d_state)),
            TokenSpec("A", (block_d, d_state), lambda i, k, j: (k, 0),
                      dtype=param_dtype, full_shape=(d_pad, d_state), rate=0),
            TokenSpec("D", (1, block_d), lambda i, k, j: (0, k),
                      dtype=param_dtype, full_shape=(1, d_pad), rate=0),
        ),
        outputs=tuple(outputs),
        scratch=(ScratchSpec("h", (block_d, d_state), torch.float32),),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=10.0 * chunk * block_d * d_state,
    )


def ssm_bwd_plan(
    bsz: int, seq: int, d_inner: int, d_state: int,
    *,
    chunk: int, block_d: int, dtype=torch.float32,
) -> StreamPlan:
    """The backward's launch plan: grid (batch, channel tiles, stages of
    ``chunk`` positions) = ("parallel", "parallel", "arbitrary"), each block
    walking its stages from the last to the first.

    It streams x, Δ, B, C, dy and the forward's checkpoint tape ("h_ckpt",
    the state before each segment of :data:`SEGMENT` positions) down and
    writes dx and dΔ per stage; "dbc" holds each position's dB/dC partial
    per tile of ``block_d`` channels, "dA"/"dD" each (row, tile)'s sums over
    its positions, written once; their shapes are :func:`bwd_work_shapes`'
    at the plan's padded sizes. The scratch is the per-tile state h and its
    gradient g, (block_d, d_state) fp32 each, which the kernel keeps in
    registers. About 18·d_state FLOPs per position and channel: 4 to
    recompute the segment's states, 14 on the reverse step and the sums.
    """
    if seq % chunk or block_d != bwd_geometry(d_state)[1]:
        raise ValueError(f"seq {seq} must be padded to chunk {chunk}, block_d {block_d} "
                         f"the backward's tile at d_state {d_state}")
    tiles = math.ceil(d_inner / block_d)
    d_pad = tiles * block_d
    work = bwd_work_shapes(bsz, seq, d_pad, d_state)

    def stream(name, direction="down"):
        return TokenSpec(name, (1, chunk, block_d), lambda i, k, j: (i, j, k), dtype=dtype,
                         full_shape=(bsz, seq, d_pad), direction=direction)

    def shared(name):
        return TokenSpec(name, (1, chunk, d_state), lambda i, k, j: (i, j, 0), dtype=dtype,
                         full_shape=(bsz, seq, d_state))

    tape = (TokenSpec("h_ckpt", (1, max(1, chunk // SEGMENT), block_d, d_state),
                      lambda i, k, j: (i, j, k, 0), dtype=torch.float32,
                      full_shape=work["h_ckpt"]),) if work["h_ckpt"][1] else ()
    return StreamPlan(
        name=f"ssm_bwd_b{bsz}_{seq}x{d_pad}x{d_state}_c{chunk}_d{block_d}",
        grid=(bsz, tiles, seq // chunk),
        inputs=(
            stream("x"), stream("dt"), shared("B"), shared("C"), stream("dy"), *tape,
            TokenSpec("A", (block_d, d_state), lambda i, k, j: (k, 0),
                      dtype=torch.float32, full_shape=(d_pad, d_state), rate=0),
            TokenSpec("D", (1, block_d), lambda i, k, j: (0, k),
                      dtype=torch.float32, full_shape=(1, d_pad), rate=0),
        ),
        outputs=(
            stream("dx", "up"), stream("ddt", "up"),
            TokenSpec("dbc", (1, chunk, 2, 1, d_state), lambda i, k, j: (i, j, 0, k, 0),
                      dtype=torch.float32, full_shape=work["dbc"], direction="up"),
            TokenSpec("dA", (1, block_d, d_state), lambda i, k, j: (i, k, 0),
                      dtype=torch.float32, full_shape=work["dA"], direction="up"),
            TokenSpec("dD", (1, block_d), lambda i, k, j: (i, k), dtype=torch.float32,
                      full_shape=work["dD"], direction="up"),
        ),
        scratch=(ScratchSpec("h", (block_d, d_state), torch.float32),
                 ScratchSpec("g", (block_d, d_state), torch.float32)),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=18.0 * chunk * block_d * d_state,
    )


def bwd_geometry(d_state: int) -> tuple[int, int, int, int]:
    """``(lanes, block_d, segment, stage)`` of the backward kernel: 4 states
    a lane (:data:`BWD_STATES`), so ``d_state / 4`` lanes a channel and a
    tile of 64 channels at d_state 16 (128 at 8) in a 256-thread block; a
    checkpoint every :data:`SEGMENT` positions, whose 9 states and 8 decays
    a lane keeps in 68 registers of the 128 it may hold at two blocks an
    SM (one at d_state 8); stages of :data:`BWD_STAGE` positions. The backward's own rule, the
    same for every batch size, so a row alone takes the tiles and the sums'
    order it takes in its batch."""
    if d_state not in _D_STATES:
        raise ValueError(f"the ssm_scan_bwd kernel supports d_state {_D_STATES}, not {d_state}")
    lanes = d_state // BWD_STATES
    return lanes, BWD_THREADS // lanes, SEGMENT, BWD_STAGE


def bwd_work_shapes(bsz: int, seq: int, d_inner: int,
                    d_state: int) -> dict[str, tuple[int, ...]]:
    """The fp32 work buffers of one backward: the checkpoint tape (the state
    after every :data:`SEGMENT` positions but the last, which the forward
    writes), the dB/dC partials per tile of :func:`bwd_geometry`'s
    ``block_d`` channels, and the per-row dA and dD. The one description of
    them: :func:`ssm_plan` (with ``tape``) and :func:`ssm_bwd_plan` price
    them at their padded sizes, :func:`ssm_scan` and :func:`ssm_scan_bwd`
    allocate them at the operands' and pass the kernels the segment and the
    tile count, which their entries check against their own layout."""
    block_d = bwd_geometry(d_state)[1]
    return {"h_ckpt": (bsz, max(-(-seq // SEGMENT) - 1, 0), d_inner, d_state),
            "dbc": (bsz, seq, 2, -(-d_inner // block_d), d_state),
            "dA": (bsz, d_inner, d_state), "dD": (bsz, d_inner)}


def lanes_for(bsz: int, d_inner: int, d_state: int, sms: int) -> int:
    """Lanes per channel: the fewest of :data:`LANE_CHOICES` (at most
    d_state / 2: a lane holds a pair of states at least) whose warps fill
    every SM at least :data:`MIN_WARPS_PER_SM` deep, else the most. Fewer
    lanes do fewer instructions per state (one shuffle round less per
    halving); more lanes give more warps to hide the serial walk. Every
    grouping gives the same bits."""
    allowed = [g for g in LANE_CHOICES if 2 * g <= d_state]
    for lanes in allowed:
        if bsz * d_inner * lanes >= 32 * MIN_WARPS_PER_SM * sms:
            return lanes
    return allowed[-1]


def launch_geometry(seq: int, chunk: int, lanes: int, itemsize: int) -> tuple[int, int, int]:
    """``(block_d, stage, padded seq)`` of the kernel's launch: a tile of
    ``128 / lanes`` channels, a stage of ``min(chunk, seq, STAGE_BYTES /
    itemsize)`` positions, and the sequence padded to whole stages in the
    plan."""
    if lanes not in LANE_CHOICES:
        raise ValueError(f"lanes per channel must be one of {LANE_CHOICES}, not {lanes}")
    stage = min(chunk, seq, STAGE_BYTES // itemsize)
    return _THREADS // lanes, stage, math.ceil(seq / stage) * stage


@functools.lru_cache(maxsize=256)
def _plan(bsz: int, seq: int, d_inner: int, d_state: int, chunk: int,
          dtype: torch.dtype, block_d: int, tape: bool) -> StreamPlan:
    return ssm_plan(bsz, seq, d_inner, d_state, chunk=chunk, dtype=dtype,
                    block_d=block_d, tape=tape)


@functools.lru_cache(maxsize=256)
def _bwd_plan(bsz: int, seq: int, d_inner: int, d_state: int, chunk: int,
              dtype: torch.dtype, block_d: int) -> StreamPlan:
    return ssm_bwd_plan(bsz, seq, d_inner, d_state, chunk=chunk, dtype=dtype,
                        block_d=block_d)


def _check_operands(x, dt, b, c, a, d, dy=None) -> None:
    """The shape and device checks both directions make."""
    if x.dim() != 3 or dt.shape != x.shape or b.dim() != 3 or c.shape != b.shape \
            or b.shape[:2] != x.shape[:2] or a.shape != (x.shape[2], b.shape[2]) \
            or d.shape != (x.shape[2],) or (dy is not None and dy.shape != x.shape):
        raise ValueError(f"bad selective-scan shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)} a{tuple(a.shape)} "
                         f"d{tuple(d.shape)}"
                         + (f" dy{tuple(dy.shape)}" if dy is not None else ""))
    if any(t.device != x.device for t in (dt, b, c, a, d, *(() if dy is None else (dy,)))):
        raise ValueError("selective-scan operands on different devices")


def _check_kernel_operands(name: str, x, dt, b, c, a, d, *streams) -> None:
    """What the CUDA kernels take: ``x, dt, b, c`` (and ``streams``) of one
    dtype, float32 or bfloat16, float32 A and D, d_state 8 or 16,
    contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c, *streams)):
        raise TypeError(f"{name} streams x, dt, b, c of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {dt.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 A and D, got {a.dtype}, {d.dtype}")
    if a.shape[1] not in _D_STATES:
        raise ValueError(f"the {name} kernel supports d_state {_D_STATES}, not {a.shape[1]}")
    if not all(t.is_contiguous() for t in (x, dt, b, c, a, d, *streams)):
        raise ValueError(f"{name} needs contiguous operands")


def _lanes(lanes: int | None, x: torch.Tensor, d_state: int) -> int:
    """``lanes`` checked, or :func:`lanes_for`'s choice when None."""
    if lanes is None:
        return lanes_for(x.shape[0], x.shape[2], d_state, pipeline.sm_count(x.device))
    if lanes in LANE_CHOICES and 2 * lanes > d_state:
        raise ValueError(f"{lanes} lanes per channel leave less than a pair of d_state "
                         f"{d_state} to each")
    return lanes


#: fp32 operations per (position, channel, state) of the scan, as
#: :func:`ssm_plan` prices it: the decay, the state update, y's contraction
SSM_FLOPS = 10.0
#: the scan's backward as a function of (x, Δ, B, C, A, D, dy): fp32
#: operations per (position, channel, state) that it needs, with each
#: position's exp(Δ_t A) taken once. The states h_{t-1} are not among its
#: inputs, so one forward walk is part of the work (Δ_t A, the update's
#: product and fma: 4); the reverse step: g's fma, g·e, that times h_{t-1},
#: dA's fma, the two sums over states (Σ A g e h, Σ g B: an fma each), the
#: dB and dC terms and their sums over channels (14). The kernel's own
#: overheads (the checkpoint tape, the partials, the sums' data movement)
#: are its design, not the function's work, and are not counted.
SSM_BWD_FLOPS = 18.0


def cost(bsz: int, seq: int, d_inner: int, d_state: int, itemsize: int) -> KernelCost:
    """The scan's work: :data:`SSM_FLOPS` fp32 operations a (position,
    channel, state); x, Δ, B, C read and y written once in the streams'
    dtype, the fp32 A and D read once."""
    nbytes = (3 * bsz * seq * d_inner + 2 * bsz * seq * d_state) * itemsize \
        + (d_inner * d_state + d_inner) * 4
    return KernelCost(SSM_FLOPS * bsz * seq * d_inner * d_state, float(nbytes), "fp32")


def bwd_cost(bsz: int, seq: int, d_inner: int, d_state: int, itemsize: int) -> KernelCost:
    """The backward's work: :data:`SSM_BWD_FLOPS` fp32 operations a
    (position, channel, state); x, Δ, B, C, dy read and dx, dΔ, dB, dC
    written once in the streams' dtype, the fp32 A and D read and dA and dD
    written once."""
    nbytes = (5 * bsz * seq * d_inner + 4 * bsz * seq * d_state) * itemsize \
        + 2 * (d_inner * d_state + d_inner) * 4
    return KernelCost(SSM_BWD_FLOPS * bsz * seq * d_inner * d_state, float(nbytes), "fp32")


def _call_cost(x, dt, b, c, a, d, *rest, **kw):
    return cost(*x.shape, a.shape[1], x.element_size())


def _bwd_call_cost(x, dt, b, c, a, d, *rest, **kw):
    return bwd_cost(*x.shape, a.shape[1], x.element_size())


@counted("ssm_scan", _call_cost)
def ssm_scan(
    x: torch.Tensor,      # (B, L, d_inner)
    dt: torch.Tensor,     # (B, L, d_inner)   Δ, already softplus'd
    b: torch.Tensor,      # (B, L, d_state)
    c: torch.Tensor,      # (B, L, d_state)
    a: torch.Tensor,      # (d_inner, d_state)  negative
    d: torch.Tensor,      # (d_inner,) skip
    *,
    chunk: int = 128,
    lanes: int | None = None,
) -> torch.Tensor:
    """Selective scan over the sequence stream; returns y: (B, L, d_inner)
    in ``x``'s dtype.

    CUDA tensors go to the kernel: contiguous x, Δ, B, C of one dtype
    (float32 or bfloat16), float32 A and D, d_state 8 or 16, each channel's
    state split over ``lanes`` lanes (2, 4 or 8, at most d_state / 2;
    :func:`lanes_for` when None). CPU tensors go to
    :func:`repro_torch.kernels.ref.ssm_scan_ref`. Where grad mode is on and
    an operand requires grad, the call goes through :class:`SelectiveScan`,
    whose forward also writes the backward's checkpoint tape and whose
    backward is :func:`ssm_scan_bwd`.
    """
    _check_operands(x, dt, b, c, a, d)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, b, c, a, d)):
        return SelectiveScan.apply(x, dt, b, c, a, d, chunk, lanes)
    return _forward(x, dt, b, c, a, d, chunk, lanes)[0]


@counted("ssm_scan", _call_cost)
def ssm_scan_with_tape(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a: torch.Tensor, d: torch.Tensor,
    *,
    chunk: int = 128,
    lanes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """y and the backward's checkpoint tape from one forward launch, as
    :class:`SelectiveScan`'s forward runs it: y is the same bits as
    :func:`ssm_scan`'s, the tape the state after every :data:`SEGMENT`
    positions but the last (:func:`bwd_work_shapes`' "h_ckpt"), the same
    bits for every ``lanes``; None where it holds no state, and on CPU
    tensors (whose backward needs none)."""
    _check_operands(x, dt, b, c, a, d)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _forward(x, dt, b, c, a, d, chunk, lanes, tape=True)


def _forward(x, dt, b, c, a, d, chunk: int, lanes: int | None,
             tape: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """y, and with ``tape`` on CUDA tensors the backward's checkpoint tape
    (:func:`bwd_work_shapes`' "h_ckpt", written by the same launch; None
    where it holds no state, and on the CPU)."""
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, dt, b, c, a, d), None
    _check_kernel_operands("ssm_scan", x, dt, b, c, a, d)
    bsz, seq, d_inner = x.shape
    d_state = a.shape[1]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y, None
    h_ckpt = None
    if tape:
        shape = bwd_work_shapes(bsz, seq, d_inner, d_state)["h_ckpt"]
        if shape[1]:
            h_ckpt = torch.empty(shape, dtype=torch.float32, device=x.device)
    lanes = _lanes(lanes, x, d_state)
    block_d, ck, seq_p = launch_geometry(seq, chunk, lanes, x.element_size())
    launch = pipeline.lower(_plan(bsz, seq_p, d_inner, d_state, ck, x.dtype, block_d,
                                  h_ckpt is not None), "bsps_ssm_scan", x.device)
    pipeline.launch(launch, x.device, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                    c.data_ptr(), a.data_ptr(), d.data_ptr(), y.data_ptr(),
                    None if h_ckpt is None else h_ckpt.data_ptr(),
                    seq, d_inner, d_state, ck, block_d, 0 if h_ckpt is None else SEGMENT,
                    _DTYPES[x.dtype])
    ssm_scan.launches += 1
    return y, h_ckpt


ssm_scan.launches = 0


@counted("ssm_scan_bwd", _bwd_call_cost)
def ssm_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
    *,
    tape: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, dΔ, dB, dC, dA, dD)`` of :func:`ssm_scan` for
    the output gradient ``dy``, each in its input's dtype.

    CUDA tensors go to the backward kernel, which takes what the forward
    takes (and ``dy`` in x's dtype, contiguous) and the forward's
    checkpoint tape (fp32, :func:`bwd_work_shapes`' "h_ckpt"; where
    ``tape`` is None and the sequence is longer than a segment, a forward
    launch with the tape makes it first, counted as an ``ssm_scan``
    launch): the same bits for every batch and run. CPU tensors go to
    :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`.
    """
    _check_operands(x, dt, b, c, a, d, dy)
    if x.device.type == "cpu":
        return ref.ssm_scan_bwd_ref(x, dt, b, c, a, d, dy)
    _check_kernel_operands("ssm_scan_bwd", x, dt, b, c, a, d, dy)
    bsz, seq, d_inner = x.shape
    d_state = a.shape[1]
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(b),
             torch.empty_like(c), torch.empty_like(a), torch.empty_like(d))
    if x.numel() == 0:
        return tuple(g.zero_() for g in grads)
    _, block_d, seg, stage = bwd_geometry(d_state)
    shapes = bwd_work_shapes(bsz, seq, d_inner, d_state)
    if not shapes["h_ckpt"][1]:
        tape = None
    elif tape is None:
        tape = _forward(x, dt, b, c, a, d, 128, None, tape=True)[1]
    elif tape.shape != shapes["h_ckpt"] or tape.dtype != torch.float32 \
            or tape.device != x.device or not tape.is_contiguous():
        raise ValueError(f"ssm_scan_bwd takes the forward's fp32 tape of shape "
                         f"{shapes['h_ckpt']}, not {tape.dtype} {tuple(tape.shape)}")
    work = [torch.empty(shapes[k], dtype=torch.float32, device=x.device)
            for k in ("dbc", "dA", "dD")]
    seq_p = math.ceil(seq / stage) * stage
    launch = pipeline.lower(_bwd_plan(bsz, seq_p, d_inner, d_state, stage, x.dtype, block_d),
                            "bsps_ssm_scan_bwd", x.device)
    pipeline.launch(launch, x.device, *(t.data_ptr() for t in (x, dt, b, c, a, d, dy)),
                    None if tape is None else tape.data_ptr(),
                    *(g.data_ptr() for g in grads), *(w.data_ptr() for w in work),
                    seq, d_inner, d_state, stage, block_d, seg, shapes["dbc"][3],
                    _DTYPES[x.dtype])
    ssm_scan_bwd.launches += 1
    return grads


ssm_scan_bwd.launches = 0


def bwd_kernel_attrs(d_state: int, dtype: torch.dtype,
                     device: torch.device) -> dict[str, int]:
    """The backward kernel's ``registers`` and ``spill_bytes`` a thread,
    ``smem_bytes`` a block and ``blocks_per_sm`` at ``d_state`` and
    ``dtype`` on ``device``, as the CUDA runtime reports them."""
    regs, spill, smem, blocks = pipeline.kernel_attrs(
        "bsps_ssm_scan_bwd_attrs", device, d_state, _DTYPES[dtype])
    return {"registers": regs, "spill_bytes": spill, "smem_bytes": smem,
            "blocks_per_sm": blocks}


class SelectiveScan(torch.autograd.Function):
    """The selective scan, differentiable: the forward kernel, writing the
    backward's checkpoint tape beside y, then :func:`ssm_scan_bwd`'s kernel
    for the gradients of all six operands. It saves the operands and the
    tape (the state every :data:`SEGMENT` positions), not the states: the
    backward recomputes them from the tape. On CPU tensors the plain pair
    runs (``ssm_scan_ref``, ``ssm_scan_bwd_ref``) and no tape is saved."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, chunk: int = 128, lanes: int | None = None):
        y, tape = _forward(x, dt, b, c, a, d, chunk, lanes, tape=True)
        ctx.save_for_backward(x, dt, b, c, a, d, *(() if tape is None else (tape,)))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, b, c, a, d, *tape = ctx.saved_tensors
        grads = ssm_scan_bwd(x, dt, b, c, a, d, dy.contiguous(), tape=tape[0] if tape else None)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)

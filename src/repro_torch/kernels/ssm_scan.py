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
:func:`ssm_bwd_plan`) keeps that grid and those lane groups. Each block
walks its channels forward once, storing the state before every segment of
:func:`bwd_segment` positions to an fp32 checkpoint tape, then walks the
segments in reverse, recomputing each segment's states from its checkpoint
and carrying ∂L/∂h back through them. dB and dC sum over channels of other
tiles, dA and dD over rows: the kernel writes fp32 partials (per group of
16 channels, per row) and a second kernel of the same launch sums them in a
fixed order, so the gradients are the same bits for every lane count,
batch and run. :class:`SelectiveScan` makes the scan differentiable:
:func:`ssm_scan` goes through it where a gradient is being taken.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.kernels import pipeline, ref

__all__ = ["ssm_scan", "ssm_scan_bwd", "SelectiveScan", "ssm_plan", "ssm_bwd_plan",
           "bwd_segment", "bwd_work_shapes", "launch_geometry", "lanes_for", "LANE_CHOICES",
           "STAGE_BYTES", "MIN_WARPS_PER_SM"]

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
#: channels per dB/dC partial of the backward (the tile at 8 lanes; the
#: kernel's kGroup, which its entry checks)
GROUP = 16


def ssm_plan(
    bsz: int, seq: int, d_inner: int, d_state: int,
    *,
    chunk: int, dtype=torch.float32, param_dtype=torch.float32,
    block_d: int | None = None,
) -> StreamPlan:
    """StreamPlan for the chunked selective scan on a padded sequence.

    ~10·d_inner·d_state FLOPs per scanned position (exp/decay, state update,
    output contraction), times ``chunk`` positions per hyperstep.
    ``param_dtype`` prices the resident A/D operands, which the model keeps
    in fp32 even for bf16 activation streams.

    ``block_d=None`` is the JAX package's plan. ``block_d`` gives the CUDA
    launch plan: channel tiles of ``block_d`` (the last one ragged, padded
    in the plan) as a second "parallel" axis, the state a
    (block_d, d_state) scratch per tile.
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
    return StreamPlan(
        name=f"ssm_b{bsz}_{seq}x{d_pad}x{d_state}_c{chunk}_d{block_d}",
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
        outputs=(
            TokenSpec("y", (1, chunk, block_d), lambda i, k, j: (i, j, k),
                      dtype=dtype, full_shape=(bsz, seq, d_pad), direction="up"),
        ),
        scratch=(ScratchSpec("h", (block_d, d_state), torch.float32),),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=10.0 * chunk * block_d * d_state,
    )


def ssm_bwd_plan(
    bsz: int, seq: int, d_inner: int, d_state: int,
    *,
    chunk: int, block_d: int, dtype=torch.float32,
) -> StreamPlan:
    """The backward's launch plan: the forward's grid (batch, channel
    tiles, segments of ``chunk`` positions) = ("parallel", "parallel",
    "arbitrary"), each block walking its segments forward and then back.

    It streams x, Δ, B and dy (and C on the way back) and writes dx and dΔ
    per segment; the checkpoint tape ("h_ckpt", the state before each
    segment) goes up on the forward sweep and comes back down on the
    reverse one; "dbc" holds each segment's dB/dC partials per group of
    :data:`GROUP` channels, "dA"/"dD" each (row, tile)'s sums over its
    positions, written once; their shapes are :func:`bwd_work_shapes`' at
    the plan's padded sizes. The scratch is the per-tile state h and its
    gradient g, (block_d, d_state) fp32 each, which the kernel keeps in
    registers. About 22·d_state FLOPs per position and channel: 4 on the
    forward sweep, 4 to recompute the segment, 14 on the reverse step.
    """
    if seq % chunk or block_d % GROUP:
        raise ValueError(f"seq {seq} must be padded to chunk {chunk}, block_d {block_d} "
                         f"a multiple of {GROUP}")
    tiles = math.ceil(d_inner / block_d)
    d_pad = tiles * block_d
    ng = block_d // GROUP
    work = bwd_work_shapes(bsz, seq, d_pad, d_state, seq // chunk)

    def stream(name, direction="down"):
        return TokenSpec(name, (1, chunk, block_d), lambda i, k, j: (i, j, k), dtype=dtype,
                         full_shape=(bsz, seq, d_pad), direction=direction)

    def shared(name):
        return TokenSpec(name, (1, chunk, d_state), lambda i, k, j: (i, j, 0), dtype=dtype,
                         full_shape=(bsz, seq, d_state))

    return StreamPlan(
        name=f"ssm_bwd_b{bsz}_{seq}x{d_pad}x{d_state}_c{chunk}_d{block_d}",
        grid=(bsz, tiles, seq // chunk),
        inputs=(
            stream("x"), stream("dt"), shared("B"), shared("C"), stream("dy"),
            TokenSpec("A", (block_d, d_state), lambda i, k, j: (k, 0),
                      dtype=torch.float32, full_shape=(d_pad, d_state), rate=0),
            TokenSpec("D", (1, block_d), lambda i, k, j: (0, k),
                      dtype=torch.float32, full_shape=(1, d_pad), rate=0),
        ),
        outputs=(
            stream("dx", "up"), stream("ddt", "up"),
            TokenSpec("h_ckpt", (1, 1, block_d, d_state), lambda i, k, j: (i, j, k, 0),
                      dtype=torch.float32, full_shape=work["h_ckpt"], direction="up"),
            TokenSpec("dbc", (1, chunk, 2, ng, d_state), lambda i, k, j: (i, j, 0, k, 0),
                      dtype=torch.float32, full_shape=work["dbc"], direction="up"),
            TokenSpec("dA", (1, block_d, d_state), lambda i, k, j: (i, k, 0),
                      dtype=torch.float32, full_shape=work["dA"], direction="up"),
            TokenSpec("dD", (1, block_d), lambda i, k, j: (i, k), dtype=torch.float32,
                      full_shape=work["dD"], direction="up"),
        ),
        scratch=(ScratchSpec("h", (block_d, d_state), torch.float32),
                 ScratchSpec("g", (block_d, d_state), torch.float32)),
        dimension_semantics=("parallel", "parallel", "arbitrary"),
        flops_per_hyperstep=22.0 * chunk * block_d * d_state,
    )


def bwd_segment(lanes: int, d_state: int) -> int:
    """Positions per segment of the backward: 8 where a lane holds 8
    states, else 16, so that a segment's recomputed states stay in
    registers (the kernel's ``seg_len``). The segment sets only where the
    checkpoints fall: the gradients are the same bits for any. The kernel's
    entry refuses a longer one."""
    return 8 if d_state // lanes >= 8 else 16


def bwd_work_shapes(bsz: int, seq: int, d_inner: int, d_state: int,
                    n_segments: int) -> dict[str, tuple[int, ...]]:
    """The fp32 work buffers of one backward launch: the checkpoint tape,
    the dB/dC partials per group of :data:`GROUP` channels, and the
    per-row dA and dD. The one description of them: :func:`ssm_bwd_plan`
    prices them at its padded sizes, :func:`ssm_scan_bwd` allocates them
    at the operands' and passes the kernel the group count and
    :data:`GROUP`, which its entry checks against its own layout."""
    return {"h_ckpt": (bsz, n_segments, d_inner, d_state),
            "dbc": (bsz, seq, 2, -(-d_inner // GROUP), d_state),
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
          dtype: torch.dtype, block_d: int) -> StreamPlan:
    return ssm_plan(bsz, seq, d_inner, d_state, chunk=chunk, dtype=dtype,
                    block_d=block_d)


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
    whose backward is :func:`ssm_scan_bwd`.
    """
    _check_operands(x, dt, b, c, a, d)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, b, c, a, d)):
        return SelectiveScan.apply(x, dt, b, c, a, d, chunk, lanes)
    return _forward(x, dt, b, c, a, d, chunk, lanes)


def _forward(x, dt, b, c, a, d, chunk: int, lanes: int | None) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, dt, b, c, a, d)
    _check_kernel_operands("ssm_scan", x, dt, b, c, a, d)
    bsz, seq, d_inner = x.shape
    d_state = a.shape[1]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lanes = _lanes(lanes, x, d_state)
    block_d, ck, seq_p = launch_geometry(seq, chunk, lanes, x.element_size())
    launch = pipeline.lower(_plan(bsz, seq_p, d_inner, d_state, ck, x.dtype, block_d),
                            "bsps_ssm_scan", x.device)
    pipeline.launch(launch, x.device, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                    c.data_ptr(), a.data_ptr(), d.data_ptr(), y.data_ptr(),
                    seq, d_inner, d_state, ck, block_d, _DTYPES[x.dtype])
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0


def ssm_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
    *,
    lanes: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, dΔ, dB, dC, dA, dD)`` of :func:`ssm_scan` for
    the output gradient ``dy``, each in its input's dtype.

    CUDA tensors go to the backward kernel, which takes what the forward
    takes (and ``dy`` in x's dtype, contiguous): the same bits for every
    ``lanes``, batch and run. CPU tensors go to
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
    lanes = _lanes(lanes, x, d_state)
    block_d, ck, seq_p = launch_geometry(seq, bwd_segment(lanes, d_state), lanes,
                                         x.element_size())
    shapes = bwd_work_shapes(bsz, seq, d_inner, d_state, seq_p // ck)
    work = [torch.empty(shapes[k], dtype=torch.float32, device=x.device)
            for k in ("h_ckpt", "dbc", "dA", "dD")]
    launch = pipeline.lower(_bwd_plan(bsz, seq_p, d_inner, d_state, ck, x.dtype, block_d),
                            "bsps_ssm_scan_bwd", x.device)
    pipeline.launch(launch, x.device, *(t.data_ptr() for t in (x, dt, b, c, a, d, dy)),
                    *(g.data_ptr() for g in grads), *(w.data_ptr() for w in work),
                    seq, d_inner, d_state, ck, block_d, shapes["dbc"][3], GROUP,
                    _DTYPES[x.dtype])
    ssm_scan_bwd.launches += 1
    return grads


ssm_scan_bwd.launches = 0


class SelectiveScan(torch.autograd.Function):
    """The selective scan, differentiable: the forward kernel, then
    :func:`ssm_scan_bwd`'s kernel for the gradients of all six operands.
    It saves the operands, not the states: the backward recomputes them. On
    CPU tensors the plain pair runs (``ssm_scan_ref``, ``ssm_scan_bwd_ref``)."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, chunk: int = 128, lanes: int | None = None):
        ctx.save_for_backward(x, dt, b, c, a, d)
        ctx.lanes = lanes
        return _forward(x, dt, b, c, a, d, chunk, lanes)

    @staticmethod
    def backward(ctx, dy):
        grads = ssm_scan_bwd(*ctx.saved_tensors, dy.contiguous(), lanes=ctx.lanes)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)

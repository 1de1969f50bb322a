"""Two-level Cannon matmul: inner Cannon over ranks + BSPS outer streams (§3.2).

The *inner level* (:func:`cannon_matmul`) is the paper's Cannon algorithm
lifted from the Epiphany core grid to a grid of ranks: matrices are
block-distributed over the (data × model) mesh treated as an N×N grid; each
of the N steps multiplies the resident blocks and rotates A left / B up
with one ``batch_isend_irecv`` — the systolic schedule with zero data
redundancy the paper derives: per step exactly one block to each
neighbour per direction.

The *outer level* (Algorithm 2) is a hyperstep loop that streams M×M outer
blocks from external memory around an inner BSP program on the core grid:
:func:`cannon_plan` prices the whole construction with Eq. 2
(``T̃ = M³·max(N(2k³+2k²g+l), 2k²e)``), :func:`cannon_streams` lays out the
per-core pseudo-streams Σ^A (row-major, re-read M times via ``MOVE``) and
Σ^B (column-major, rewound once per row group), and
:func:`two_level_cannon` runs the product end to end through a multi-core
:class:`~repro_torch.core.hyperstep.HyperstepRunner` — one hyperstep per
outer block product, C blocks written back once per M hypersteps on the
cores' DMA lanes.

Without a mesh the N×N grid is N² virtual cores of one device, each with
its own streams and DMA lane, sharing the device's host link and
multiprocessors, and the inner program is the local product on the
assembled outer block. With ``mesh=`` and N > 1 it is :func:`cannon_matmul`
over the mesh's N×N ranks; every rank runs the same runner (the host
program, replicated as JAX's single controller is) and gathers each
hyperstep's product, since its write-back lanes hold every core's C piece.
Every local product is :func:`repro_torch.models.layers.ops_matmul`, which
launches the port's matmul kernel on CUDA tensors (``simt_f32`` for fp32
operands, ``wgmma`` for bf16) and runs its plain version on CPU tensors.

The accumulator keeps the operands' dtype, as the reference's does: a bf16
run adds its M partial products in bf16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hyperstep import HyperstepRunner
from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.core.stream import Stream, StreamSet
from repro_torch.device import resolve_device
from repro_torch.models.layers import ops_matmul

__all__ = [
    "cannon_matmul",
    "cannon_plan",
    "cannon_streams",
    "make_cannon_step",
    "make_cannon_step_compiled",
    "cannon_compiled_state",
    "cannon_move_schedule",
    "make_cannon_runner",
    "gather_c",
    "two_level_cannon",
]


def _exchange(pairs: list[tuple[torch.Tensor, int, int]]) -> list[torch.Tensor]:
    """Send each ``t`` to global rank ``to`` and receive a tensor of its
    shape from ``frm``, all in one ``batch_isend_irecv``; the received
    tensors, in order."""
    ops, got = [], []
    for t, to, frm in pairs:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, to), dist.P2POp(dist.irecv, buf, frm)]
        got.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def _local_block(x: Any, i: int, j: int, n: int, dmesh: Any, placements: tuple) -> torch.Tensor:
    """Block (i, j) of an N×N blocking of ``x``: the local shard of a
    DTensor (redistributed to ``placements`` first), a slice of a full
    tensor."""
    if hasattr(x, "to_local"):
        return x.redistribute(dmesh, placements).to_local()
    r, c = x.shape[0] // n, x.shape[1] // n
    return x[i * r:(i + 1) * r, j * c:(j + 1) * c]


def cannon_matmul(a: Any, b: Any, *, mesh: Any, axis_a: str = "data",
                  axis_b: str = "model") -> Any:
    """C = A @ B on an N×N (axis_a × axis_b) rank grid via Cannon rotation.

    Requires a square grid (``mesh.shape[axis_a] == mesh.shape[axis_b]``).
    ``a`` and ``b`` are full tensors (the same on every rank) or DTensors on
    ``mesh.device_mesh``; C is a DTensor sharded ``(axis_a, axis_b)``.
    Rank (i, j) starts from the skewed blocks A[i, i+j] and B[i+j, j] (A
    shifted left by i, B up by j), then N times adds its local product
    (:func:`~repro_torch.models.layers.ops_matmul`, rounded to the operand
    dtype) into an fp32 accumulator and passes A left and B up one block
    (not after the last product); C is the accumulator cast back to the
    operand dtype. A 1×1 grid sends nothing.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = mesh.shape[axis_a]
    if mesh.shape[axis_b] != n:
        raise ValueError(f"Cannon needs a square grid, got {mesh.shape}")
    if a.shape[0] % n or a.shape[1] % n or b.shape[1] % n:
        raise ValueError("matrix dims must divide the grid (paper pads zeros)")
    dmesh = mesh.device_mesh
    if dmesh is None:
        raise ValueError("cannon_matmul needs a mesh over a rank group")
    names = mesh.axis_names
    ia, ib = names.index(axis_a), names.index(axis_b)
    coord = dmesh.get_coordinate()
    i, j = int(coord[ia]), int(coord[ib])
    place = [Replicate()] * len(names)
    place[ia], place[ib] = Shard(0), Shard(1)
    place = tuple(place)
    a_blk = _local_block(a, i, j, n, dmesh, place)
    b_blk = _local_block(b, i, j, n, dmesh, place)

    def rank_at(ci: int, cj: int) -> int:
        pos = list(coord)
        pos[ia], pos[ib] = ci % n, cj % n
        return int(dmesh.mesh[tuple(pos)])

    # initial skew: A left by i (row i), B up by j (column j)
    if n > 1 and (i or j):
        pairs = []
        if i:
            pairs.append((a_blk, rank_at(i, j - i), rank_at(i, j + i)))
        if j:
            pairs.append((b_blk, rank_at(i - j, j), rank_at(i + j, j)))
        got = _exchange(pairs)
        if i:
            a_blk = got.pop(0)
        if j:
            b_blk = got.pop(0)
    acc = torch.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=torch.float32,
                      device=a_blk.device)
    for step in range(n):
        acc += ops_matmul(a_blk, b_blk).float()
        if step < n - 1:
            a_blk, b_blk = _exchange([(a_blk, rank_at(i, j - 1), rank_at(i, j + 1)),
                                      (b_blk, rank_at(i - 1, j), rank_at(i + 1, j))])
    c = acc.to(a_blk.dtype)
    shape = (a.shape[0], b.shape[1])
    return DTensor.from_local(c, dmesh, place, run_check=False, shape=torch.Size(shape),
                              stride=(shape[1], 1))


def _check_dims(n: int, m_blocks: int, n_grid: int) -> tuple[int, int]:
    """(outer block side K, per-core inner block side k) for n, M, N."""
    if m_blocks <= 0 or n_grid <= 0:
        raise ValueError(f"need m_blocks>0 and n_grid>0, got {m_blocks}, {n_grid}")
    if n % (m_blocks * n_grid) != 0:
        raise ValueError(
            f"n={n} must be divisible by M·N={m_blocks * n_grid} "
            "(paper pads with zeros)")
    big = n // m_blocks
    return big, big // n_grid


def _dtype_of(a: Any) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a)[:1, :1]).dtype


def cannon_plan(n: int, m_blocks: int, n_grid: int = 1, *,
                dtype: torch.dtype = torch.float32) -> StreamPlan:
    """The paper's two-level Cannon (Algorithm 2) as a StreamPlan (Eq. 2).

    Grid (i, j, s): one hyperstep per outer-block product C_ij += A_is·B_sj,
    M per axis. Token specs describe *one core* of the N×N inner grid — each
    fetches its k×k sub-block of A and B every hyperstep (k = n/(N·M)) and
    flushes its k×k piece of C when the plan moves off an (i, j) output
    block, i.e. once per M hypersteps. The non-injective A map (i, s) is the
    ``MOVE(Σ^A, −M)`` row-group reuse; the inner BSP program term is N
    supersteps of work 2k³ and h-relation 2k² each, so ``cost()`` is exactly
    Eq. 2's ``Σ max(N(2k³ + 2k²g + l), e·C)`` with the C-block write-back
    charged on flush hypersteps.
    """
    _, k = _check_dims(n, m_blocks, n_grid)
    side = m_blocks * k   # one core's slice of the full matrix
    return StreamPlan(
        name=f"cannon2_n{n}_M{m_blocks}_N{n_grid}",
        grid=(m_blocks, m_blocks, m_blocks),
        inputs=(
            TokenSpec("A", (k, k), lambda i, j, s: (i, s), dtype=dtype,
                      full_shape=(side, side)),
            TokenSpec("B", (k, k), lambda i, j, s: (s, j), dtype=dtype,
                      full_shape=(side, side)),
        ),
        outputs=(
            TokenSpec("C", (k, k), lambda i, j, s: (i, j), dtype=dtype,
                      full_shape=(side, side), direction="up"),
        ),
        scratch=(ScratchSpec("C_acc", (k, k), dtype),),
        dimension_semantics=("arbitrary", "arbitrary", "arbitrary"),
        flops_per_hyperstep=n_grid * 2.0 * k**3,
        comm_words_per_hyperstep=n_grid * 2.0 * k**2,
        supersteps_per_hyperstep=float(n_grid),
    )


def cannon_streams(
    a: Any, b: Any, m_blocks: int, n_grid: int = 1,
) -> tuple[list[list[Stream]], list[list[Stream]], StreamSet]:
    """Per-core stream sets for Algorithm 2 on an N×N core grid.

    Returns ``(ins, outs, stream_set)``: for each core (row-major order),
    ``ins[core] = [Σ^A, Σ^B]`` — the core's sub-blocks of A in row-major
    outer-block order and of B in column-major order (the layouts whose
    cursor walks are pure advances plus the ``MOVE`` seeks of
    :func:`cannon_move_schedule`) — and ``outs[core] = [Σ^C]``, a zeroed
    write-back stream with one token per outer C block. Numpy operands give
    numpy backings; tensors give tensors on their device (C pinned when A
    is, like the block grids).
    """
    n = a.shape[0]
    _, k = _check_dims(n, m_blocks, n_grid)
    ss = StreamSet()
    a_streams = ss.create_block_grid(a, m_blocks, n_grid, order="row", name="A")
    b_streams = ss.create_block_grid(b, m_blocks, n_grid, order="col", name="B")
    ins, outs = [], []
    for core in range(n_grid * n_grid):
        shape = (m_blocks * m_blocks, k, k)
        if isinstance(a, torch.Tensor):
            c_backing = torch.zeros(shape, dtype=a.dtype, device=a.device,
                                    pin_memory=a.is_pinned())
        else:
            c_backing = np.zeros(shape, np.asarray(a).dtype)
        sc = ss.create(c_backing, 1, name=f"C[{core // n_grid},{core % n_grid}]")
        ins.append([a_streams[core], b_streams[core]])
        outs.append([sc])
    return ins, outs, ss


def cannon_move_schedule(m_blocks: int):
    """The ``MOVE`` calls of Algorithm 2 as an ``on_hyperstep_end`` callback.

    Called with the hyperstep m whose tokens were just fetched; positions the
    cursors for hyperstep m+1 of the (i, j, s) grid walk: at the end of an
    outer product (s wraps), Σ^A seeks −M to replay row group i for the next
    j (``MOVE(Σ^A, −M)``), and at the end of a row group (j also wraps) Σ^B
    rewinds −M² for the next i (``MOVE(Σ^B, −M²)``). Works on the nested
    per-core stream sets of the multi-core runner.
    """
    total = m_blocks**3

    def on_end(m: int, per_core_streams) -> None:
        if m + 1 >= total:
            return
        j, s = (m // m_blocks) % m_blocks, m % m_blocks
        if s != m_blocks - 1:
            return
        for core, (sa, sb) in enumerate(per_core_streams):
            if j < m_blocks - 1:
                sa.seek(core, -m_blocks)
            else:
                sb.seek(core, -m_blocks * m_blocks)

    return on_end


def _assemble_grid(blocks: list, n_grid: int) -> torch.Tensor:
    """Per-core (1, k, k) tokens (row-major core order) -> the global block.

    A device copy for N > 1 (2·K² elements a hyperstep for A and B), which
    the runner counts as compute time; the token itself for N = 1."""
    if n_grid == 1:
        return blocks[0][0]
    rows = [torch.cat([t[0] for t in blocks[ci * n_grid:(ci + 1) * n_grid]], dim=1)
            for ci in range(n_grid)]
    return torch.cat(rows, dim=0)


def _split_grid(block: torch.Tensor, n_grid: int) -> list[torch.Tensor]:
    """The global C block -> per-core (k, k) pieces (views), row-major core order."""
    k = block.shape[0] // n_grid
    return [block[ci * k:(ci + 1) * k, cj * k:(cj + 1) * k]
            for ci in range(n_grid) for cj in range(n_grid)]


def _inner(n_grid: int, mesh: Any, axis_a: str, axis_b: str):
    """The per-hyperstep product of the assembled outer blocks: Cannon over
    ``mesh``'s ranks, gathered to every rank (N > 1 with a mesh), else the
    local product."""
    if mesh is not None and n_grid > 1:
        return lambda x, y: cannon_matmul(x, y, mesh=mesh, axis_a=axis_a,
                                          axis_b=axis_b).full_tensor()
    return ops_matmul


def make_cannon_step(m_blocks: int, n_grid: int = 1, *, mesh: Any = None,
                     axis_a: str = "data", axis_b: str = "model"):
    """The per-hyperstep inner BSP program of two-level Cannon (measure mode).

    State is ``(s, acc)`` — the position within the current outer product and
    the accumulated C block (the plan's ``C_acc`` scratch). Each hyperstep
    assembles the cores' A/B tokens into the outer block, runs the inner
    Cannon (:func:`cannon_matmul` on ``mesh``; the local product when
    ``mesh`` is None or the grid is 1×1) and accumulates; when s wraps, the
    finished C block is split back into per-core tokens for the runner's
    write-back lanes. The pieces stay on the device: the lanes copy them
    up, so the step never waits for the card.
    """
    inner = _inner(n_grid, mesh, axis_a, axis_b)

    def step(state, toks):
        s, acc = state
        part = inner(_assemble_grid(toks[0], n_grid), _assemble_grid(toks[1], n_grid))
        acc = part if acc is None else acc + part
        if s == m_blocks - 1:
            return (0, None), [_split_grid(acc, n_grid)]
        return (s + 1, acc), [None]   # no C flush mid outer product

    return step


def make_cannon_step_compiled(m_blocks: int, n_grid: int = 1, *, mesh: Any = None,
                              axis_a: str = "data", axis_b: str = "model"):
    """The compiled-mode twin of :func:`make_cannon_step`.

    State is ``(s, acc)`` with ``s`` a host position counter (no device
    read) and ``acc`` a device tensor, restarted from the product when a new
    outer product begins; the per-core C pieces are returned *every*
    hyperstep, and the runner's ``out_every`` flush mask keeps only the ones
    where the outer product completes. Initial state comes from
    :func:`cannon_compiled_state`; ``mesh`` as in :func:`make_cannon_step`.
    """
    inner = _inner(n_grid, mesh, axis_a, axis_b)

    def step(state, toks):
        s, acc = state
        part = inner(_assemble_grid(toks[0], n_grid),
                     _assemble_grid(toks[1], n_grid)).to(acc.dtype)
        acc = part if s == 0 else acc + part
        return ((s + 1) % m_blocks, acc), [_split_grid(acc, n_grid)]

    return step


def cannon_compiled_state(n: int, m_blocks: int, dtype: torch.dtype = torch.float32,
                          device: Any = None) -> tuple[int, torch.Tensor]:
    """Initial ``(s, acc)`` carry for :func:`make_cannon_step_compiled`."""
    big = n // m_blocks
    return 0, torch.zeros((big, big), dtype=dtype, device=resolve_device(device))


def gather_c(outs: list[list[Stream]], n: int, m_blocks: int, n_grid: int = 1) -> Any:
    """Reassemble C from the per-core write-back streams' backings (numpy
    backings give a numpy array, tensor backings a tensor on their device)."""
    big, k = _check_dims(n, m_blocks, n_grid)
    first = outs[0][0].data
    if isinstance(first, torch.Tensor):
        c = torch.zeros((n, n), dtype=first.dtype, device=first.device)
    else:
        c = np.zeros((n, n), first.dtype)
    for core, (sc,) in enumerate(outs):
        ci, cj = divmod(core, n_grid)
        for i in range(m_blocks):
            for j in range(m_blocks):
                c[i * big + ci * k: i * big + (ci + 1) * k,
                  j * big + cj * k: j * big + (cj + 1) * k] = sc.data[i * m_blocks + j]
    return c


def make_cannon_runner(
    a: Any,
    b: Any,
    m_blocks: int,
    *,
    n_grid: int = 1,
    mesh: Any = None,
    machine=None,
    plan: StreamPlan | None = None,
    compiled: bool = True,
    verify: bool = True,
    device: Any = None,
) -> tuple[HyperstepRunner, list[list[Stream]], Any]:
    """Build (but do not run) the Algorithm 2 runner; returns (runner, outs,
    initial state).

    ``a`` and ``b`` are numpy arrays (the host's external memory) or
    tensors (bf16 operands have no numpy dtype); a pinned CPU tensor lets
    the measure-mode lanes copy tokens to the card without staging them
    through pinned memory first. ``device`` is where the tokens are staged
    and multiplied: the card unless the caller names the CPU. ``mesh`` (a
    mesh over a rank group whose ``data`` and ``model`` axes are the N×N
    grid) runs the inner product as :func:`cannon_matmul` over its ranks.

    Reusable across runs — repeated ``runner.run(state,
    num_hypersteps=m_blocks**3, compiled=...)`` calls replay the product.
    ``verify=True`` statically replays the MOVE schedule before the first
    dispatch — the non-injective down-stream maps are legal reuse and pass
    clean; a corrupted seek schedule raises ``PlanVerificationError``
    instead of corrupting C.
    """
    n = a.shape[0]
    if tuple(a.shape) != (n, n) or tuple(b.shape) != (n, n):
        raise ValueError(f"need square same-shape matrices, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    _check_dims(n, m_blocks, n_grid)
    if mesh is not None and n_grid > 1:
        shape = dict(mesh.shape)
        if shape.get("data") != n_grid or shape.get("model") != n_grid:
            raise ValueError(
                f"mesh shape {shape} does not match the {n_grid}×{n_grid} grid")
    device = resolve_device(device)
    dtype = _dtype_of(a)
    if plan is None:
        plan = cannon_plan(n, m_blocks, n_grid, dtype=dtype)
    if not isinstance(a, torch.Tensor):
        a, b = np.asarray(a), np.asarray(b)
    ins, outs, _ = cannon_streams(a, b, m_blocks, n_grid)
    if compiled:
        step = make_cannon_step_compiled(m_blocks, n_grid, mesh=mesh)
        state0: Any = cannon_compiled_state(n, m_blocks, dtype, device)
    else:
        step = make_cannon_step(m_blocks, n_grid, mesh=mesh)
        state0 = (0, None)
    runner = HyperstepRunner(
        step,
        ins,
        cores=n_grid * n_grid,
        out_streams=outs,
        out_every=[m_blocks],
        on_hyperstep_end=cannon_move_schedule(m_blocks),
        plan=plan,
        machine=machine,
        verify=verify,
        device=device,
    )
    return runner, outs, state0


def two_level_cannon(
    a: Any,
    b: Any,
    m_blocks: int,
    *,
    n_grid: int = 1,
    mesh: Any = None,
    machine=None,
    plan: StreamPlan | None = None,
    compiled: bool = True,
    device: Any = None,
) -> tuple[Any, HyperstepRunner]:
    """C = A·B per Algorithm 2 on a (virtual) N×N core grid; returns (C, runner).

    The full paper construction: an outer hyperstep loop streaming M×M outer
    blocks (Σ^A re-read M times via ``MOVE``), the inner Cannon over
    ``mesh``'s ranks (the local product on the assembled block without a
    mesh or on a 1×1 grid) as the per-hyperstep BSP program, C flushed up
    once per outer product. By default the whole loop runs as one compiled replay
    (``HyperstepRunner.compile`` — the MOVE schedule becomes static gather
    indices over streams staged once on the device); pass ``compiled=False``
    for the instrumented host loop with per-hyperstep records. With
    ``machine`` given the runner prices the run with Eq. 2 — read
    ``runner.predicted_vs_measured()`` after. C comes back in the operands'
    kind (numpy for numpy operands).
    """
    n = a.shape[0]
    runner, outs, state0 = make_cannon_runner(
        a, b, m_blocks, n_grid=n_grid, mesh=mesh, machine=machine, plan=plan,
        compiled=compiled, device=device)
    # explicit count: the seek-based MOVE reuse means the naive stream budget
    # (M² A tokens) undercounts the M³ hypersteps the walk actually performs
    runner.run(state0, num_hypersteps=m_blocks**3, compiled=compiled)
    return gather_c(outs, n, m_blocks, n_grid), runner

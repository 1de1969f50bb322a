"""StreamPlan — declarative BSPS kernel plans scored by the paper's cost model.

A :class:`StreamPlan` is the repo's single description of a bulk-synchronous
pseudo-streaming computation (DESIGN.md §3): which token (block) of each
stream is resident at every hyperstep, what persistent local state the core
keeps between hypersteps, and how much work one hyperstep does. The same
object serves three consumers:

* :func:`repro_torch.kernels.pipeline.lower` turns a chip-level plan into a
  CUDA launch — grid, in-block loop count, shared-memory request. No kernel
  module launches a kernel itself.
* :class:`repro_torch.core.hyperstep.HyperstepRunner` accepts a host-level
  plan (built from :class:`~repro_torch.core.stream.Stream` objects via
  :func:`host_plan`) and reports its measured hyperstep timings next to the
  plan's prediction.
* The planner (:func:`autotune`) enumerates candidate token sizes under the
  double-buffered local-memory budget (the paper's "prefetching halves the
  effective local memory", :meth:`BSPAccelerator.max_token_words`), scores
  each candidate with :func:`repro_torch.core.cost.bsps_cost`
  ``T̃ = Σ_h max(T_h, e·ΣC_i)`` and picks the predicted-fastest — the paper's
  central claim that the cost function *selects* parameters, not merely
  reports them.

Token reuse (the paper's ``MOVE(Σ, -M)``) is expressed as a *non-injective*
index map: the fetch schedule only charges ``e·C_i`` on hypersteps where the
resident block index actually changes, so revisited tokens are free exactly
like a cursor seek that stays put. Skipped work (the paper's "we are allowed
to revisit or skip tokens") is expressed by a per-hyperstep ``flops`` callable
that may return 0 for masked-out steps (causal attention).

Streams are bidirectional (paper §4: ``bsp_stream_move_up`` writes results
back): every :class:`TokenSpec` carries a ``direction``, Eq. 1 charges the up
side through :meth:`StreamPlan.writeback_schedule` exactly as it charges the
fetch side, and a per-hyperstep advance ``rate`` distinguishes resident
operands (rate 0) from streams that consume several tokens per hyperstep.

Dtypes are torch dtypes (or numpy dtypes for host-side streams) with the
itemsizes of the JAX package's; the fingerprint names them the way the JAX
package does (``"bfloat16"``), so a plan and its JAX twin fingerprint alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.cost import HyperstepCost, bsps_cost

__all__ = [
    "TokenSpec",
    "ScratchSpec",
    "StreamPlan",
    "PlanChoice",
    "host_plan",
    "streamed_operand",
    "enumerate_plans",
    "autotune",
    "median_seconds",
    "dtype_name",
    "dtype_itemsize",
]

# Above this many hypersteps the exact per-step fetch schedule is not
# enumerated; cost() falls back to the closed form H·max(mean_flops, e·ΣC_i).
# Its fetch side charges every streamed token every hyperstep (exact for
# dense matmul, an over-count for reuse patterns), but the compute side is a
# per-step *average*, so for plans with skipped hypersteps on compute-bound
# machines the closed form can sit slightly below the exact Eq. 1 sum — it is
# an estimate, not a bound. Keeps planning O(1) for production-sized grids.
ENUMERATION_LIMIT = 1 << 18


def dtype_name(dtype: Any) -> str:
    """The dtype's name as the JAX package spells it (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def dtype_itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class TokenSpec:
    """One stream's token as resident in local memory.

    ``block_shape`` is the token shape C_i (in elements); ``index_map`` maps
    grid coordinates -> block index (the BlockSpec contract of the JAX package).
    Non-injective maps encode token reuse (``MOVE``); a constant map encodes a
    fully resident operand (fetched once, hyperstep 0).

    ``direction`` is the side of the external link the token moves on:
    ``"down"`` tokens are prefetched (``bsp_stream_move_down``), ``"up"``
    tokens are finished results written back (``bsp_stream_move_up``). Eq. 1
    prices both — the same C_i charge, opposite direction, one shared link.

    ``rate`` is the per-hyperstep cursor advance at the host level: rate-0
    tokens are resident operands (fetched once, single-buffered — no prefetch
    buffer needed), rate-k tokens advance k stream tokens per hyperstep. At
    the chip level the index map is authoritative and ``rate`` is descriptive.

    ``full_shape`` is the backing array's shape in external memory — required
    for output tokens (it becomes the ``out_shape`` of the lowered call),
    optional for inputs.
    """

    name: str
    block_shape: tuple[int, ...]
    index_map: Callable[..., tuple[int, ...]]
    dtype: Any = torch.float32
    full_shape: tuple[int, ...] | None = None
    direction: str = "down"
    rate: int = 1

    def __post_init__(self) -> None:
        if self.direction not in ("down", "up"):
            raise ValueError(f"direction must be 'down' or 'up', got {self.direction!r}")
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")

    @property
    def words(self) -> int:
        """Token size C_i in words (elements)."""
        return int(np.prod(self.block_shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.words * dtype_itemsize(self.dtype)

    @property
    def resident(self) -> bool:
        """Rate-0 tokens stay in local memory for the whole pass."""
        return self.rate == 0


@dataclasses.dataclass(frozen=True)
class ScratchSpec:
    """Persistent local state (the paper's partial results, e.g. the C block
    of Cannon or flash attention's (m, l, acc)). Lives in local memory for the
    whole stream pass; never moves on the external link."""

    name: str
    shape: tuple[int, ...]
    dtype: Any = torch.float32

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * dtype_itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """A BSPS kernel as data: grid of hypersteps, token specs, scratch, work.

    ``flops_per_hyperstep`` is either a number (uniform hypersteps) or a
    callable over grid coordinates (pseudo-streaming skips — return ~0 for
    steps whose token is skipped). ``mean_flops_per_hyperstep`` backs the
    closed-form cost path for grids too large to enumerate.

    A hyperstep's compute side may itself be an *inner BSP program* on the
    p-core grid (the paper's two-level construction, Eq. 2):
    ``comm_words_per_hyperstep`` is the program's summed h-relation ``Σ_i h_i``
    in words, ``supersteps_per_hyperstep`` its superstep count — the cost
    functions then price each hyperstep's compute side as
    ``flops + g·comm + l·supersteps``, the ``max_s w_i(s) + g·h_i + l`` term
    summed over inner supersteps. Streamed token specs describe *one core's*
    streams (Eq. 1 takes the max over cores; on a homogeneous grid every core
    moves the same volume). Both default to 0: a plan without an inner
    program prices exactly as before.

    A hyperstep may additionally be one superstep of a *host-level* BSP
    program (DESIGN.md §8, the third pricing level):
    ``host_comm_words_per_hyperstep`` is the host-level h-relation (the max
    words one host exchanges with the others per hyperstep) and
    ``host_supersteps_per_hyperstep`` the number of host barriers, priced
    with the outer ``(g_host, l_host)`` pair of the accelerator — the
    superstep term applied recursively on top of the device-level ``max``:
    ``T_host = T_device + g_host·h_host + l_host·s_host``. Both default to
    0, so single-host plans price exactly as before.

    ``dimension_semantics`` marks each grid axis "parallel" or "arbitrary":
    the lowering makes "parallel" axes the CUDA grid and "arbitrary" axes
    the loop each block runs — the sequential hyperstep stream.
    """

    name: str
    grid: tuple[int, ...]
    inputs: tuple[TokenSpec, ...]
    outputs: tuple[TokenSpec, ...]
    scratch: tuple[ScratchSpec, ...] = ()
    dimension_semantics: tuple[str, ...] = ()
    flops_per_hyperstep: float | Callable[..., float] = 0.0
    mean_flops_per_hyperstep: float | None = None
    comm_words_per_hyperstep: float = 0.0
    supersteps_per_hyperstep: float = 0.0
    host_comm_words_per_hyperstep: float = 0.0
    host_supersteps_per_hyperstep: float = 0.0
    # memoised fetch/write-back schedules — the plan is frozen, walks are O(grid)
    _fetch_cache: list | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _writeback_cache: list | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        if not self.grid or any(g <= 0 for g in self.grid):
            raise ValueError(f"bad grid {self.grid}")
        if self.dimension_semantics and len(self.dimension_semantics) != len(self.grid):
            raise ValueError("dimension_semantics must match grid rank")
        for t in self.inputs:
            if t.direction != "down":
                raise ValueError(f"input token {t.name!r} must have direction 'down'")
        for t in self.outputs:
            if t.direction != "up":
                raise ValueError(f"output token {t.name!r} must have direction 'up'")
            if t.full_shape is None:
                raise ValueError(f"output token {t.name!r} needs full_shape")

    # -- hyperstep accounting ------------------------------------------------

    @property
    def num_hypersteps(self) -> int:
        return int(np.prod(self.grid, dtype=np.int64))

    def _flops_at(self, coords: tuple[int, ...]) -> float:
        f = self.flops_per_hyperstep
        return float(f(*coords)) if callable(f) else float(f)

    def fetch_schedule(self) -> list[int]:
        """Words streamed down *at* each hyperstep (arrival order).

        Walks the grid in execution order (last axis fastest) and
        charges a token's C_i only on steps where its block index changes —
        revisits (non-injective maps) and resident operands (constant maps)
        are fetched once, exactly the pseudo-streaming cursor semantics.
        Memoised (the plan is immutable); treat the result as read-only.
        """
        if self._fetch_cache is not None:
            return self._fetch_cache
        if self.num_hypersteps > ENUMERATION_LIMIT:
            raise ValueError(
                f"{self.name}: {self.num_hypersteps} hypersteps exceeds the "
                f"enumeration limit {ENUMERATION_LIMIT}; use cost(exact=False)"
            )
        fetched: list[int] = []
        prev: list[tuple[int, ...] | None] = [None] * len(self.inputs)
        for coords in itertools.product(*(range(g) for g in self.grid)):
            words = 0
            for idx, tok in enumerate(self.inputs):
                block = tuple(tok.index_map(*coords))
                if block != prev[idx]:
                    words += tok.words
                    prev[idx] = block
            fetched.append(words)
        object.__setattr__(self, "_fetch_cache", fetched)
        return fetched

    def writeback_schedule(self) -> list[int]:
        """Words streamed *up* at each hyperstep (``bsp_stream_move_up``).

        An output block is flushed over the external link when the plan moves
        off it: the enumerated schedule charges ``C_i`` on hypersteps whose
        output block index changes (the flush of the finished block overlaps
        that step's compute, like the prefetch it shares the link with), and
        the final hyperstep flushes every output's last block. Non-injective
        output maps therefore price revisited result blocks exactly once per
        visit run, symmetric with :meth:`fetch_schedule`.
        """
        if self._writeback_cache is not None:
            return self._writeback_cache
        if self.num_hypersteps > ENUMERATION_LIMIT:
            raise ValueError(
                f"{self.name}: {self.num_hypersteps} hypersteps exceeds the "
                f"enumeration limit {ENUMERATION_LIMIT}; use cost(exact=False)"
            )
        written = [0] * self.num_hypersteps
        prev: list[tuple[int, ...] | None] = [None] * len(self.outputs)
        for h, coords in enumerate(itertools.product(*(range(g) for g in self.grid))):
            for idx, tok in enumerate(self.outputs):
                block = tuple(tok.index_map(*coords))
                if prev[idx] is not None and block != prev[idx]:
                    written[h] += tok.words
                prev[idx] = block
        if written:
            written[-1] += sum(t.words for t in self.outputs)
        object.__setattr__(self, "_writeback_cache", written)
        return written

    # -- identity ------------------------------------------------------------

    # beyond this many hypersteps the fingerprint samples the index maps on a
    # bounded, deterministic subset of the grid instead of enumerating it
    FINGERPRINT_ENUMERATION_LIMIT = 4096

    def _fingerprint_coords(self) -> Iterable[tuple[int, ...]]:
        h_total = self.num_hypersteps
        if h_total <= self.FINGERPRINT_ENUMERATION_LIMIT:
            return itertools.product(*(range(g) for g in self.grid))
        picks = np.unique(np.linspace(
            0, h_total - 1, self.FINGERPRINT_ENUMERATION_LIMIT,
            dtype=np.int64))
        return (tuple(np.unravel_index(int(i), self.grid)) for i in picks)

    def fingerprint(self) -> str:
        """Stable identity of the plan's *lowering-relevant* structure.

        Covers name, grid, dimension semantics, every token spec (shape,
        dtype, full shape, direction, rate), scratch, and a digest of the
        index maps' behaviour over the grid (enumerated exactly for small
        grids, sampled deterministically above
        ``FINGERPRINT_ENUMERATION_LIMIT``) — i.e. everything
        :func:`repro_torch.kernels.pipeline.lower` reads. Two plans with
        equal fingerprints lower to the same launch, which is what lets the
        kernel layer cache lowered launches across plan rebuilds. Does not
        cover the cost-model fields (flops, comm words): they never reach the
        lowered kernel.
        """
        if getattr(self, "_fingerprint_cache", None) is not None:
            return self._fingerprint_cache
        digest = hashlib.sha1()

        def put(*vals: Any) -> None:
            digest.update(repr(vals).encode())

        put(self.name, self.grid, self.dimension_semantics)
        for t in (*self.inputs, *self.outputs):
            put(t.name, t.block_shape, dtype_name(t.dtype), t.full_shape,
                t.direction, t.rate)
        for s in self.scratch:
            put(s.name, s.shape, dtype_name(s.dtype))
        for coords in self._fingerprint_coords():
            for t in (*self.inputs, *self.outputs):
                put(tuple(t.index_map(*coords)))
        out = digest.hexdigest()
        object.__setattr__(self, "_fingerprint_cache", out)
        return out

    def hyperstep_costs(self) -> list[HyperstepCost]:
        """Exact per-hyperstep costs for :func:`repro_torch.core.cost.bsps_cost`.

        Eq. 1 charges hyperstep h with the fetch of hyperstep h+1's tokens
        (hyperstep 0's tokens are resident at program start), so the arrival
        schedule is shifted by one; write-backs are charged on the hyperstep
        whose compute they overlap (see :meth:`writeback_schedule`).
        """
        arrivals = self.fetch_schedule()
        writebacks = self.writeback_schedule()
        coords_iter = itertools.product(*(range(g) for g in self.grid))
        costs = []
        for h, coords in enumerate(coords_iter):
            nxt = arrivals[h + 1] if h + 1 < len(arrivals) else 0
            costs.append(
                HyperstepCost(
                    bsp_flops=self._flops_at(coords),
                    fetch_words=[float(nxt)],
                    writeback_words=[float(writebacks[h])],
                    comm_words=self.comm_words_per_hyperstep,
                    supersteps=self.supersteps_per_hyperstep,
                    host_comm_words=self.host_comm_words_per_hyperstep,
                    host_supersteps=self.host_supersteps_per_hyperstep,
                )
            )
        return costs

    @property
    def total_flops(self) -> float:
        if callable(self.flops_per_hyperstep):
            if self.num_hypersteps > ENUMERATION_LIMIT:
                if self.mean_flops_per_hyperstep is None:
                    raise ValueError(
                        f"{self.name}: callable flops on a "
                        f"{self.num_hypersteps}-step grid needs "
                        "mean_flops_per_hyperstep"
                    )
                return self.mean_flops_per_hyperstep * self.num_hypersteps
            return sum(
                self._flops_at(c)
                for c in itertools.product(*(range(g) for g in self.grid))
            )
        return float(self.flops_per_hyperstep) * self.num_hypersteps

    @property
    def mean_flops(self) -> float:
        """Per-hyperstep flops for the closed-form cost path."""
        if callable(self.flops_per_hyperstep):
            if self.mean_flops_per_hyperstep is not None:
                return self.mean_flops_per_hyperstep
            return self.total_flops / self.num_hypersteps
        return float(self.flops_per_hyperstep)

    def _superstep_terms(self, acc: BSPAccelerator) -> float:
        """Per-hyperstep ``g·Σh_i + l·supersteps`` of the inner BSP program."""
        return (acc.g * self.comm_words_per_hyperstep
                + acc.l * self.supersteps_per_hyperstep)

    def _host_terms(self, acc: BSPAccelerator) -> float:
        """Per-hyperstep outer term ``g_host·h_host + l_host·s_host``.

        Additive on top of the device-level ``max`` — the recursion of
        DESIGN.md §8, not part of the compute-vs-link comparison."""
        return (acc.g_host * self.host_comm_words_per_hyperstep
                + acc.l_host * self.host_supersteps_per_hyperstep)

    def cost(self, acc: BSPAccelerator, *, exact: bool | None = None) -> float:
        """Predicted T̃ in FLOP units (paper Eq. 1 / Eq. 2) on ``acc``.

        Eq. 1 sums C_i over *all* opened streams, up and down: the link side
        of each hyperstep's ``max`` is its prefetch volume plus its write-back
        volume; the compute side is the inner BSP program's
        ``flops + g·comm + l·supersteps`` (Eq. 2's ``N(2k³ + 2k²g + l)`` for
        two-level Cannon). ``exact=None`` enumerates both schedules when the
        grid is small enough, else uses the closed-form estimate ``H ·
        max(mean_flops + g·comm + l·s, e·ΣC_i)`` — every streamed token, down
        *and* up, charged every hyperstep, per-step work averaged (see the
        ENUMERATION_LIMIT note on its bias).
        """
        if exact is None:
            exact = self.num_hypersteps <= ENUMERATION_LIMIT
        if exact:
            return bsps_cost(self.hyperstep_costs(), acc)
        words = float(sum(t.words for t in self.inputs)
                      + sum(t.words for t in self.outputs))
        return self.num_hypersteps * (
            max(self.mean_flops + self._superstep_terms(acc), acc.e * words)
            + self._host_terms(acc))

    def predicted_seconds(self, acc: BSPAccelerator, *, exact: bool | None = None) -> float:
        return acc.flops_to_seconds(self.cost(acc, exact=exact))

    def total_fetch_words(self, *, exact: bool | None = None) -> float:
        if exact is None:
            exact = self.num_hypersteps <= ENUMERATION_LIMIT
        if not exact:
            return float(sum(t.words for t in self.inputs)) * self.num_hypersteps
        return float(sum(self.fetch_schedule()))

    def total_writeback_words(self, *, exact: bool | None = None) -> float:
        """Words streamed up over the whole pass (closed form: every up-token
        every hyperstep, symmetric with the fetch side's over-count)."""
        if exact is None:
            exact = self.num_hypersteps <= ENUMERATION_LIMIT
        if not exact:
            return float(sum(t.words for t in self.outputs)) * self.num_hypersteps
        return float(sum(self.writeback_schedule()))

    def bandwidth_heavy(self, acc: BSPAccelerator, *, exact: bool | None = None) -> bool:
        """True if streaming the tokens — down *or* up — costs more than
        computing on them (paper §2 criterion, summed over the whole pass).
        The compute side includes the inner BSP program's superstep terms.
        ``exact=False`` stays O(1) on both sides of the comparison."""
        flops = (
            self.mean_flops * self.num_hypersteps
            if exact is False else self.total_flops
        )
        flops += self._superstep_terms(acc) * self.num_hypersteps
        link_words = (self.total_fetch_words(exact=exact)
                      + self.total_writeback_words(exact=exact))
        return acc.e * link_words > flops

    # -- local-memory accounting --------------------------------------------

    @property
    def input_token_bytes(self) -> int:
        """Streamed input tokens, double-buffered (paper: prefetch halves L);
        rate-0 (resident) tokens need no prefetch buffer and count once."""
        return sum(t.nbytes if t.resident else 2 * t.nbytes for t in self.inputs)

    @property
    def output_token_bytes(self) -> int:
        """Output tokens also ride the revolving pipeline buffers (a finished
        block drains while the next fills); write-once (rate-0) outputs such
        as a final scalar need only the single buffer."""
        return sum(t.nbytes if t.resident else 2 * t.nbytes for t in self.outputs)

    @property
    def scratch_bytes(self) -> int:
        return sum(s.nbytes for s in self.scratch)

    @property
    def vmem_bytes(self) -> int:
        """Total resident local-memory footprint of one core/chip."""
        return self.input_token_bytes + self.output_token_bytes + self.scratch_bytes

    def fits(self, acc: BSPAccelerator) -> bool:
        """Does the plan fit the accelerator's local memory L?

        Double buffers are already counted in :attr:`vmem_bytes`, so this is
        the same constraint as requiring each single-buffered token set to fit
        in ``effective_local_words`` / ``max_token_words`` (paper §2).
        """
        return self.vmem_bytes <= acc.L * acc.word_bytes


# ---------------------------------------------------------------------------
# Pod/host-level plans from Stream objects
# ---------------------------------------------------------------------------


def _stream_token_shape(s: Any) -> tuple[int, ...]:
    """Per-token shape of a stream, duck-typed.

    ``Stream`` exposes :attr:`~repro_torch.core.stream.Stream.token_shape`;
    a stream adapter may provide the same protocol without a backing array.
    """
    if hasattr(s, "token_shape"):
        return tuple(s.token_shape)
    return (s.token_size,) + tuple(s.data.shape[1:])


def _stream_dtype(s: Any) -> Any:
    if hasattr(s, "dtype"):
        return s.dtype
    return s.data.dtype


def host_plan(
    streams: Sequence[Any],
    *,
    flops_per_hyperstep: float | Callable[..., float],
    name: str = "host",
    num_hypersteps: int | None = None,
    rates: Sequence[int] | None = None,
    out_streams: Sequence[Any] = (),
    out_every: Sequence[int] | None = None,
    scratch: tuple[ScratchSpec, ...] = (),
    comm_words_per_hyperstep: float = 0.0,
    supersteps_per_hyperstep: float = 0.0,
    host_comm_words_per_hyperstep: float = 0.0,
    host_supersteps_per_hyperstep: float = 0.0,
) -> StreamPlan:
    """Build a pod/host-level StreamPlan from open-able ``Stream`` objects.

    One grid axis — the hyperstep count (default: until the shortest advancing
    stream is exhausted, matching :class:`HyperstepRunner`); one TokenSpec per
    stream. ``rates[i]`` is the per-hyperstep cursor advance of down-stream i
    (default 1): rate-0 streams become resident operands (constant index map,
    fetched once), rate-k streams consume a k-token block per hyperstep.

    ``out_streams`` are write-back (``move_up``) streams; ``out_every[j]``
    says up-stream j completes one token every that-many hypersteps (default
    1), expressed as the index map ``t -> t // every`` — the enumerated
    schedule then charges the up-token only on hypersteps where the output
    block index changes, exactly how a checkpoint written every k steps costs.

    ``scratch`` declares persistent local state the program keeps between
    hypersteps (e.g. a serving KV cache), so :attr:`StreamPlan.vmem_bytes`
    budgets the host run like a kernel. When the per-hyperstep step is itself
    an inner BSP program on a p-core grid (a multi-core
    :class:`~repro_torch.core.hyperstep.HyperstepRunner`), pass *one core's*
    streams plus ``comm_words_per_hyperstep`` / ``supersteps_per_hyperstep``
    so Eq. 2's ``g·h + l`` superstep terms are priced. When the device
    program additionally runs replicated across a host mesh, pass the
    host-level h-relation and barrier count via
    ``host_comm_words_per_hyperstep`` / ``host_supersteps_per_hyperstep`` —
    they are priced with the outer ``(g_host, l_host)`` pair (DESIGN.md §8).
    The resulting plan prices a
    :class:`~repro_torch.core.hyperstep.HyperstepRunner` run with the same
    Eq. 1 used one level down for the CUDA kernels.
    """
    if not streams and not out_streams:
        raise ValueError("need at least one stream (down or up)")
    rates = list(rates) if rates is not None else [1] * len(streams)
    if len(rates) != len(streams):
        raise ValueError(f"rates has {len(rates)} entries for {len(streams)} streams")
    out_every = list(out_every) if out_every is not None else [1] * len(out_streams)
    if len(out_every) != len(out_streams):
        raise ValueError(
            f"out_every has {len(out_every)} entries for {len(out_streams)} streams")

    h = num_hypersteps
    if h is None:
        budgets = []
        for s, r in zip(streams, rates):
            if r <= 0:
                continue
            avail = s.num_tokens - s.cursor
            if avail % r:
                raise ValueError(
                    f"[BSPS103] rate {r} does not divide the {avail} "
                    f"remaining tokens of {s.name or s.stream_id} in "
                    f"{name!r}: the tail hyperstep would silently truncate "
                    f"(pad the stream or pass num_hypersteps explicitly)")
            budgets.append(avail // r)
        # the runner advances an up-stream cursor once per *flush*, i.e.
        # every out_every[j] hypersteps — mirror HyperstepRunner._remaining
        budgets += [(s.num_tokens - s.cursor) * e
                    for s, e in zip(out_streams, out_every)]
        if not budgets:
            raise ValueError("all streams are resident; pass num_hypersteps")
        h = min(budgets)
    if h <= 0:
        raise ValueError(f"no hypersteps to plan (h={h})")

    def token(s: Any, rate: int, direction: str, every: int = 1) -> TokenSpec:
        shape = _stream_token_shape(s)
        trailing = shape[1:]
        nt = len(trailing)
        if direction == "down" and rate == 0:      # resident operand
            block = shape
            index_map = lambda t, nt=nt: (0,) * (nt + 1)
        elif direction == "down":
            block = (rate * shape[0],) + trailing
            index_map = lambda t, nt=nt: (t,) + (0,) * nt
        else:                                       # up: one token per `every` steps
            block = shape
            index_map = lambda t, e=every, nt=nt: (t // e,) + (0,) * nt
        return TokenSpec(
            name=s.name or f"stream{s.stream_id}",
            block_shape=block,
            index_map=index_map,
            dtype=_stream_dtype(s),
            full_shape=(s.num_tokens * shape[0],) + trailing,
            direction=direction,
            rate=rate,
        )

    return StreamPlan(
        name=name,
        grid=(h,),
        inputs=tuple(token(s, r, "down") for s, r in zip(streams, rates)),
        outputs=tuple(token(s, 1, "up", every=e)
                      for s, e in zip(out_streams, out_every)),
        scratch=scratch,
        dimension_semantics=("arbitrary",),
        flops_per_hyperstep=flops_per_hyperstep,
        comm_words_per_hyperstep=comm_words_per_hyperstep,
        supersteps_per_hyperstep=supersteps_per_hyperstep,
        host_comm_words_per_hyperstep=host_comm_words_per_hyperstep,
        host_supersteps_per_hyperstep=host_supersteps_per_hyperstep,
    )


# ---------------------------------------------------------------------------
# Serving-tier pricing: operands that stream every hyperstep
# ---------------------------------------------------------------------------


def streamed_operand(name: str, words: int, *, dtype: Any = torch.float32,
                     direction: str = "down") -> TokenSpec:
    """A token of ``words`` elements that crosses the link *every* hyperstep.

    The working-set operands of a decode step (the parameters, the growing KV
    pool) do not fit in local memory, so each hyperstep streams them through
    the core again — the index map advances every step, which is exactly what
    the fetch/write-back schedules charge. The degenerate opposite (fetched
    once) is a rate-0 resident token. ``full_shape`` stays ``None``: the
    backing extent grows with the hyperstep count, so declaring one token's
    worth would contradict the advancing map.
    """
    return TokenSpec(
        name=name,
        block_shape=(int(words),),
        index_map=lambda t: (t,),
        dtype=dtype,
        direction=direction,
        rate=1,
    )


# ---------------------------------------------------------------------------
# Planner: enumerate -> filter by budget -> score with Eq. 1 -> (measure)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """One scored candidate from :func:`autotune`."""

    params: Mapping[str, Any]
    plan: StreamPlan
    feasible: bool
    predicted_flops: float
    predicted_seconds: float
    measured_seconds: float | None = None

    def row(self) -> dict[str, Any]:
        """Flat record for the predicted-vs-measured tables."""
        out = {
            **{f"param_{k}": v for k, v in self.params.items()},
            "feasible": self.feasible,
            "vmem_bytes": self.plan.vmem_bytes,
            "predicted_flops": self.predicted_flops,
            "predicted_seconds": self.predicted_seconds,
        }
        if self.measured_seconds is not None:
            out["measured_seconds"] = self.measured_seconds
            if self.measured_seconds > 0:
                out["pred_over_meas"] = self.predicted_seconds / self.measured_seconds
        return out


def enumerate_plans(
    build: Callable[..., StreamPlan],
    candidates: Iterable[Mapping[str, Any]],
    acc: BSPAccelerator,
    *,
    exact: bool | None = None,
) -> list[PlanChoice]:
    """Score every candidate parameter set; feasible ones first, cheapest first.

    ``exact`` is forwarded to :meth:`StreamPlan.cost` — pass False to score
    with the O(1) closed form regardless of grid size. A candidate is
    feasible when it fits the accelerator's local memory
    (:meth:`StreamPlan.fits`). The JAX package also runs its static plan
    verifier here; the port has no verifier yet, so a candidate that verifier
    would reject is not rejected here.
    """
    choices = []
    for params in candidates:
        plan = build(**params)
        flops = plan.cost(acc, exact=exact)
        choices.append(
            PlanChoice(
                params=dict(params),
                plan=plan,
                feasible=plan.fits(acc),
                predicted_flops=flops,
                predicted_seconds=acc.flops_to_seconds(flops),
            )
        )
    # ties (common on the degenerate closed-form path) break toward fewer
    # hypersteps: Eq. 1 omits the per-hyperstep barrier l, and the paper says
    # to size tokens as large as local memory allows
    choices.sort(
        key=lambda c: (not c.feasible, c.predicted_seconds, c.plan.num_hypersteps)
    )
    return choices


def median_seconds(fn: Callable[[], Any], repeats: int = 3) -> float:
    """Warmup once, then median wall time of ``repeats`` runs.

    ``fn`` must finish its device work before it returns (end in a
    synchronise), or the clock measures the enqueue.
    """
    fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def autotune(
    build: Callable[..., StreamPlan],
    candidates: Iterable[Mapping[str, Any]],
    acc: BSPAccelerator,
    *,
    measure: Callable[..., Any] | None = None,
    measure_top: int = 3,
    repeats: int = 3,
    exact: bool | None = None,
) -> tuple[PlanChoice, list[PlanChoice]]:
    """Pick the predicted-fastest feasible plan; optionally verify by running.

    ``build(**params) -> StreamPlan`` constructs a candidate;  candidates that
    blow the double-buffered local-memory budget (:meth:`StreamPlan.fits`,
    i.e. ``BSPAccelerator.max_token_words``) are excluded from selection but
    kept in the returned list for the tables. With ``measure(**params)`` given
    (a thunk that runs the candidate end-to-end), the ``measure_top``
    predicted-fastest feasible candidates are wall-clocked and the best
    *measured* one wins — the predicted/measured ratio lands in each
    :meth:`PlanChoice.row`, which is the paper's Fig. 5 validation inlined
    into the planner.

    Returns ``(best, all_choices)``.
    """
    choices = enumerate_plans(build, candidates, acc, exact=exact)
    feasible = [c for c in choices if c.feasible]
    if not feasible:
        raise ValueError(
            f"no candidate fits local memory "
            f"(L = {acc.L} words on {acc.name}); smallest candidate needs "
            f"{min((c.plan.vmem_bytes for c in choices), default=0)} bytes"
        )
    if measure is None:
        return feasible[0], choices

    timed: list[PlanChoice] = []
    for c in feasible[:measure_top]:
        seconds = median_seconds(lambda c=c: measure(**c.params), repeats)
        timed.append(dataclasses.replace(c, measured_seconds=seconds))
    timed.sort(key=lambda c: c.measured_seconds)
    # splice the timed results back into the full table
    by_key = {tuple(sorted(c.params.items())): c for c in timed}
    choices = [by_key.get(tuple(sorted(c.params.items())), c) for c in choices]
    return timed[0], choices

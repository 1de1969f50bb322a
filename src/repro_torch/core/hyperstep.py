"""Hyperstep executor — the BSPS runtime (paper §2, Fig. 1).

A hyperstep is (1) an ordinary BSP program run on the tokens currently resident
in local memory, concurrent with (2) the asynchronous fetch of the tokens for the
next hyperstep and (3) the asynchronous write-back of the previous hyperstep's
finished output tokens. A bulk synchronisation separates hypersteps: no core
starts hyperstep h+1 before every core has its tokens for h+1 resident and its
outputs of h-1 safely in external memory.

This module realises that schedule at the host level, on the card:

* "local memory" = device memory; "external memory" = the stream backing store
  in host RAM;
* the async DMA engine = a background thread *per core* (one, like the single
  DMA engine per Epiphany core). On a CUDA device each lane owns a side CUDA
  stream: it stages the next tokens through pinned host memory and drains
  finished output tokens (``bsp_stream_move_up``) while the current compute
  runs on the compute stream, and waits on CUDA events for its own copies;
* the bulk synchronisation = joining every core's DMA lane + synchronising the
  device before advancing.

The runner is the paper's two-level construction: with ``cores=p`` each of the
p cores owns its own stream set and DMA lane, and the per-hyperstep ``step`` is
the *inner BSP program* on the whole grid, called once per hyperstep with every
core's tokens. The single-core mode (``cores=None``) is the degenerate p=1
case with the flat-stream interface.

The same schedule appears one level down in ``kernels/``, where a block
streams tiles of device memory through shared memory.

A token is an array or a pytree of arrays (dicts, lists, tuples — a
training batch is ``{"tokens", "labels"}``), as in the JAX package's
runner: staging, rate-k merging and the compiled gathers and scatters work
leaf by leaf.

Streams need not all advance at the same rate: ``rates[i]`` tokens of stream i
are consumed per hyperstep — rate-0 streams are resident operands fetched once
before hyperstep 0, rate-k streams deliver a k-token block each step. Up-streams
may flush sparsely: ``out_every[j]`` says out-stream j completes one token
every that many hypersteps.

The executor records per-core, per-hyperstep wall times split into compute /
fetch / write-back — the fetch and write-back durations are measured *inside*
each DMA lane, so they are real link-busy times even when fully hidden behind
compute — plus ``fetch_wait_seconds``, the slice of the bulk sync actually
spent waiting on the lanes. The pre-loop staging of hyperstep 0's tokens (and
of the rate-0 residents) is attributed to record 0's ``initial_fetch_*``
fields, so summed words over the records match the plan's enumerated fetch
schedule exactly. ``records`` holds the bulk-synchronous aggregate — the max
over cores, the quantity Eq. 1 prices — and ``core_records[c]`` each core's own
row. Give the runner the run's :class:`~repro_torch.core.plan.StreamPlan` (see
:func:`repro_torch.core.plan.host_plan`) and the machine's
:class:`~repro_torch.core.bsp.BSPAccelerator` and it prices the run with
Eq. 1/Eq. 2 — :meth:`HyperstepRunner.predicted_vs_measured` is the
predicted/measured table row.

Two execution modes:

* **measure mode** — the instrumented host loop above: one step plus a bulk
  sync per hyperstep, per-step records. Ground truth for calibration and
  bottleneck identification, but the per-step sync dominates short
  hypersteps.
* **compiled mode** (``run(state, compiled=True)``) — :meth:`compile` replays
  the cursor walk (prologue residents, per-core rate-k advances,
  ``on_hyperstep_end`` MOVE/seek schedules, ``out_every``-sparse write-backs)
  as precomputed gather/scatter indices over streams staged once on the
  device (:meth:`repro_torch.core.stream.Stream.as_stacked`), in one Python
  loop with no host sync per hyperstep. Per-step records collapse into one
  whole-run row; the word totals equal the measure-mode sums (the schedule is
  identical), so :meth:`HyperstepRunner.predicted_vs_measured` stays the
  Eq. 1 table row.

The runner's robustness hooks are the JAX package's: a static verifier
(:func:`repro_torch.core.verify.verify_runner`) runs before a run or a
compile, a :class:`~repro_torch.core.faults.FaultInjector` is consulted at the
dispatch, the DMA lanes, the compute and the flush, a
:class:`~repro_torch.core.health.HealthMonitor` scores each record against its
Eq. 1 price, and each run lands as one record in a
:class:`~repro_torch.core.calibstore.CalibrationStore`. In compiled mode the
health check and the calibration record happen at the run's boundary, after
the replay: nothing inside the replay reads the card back.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.plan import StreamPlan
from repro_torch.core.stream import Stream
from repro_torch.core.trace import span, traced
from repro_torch.core.verify import Diagnostic, PlanVerificationError, verify_runner
from repro_torch.device import resolve_device

__all__ = ["HyperstepRecord", "HyperstepRunner", "CompiledHyperstepProgram",
           "PlanVerificationError", "run_bsps"]


@dataclasses.dataclass
class HyperstepRecord:
    """Timing of one hyperstep: the overlapped operations + the step total.

    ``fetch_seconds`` / ``writeback_seconds`` are lane-busy durations measured
    inside the DMA thread (real link time, even when hidden behind compute);
    ``fetch_wait_seconds`` is how long the bulk sync blocked on the lane after
    compute finished — >0 means the link, not the core, gated this step.
    Write-back of step h's outputs overlaps step h+1's compute, so its fields
    are filled in when that later bulk sync joins the lane.

    Record 0 additionally carries ``initial_fetch_words`` /
    ``initial_fetch_seconds``: the pre-loop staging of hyperstep 0's tokens
    and the rate-0 residents (the paper assumes them resident at program
    start, so they are outside ``step_seconds`` — but they did cross the
    external link, and the plan's enumerated fetch schedule charges them at
    arrival 0).
    """

    index: int
    compute_seconds: float
    fetch_seconds: float
    step_seconds: float
    fetch_words: int
    fetch_wait_seconds: float = 0.0
    writeback_seconds: float = 0.0
    writeback_words: int = 0
    initial_fetch_seconds: float = 0.0
    initial_fetch_words: int = 0

    @property
    def bandwidth_heavy(self) -> bool:
        return self.fetch_seconds + self.writeback_seconds > self.compute_seconds


def _leaves(x: Any) -> list[Any]:
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _map(fn: Callable[..., Any], *trees: Any) -> Any:
    """``fn`` over the leaves of token trees of one structure (dicts, lists,
    tuples)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _block(x: Any) -> Any:
    """Bulk sync: wait for the device work behind any CUDA tensor in ``x``."""
    devices = {t.device for t in _leaves(x)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return x


def _concat(toks: Sequence[Any]) -> Any:
    """Merge a rate-k stream's k tokens into one block along the token axis,
    leaf by leaf for pytree tokens."""
    if len(toks) == 1:
        return toks[0]

    def cat(*leaves: Any) -> Any:
        if isinstance(leaves[0], torch.Tensor):
            return torch.cat(leaves, dim=0)
        return np.concatenate(leaves, axis=0)

    return _map(cat, *toks)


@dataclasses.dataclass
class _Lane:
    """One core's DMA lane: its thread's device, copy stream and the stream
    the compute runs on (``side``/``compute`` are None off the card)."""

    device: torch.device
    side: Any = None
    compute: Any = None

    @classmethod
    def open(cls, device: torch.device) -> "_Lane":
        if device.type != "cuda":
            return cls(device)
        return cls(device, torch.cuda.Stream(device),
                   torch.cuda.current_stream(device))

    def stage(self, tok: Any) -> Any:
        """Move one token block into local (device) memory, in this lane.

        On the card the copy runs on the lane's side stream from pinned host
        memory, and the lane thread waits on an event for it — the lane is
        busy, the compute stream is not. The staged tensors are marked as
        used by the compute stream so their memory is not reused under them.
        A pytree token stages leaf by leaf, behind one event.
        """
        if self.side is None:
            return _map(lambda x: torch.as_tensor(x).to(self.device), tok)

        def pinned(x: Any) -> torch.Tensor:
            host = torch.as_tensor(x)
            if host.device.type == "cpu" and not host.is_pinned():
                host = host.contiguous().pin_memory()
            return host

        with torch.cuda.stream(self.side):
            dev = _map(lambda x: pinned(x).to(self.device, non_blocking=True), tok)
            done = torch.cuda.Event()
            done.record(self.side)
        done.synchronize()
        for t in _leaves(dev):
            t.record_stream(self.compute)
        return dev

    def drain(self, tok: Any, ready: Any) -> Any:
        """Copy one finished output token back to host memory, in this lane.

        ``ready`` is the event recorded on the compute stream after the step
        that produced ``tok``; the side stream waits on it before copying.
        """
        if tok is None or self.side is None or not isinstance(tok, torch.Tensor) \
                or not tok.is_cuda:
            return tok
        self.side.wait_event(ready)
        with torch.cuda.stream(self.side):
            host = torch.empty(tok.shape, dtype=tok.dtype, pin_memory=True)
            host.copy_(tok, non_blocking=True)
            tok.record_stream(self.side)
            done = torch.cuda.Event()
            done.record(self.side)
        done.synchronize()
        return host


def _fetch(
    streams: Sequence[Stream],
    rates: Sequence[int],
    core: int,
    lane: _Lane,
    inj: Any = None,
    g: int = 0,
) -> tuple[list[Any], float]:
    """Stage the next token block of each advancing stream into local memory.

    Returns (tokens, seconds): one entry per *advancing* (rate > 0) stream, in
    stream order, plus the in-thread duration — the lane-busy time. With a
    fault injector ``inj``, hyperstep ``g``'s injected DMA stall sleeps
    *inside* the lane first, so the stall is real lane-busy time and the bulk
    sync feels it.
    """
    t0 = time.perf_counter()
    d = inj.fetch_delay(g, core) if inj is not None else 0.0
    if d:
        time.sleep(d)
    toks = []
    for s, rate in zip(streams, rates):
        if rate <= 0:
            continue
        toks.append(lane.stage(_concat([s.move_down(core) for _ in range(rate)])))
    return toks, time.perf_counter() - t0


def _prologue(
    streams: Sequence[Stream],
    rates: Sequence[int],
    core: int,
    lane: _Lane,
    inj: Any = None,
    g: int = 0,
) -> tuple[list[Any], list[Any], int, float]:
    """Pre-loop staging: rate-0 residents + hyperstep 0's tokens, one core.

    Returns (residents, first_tokens, words, seconds) — the words and the
    in-thread duration cover *everything* this core moved before hyperstep 0,
    matching the plan's arrival-0 charge. ``inj``/``g`` inject a DMA stall on
    that staging, as in ``_fetch``.
    """
    t0 = time.perf_counter()
    d = inj.fetch_delay(g, core) if inj is not None else 0.0
    if d:
        time.sleep(d)
    residents: list[Any] = []
    words = 0
    for s, r in zip(streams, rates):
        if r != 0:
            residents.append(None)
            continue
        residents.append(lane.stage(s.move_down(core)))
        words += s.token_words
    toks, _ = _fetch(streams, rates, core, lane)
    words += sum(s.token_words * r for s, r in zip(streams, rates))
    return residents, toks, words, time.perf_counter() - t0


def _writeback(
    out_streams: Sequence[Stream], core: int, out_tokens: Sequence[Any],
    lane: _Lane, ready: Any,
) -> tuple[int, float]:
    """Drain finished output tokens up the external link (bulk move_up).

    Returns (words, seconds) measured in-thread. ``move_up`` reports the words
    it actually moved, so sparse up-streams (checkpoint every k steps) cost 0
    on the steps they skip.
    """
    t0 = time.perf_counter()
    words = 0
    for s, tok in zip(out_streams, out_tokens):
        words += int(s.move_up(core, lane.drain(tok, ready)) or 0)
    return words, time.perf_counter() - t0


class _CursorProxy:
    """Cursor-only stand-in for a stream during :meth:`HyperstepRunner.compile`.

    The compiled schedule is built by replaying the host loop's cursor
    bookkeeping — prologue, per-hyperstep rate-k advances, and the
    ``on_hyperstep_end`` seeks (Cannon's ``MOVE`` calls) — against these
    proxies, so no data moves and the real streams are untouched. An
    ``on_hyperstep_end`` used with compiled mode must therefore only perform
    cursor motion (``seek``).
    """

    def __init__(self, stream: Any) -> None:
        self.num_tokens = stream.num_tokens
        self.name = getattr(stream, "name", "")
        self.stream_id = getattr(stream, "stream_id", 0)
        self._cursor = stream.cursor

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, core: int, delta_tokens: int) -> None:
        new = self._cursor + delta_tokens
        if not 0 <= new <= self.num_tokens:
            raise IndexError(
                f"compiled schedule: seek to {new} outside "
                f"[0, {self.num_tokens}] on {self.name or self.stream_id}")
        self._cursor = new

    def take(self, n: int) -> int:
        """Consume n consecutive tokens; returns the start index."""
        if self._cursor + n > self.num_tokens:
            raise IndexError(
                f"compiled schedule: stream {self.name or self.stream_id} "
                f"exhausted at cursor {self._cursor} (+{n} of "
                f"{self.num_tokens})")
        start = self._cursor
        self._cursor += n
        return start


def _gather_block(stacked: Any, start: int, rate: int) -> Any:
    """Device-side ``move_down`` ×rate: consecutive tokens off a stacked copy
    (a tensor, or a pytree of them), merged along the token axis leaf by
    leaf (the device twin of ``_concat``). Views: no copy, no host sync."""

    def take(leaf: torch.Tensor) -> torch.Tensor:
        if rate == 1:
            return leaf[start]
        sl = leaf[start:start + rate]
        return sl.reshape((rate * sl.shape[1],) + tuple(sl.shape[2:]))

    return _map(take, stacked)


def _scatter_block(buf: Any, tok: Any, idx: int) -> None:
    """Device-side ``move_up``: write ``tok`` into row ``idx`` of a stacked
    out-buffer (leaf by leaf for a pytree), in place. The flush mask is
    static, so the caller skips the rows that do not complete; no host
    sync."""

    def put(leaf: torch.Tensor, t: Any) -> None:
        row = leaf[idx]
        row.copy_(torch.as_tensor(t).reshape(row.shape))

    _map(put, buf, tok)


@dataclasses.dataclass
class _RunSchedule:
    """The cursor walk of one compiled run as static (host-built) arrays.

    ``start_in_cursors`` / ``start_out_cursors`` pin the cursor positions the
    walk was simulated from: a cached program is only replayable when the
    streams stand where the simulation started.
    """

    total: int
    gather_indices: np.ndarray      # (H, cores, n_advancing) int32
    resident_indices: np.ndarray    # (cores, n_slots) int32 (rate-0 rows only)
    scatter_indices: np.ndarray     # (H, cores, n_out) int32
    flush_mask: np.ndarray          # (H, n_out) bool
    step_words: list[int]           # per core, per hyperstep (uniform)
    initial_words: list[int]        # per core: residents + hyperstep 0 tokens
    writeback_words: list[int]      # per core, whole run
    final_in_cursors: list[list[int]]
    final_out_cursors: list[list[int]]
    start_in_cursors: list[list[int]] = dataclasses.field(default_factory=list)
    start_out_cursors: list[list[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CompiledHyperstepProgram:
    """A whole hyperstep program as one replay over staged streams.

    Built by :meth:`HyperstepRunner.compile`; ``__call__(state, out_bufs,
    stacked)`` runs ``total`` hypersteps with no host sync in between and
    returns ``(state, out_bufs)`` (``out_bufs`` are written in place).
    ``schedule`` exposes the precomputed gather/scatter index arrays.
    """

    total: int
    schedule: _RunSchedule
    _call: Callable[..., Any]

    def __call__(self, state: Any, out_bufs: Any, stacked: Any) -> Any:
        return self._call(state, out_bufs, stacked)


class HyperstepRunner:
    """Runs a BSPS program: ``state = step(state, tokens)`` per hyperstep.

    Parameters
    ----------
    step:
        The hyperstep's BSP program. Single-core: called with the resident
        tokens (one per advancing stream, in stream order, resident rate-0
        tokens included at their stream position). Multi-core (``cores=p``):
        called once per hyperstep with ``tokens[i]`` = the list of core 0..p-1
        tokens of stream slot i. With ``out_streams`` given, must return
        ``(state, out_tokens)`` — one token per out slot (per core, in
        multi-core mode); ``None`` skips that stream's write for the
        hyperstep, advancing its cursor for free (measure mode only).
    streams:
        The open down-streams (``O_s``). Single-core: a flat sequence.
        Multi-core: a length-p sequence of per-core sequences — every core
        must open the same number of slots, slot i sharing one ``rates[i]``.
        Use :meth:`Stream.seek` inside ``on_hyperstep_end`` for the
        pseudo-streaming access patterns (e.g. Cannon's ``MOVE`` calls).
    cores:
        None (default) = single-core mode on core id ``core``. An int p =
        multi-core mode on core ids 0..p-1: per-core stream sets, one DMA lane
        per core, a shared bulk-sync barrier, per-core records.
    rates:
        Per-slot cursor advance per hyperstep (default 1 each); rate 0 marks
        a resident operand — fetched once before hyperstep 0, never advanced.
    out_streams:
        Up-streams written back (``bsp_stream_move_up``), nested per core in
        multi-core mode. The write-back of hyperstep h rides the same
        per-core DMA lane as the prefetch, overlapped with hyperstep h+1's
        compute and joined at its bulk sync.
    out_every:
        Per-out-slot flush interval (default 1 = every hyperstep): slot j is
        written (and its cursor advanced) only on hypersteps h with
        ``(h+1) % out_every[j] == 0``. Mirrors ``host_plan(out_every=)``.
    prefetch:
        If True (default) overlap next-token fetch / write-back with compute.
        If False, run serially (reference semantics).
    device:
        Where tokens are staged ("local memory"). ``None`` means the CUDA
        card and raises when there is none; pass ``"cpu"`` to run on the CPU.
    plan / machine:
        Optional :class:`StreamPlan` describing this run and the
        :class:`BSPAccelerator` to price it on. When both are given the
        runner predicts its own wall time with Eq. 1 — the plan also supplies
        the default hyperstep count.
    verify:
        If True (default) the runner statically verifies the run before
        executing or compiling it (:func:`repro_torch.core.verify.verify_runner`):
        cursor overruns, bad MOVE seeks, up-stream write races, backing
        aliasing and budget blowouts raise
        :class:`~repro_torch.core.verify.PlanVerificationError` *before* any
        dispatch. Memoized per (hyperstep count, cursor positions), so hot
        paths pay a set lookup. ``verify=False`` opts out.
    faults:
        Optional :class:`~repro_torch.core.faults.FaultInjector`, consulted
        before each dispatch (host loop: per hyperstep; compiled: per run —
        an injected ``dispatch_fail`` raises
        :class:`~repro_torch.core.faults.FaultInjected` from :meth:`run`
        before any cursor or state moves), inside each DMA lane's fetch
        (``dma_stall``), around the compute (``straggler``) and on up-stream
        tokens at flush time (``corrupt``). Hyperstep-indexed triggers use
        the *global* hyperstep count, so a host-loop run and a compiled run
        of the same program produce the same fault trace.
    health:
        Optional :class:`~repro_torch.core.health.HealthMonitor`. Each
        appended aggregate record is scored against its Eq. 1 prediction and
        flushed up-stream tokens are NaN-checked — in compiled mode once, at
        the run's boundary.
    calibstore:
        Where each run's measured aggregates land as one
        :class:`~repro_torch.core.calibstore.MeasurementRecord` (needs
        ``plan`` + ``machine``). ``None`` records into the process default
        store, a :class:`~repro_torch.core.calibstore.CalibrationStore`
        isolates, ``False`` disables recording.
    """

    def __init__(
        self,
        step: Callable[..., Any],
        streams: Sequence[Any],
        *,
        core: int = 0,
        cores: int | None = None,
        rates: Sequence[int] | None = None,
        out_streams: Sequence[Any] = (),
        out_every: Sequence[int] | None = None,
        prefetch: bool = True,
        device: Any = None,
        on_hyperstep_end: Callable[[int, Sequence[Any]], None] | None = None,
        plan: StreamPlan | None = None,
        machine: BSPAccelerator | None = None,
        verify: bool = True,
        faults: Any | None = None,
        health: Any | None = None,
        calibstore: Any | None = None,
    ) -> None:
        self._step = step
        self._multi = cores is not None
        if self._multi:
            if cores <= 0:
                raise ValueError(f"cores must be positive, got {cores}")
            self._core_ids = list(range(cores))
            self._streams = [list(s) for s in streams]
            if len(self._streams) != cores:
                raise ValueError(
                    f"multi-core mode needs one stream set per core: got "
                    f"{len(self._streams)} sets for {cores} cores")
            self._out_streams = ([list(o) for o in out_streams]
                                 if out_streams else [[] for _ in self._core_ids])
            if len(self._out_streams) != cores:
                raise ValueError(
                    f"multi-core mode needs one out-stream set per core: got "
                    f"{len(self._out_streams)} sets for {cores} cores")
        else:
            self._core_ids = [core]
            self._streams = [list(streams)]
            self._out_streams = [list(out_streams)]
        n_slots = len(self._streams[0])
        n_out = len(self._out_streams[0])
        for ss in self._streams:
            if len(ss) != n_slots:
                raise ValueError("every core must open the same stream slots")
        for ss in self._out_streams:
            if len(ss) != n_out:
                raise ValueError("every core must open the same out-stream slots")

        self._rates = list(rates) if rates is not None else [1] * n_slots
        if len(self._rates) != n_slots:
            raise ValueError(
                f"rates has {len(self._rates)} entries for {n_slots} streams")
        if any(r < 0 for r in self._rates):
            raise ValueError(f"rates must be >= 0, got {self._rates}")
        self._out_every = (list(out_every) if out_every is not None
                           else [1] * n_out)
        if len(self._out_every) != n_out:
            raise ValueError(
                f"out_every has {len(self._out_every)} entries for "
                f"{n_out} out streams")
        if any(e < 1 for e in self._out_every):
            raise ValueError(f"out_every must be >= 1, got {self._out_every}")
        self._prefetch = prefetch
        self.device = resolve_device(device)
        self._on_end = on_hyperstep_end
        self.plan = plan
        self.machine = machine
        self.records: list[HyperstepRecord] = []
        self.core_records: list[list[HyperstepRecord]] = [
            [] for _ in self._core_ids]
        # hypersteps executed so far (host loop: one per record; compiled
        # mode: the whole run at once) — the measured side's step count for
        # pro-rata pricing in predicted_seconds()
        self.hypersteps_run: int = 0
        # bulk syncs made: the host loop pays one per hyperstep, a compiled
        # run one per run — the execution mode's own barrier count, priced at
        # the machine's l (which calibrate() measures as that latency)
        self.dispatches_run: int = 0
        # lifetime twins of the two counters above: fault triggers and health
        # observations are indexed by these, and they survive reset_records()
        # — a segment engine that resets its per-segment row must still walk
        # forward through a FaultPlan's hyperstep domain
        self.lifetime_hypersteps: int = 0
        self.lifetime_dispatches: int = 0
        self._compiled_cache: dict[int, CompiledHyperstepProgram] = {}
        self._verify_enabled = verify
        self._verified_keys: set[Any] = set()
        self.faults = faults
        self.health = health
        self.calibstore = calibstore

    # -- schedule helpers ----------------------------------------------------

    @property
    def num_cores(self) -> int:
        return len(self._core_ids)

    def _remaining(self) -> int | None:
        """Hypersteps the streams can still supply (None if nothing advances)."""
        budgets = []
        for ss in self._streams:
            budgets += [
                (s.num_tokens - s.cursor) // r
                for s, r in zip(ss, self._rates) if r > 0
            ]
        for outs in self._out_streams:
            budgets += [(s.num_tokens - s.cursor) * e
                        for s, e in zip(outs, self._out_every)]
        return min(budgets) if budgets else None

    def _resolve_total(self, num_hypersteps: int | None) -> int:
        if num_hypersteps is not None:
            return num_hypersteps
        remaining = self._remaining()
        if self.plan is not None:
            # a plan sets the target count but can never outrun the
            # streams (cursors may have moved since it was built)
            total = self.plan.num_hypersteps
            return total if remaining is None else min(total, remaining)
        if remaining is None:
            raise ValueError("need streams, a plan, or an explicit num_hypersteps")
        return remaining

    def _assemble(self, resident: list[Any], fetched: list[Any]) -> list[Any]:
        """Interleave resident (rate-0) tokens with freshly fetched ones."""
        toks, it = [], iter(fetched)
        for idx, rate in enumerate(self._rates):
            toks.append(resident[idx] if rate == 0 else next(it))
        return toks

    def _step_tokens(self, per_core: list[list[Any]]) -> list[Any]:
        """Per-core token lists -> the step's argument.

        Single-core: the flat token list. Multi-core: one entry per stream
        slot, each the list of per-core tokens (core order 0..p-1).
        """
        if not self._multi:
            return per_core[0]
        n_slots = len(self._streams[0])
        return [[per_core[c][i] for c in range(self.num_cores)]
                for i in range(n_slots)]

    def _per_core_out(self, out_tokens: Sequence[Any]) -> list[list[Any]]:
        """The step's out tokens -> per-core lists (one entry per out slot)."""
        n_out = len(self._out_streams[0])
        if len(out_tokens) != n_out:
            raise ValueError(
                f"step returned {len(out_tokens)} out tokens for "
                f"{n_out} out streams")
        if not self._multi:
            return [list(out_tokens)]
        return [[None if out_tokens[j] is None else out_tokens[j][c]
                 for j in range(n_out)]
                for c in range(self.num_cores)]

    def _on_end_arg(self) -> Any:
        return self._streams if self._multi else self._streams[0]

    # -- static verification ---------------------------------------------------

    def verify(self, num_hypersteps: int | None = None) -> list[Diagnostic]:
        """Statically verify the upcoming run; returns all diagnostics.

        Pure cursor arithmetic (no data moves, nothing compiles) — see
        :func:`repro_torch.core.verify.verify_runner`. :meth:`run` and
        :meth:`compile` call this automatically unless the runner was built
        with ``verify=False``; call it directly to see warnings and infos,
        which the automatic hook ignores.
        """
        return verify_runner(self, num_hypersteps)

    def _verify_or_raise(self, total: int) -> None:
        """The compile/run hook: raise on error findings, memoized per walk."""
        if not self._verify_enabled:
            return
        key = (
            total,
            tuple(tuple(s.cursor for s in ss) for ss in self._streams),
            tuple(tuple(s.cursor for s in outs) for outs in self._out_streams),
        )
        if key in self._verified_keys:
            return
        errors = [d for d in self.verify(total) if d.severity == "error"]
        if errors:
            raise PlanVerificationError(errors)
        self._verified_keys.add(key)

    # -- fault injection / health / calibration hooks --------------------------

    @property
    def _source_name(self) -> str:
        return self.plan.name if self.plan is not None else "hyperstep"

    def _predicted_seconds_for(self, total: int, dispatches: int = 1) -> float:
        """Eq. 1 price of ``total`` hypersteps + ``dispatches`` barriers.

        The health monitor's SLO denominator. Without a plan + machine the
        fallback is a flat per-hyperstep unit — the monitor's baseline ratio
        self-normalizes, so only *changes* in per-hyperstep time alarm.
        """
        if self.plan is not None and self.machine is not None:
            per = (self.plan.predicted_seconds(self.machine)
                   / max(self.plan.num_hypersteps, 1))
            return per * total + self.machine.flops_to_seconds(
                self.machine.l * dispatches)
        return 1e-3 * max(total, 1)

    def _observe(self, total: int, dispatches: int, index: int,
                 measured_seconds: float | None = None) -> None:
        if self.health is None or not self.records:
            return
        self.health.observe_record(
            self.records[-1], self._predicted_seconds_for(total, dispatches),
            source=self._source_name, index=index,
            measured_seconds=measured_seconds)

    def _record_measurement(self, hypersteps: int, dispatches: int,
                            rec_start: int, fault_start: int,
                            measured_seconds: float) -> None:
        """Fold the run just finished into the calibration store.

        Runs with an active injector are recorded *with* their ``faulty``
        flag rather than dropped — the robust fitter's outlier screen is what
        rejects a sporadic stall, and a sustained one is real drift it must
        see. Store recording must never fail the run that was measured.
        """
        if self.plan is None or self.machine is None or self.calibstore is False:
            return
        store = self.calibstore
        if store is None:
            from repro_torch.core.calibstore import get_default_store
            store = get_default_store()
        faulty = (self.faults is not None and
                  len(getattr(self.faults, "trace", ())) > fault_start)
        try:
            store.record_run(
                plan=self.plan, machine=self.machine,
                records=self.records[rec_start:],
                hypersteps=hypersteps, dispatches=dispatches,
                predicted_seconds=self._predicted_seconds_for(
                    hypersteps, dispatches),
                measured_seconds=measured_seconds, faulty=faulty,
                device=self.device)
        except (ValueError, OverflowError):
            # a plan whose flops cannot be aggregated (callable per-step work
            # on a giant grid with no declared mean) prices nothing — skip
            return

    def _apply_compiled_corruption(self, sched: _RunSchedule, out_bufs: Any,
                                   base: int, total: int) -> Any:
        """Apply compiled-mode ``corrupt`` triggers to the scattered rows."""
        from repro_torch.core.faults import corrupt_stacked_row

        for h_local, slot, mode, core_sel in self.faults.corrupt_targets(
                base, total):
            if slot >= len(self._out_streams[0]):
                continue
            if not sched.flush_mask[h_local, slot]:
                continue
            for c, core in enumerate(self._core_ids):
                if core_sel is not None and core != core_sel:
                    continue
                row = int(sched.scatter_indices[h_local, c, slot])
                out_bufs[c][slot] = corrupt_stacked_row(out_bufs[c][slot], row, mode)
        return out_bufs

    # -- compiled mode -------------------------------------------------------

    def _simulate_schedule(self, total: int) -> _RunSchedule:
        """Replay the host loop's cursor bookkeeping into static index arrays.

        Mirrors :meth:`run` exactly: prologue (rate-0 residents + hyperstep
        0's tokens), then per hyperstep the rate-k advances followed by the
        ``on_hyperstep_end`` seeks.
        """
        ncores = self.num_cores
        rates = self._rates
        adv = [i for i, r in enumerate(rates) if r > 0]
        n_out = len(self._out_streams[0])
        start_in = [[s.cursor for s in ss] for ss in self._streams]
        start_out = [[s.cursor for s in outs] for outs in self._out_streams]
        proxies = [[_CursorProxy(s) for s in ss] for ss in self._streams]
        gather = np.zeros((total, ncores, len(adv)), np.int32)
        resident = np.zeros((ncores, len(rates)), np.int32)
        initial_words = []
        for c, (ss, px) in enumerate(zip(self._streams, proxies)):
            words = 0
            for i, (s, r) in enumerate(zip(ss, rates)):
                if r == 0:
                    resident[c, i] = px[i].take(1)
                    words += s.token_words
            for a_j, i in enumerate(adv):
                gather[0, c, a_j] = px[i].take(rates[i])
                words += ss[i].token_words * rates[i]
            initial_words.append(words)

        def on_end(h: int) -> None:
            if self._on_end is None:
                return
            arg = proxies if self._multi else proxies[0]
            self._on_end(h, arg)

        on_end(0)
        for h in range(1, total):
            for c, px in enumerate(proxies):
                for a_j, i in enumerate(adv):
                    gather[h, c, a_j] = px[i].take(rates[i])
            on_end(h)

        out_px = [[_CursorProxy(s) for s in outs] for outs in self._out_streams]
        scatter = np.zeros((total, ncores, n_out), np.int32)
        flush = np.zeros((total, n_out), bool)
        wb_words = [0] * ncores
        for h in range(total):
            for j, every in enumerate(self._out_every):
                if (h + 1) % every != 0:
                    continue
                flush[h, j] = True
                for c in range(ncores):
                    scatter[h, c, j] = out_px[c][j].take(1)
                    wb_words[c] += self._out_streams[c][j].token_words
        step_words = [
            sum(s.token_words * r for s, r in zip(ss, rates))
            for ss in self._streams
        ]
        return _RunSchedule(
            total=total,
            gather_indices=gather,
            resident_indices=resident,
            scatter_indices=scatter,
            flush_mask=flush,
            step_words=step_words,
            initial_words=initial_words,
            writeback_words=wb_words,
            final_in_cursors=[[p.cursor for p in px] for px in proxies],
            final_out_cursors=[[p.cursor for p in px] for px in out_px],
            start_in_cursors=start_in,
            start_out_cursors=start_out,
        )

    def _schedule_current(self, sched: _RunSchedule) -> bool:
        """True if the streams stand where ``sched``'s cursor walk starts."""
        return (sched.start_in_cursors
                == [[s.cursor for s in ss] for ss in self._streams]
                and sched.start_out_cursors
                == [[s.cursor for s in outs] for outs in self._out_streams])

    @traced("repro_torch.hyperstep.compile")
    def compile(self, num_hypersteps: int | None = None) -> CompiledHyperstepProgram:
        """Build the whole hyperstep program as one replay of the cursor walk.

        The returned program runs ``total`` hypersteps with no host sync in
        between: token fetches become gathers from stacked stream copies
        (static index arrays from :meth:`_simulate_schedule`), write-backs
        become masked scatters into stacked output buffers. The step must
        return an out token for *every* slot every hyperstep (the flush mask
        drops the non-completing ones; the ``None`` skip is a host-loop-only
        contract). Programs are cached per hyperstep count;
        ``run(compiled=True)`` compiles on first use. Under a profiler each
        build is a ``repro_torch.hyperstep.compile`` span.
        """
        for ss in (*self._streams, *self._out_streams):
            for s in ss:
                if not hasattr(s, "as_stacked"):
                    raise TypeError(
                        f"compiled mode needs array-backed streams with "
                        f"as_stacked(); {getattr(s, 'name', s)!r} has none "
                        "(use measure mode for host-I/O streams)")
        total = self._resolve_total(num_hypersteps)
        if total <= 0:
            raise ValueError(f"nothing to compile (total={total})")
        self._verify_or_raise(total)
        sched = self._simulate_schedule(total)
        prog = CompiledHyperstepProgram(
            total=total, schedule=sched, _call=self._build_program(sched))
        self._compiled_cache[total] = prog
        return prog

    def _build_program(self, sched: _RunSchedule) -> Callable:
        ncores = self.num_cores
        rates = self._rates
        n_out = len(self._out_streams[0])
        multi = self._multi
        step = self._step
        # python ints: indexing a device tensor with them needs no host sync
        gather = sched.gather_indices.tolist()
        scatter = sched.scatter_indices.tolist()
        flush = sched.flush_mask.tolist()
        res_idx = sched.resident_indices.tolist()

        def program(state: Any, out_bufs: Any, stacked: Any) -> Any:
            residents = [
                [None if rates[i] > 0 else _gather_block(stacked[c][i], res_idx[c][i], 1)
                 for i in range(len(rates))]
                for c in range(ncores)
            ]
            for h in range(sched.total):
                per_core = []
                for c in range(ncores):
                    toks, a_j = [], 0
                    for i, r in enumerate(rates):
                        if r == 0:
                            toks.append(residents[c][i])
                        else:
                            toks.append(_gather_block(
                                stacked[c][i], gather[h][c][a_j], r))
                            a_j += 1
                    per_core.append(toks)
                out = step(state, self._step_tokens(per_core))
                if not n_out:
                    state = out
                    continue
                state, out_tokens = out
                for j in range(n_out):
                    if not flush[h][j]:
                        continue
                    for c in range(ncores):
                        _scatter_block(out_bufs[c][j],
                                       out_tokens[j][c] if multi else out_tokens[j],
                                       scatter[h][c][j])
            return state, out_bufs

        return program

    def _run_compiled(self, state: Any, num_hypersteps: int | None) -> Any:
        total = self._resolve_total(num_hypersteps)
        if total <= 0:
            return state
        self._verify_or_raise(total)
        base = self.lifetime_hypersteps
        fault_start = (len(getattr(self.faults, "trace", ()))
                       if self.faults is not None else 0)
        if self.faults is not None:
            # simulated preemption: raises before any stream opens or state
            # moves, so the caller may retry the dispatch verbatim
            self.faults.on_dispatch()
        prog = self._compiled_cache.get(total)
        if prog is not None and not self._schedule_current(prog.schedule):
            # the streams stand at a different cursor position than the
            # cached walk was simulated from (a caller seeked between runs):
            # the static gather/scatter arrays are stale — rebuild
            prog = None
        if prog is None:
            prog = self.compile(total)
        sched = prog.schedule
        for core, ins, outs in zip(self._core_ids, self._streams,
                                   self._out_streams):
            for s in [*ins, *outs]:
                s.open(core)
        try:
            # staging: the whole pseudo-stream crosses the external link once
            # (the compiled twin of the prologue + the per-step prefetches)
            t0 = time.perf_counter()
            with span("repro_torch.hyperstep.stage"):
                stacked = [[s.as_stacked(self.device) for s in ss]
                           for ss in self._streams]
                out_bufs = [[s.as_stacked(self.device) for s in outs]
                            for outs in self._out_streams]
                _block(stacked)
                _block(out_bufs)
                if self.faults is not None:
                    # the whole run stages at once, so every dma_stall
                    # trigger in range lands on this one link crossing
                    d = sum(self.faults.fetch_delay(g)
                            for g in range(base, base + total))
                    if d:
                        time.sleep(d)
            stage_s = time.perf_counter() - t0

            t1 = time.perf_counter()
            with span("repro_torch.hyperstep.replay"):
                state, out_bufs = prog(state, out_bufs, stacked)
                _block(state)
                _block(out_bufs)
                if self.faults is not None:
                    d = sum(self.faults.compute_delay(g)
                            for g in range(base, base + total))
                    if d:
                        time.sleep(d)
            run_s = time.perf_counter() - t1

            # the run's boundary: corruption triggers land on the scattered
            # rows, and the health monitor reads each output buffer once
            if self.faults is not None:
                out_bufs = self._apply_compiled_corruption(
                    sched, out_bufs, base, total)
            if self.health is not None:
                for c in range(self.num_cores):
                    for buf in out_bufs[c]:
                        self.health.check_output(
                            buf, source=self._source_name, index=base)

            # drain the finished output tokens back to external memory and
            # advance the cursors to the walk's final positions
            t2 = time.perf_counter()
            with span("repro_torch.hyperstep.drain"):
                for c, (core, outs) in enumerate(zip(self._core_ids,
                                                     self._out_streams)):
                    for j, s in enumerate(outs):
                        s.load_stacked(out_bufs[c][j])
                        s.seek(core, sched.final_out_cursors[c][j] - s.cursor)
            drain_s = time.perf_counter() - t2
            for c, (core, ins) in enumerate(zip(self._core_ids, self._streams)):
                for i, s in enumerate(ins):
                    s.seek(core, sched.final_in_cursors[c][i] - s.cursor)
        finally:
            for core, ins, outs in zip(self._core_ids, self._streams,
                                       self._out_streams):
                for s in [*ins, *outs]:
                    s.close(core)

        # One whole-run record: compute/step = the replay. The link-busy
        # fields hold the run's real external traffic times — fetch = staging
        # the stacked streams, writeback = draining the output buffers — so
        # the bandwidth-heavy vote compares measured link time against
        # measured compute time at run granularity. Word totals equal the
        # measure-mode sums (identical schedule).
        for c in range(self.num_cores):
            self.core_records[c].append(HyperstepRecord(
                index=0,
                compute_seconds=run_s,
                fetch_seconds=stage_s,
                step_seconds=run_s,
                fetch_words=sched.step_words[c] * (total - 1),
                writeback_seconds=drain_s,
                writeback_words=sched.writeback_words[c],
                initial_fetch_words=sched.initial_words[c],
            ))
        self.records.append(HyperstepRecord(
            index=0,
            compute_seconds=run_s,
            fetch_seconds=stage_s,
            step_seconds=run_s,
            fetch_words=max(sched.step_words) * (total - 1),
            writeback_seconds=drain_s,
            writeback_words=max(sched.writeback_words),
            initial_fetch_words=max(sched.initial_words),
        ))
        self.hypersteps_run += total
        self.dispatches_run += 1
        self.lifetime_hypersteps += total
        self.lifetime_dispatches += 1
        # the run's bulk-synchronous wall: staging the pseudo-stream across
        # the link + the replay + draining the outputs. step_seconds alone is
        # the compute window — Eq. 1 prices the link crossings too, so health
        # scoring and the calibration record use the full wall (a stalled
        # DMA lands in stage_s and must move the ratio)
        wall = stage_s + run_s + drain_s
        self._observe(total, 1, self.lifetime_dispatches - 1,
                      measured_seconds=wall)
        self._record_measurement(total, 1, len(self.records) - 1,
                                 fault_start, wall)
        return state

    def run(self, state: Any, num_hypersteps: int | None = None, *,
            compiled: bool = False, measure: bool = True) -> Any:
        """Execute hypersteps until streams are exhausted (or a fixed count).

        Callable repeatedly: closing the streams on exit rewinds their
        cursors, so each call replays the program from the start (records
        accumulate across calls).

        ``compiled=True`` replays the whole program with no host sync per
        hyperstep (see :meth:`compile`); ``measure`` applies to the host loop
        only — when False the per-hyperstep bulk sync no longer waits for the
        device, so the per-step compute timings are enqueue times, not device
        times.
        """
        if compiled:
            return self._run_compiled(state, num_hypersteps)
        ncores = self.num_cores
        # One background lane per core, like the single DMA engine per
        # Epiphany core; per-run so the runner can be reused afterwards.
        self._dma = [
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"bsps-dma{c}")
            for c in self._core_ids
        ]
        lanes = [_Lane.open(self.device) for _ in self._core_ids]
        for core, ins, outs in zip(self._core_ids, self._streams,
                                   self._out_streams):
            for s in [*ins, *outs]:
                s.open(core)
        wb_futs: list[Future | None] = [None] * ncores
        wb_idx = -1

        def join_writeback() -> None:
            nonlocal wb_futs
            if all(f is None for f in wb_futs):
                return
            per = [(0, 0.0) if f is None else f.result() for f in wb_futs]
            if 0 <= wb_idx < len(self.records):
                for c, (words, seconds) in enumerate(per):
                    rec = self.core_records[c][wb_idx]
                    rec.writeback_seconds = seconds
                    rec.writeback_words = words
                agg = self.records[wb_idx]
                agg.writeback_seconds = max(s for _, s in per)
                agg.writeback_words = max(w for w, _ in per)
            wb_futs = [None] * ncores

        try:
            total = self._resolve_total(num_hypersteps)
            if total <= 0:
                return state
            self._verify_or_raise(total)
            inj = self.faults
            base = self.lifetime_hypersteps
            rec_start = len(self.records)
            fault_start = len(getattr(inj, "trace", ())) if inj is not None else 0

            # Hyperstep 0's tokens are assumed resident at program start
            # (paper §2); rate-0 operands are fetched here, once, and reused.
            # Each core's prologue runs on its own DMA lane; the words and
            # lane-busy time land in record 0's initial_fetch_* fields so the
            # measured fetch totals match the plan's arrival-0 charge.
            pro_futs = [
                dma.submit(_prologue, ss, self._rates, core, lane, inj, base)
                for dma, ss, core, lane in zip(self._dma, self._streams,
                                               self._core_ids, lanes)
            ]
            pro = [f.result() for f in pro_futs]
            residents = [p[0] for p in pro]
            init_stats = [(p[2], p[3]) for p in pro]
            per_core_toks = [self._assemble(residents[c], pro[c][1])
                             for c in range(ncores)]
            step_toks = self._step_tokens(per_core_toks)
            if self._on_end:
                self._on_end(0, self._on_end_arg())

            step_words = [
                sum(s.token_words * r for s, r in zip(ss, self._rates))
                for ss in self._streams
            ]
            n_out = len(self._out_streams[0])

            for h in range(total):
                if inj is not None:
                    # host-loop dispatch = one step call per hyperstep; an
                    # injected preemption raises here, before this step's
                    # compute or cursor motion (the finally rewinds streams)
                    inj.on_dispatch()
                t0 = time.perf_counter()
                last = h == total - 1
                futs: list[Future] | None = None
                if not last:
                    if self._prefetch:
                        futs = [
                            dma.submit(_fetch, ss, self._rates, core, lane,
                                       inj, base + h + 1)
                            for dma, ss, core, lane in zip(
                                self._dma, self._streams, self._core_ids, lanes)
                        ]
                    else:
                        nxts = [
                            _fetch(ss, self._rates, core, lane, inj, base + h + 1)
                            for ss, core, lane in zip(
                                self._streams, self._core_ids, lanes)
                        ]

                t_c = time.perf_counter()
                out = self._step(state, step_toks)
                if n_out:
                    state, out_tokens = out
                else:
                    state, out_tokens = out, ()
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                if measure:
                    # the bulk sync doubles as the timing fence; without
                    # records the steps may be enqueued ahead freely
                    _block(state)
                if inj is not None:
                    d = inj.compute_delay(base + h)
                    if d:
                        time.sleep(d)  # straggler: the core, not the link
                compute_s = time.perf_counter() - t_c

                wait_s = 0.0
                if not last:
                    if futs is not None:
                        t_w = time.perf_counter()
                        nxts = [f.result() for f in futs]  # bulk synchronisation
                        wait_s = time.perf_counter() - t_w
                    fetch_secs = [s for _, s in nxts]
                    per_core_toks = [
                        self._assemble(residents[c], nxts[c][0])
                        for c in range(ncores)
                    ]
                    step_toks = self._step_tokens(per_core_toks)
                else:
                    fetch_secs = [0.0] * ncores

                # join the *previous* write-back (it overlapped this compute),
                # then put this step's outputs on the lane for the next overlap
                join_writeback()
                flush = [(h + 1) % e == 0 for e in self._out_every]
                wb_now = [(0, 0.0)] * ncores
                if n_out and any(flush):
                    if inj is not None:
                        out_tokens = [
                            inj.corrupt_token(base + h, j, tok)
                            if flush[j] and tok is not None else tok
                            for j, tok in enumerate(out_tokens)
                        ]
                    if self.health is not None:
                        for j, tok in enumerate(out_tokens):
                            if flush[j] and tok is not None:
                                self.health.check_output(
                                    tok, source=self._source_name,
                                    index=base + h)
                    per_core_out = self._per_core_out(out_tokens)
                    if self._prefetch:
                        # absolute index: records accumulate across run() calls
                        wb_idx = len(self.records)
                        wb_futs = [
                            dma.submit(
                                _writeback,
                                [s for s, f in zip(outs, flush) if f],
                                core,
                                [t for t, f in zip(toks, flush) if f],
                                lane, ready)
                            for dma, outs, core, toks, lane in zip(
                                self._dma, self._out_streams, self._core_ids,
                                per_core_out, lanes)
                        ]
                    else:
                        wb_now = [
                            _writeback(
                                [s for s, f in zip(outs, flush) if f],
                                core,
                                [t for t, f in zip(toks, flush) if f],
                                lane, ready)
                            for outs, core, toks, lane in zip(
                                self._out_streams, self._core_ids,
                                per_core_out, lanes)
                        ]

                step_s = time.perf_counter() - t0
                for c in range(ncores):
                    self.core_records[c].append(HyperstepRecord(
                        index=h,
                        compute_seconds=compute_s,
                        fetch_seconds=fetch_secs[c],
                        step_seconds=step_s,
                        fetch_words=step_words[c] if not last else 0,
                        fetch_wait_seconds=wait_s,
                        writeback_seconds=wb_now[c][1],
                        writeback_words=wb_now[c][0],
                        initial_fetch_seconds=init_stats[c][1] if h == 0 else 0.0,
                        initial_fetch_words=init_stats[c][0] if h == 0 else 0,
                    ))
                # the bulk-synchronous aggregate: the max over cores, the
                # quantity Eq. 1's per-hyperstep max prices
                self.records.append(HyperstepRecord(
                    index=h,
                    compute_seconds=compute_s,
                    fetch_seconds=max(fetch_secs),
                    step_seconds=step_s,
                    fetch_words=max(step_words) if not last else 0,
                    fetch_wait_seconds=wait_s,
                    writeback_seconds=max(s for _, s in wb_now),
                    writeback_words=max(w for w, _ in wb_now),
                    initial_fetch_seconds=(
                        max(s for _, s in init_stats) if h == 0 else 0.0),
                    initial_fetch_words=(
                        max(w for w, _ in init_stats) if h == 0 else 0),
                ))
                self.hypersteps_run += 1
                self.dispatches_run += 1
                self.lifetime_hypersteps += 1
                self.lifetime_dispatches += 1
                self._observe(1, 1, base + h)
                if self._on_end and not last:
                    # Cursor adjustments (seek/MOVE) for the *following* fetch.
                    self._on_end(h + 1, self._on_end_arg())
            join_writeback()
            if not measure:
                _block(state)  # final bulk sync before cursors rewind
            # host-loop wall: step_seconds already spans compute + fetch wait
            # per hyperstep, so the run's measured side is their sum
            self._record_measurement(
                total, total, rec_start, fault_start,
                sum(r.step_seconds for r in self.records[rec_start:]))
            return state
        finally:
            # join any in-flight DMA work *before* closing: close() rewinds
            # the cursors, and a background move_down/move_up landing
            # afterwards would corrupt the replay state of the next run()
            for dma in self._dma:
                dma.shutdown(wait=True)
            if any(f is not None for f in wb_futs):
                join_writeback()
            for core, ins, outs in zip(self._core_ids, self._streams,
                                       self._out_streams):
                for s in [*ins, *outs]:
                    s.close(core)

    def reset_records(self) -> None:
        """Drop accumulated timing state (records persist across run() calls).

        For long-lived runners on a hot path (one cached decode runner
        serving many requests) call this before a run to make
        :meth:`predicted_vs_measured` a per-run row instead of a lifetime
        aggregate. Compiled programs stay cached — only measurements reset.
        """
        self.records = []
        self.core_records = [[] for _ in self._core_ids]
        self.hypersteps_run = 0
        self.dispatches_run = 0

    @property
    def total_seconds(self) -> float:
        return sum(r.step_seconds for r in self.records)

    @property
    def total_fetch_words(self) -> int:
        """Words streamed down over the run, max-core, incl. the initial fetch.

        Matches ``plan.total_fetch_words()`` (the enumerated arrival schedule)
        for plans whose fetch volume is uniform per hyperstep.
        """
        return sum(r.fetch_words + r.initial_fetch_words for r in self.records)

    # -- cost-model hooks ----------------------------------------------------

    def predicted_seconds(self) -> float | None:
        """Eq. 1 prediction for this run, or None without a plan + machine.

        After :meth:`run`, a ``num_hypersteps`` override shorter than the plan
        is priced pro rata so prediction and measurement cover the same steps.
        The execution mode adds its own barriers on top — one bulk sync per
        host-loop hyperstep, one per compiled run — charged at the machine's
        ``l`` (the calibrated per-hyperstep latency).
        """
        if self.plan is None or self.machine is None:
            return None
        pred = self.plan.predicted_seconds(self.machine)
        if self.hypersteps_run and self.hypersteps_run != self.plan.num_hypersteps:
            pred *= self.hypersteps_run / self.plan.num_hypersteps
        pred += self.machine.flops_to_seconds(
            self.machine.l * self.dispatches_run)
        return pred

    def predicted_vs_measured(self) -> dict[str, float]:
        """One predicted-vs-measured table row (run first, then call this)."""
        if not self.records:
            raise RuntimeError("run() the program before asking for the table row")
        pred = self.predicted_seconds()
        if pred is None:
            raise RuntimeError("construct the runner with plan= and machine=")
        meas = self.total_seconds
        planned_words = self.plan.total_fetch_words()
        if self.hypersteps_run != self.plan.num_hypersteps:
            planned_words *= self.hypersteps_run / self.plan.num_hypersteps
        return {
            "predicted_seconds": pred,
            "measured_seconds": meas,
            "pred_over_meas": pred / max(meas, 1e-12),
            "bandwidth_heavy_predicted": float(self.plan.bandwidth_heavy(self.machine)),
            "bandwidth_heavy_measured": float(self._measured_bandwidth_heavy()),
            "fetch_words_planned": planned_words,
            "fetch_words_measured": float(self.total_fetch_words),
        }

    def _measured_bandwidth_heavy(self) -> bool:
        """Majority vote over the hypersteps that actually moved tokens.

        The fetch and write-back durations are measured inside the DMA lane,
        so the vote compares real link-busy time against real compute time in
        both prefetch and serial mode.
        """
        recs = [
            r for r in self.records if r.fetch_words > 0 or r.writeback_words > 0
        ] or self.records
        votes = [r.bandwidth_heavy for r in recs]
        return sum(votes) > len(votes) / 2


def run_bsps(
    step: Callable[..., Any],
    streams: Sequence[Stream],
    state: Any,
    **kwargs: Any,
) -> tuple[Any, list[HyperstepRecord]]:
    """One-shot convenience wrapper around :class:`HyperstepRunner`."""
    runner = HyperstepRunner(step, streams, **kwargs)
    out = runner.run(state)
    return out, runner.records

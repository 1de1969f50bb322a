"""Static verification of BSPS plans and runners (DESIGN.md §9).

The paper's central property — a BSPS program's behaviour is fully determined
by its declaration (index maps, rates, seek schedules, token sizes) — cuts
both ways: the same declarations Eq. 1/Eq. 2 price *before* a run also decide
its correctness before a run. This module replays those declarations
symbolically and returns structured :class:`Diagnostic` records instead of
letting cursor overruns, cross-core write races, blown double-buffer budgets,
or backing aliasing surface as silent wrong answers or opaque errors
deep inside :meth:`repro_torch.core.hyperstep.HyperstepRunner.compile`.

Nothing here executes or compiles anything: plan-level checks walk the
declared grid (:func:`verify_plan`), runner-level checks replay the cursor
bookkeeping against diagnostic proxies (:func:`verify_runner`) — the same
walk :meth:`HyperstepRunner._simulate_schedule` performs to build a compiled
program, collecting findings rather than raising on the first.

Diagnostic codes are stable (tests assert them, and they equal the JAX
package's codes, severities and messages on the same plans) and grouped by
check family:

=========  ========  ==========================================================
code       severity  meaning
=========  ========  ==========================================================
BSPS101    error     MOVE/seek lands outside the stream's token range
BSPS102    error     stream exhausted before the requested hypersteps
BSPS103    warn      rate / out_every does not divide the available tokens
                     (the tail hyperstep silently truncates)
BSPS104    error     index map addresses a block starting outside full_shape
BSPS105    info      on_hyperstep_end is not statically replayable
BSPS121    error     write-write race: two up-stream slots hit the same output
                     token in the same hyperstep
BSPS122    error     output block revisited after completion (the write-back
                     lane already flushed it — lost update)
BSPS141    error     per-hyperstep local-memory peak exceeds the budget L
BSPS142    error     up-stream aliases a down-stream backing
                     (read-after-writeback hazard)
BSPS143    info      whole-plan double-buffer bound exceeds L but the
                     per-step peak fits (the static bound is pessimistic)
BSPS161    warn      declared host_comm_words disagrees with the resolved
                     shardspec's host_h_relation
BSPS162    warn      bandwidth_heavy verdict flips between exact and
                     closed-form pricing
=========  ========  ==========================================================

Wiring (DESIGN.md §9): ``HyperstepRunner.compile()``/``run()`` verify by
default and raise :class:`PlanVerificationError` on error-severity findings
(opt out with ``HyperstepRunner(..., verify=False)``);
:func:`repro_torch.core.plan.enumerate_plans` attaches each candidate's
diagnostics to its :class:`~repro_torch.core.plan.PlanChoice`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

import numpy as np

from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.plan import ENUMERATION_LIMIT, StreamPlan

__all__ = [
    "Diagnostic",
    "PlanVerificationError",
    "CODES",
    "SEVERITY",
    "verify_plan",
    "verify_runner",
    "format_diagnostics",
]

CODES = {
    "BSPS101": "seek outside the stream's token range",
    "BSPS102": "stream exhausted before the requested hypersteps",
    "BSPS103": "rate/out_every does not divide the available tokens",
    "BSPS104": "index map addresses a block outside full_shape",
    "BSPS105": "on_hyperstep_end is not statically replayable",
    "BSPS121": "write-write race on an up-stream token",
    "BSPS122": "output block revisited after completion",
    "BSPS141": "per-hyperstep local-memory peak exceeds budget",
    "BSPS142": "up-stream aliases a down-stream backing",
    "BSPS143": "double-buffer bound pessimistic; per-step peak fits",
    "BSPS161": "host_comm_words disagrees with shardspec h-relation",
    "BSPS162": "bandwidth_heavy verdict flips exact vs closed-form",
}

SEVERITY = {
    "BSPS101": "error",
    "BSPS102": "error",
    "BSPS103": "warn",
    "BSPS104": "error",
    "BSPS105": "info",
    "BSPS121": "error",
    "BSPS122": "error",
    "BSPS141": "error",
    "BSPS142": "error",
    "BSPS143": "info",
    "BSPS161": "warn",
    "BSPS162": "warn",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding, locatable and stable across releases.

    ``code`` is from :data:`CODES`; ``severity`` error/warn/info (errors make
    ``compile()``/``run()`` raise, warns and infos only show in tables);
    ``hyperstep``/``stream`` locate the finding where the check can pin one;
    ``hint`` says what to change.
    """

    code: str
    severity: str
    message: str
    plan: str = ""
    hyperstep: int | None = None
    stream: str = ""
    hint: str = ""

    def format(self) -> str:
        loc = self.plan or "<runner>"
        if self.stream:
            loc += f":{self.stream}"
        if self.hyperstep is not None:
            loc += f"@h{self.hyperstep}"
        out = f"{self.code} {self.severity:5s} {loc}: {self.message}"
        if self.hint:
            out += f"  [{self.hint}]"
        return out


def _diag(code: str, message: str, *, plan: str = "",
          hyperstep: int | None = None, stream: str = "",
          hint: str = "") -> Diagnostic:
    return Diagnostic(code=code, severity=SEVERITY[code], message=message,
                      plan=plan, hyperstep=hyperstep, stream=stream, hint=hint)


def format_diagnostics(diags: Sequence[Diagnostic]) -> str:
    return "\n".join(d.format() for d in diags)


class PlanVerificationError(RuntimeError):
    """Raised by ``HyperstepRunner.compile()``/``run()`` on error findings."""

    def __init__(self, diagnostics: Sequence[Diagnostic]) -> None:
        self.diagnostics = tuple(diagnostics)
        super().__init__(
            "plan verification failed:\n" + format_diagnostics(self.diagnostics)
            + "\n(pass verify=False to the runner to skip static checks)")


# ---------------------------------------------------------------------------
# Plan-level checks: the declared grid walk, budget, and pricing consistency
# ---------------------------------------------------------------------------


def _token_blocks(plan: StreamPlan) -> tuple[list[Any], np.ndarray]:
    """Enumerate every token's block coords over the grid, one pass."""
    coords_all = list(itertools.product(*(range(g) for g in plan.grid)))
    h_total = len(coords_all)
    blocks = []
    for tok in (*plan.inputs, *plan.outputs):
        blocks.append(np.asarray([tok.index_map(*c) for c in coords_all],
                                 np.int64).reshape(h_total, -1))
    return blocks, np.asarray(coords_all, np.int64)


def _check_index_ranges(plan: StreamPlan, blocks: list[np.ndarray],
                        diags: list[Diagnostic]) -> None:
    """BSPS104 — a block whose *start* lies outside full_shape can never be a
    legal edge block (partial trailing blocks are legal padding)."""
    for tok, blk in zip((*plan.inputs, *plan.outputs), blocks):
        if tok.full_shape is None or len(tok.full_shape) != blk.shape[1]:
            continue
        starts = blk * np.asarray(tok.block_shape, np.int64)
        bad = np.any((starts >= np.asarray(tok.full_shape, np.int64))
                     | (blk < 0), axis=1)
        if bad.any():
            h = int(np.argmax(bad))
            diags.append(_diag(
                "BSPS104",
                f"block {tuple(int(b) for b in blk[h])} starts outside "
                f"full_shape {tok.full_shape}",
                plan=plan.name, hyperstep=h, stream=tok.name,
                hint="index map must stay inside full_shape // block_shape"))


def _check_output_revisits(plan: StreamPlan, blocks: list[np.ndarray],
                           diags: list[Diagnostic]) -> None:
    """BSPS122 — an output block the walk left was already flushed up the
    link (``writeback_schedule`` charges on the change); coming back to it
    writes a stale resident copy over the finished result. Non-injective
    *down*-stream maps are the paper's MOVE reuse and stay legal."""
    n_in = len(plan.inputs)
    for tok, blk in zip(plan.outputs, blocks[n_in:]):
        seen: set[tuple[int, ...]] = set()
        prev: tuple[int, ...] | None = None
        for h in range(blk.shape[0]):
            cur = tuple(int(b) for b in blk[h])
            if cur != prev:
                if cur in seen:
                    diags.append(_diag(
                        "BSPS122",
                        f"output block {cur} revisited after the walk moved "
                        f"off it (flushed at the earlier visit)",
                        plan=plan.name, hyperstep=h, stream=tok.name,
                        hint="make the output map's visits contiguous "
                             "(order the grid so each output block finishes "
                             "once)"))
                    break
                if prev is not None:
                    seen.add(prev)
                prev = cur


def _per_step_peak_bytes(plan: StreamPlan,
                         blocks: list[np.ndarray]) -> tuple[int, int]:
    """(peak bytes, argmax hyperstep) of the per-hyperstep footprint.

    Tighter than :attr:`StreamPlan.vmem_bytes` (which double-buffers every
    non-resident token all the time): the second buffer of an input is only
    live on steps whose *next* step changes its block (prefetch in flight),
    and of an output only on steps where a finished block drains while the
    next fills. ``batched_scratch`` lanes are in ``scratch_bytes``.
    """
    h_total = blocks[0].shape[0] if blocks else plan.num_hypersteps
    footprint = np.full(h_total, plan.scratch_bytes, np.int64)
    n_in = len(plan.inputs)
    for tok, blk in zip(plan.inputs, blocks[:n_in]):
        footprint += tok.nbytes
        if tok.resident:
            continue
        changed = np.any(blk[1:] != blk[:-1], axis=1)
        footprint[:-1] += np.where(changed, tok.nbytes, 0)
    for tok, blk in zip(plan.outputs, blocks[n_in:]):
        footprint += tok.nbytes
        if tok.resident:
            continue
        completes = np.zeros(h_total, bool)
        completes[:-1] = np.any(blk[1:] != blk[:-1], axis=1)
        completes[-1] = True
        footprint += np.where(completes, tok.nbytes, 0)
    h = int(np.argmax(footprint))
    return int(footprint[h]), h


def verify_plan(
    plan: StreamPlan,
    acc: BSPAccelerator | None = None,
    *,
    host_h: dict[str, float] | None = None,
    exact: bool | None = None,
) -> list[Diagnostic]:
    """Statically check a :class:`StreamPlan`; returns diagnostics, raises
    nothing.

    With ``acc`` the budget checks run (BSPS141/143) and the pricing-verdict
    consistency check (BSPS162); with ``host_h`` (a dict with the host-level
    ``h_words`` and ``supersteps`` of a sharded program) the declared
    host-level pricing is cross-checked (BSPS161). ``exact=False`` skips the
    enumerated walks (O(1), for production-sized sweeps), keeping only the
    closed-form budget bound.
    """
    diags: list[Diagnostic] = []
    enumerable = (plan.num_hypersteps <= ENUMERATION_LIMIT
                  and exact is not False)
    budget = None if acc is None else acc.L * acc.word_bytes

    if enumerable:
        blocks, _ = _token_blocks(plan)
        _check_index_ranges(plan, blocks, diags)
        _check_output_revisits(plan, blocks, diags)
        if budget is not None:
            peak, h_peak = _per_step_peak_bytes(plan, blocks)
            if peak > budget:
                diags.append(_diag(
                    "BSPS141",
                    f"per-hyperstep peak {peak} B exceeds local memory "
                    f"{budget} B on {acc.name}",
                    plan=plan.name, hyperstep=h_peak,
                    hint="shrink block shapes or scratch (autotune under "
                         "fits())"))
            elif plan.vmem_bytes > budget:
                diags.append(_diag(
                    "BSPS143",
                    f"static double-buffer bound {plan.vmem_bytes} B exceeds "
                    f"{budget} B but the per-step peak {peak} B fits",
                    plan=plan.name, hyperstep=h_peak,
                    hint="the plan is runnable; fits() is conservative for "
                         "this walk"))
    elif budget is not None and plan.vmem_bytes > budget:
        diags.append(_diag(
            "BSPS141",
            f"double-buffered footprint {plan.vmem_bytes} B exceeds local "
            f"memory {budget} B on {acc.name}",
            plan=plan.name,
            hint="shrink block shapes or scratch (autotune under fits())"))

    if acc is not None and enumerable:
        if plan.bandwidth_heavy(acc, exact=True) != plan.bandwidth_heavy(
                acc, exact=False):
            exact_side = ("bandwidth_heavy"
                          if plan.bandwidth_heavy(acc, exact=True)
                          else "compute_bound")
            diags.append(_diag(
                "BSPS162",
                f"pricing verdict flips: exact says {exact_side}, the closed "
                f"form says the opposite on {acc.name}",
                plan=plan.name,
                hint="reuse-heavy walks overcount in the closed form; "
                     "price this plan with exact=True"))

    if host_h is not None:
        implied_h = float(host_h.get("h_words", 0.0))
        declared_h = float(plan.host_comm_words_per_hyperstep)
        scale = max(abs(implied_h), abs(declared_h))
        if scale > 0 and abs(implied_h - declared_h) > 0.05 * scale:
            diags.append(_diag(
                "BSPS161",
                f"declared host_comm_words_per_hyperstep={declared_h:.6g} vs "
                f"shardspec h-relation {implied_h:.6g}",
                plan=plan.name,
                hint="pass host_h_relation()['h_words'] straight into "
                     "host_plan(host_comm_words_per_hyperstep=)"))
        implied_s = float(host_h.get("supersteps", 0.0))
        declared_s = float(plan.host_supersteps_per_hyperstep)
        scale = max(abs(implied_s), abs(declared_s))
        if scale > 0 and abs(implied_s - declared_s) > 0.05 * scale:
            diags.append(_diag(
                "BSPS161",
                f"declared host_supersteps_per_hyperstep={declared_s:.6g} vs "
                f"shardspec supersteps {implied_s:.6g}",
                plan=plan.name,
                hint="pass host_h_relation()['supersteps'] straight into "
                     "host_plan(host_supersteps_per_hyperstep=)"))
    return diags


# ---------------------------------------------------------------------------
# Runner-level checks: replay the cursor walk, race + aliasing over real slots
# ---------------------------------------------------------------------------


class _DiagCursor:
    """Cursor proxy that records violations instead of raising.

    The diagnostic twin of ``hyperstep._CursorProxy``: seeks clamp into range
    and takes saturate at the end, so one bad MOVE yields one finding and the
    replay still covers the rest of the walk. One finding per (stream, code).
    """

    def __init__(self, stream: Any, sink: list[Diagnostic], hbox: list[int],
                 plan_name: str) -> None:
        self.num_tokens = stream.num_tokens
        self.name = (getattr(stream, "name", "")
                     or f"stream{getattr(stream, 'stream_id', '?')}")
        self._cursor = int(stream.cursor)
        self._sink = sink
        self._hbox = hbox
        self._plan = plan_name
        self._seen: set[str] = set()

    @property
    def cursor(self) -> int:
        return self._cursor

    def _flag(self, code: str, message: str, hint: str) -> None:
        if code in self._seen:
            return
        self._seen.add(code)
        self._sink.append(_diag(code, message, plan=self._plan,
                                hyperstep=self._hbox[0], stream=self.name,
                                hint=hint))

    def seek(self, core: int, delta_tokens: int) -> None:
        new = self._cursor + delta_tokens
        if not 0 <= new <= self.num_tokens:
            self._flag(
                "BSPS101",
                f"seek by {delta_tokens} lands at {new}, outside "
                f"[0, {self.num_tokens}]",
                "check the MOVE/on_hyperstep_end schedule against the grid "
                "walk")
            new = min(max(new, 0), self.num_tokens)
        self._cursor = new

    def take(self, n: int) -> int:
        if self._cursor + n > self.num_tokens:
            self._flag(
                "BSPS102",
                f"exhausted at cursor {self._cursor} (+{n} of "
                f"{self.num_tokens} tokens)",
                "shorten num_hypersteps or supply more tokens")
            return max(0, self.num_tokens - n)
        start = self._cursor
        self._cursor += n
        return start


def _backing_key(stream: Any) -> int:
    data = getattr(stream, "data", None)
    return id(data) if data is not None else id(stream)


def verify_runner(runner: Any, num_hypersteps: int | None = None,
                  ) -> list[Diagnostic]:
    """Statically check a :class:`~repro_torch.core.hyperstep.HyperstepRunner` run.

    Replays the exact cursor bookkeeping of :meth:`HyperstepRunner.run` /
    ``_simulate_schedule`` — prologue residents, per-core rate-k advances,
    ``on_hyperstep_end`` seeks, ``out_every`` flushes — against diagnostic
    proxies (BSPS101/102/103/105), detects cross-slot write-write races on
    shared up-stream backings (BSPS121) and up/down aliasing (BSPS142), then
    folds in :func:`verify_plan` of the attached plan. Pure host-side cursor
    arithmetic: no data moves, no tracing, no stream is opened.
    """
    diags: list[Diagnostic] = []
    plan_name = runner.plan.name if runner.plan is not None else ""
    total = runner._resolve_total(num_hypersteps)
    if total <= 0:
        return diags
    rates = runner._rates
    adv = [i for i, r in enumerate(rates) if r > 0]
    hbox = [0]

    # -- schedule replay: BSPS101/102 (+105 for opaque callbacks) ------------
    proxies = [[_DiagCursor(s, diags, hbox, plan_name) for s in ss]
               for ss in runner._streams]
    for px in proxies:
        for i, r in enumerate(rates):
            if r == 0:
                px[i].take(1)
        for i in adv:
            px[i].take(rates[i])

    on_end = runner._on_end

    def run_on_end(h: int) -> None:
        nonlocal on_end
        if on_end is None:
            return
        try:
            on_end(h, proxies if runner._multi else proxies[0])
        except Exception as e:
            diags.append(_diag(
                "BSPS105",
                f"on_hyperstep_end raised {type(e).__name__} during static "
                f"replay ({e}); schedule checks may be incomplete",
                plan=plan_name, hyperstep=h,
                hint="keep on_hyperstep_end cursor-only (seek) for static "
                     "verification and compiled mode"))
            on_end = None

    run_on_end(0)
    for h in range(1, total):
        hbox[0] = h
        for px in proxies:
            for i in adv:
                px[i].take(rates[i])
        run_on_end(h)

    # -- BSPS103: silent tail truncation (only meaningful without seeks) -----
    if runner._on_end is None:
        for ss in runner._streams[:1]:   # slots are homogeneous across cores
            for i, (s, r) in enumerate(zip(ss, rates)):
                avail = s.num_tokens - s.cursor
                if r > 0 and avail % r:
                    diags.append(_diag(
                        "BSPS103",
                        f"rate {r} leaves {avail % r} of {avail} tokens "
                        f"unconsumable (tail truncated)",
                        plan=plan_name,
                        stream=getattr(s, "name", "") or f"slot{i}",
                        hint="pad the stream or pick a dividing rate"))
    for j, every in enumerate(runner._out_every):
        if total % every:
            s = runner._out_streams[0][j]
            diags.append(_diag(
                "BSPS103",
                f"out_every={every} does not divide the {total}-hyperstep "
                f"run; the final partial interval never flushes",
                plan=plan_name,
                stream=getattr(s, "name", "") or f"out{j}",
                hint="choose num_hypersteps as a multiple of out_every"))

    # -- BSPS121/142: write races and up/down aliasing across real slots -----
    in_keys: dict[int, str] = {}
    for ss in runner._streams:
        for s in ss:
            in_keys.setdefault(_backing_key(s), getattr(s, "name", "") or "?")
    out_px = [[_DiagCursor(s, [], hbox, plan_name) for s in outs]
              for outs in runner._out_streams]
    aliased: set[int] = set()
    raced: set[tuple[tuple[int, int], tuple[int, int]]] = set()
    writes: dict[tuple[int, int, int], tuple[int, int]] = {}
    for c, outs in enumerate(runner._out_streams):
        for j, s in enumerate(outs):
            key = _backing_key(s)
            if key in in_keys and key not in aliased:
                aliased.add(key)
                diags.append(_diag(
                    "BSPS142",
                    f"up-stream {getattr(s, 'name', '') or j!r} shares its "
                    f"backing with down-stream {in_keys[key]!r}: the "
                    f"write-back clobbers tokens later reads (and a donated "
                    f"compiled buffer) still gather",
                    plan=plan_name, stream=getattr(s, "name", "") or f"out{j}",
                    hint="give the up-stream its own backing array"))
    for h in range(total):
        hbox[0] = h
        for j, every in enumerate(runner._out_every):
            if (h + 1) % every:
                continue
            for c in range(len(out_px)):
                # saturating take — overruns were already diagnosed above via
                # the real sink on a fresh replay below
                idx = out_px[c][j].take(1)
                key = _backing_key(runner._out_streams[c][j])
                prev = writes.get((h, key, idx))
                pair = None if prev is None else (min(prev, (c, j)),
                                                  max(prev, (c, j)))
                if prev is not None and prev != (c, j) and pair not in raced:
                    raced.add(pair)
                    pc, pj = prev
                    diags.append(_diag(
                        "BSPS121",
                        f"slots core{pc}/out{pj} and core{c}/out{j} both "
                        f"write token {idx} of the same backing at "
                        f"hyperstep {h}",
                        plan=plan_name, hyperstep=h,
                        stream=getattr(runner._out_streams[c][j], "name", "")
                        or f"out{j}",
                        hint="up-stream slots must not share a backing "
                             "array (overlapping up-streams are races; "
                             "only down-stream MOVE maps may overlap)"))
                writes[(h, key, idx)] = (c, j)
    # out-stream exhaustion (the proxies above used a throwaway sink)
    out_diag_px = [[_DiagCursor(s, diags, hbox, plan_name) for s in outs]
                   for outs in runner._out_streams]
    for h in range(total):
        hbox[0] = h
        for j, every in enumerate(runner._out_every):
            if (h + 1) % every:
                continue
            for px in out_diag_px:
                px[j].take(1)

    if runner.plan is not None:
        # a clamped run (total < plan grid, the documented stale-cursor
        # pattern) never executes the plan's tail — the enumerated walk
        # checks would flag hypersteps that don't happen, so keep only the
        # closed-form budget bound in that case
        clamped = total != runner.plan.num_hypersteps
        diags.extend(verify_plan(runner.plan, runner.machine,
                                 exact=False if clamped else None))
    return diags

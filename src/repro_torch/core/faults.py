"""Deterministic fault injection for BSPS programs (DESIGN.md §10).

The BSF verification line (Ezhova; Sokolinsky) validates a cost model by
systematically comparing predictions against measurements. The runtime twin
of that method needs the *measurements to go wrong on demand*: every recovery
path in the runtime — deadline retirement, dispatch retry, checkpoint
auto-resume, admission shedding — is only trustworthy once a test has injected
the exact failure it answers and asserted the response. This module is that
injection layer.

A :class:`FaultPlan` is a declaration, exactly like a :class:`StreamPlan`:
the set of faults a run will experience is fully determined before the run by
``(specs, seed)`` — probabilistic rates are expanded into concrete trigger
indices at construction with a seeded generator, so the same plan replayed
twice injects the same faults at the same places. The trigger sets are drawn
with numpy exactly as the JAX package draws them, so one ``(specs, seed)``
injects the same faults in either package. A :class:`FaultInjector` is one replay of the plan: the runtime
hooks consult it at well-defined points and every fault that fires appends a
:class:`FaultRecord` to ``injector.trace``, so tests assert the exact fault
sequence next to the exact recovery.

Fault classes and their hook points:

==============  ============================================================
kind            where it fires
==============  ============================================================
dma_stall       the per-core DMA lane, before a hyperstep's token fetch
                (:class:`~repro_torch.core.hyperstep.HyperstepRunner` host loop)
                or the compiled run's staging — the lane-busy time grows,
                so ``fetch_wait_seconds`` shows the stall when it gates
straggler       the compute side of a hyperstep (host loop) or the compiled
                dispatch — the step's wall time grows past its Eq. 1 band
corrupt         an up-stream token at flush time: NaN for float tokens,
                a high-bit flip for integer tokens (an out-of-vocab id)
dispatch_fail   the start of a dispatch — raises :class:`FaultInjected`
                from ``run()`` before any state moves (simulated
                preemption; safe to retry)
page_exhaust    :meth:`repro_torch.launch.engine.PagedKVPool.can_admit` —
                the pool reports no free pages although pages are free
data_error      a data source's batch reads
                (:class:`repro_torch.data.pipeline.TokenStream`, consulted
                once per read attempt inside its bounded retry) — raises
                :class:`FaultInjected` from the data source; each failed
                attempt emits BSPS210, exhausted retries BSPS211 and a
                :class:`~repro_torch.data.pipeline.DataSourceError`
==============  ============================================================

Trigger indexing: ``dma_stall``/``straggler``/``corrupt`` triggers are
*hyperstep*-indexed (global across a runner's lifetime, so a host-loop run
and a compiled run of the same program produce the same trace);
``dispatch_fail`` and ``page_exhaust`` are indexed by consultation count
(the n-th dispatch / admission check); ``data_error`` by batch index.
``count`` makes a trigger fail that many consecutive consultations — the
"retry succeeds on attempt 2" contract is ``count=1``, "retry exhausted" is
``count > retries``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "FAULT_KINDS",
    "FaultSpec",
    "FaultRecord",
    "FaultPlan",
    "FaultInjector",
    "FaultInjected",
    "corrupt_array",
    "corrupt_pytree",
    "corrupt_stacked_row",
    "fault_signature",
]

FAULT_KINDS = (
    "dma_stall",
    "straggler",
    "corrupt",
    "dispatch_fail",
    "page_exhaust",
    "data_error",
)

# trigger-index domain per kind (documented above; tests rely on it)
_DOMAIN = {
    "dma_stall": "hyperstep",
    "straggler": "hyperstep",
    "corrupt": "hyperstep",
    "dispatch_fail": "dispatch",
    "page_exhaust": "page",
    "data_error": "batch",
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declared fault: what to inject, where, and how hard.

    ``at`` are explicit trigger indices in the kind's domain; ``rate`` adds
    Bernoulli(rate) triggers over ``[0, horizon)``, expanded deterministically
    by :class:`FaultPlan`. ``count`` fails that many *consecutive* indices per
    trigger (dispatch/page/data kinds — the knob that makes a bounded retry
    succeed or exhaust). ``core`` restricts a stall/straggler/corruption to
    one core (None = every core); ``slot`` picks the out-stream a corruption
    hits; ``mode`` is ``"nan"`` (float tokens) or ``"bitflip"``.
    """

    kind: str
    at: tuple[int, ...] = ()
    rate: float = 0.0
    delay_s: float = 0.0
    core: int | None = None
    slot: int = 0
    mode: str = "nan"
    count: int = 1

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.mode not in ("nan", "bitflip"):
            raise ValueError(f"mode must be 'nan' or 'bitflip', got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One fault that actually fired — the replayable trace entry."""

    kind: str
    index: int                    # trigger index in the kind's domain
    core: int | None = None
    slot: int = 0
    mode: str = ""
    delay_s: float = 0.0


class FaultInjected(RuntimeError):
    """Raised by injected ``dispatch_fail`` / ``data_error`` faults.

    Carries the :class:`FaultRecord`, so recovery code (and tests) can tell an
    injected preemption from a real failure.
    """

    def __init__(self, record: FaultRecord) -> None:
        super().__init__(f"injected fault: {record}")
        self.record = record


class FaultPlan:
    """A deterministic, seeded fault schedule: same seed → same fault trace.

    Probabilistic ``rate`` triggers are expanded at construction: spec ``i``
    draws from ``SeedSequence([seed, i])``, so adding or removing one spec
    never perturbs another's triggers. ``triggers(kind)`` exposes the expanded
    index set per kind (tests assert determinism on it); :meth:`replay`
    returns a fresh :class:`FaultInjector` — one replay of the plan.
    """

    def __init__(self, specs: Iterable[FaultSpec], *, seed: int = 0,
                 horizon: int = 1024) -> None:
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.horizon = int(horizon)
        self._triggers: list[frozenset[int]] = []
        for i, spec in enumerate(self.specs):
            hits = set(int(a) for a in spec.at)
            if spec.rate > 0.0:
                rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
                hits |= set(np.nonzero(rng.random(self.horizon)
                                       < spec.rate)[0].tolist())
            # count > 1: a trigger covers that many consecutive indices
            expanded = set()
            for t in hits:
                expanded |= set(range(t, t + spec.count))
            self._triggers.append(frozenset(expanded))

    def triggers(self, kind: str) -> dict[int, frozenset[int]]:
        """Expanded trigger indices per spec position, for ``kind`` specs."""
        return {i: trig for i, (spec, trig)
                in enumerate(zip(self.specs, self._triggers))
                if spec.kind == kind}

    def replay(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """One replay of a :class:`FaultPlan`: the hooks the runtime consults.

    Hyperstep-indexed hooks (``fetch_delay``/``compute_delay``/
    ``corrupt_token``/``corrupt_targets``) take the global hyperstep as an
    argument; consultation-indexed hooks (``on_dispatch``/``page_fault``)
    advance an internal counter per call; ``data_error`` takes the batch
    index. Every fault that fires is appended to :attr:`trace`.
    """

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.trace: list[FaultRecord] = []
        self._counters = {"dispatch": 0, "page": 0}
        # (spec position, trigger index) pairs already fired for
        # hyperstep-indexed kinds, so a compiled segment that re-walks its
        # range and the host loop's per-step consults fire each trigger once
        self._fired: set[tuple[int, int]] = set()

    def _specs(self, kind: str):
        for i, spec in enumerate(self.plan.specs):
            if spec.kind == kind:
                yield i, spec, self.plan._triggers[i]

    # -- hyperstep-indexed hooks --------------------------------------------

    def _delay(self, kind: str, h: int, core: int | None) -> float:
        total = 0.0
        for i, spec, trig in self._specs(kind):
            if h not in trig:
                continue
            if spec.core is not None and core is not None and spec.core != core:
                continue
            key = (i, h) if core is None else (i, h * 1_000_003 + core)
            if key in self._fired:
                continue
            self._fired.add(key)
            rec = FaultRecord(kind=kind, index=h, core=core,
                              delay_s=spec.delay_s)
            self.trace.append(rec)
            total += spec.delay_s
        return total

    def fetch_delay(self, h: int, core: int | None = None) -> float:
        """Seconds of injected DMA stall before hyperstep ``h``'s fetch."""
        return self._delay("dma_stall", h, core)

    def compute_delay(self, h: int, core: int | None = None) -> float:
        """Seconds of injected straggler delay on hyperstep ``h``'s compute."""
        return self._delay("straggler", h, core)

    def corrupt_token(self, h: int, slot: int, token: Any,
                      core: int | None = None) -> Any:
        """Corrupt an up-stream token at flush time (host-loop mode)."""
        for i, spec, trig in self._specs("corrupt"):
            if h not in trig or spec.slot != slot:
                continue
            if spec.core is not None and core is not None and spec.core != core:
                continue
            key = (i, h) if core is None else (i, h * 1_000_003 + core)
            if key in self._fired:
                continue
            self._fired.add(key)
            self.trace.append(FaultRecord(kind="corrupt", index=h, core=core,
                                          slot=slot, mode=spec.mode))
            token = corrupt_pytree(token, spec.mode)
        return token

    def corrupt_targets(self, h_start: int, total: int
                        ) -> list[tuple[int, int, str, int | None]]:
        """Corruption triggers inside ``[h_start, h_start+total)`` (compiled).

        Returns ``(local hyperstep, slot, mode, core)`` tuples and records
        each — the compiled runner applies them to the scattered rows of its
        output buffers after the dispatch.
        """
        out = []
        for i, spec, trig in self._specs("corrupt"):
            for h in sorted(trig):
                if not h_start <= h < h_start + total or (i, h) in self._fired:
                    continue
                self._fired.add((i, h))
                self.trace.append(FaultRecord(kind="corrupt", index=h,
                                              core=spec.core, slot=spec.slot,
                                              mode=spec.mode))
                out.append((h - h_start, spec.slot, spec.mode, spec.core))
        return out

    # -- consultation-indexed hooks -----------------------------------------

    def on_dispatch(self) -> None:
        """Consult before a dispatch; raises :class:`FaultInjected` on a hit.

        Raised *before* any state moves, so the caller may retry: the retry
        consults again (advancing the counter), and a ``count=1`` trigger
        therefore fails exactly one attempt.
        """
        idx = self._counters["dispatch"]
        self._counters["dispatch"] += 1
        for _i, _spec, trig in self._specs("dispatch_fail"):
            if idx in trig:
                rec = FaultRecord(kind="dispatch_fail", index=idx)
                self.trace.append(rec)
                raise FaultInjected(rec)

    def page_fault(self) -> bool:
        """True if this admission check should see an exhausted page pool."""
        idx = self._counters["page"]
        self._counters["page"] += 1
        for _i, _spec, trig in self._specs("page_exhaust"):
            if idx in trig:
                self.trace.append(FaultRecord(kind="page_exhaust", index=idx))
                return True
        return False

    # -- batch-indexed hook --------------------------------------------------

    def data_error(self, index: int) -> None:
        """Consult on a data-source read; raises on a hit.

        ``count`` consecutive *attempts* at the same index fail (tracked per
        index), so a bounded retry with ``retries >= count`` recovers and a
        tighter budget surfaces the error to the consumer.
        """
        for i, spec, trig in self._specs("data_error"):
            if index not in trig:
                continue
            attempts = sum(1 for r in self.trace
                           if r.kind == "data_error" and r.index == index
                           and r.slot == i)
            if attempts >= spec.count:
                continue
            rec = FaultRecord(kind="data_error", index=index, slot=i)
            self.trace.append(rec)
            raise FaultInjected(rec)


# ---------------------------------------------------------------------------
# Corruption primitives
# ---------------------------------------------------------------------------

# the mantissa bit a "bitflip" flips: bit 21 of a 32- or 64-bit float (the
# JAX package's choice), bit 5 of a 16-bit one
_FLIP_BIT = {4: 1 << 21, 8: 1 << 21, 2: 1 << 5}
_INT_VIEW = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _corrupt_first(flat: torch.Tensor, mode: str) -> None:
    """Corrupt ``flat[0]`` of a 1-D tensor in place (see :func:`corrupt_array`)."""
    if flat.dtype.is_floating_point:
        if mode == "nan":
            flat[0] = float("nan")
        else:
            size = flat.element_size()
            bits = flat[:1].view(_INT_VIEW[size])
            bits ^= _FLIP_BIT[size]
    elif flat.dtype == torch.bool:
        flat[0] = ~flat[0]
    else:
        flat[:1] |= 1 << 29


def corrupt_array(x: Any, mode: str) -> Any:
    """Return ``x`` with its first element corrupted (NaN or a bit flip).

    Float arrays: ``"nan"`` writes NaN, ``"bitflip"`` flips a mantissa bit.
    Integer arrays: both modes set a high bit — for token ids that is an
    out-of-vocab value a range check catches. Keeps the array kind (numpy in,
    numpy out; a torch tensor in, a tensor on the same device out); the input
    is not modified.
    """
    if isinstance(x, torch.Tensor):
        out = x.clone()
        if out.numel():
            _corrupt_first(out.view(-1), mode)
        return out
    arr = np.array(x)               # host copy we can mutate
    if arr.size == 0:
        return x
    flat = torch.from_numpy(arr.reshape(-1))
    _corrupt_first(flat, mode)
    return arr


def corrupt_pytree(tok: Any, mode: str) -> Any:
    """Corrupt the first array leaf of a token pytree (dicts, lists, tuples)."""
    done = False

    def walk(x: Any) -> Any:
        nonlocal done
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if not done and hasattr(x, "dtype") and hasattr(x, "shape"):
            done = True
            return corrupt_array(x, mode)
        return x

    return walk(tok)


def corrupt_stacked_row(buf: Any, row: int, mode: str) -> Any:
    """Corrupt one token row of a stacked out-buffer (compiled mode).

    A torch buffer is corrupted in place (it is the compiled run's output
    buffer, drained to the stream after this) and returned.
    """
    if isinstance(buf, torch.Tensor):
        _corrupt_first(buf[row].view(-1), mode)
        return buf
    arr = np.array(buf)
    arr[row] = corrupt_array(arr[row], mode)
    return arr


def fault_signature(trace: Sequence[FaultRecord]) -> tuple:
    """A hashable summary of a trace (tests compare replays with this)."""
    return tuple((r.kind, r.index, r.core, r.slot, r.mode) for r in trace)

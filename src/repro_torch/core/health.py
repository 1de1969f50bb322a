"""Runtime health monitoring: the Eq. 1 cost model as the health model.

DESIGN.md §9's verifier proves a *declared* plan sound before dispatch and
speaks in stable ``BSPS1xx`` codes. This module is the runtime mirror: once
hypersteps execute, each measured record is scored against its Eq. 1
prediction, up-stream outputs are checked for NaN/Inf and out-of-range
values, and every deviation becomes a structured :class:`HealthEvent` with a
stable ``BSPS2xx`` code. The same rollup (count by code, SLO-violation rate)
is surfaced by ``ServeEngine.stats()`` — one vocabulary from static
verification to live traffic, the same codes as the JAX package's.

SLO scoring is *self-normalizing*: absolute Eq. 1 predictions can be off by a
constant factor on an uncalibrated or synthetic machine model, so the monitor
learns a baseline measured/predicted ratio over a short warmup window and
flags a hyperstep only when its ratio leaves ``band`` × baseline. A constant
model error therefore never alarms; a *change* in behavior — an injected
straggler, a contended host — does. This is the BSF verification method
(compare predictions against measurements, systematically) run forever.

Code table (see DESIGN.md §10):

=========  =====  =====================================================
code       sev    meaning
=========  =====  =====================================================
BSPS201    warn   hyperstep/segment wall time left its Eq. 1 SLO band
BSPS202    warn   fetch wait dominated compute (DMA-bound hyperstep)
BSPS203    error  up-stream output corrupt (NaN/Inf or out-of-range)
BSPS204    warn   segment dispatch failed (will retry)
BSPS205    warn   request exceeded its deadline and was retired
BSPS206    info   request cancelled; lane and pages reclaimed
BSPS207    warn   page pool exhausted; admission deferred
BSPS208    error  persistent SLO violation: degraded mode entered
BSPS209    info   SLO recovered: degraded mode exited
BSPS210    warn   data-source read failed (will retry)
BSPS211    error  bounded retry exhausted; error surfaced to caller
BSPS212    warn   crash mid-interval; auto-resumed from checkpoint
BSPS220    warn   sustained predicted/measured drift; recalibration requested
BSPS221    info   machine pack refit from the calibration store and adopted
BSPS222    warn   recalibration requested but no confident refit available
=========  =====  =====================================================

The BSPS22x codes are the drift layer (DESIGN.md §11): BSPS201 flags a
*single* record leaving the SLO band, BSPS220 flags a *sustained* shift —
the windowed median of post-warmup ratios leaving ``drift_band`` — and
carries a :class:`RecalibrationEvent` consumers poll with
:meth:`HealthMonitor.pop_recalibration` to trigger a calibration-store refit
(``repro_torch.core.calibstore``). A consumer that adopts a refit pack should call
:meth:`HealthMonitor.rebaseline` so the baseline re-learns against the new
predictions instead of alarming on the change it itself just made.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

__all__ = ["HEALTH_CODES", "HEALTH_SEVERITY", "HealthEvent", "HealthMonitor",
           "RecalibrationEvent"]

HEALTH_CODES = {
    "BSPS201": "slo-violation",
    "BSPS202": "fetch-wait-dominant",
    "BSPS203": "corrupt-output",
    "BSPS204": "dispatch-failed",
    "BSPS205": "deadline-exceeded",
    "BSPS206": "request-cancelled",
    "BSPS207": "page-pool-exhausted",
    "BSPS208": "degraded-enter",
    "BSPS209": "degraded-exit",
    "BSPS210": "data-source-retry",
    "BSPS211": "retry-exhausted",
    "BSPS212": "resumed-from-checkpoint",
    "BSPS220": "calibration-drift",
    "BSPS221": "recalibrated",
    "BSPS222": "recalibration-unavailable",
}

HEALTH_SEVERITY = {
    "BSPS201": "warn",
    "BSPS202": "warn",
    "BSPS203": "error",
    "BSPS204": "warn",
    "BSPS205": "warn",
    "BSPS206": "info",
    "BSPS207": "warn",
    "BSPS208": "error",
    "BSPS209": "info",
    "BSPS210": "warn",
    "BSPS211": "error",
    "BSPS212": "warn",
    "BSPS220": "warn",
    "BSPS221": "info",
    "BSPS222": "warn",
}


@dataclasses.dataclass(frozen=True)
class RecalibrationEvent:
    """A BSPS220 drift finding, queued for a consumer to act on.

    ``ratio`` is the windowed median of measured/predicted ratios *relative
    to the learned baseline* — the sustained shift factor, not one noisy
    observation. Consumers (serve engine, train loop) pop the event, ask the
    calibration store for a refit pack over roughly the same window, and
    re-price online (DESIGN.md §11 drift→refit→re-price flow).
    """

    source: str
    index: int | None
    ratio: float           # windowed median rel ratio that left the band
    baseline_ratio: float  # the baseline it is relative to
    window: int            # observations the median was taken over


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One structured runtime health finding (mirror of verify.Diagnostic)."""

    code: str
    severity: str
    message: str
    source: str = ""          # plan/engine/stream name the event concerns
    index: int | None = None  # hyperstep / segment / request index
    value: float = 0.0        # the measured quantity (ratio, seconds, ...)

    def format(self) -> str:
        where = f" [{self.source}]" if self.source else ""
        at = f" @{self.index}" if self.index is not None else ""
        return (f"{self.code} {self.severity.upper()}{where}{at}: "
                f"{self.message}")


def _leaves(x: Any) -> list[Any]:
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


class HealthMonitor:
    """Scores measured records against Eq. 1 and collects HealthEvents.

    ``band=(lo, hi)`` is the accepted ratio window *relative to the learned
    baseline*; the first ``warmup`` observations establish the baseline (their
    median measured/predicted ratio) and never alarm. ``consecutive_violations``
    / ``consecutive_healthy`` feed the serve engine's degradation state
    machine.

    ``drift_band``/``drift_window`` are the BSPS220 layer on top: when the
    median of the last ``drift_window`` post-warmup ratios leaves
    ``drift_band`` × baseline, one :class:`RecalibrationEvent` is queued (per
    excursion — the detector re-arms when the median returns inside) for
    :meth:`pop_recalibration`. The drift band matches the acceptance window a
    refit pack must restore predictions into.
    """

    def __init__(self, *, band: tuple[float, float] = (0.25, 4.0),
                 warmup: int = 3, name: str = "",
                 drift_band: tuple[float, float] = (0.5, 2.0),
                 drift_window: int = 4) -> None:
        self.band = (float(band[0]), float(band[1]))
        self.warmup = int(warmup)
        self.name = name
        self.drift_band = (float(drift_band[0]), float(drift_band[1]))
        self.drift_window = max(int(drift_window), 1)
        self.events: list[HealthEvent] = []
        self.observed = 0
        self.consecutive_violations = 0
        self.consecutive_healthy = 0
        self.last_ratio = 0.0
        self._ratios: list[float] = []
        self._drift_ratios: deque[float] = deque(maxlen=self.drift_window)
        self._drift_active = False
        self.recalibrations: list[RecalibrationEvent] = []
        self._pending_recalibration: RecalibrationEvent | None = None

    # -- event plumbing ------------------------------------------------------

    def emit(self, code: str, message: str, *, source: str = "",
             index: int | None = None, value: float = 0.0,
             severity: str | None = None) -> HealthEvent:
        sev = severity or HEALTH_SEVERITY.get(code, "warn")
        ev = HealthEvent(code=code, severity=sev, message=message,
                         source=source or self.name, index=index,
                         value=float(value))
        self.events.append(ev)
        return ev

    def ingest_diagnostics(self, diagnostics: Iterable[Any]) -> None:
        """Fold static verifier Diagnostics (BSPS1xx) into the same rollup."""
        for d in diagnostics:
            self.emit(d.code, d.message, source=getattr(d, "plan", "") or "",
                      index=getattr(d, "hyperstep", None),
                      severity=getattr(d, "severity", "warn"))

    # -- Eq. 1 SLO scoring ---------------------------------------------------

    @property
    def baseline_ratio(self) -> float:
        if not self._ratios:
            return 1.0
        # lower median: the canonical outlier in the warmup window is the
        # first dispatch paying jit compilation, and it only ever inflates —
        # rounding the median down keeps one slow warmup observation from
        # becoming the baseline (which would flag every later, faster,
        # observation as a too-fast "violation" forever)
        srt = sorted(self._ratios)
        return srt[(len(srt) - 1) // 2]

    def observe_record(self, record: Any, predicted_seconds: float, *,
                       source: str = "", index: int | None = None,
                       measured_seconds: float | None = None
                       ) -> HealthEvent | None:
        """Score one HyperstepRecord against its Eq. 1 prediction.

        Returns the BSPS201 event if the record violated its SLO band, else
        None. Also flags fetch-wait-dominated records (BSPS202) — those are
        not SLO violations (the sync still closed) but signal that the block
        size or prefetch depth is mis-tuned for the observed bandwidth.

        ``measured_seconds`` overrides the scored wall time — the compiled
        dispatch passes its full staging+compute+drain wall, since its
        record's ``step_seconds`` holds the compute window alone and Eq. 1
        prices the link crossings too (a stalled DMA must move the ratio).
        """
        self.observed += 1
        measured = (float(measured_seconds) if measured_seconds is not None
                    else float(getattr(record, "step_seconds", 0.0)))
        ratio = measured / max(float(predicted_seconds), 1e-12)
        self.last_ratio = ratio

        fetch_wait = float(getattr(record, "fetch_wait_seconds", 0.0))
        compute = float(getattr(record, "compute_seconds", 0.0))
        if fetch_wait > max(compute, 1e-12):
            self.emit("BSPS202",
                      f"fetch wait {fetch_wait:.3g}s exceeds compute "
                      f"{compute:.3g}s; DMA-bound", source=source,
                      index=index, value=fetch_wait)

        if len(self._ratios) < self.warmup:
            self._ratios.append(ratio)
            self.consecutive_healthy += 1
            return None
        rel = ratio / max(self.baseline_ratio, 1e-12)
        if math.isfinite(rel):
            self._drift_ratios.append(rel)
            self._check_drift(source, index)
        if not (self.band[0] <= rel <= self.band[1]) and math.isfinite(rel):
            self.consecutive_violations += 1
            self.consecutive_healthy = 0
            return self.emit(
                "BSPS201",
                f"measured/predicted ratio {ratio:.3g} is {rel:.3g}x the "
                f"baseline {self.baseline_ratio:.3g}, outside band "
                f"{self.band}", source=source, index=index, value=rel)
        self.consecutive_violations = 0
        self.consecutive_healthy += 1
        return None

    # -- drift detection (BSPS22x, DESIGN.md §11) ------------------------------

    def _check_drift(self, source: str, index: int | None) -> None:
        if len(self._drift_ratios) < self.drift_window:
            return
        # A *strict majority* of the window must sit outside the band before
        # an event fires: both order-statistic medians below (or above) it.
        # The lower median alone would fire with only half the window
        # drifted, and the consumer's refit over that mixed window is
        # statistically ambiguous — the outlier screen can't tell which half
        # is the new reality.
        ranked = sorted(self._drift_ratios)
        n = len(ranked)
        lo_med, hi_med = ranked[(n - 1) // 2], ranked[n // 2]
        med = 0.5 * (lo_med + hi_med)
        lo, hi = self.drift_band
        if not (hi_med < lo or lo_med > hi):
            self._drift_active = False    # excursion over: re-arm
            return
        if self._drift_active:
            return                        # one event per sustained excursion
        self._drift_active = True
        ev = RecalibrationEvent(source=source or self.name, index=index,
                                ratio=float(med),
                                baseline_ratio=self.baseline_ratio,
                                window=self.drift_window)
        self.recalibrations.append(ev)
        self._pending_recalibration = ev
        self.emit("BSPS220",
                  f"sustained drift: median of last {self.drift_window} "
                  f"ratios is {med:.3g}x baseline, outside drift band "
                  f"{self.drift_band}; recalibration requested",
                  source=source, index=index, value=float(med))

    def pop_recalibration(self) -> RecalibrationEvent | None:
        """The unconsumed drift event, if any (consumers poll per segment)."""
        ev, self._pending_recalibration = self._pending_recalibration, None
        return ev

    def rebaseline(self) -> None:
        """Forget the learned baseline (call after adopting a refit pack).

        Predictions just changed under the monitor's feet; the next
        ``warmup`` observations re-learn the baseline ratio without alarming,
        exactly like job start.
        """
        self._ratios = []
        self._drift_ratios.clear()
        self._drift_active = False
        self.consecutive_violations = 0

    # -- output checking -----------------------------------------------------

    def check_output(self, x: Any, *, source: str = "",
                     index: int | None = None, lo: float | None = None,
                     hi: float | None = None,
                     max_elems: int = 1 << 22) -> bool:
        """NaN/Inf-check float leaves (and range-check int leaves) of ``x``.

        Returns True when healthy; emits BSPS203 and returns False on the
        first corrupt leaf. Arrays larger than ``max_elems`` are skipped to
        bound host-side cost. ``lo``/``hi`` give a half-open valid range for
        integer leaves (e.g. token ids in ``[0, vocab)``). A leaf on the card
        is counted there and read once: one host sync per checked leaf.
        """
        for leaf in _leaves(x):
            if not (hasattr(leaf, "dtype") and hasattr(leaf, "shape")):
                continue
            size = leaf.numel() if isinstance(leaf, torch.Tensor) else np.size(leaf)
            if size == 0 or size > max_elems:
                continue
            t = torch.as_tensor(leaf)
            if t.dtype.is_floating_point:
                bad = int((~torch.isfinite(t)).sum())
                if bad:
                    self.emit("BSPS203",
                              f"{bad} non-finite value(s) in up-stream "
                              f"output", source=source, index=index,
                              value=float(bad))
                    return False
            elif t.dtype != torch.bool and (lo is not None or hi is not None):
                lo_v = -math.inf if lo is None else lo
                hi_v = math.inf if hi is None else hi
                bad = int(((t < lo_v) | (t >= hi_v)).sum())
                if bad:
                    self.emit("BSPS203",
                              f"{bad} out-of-range value(s) in up-stream "
                              f"output (valid [{lo}, {hi}))", source=source,
                              index=index, value=float(bad))
                    return False
        return True

    # -- rollup --------------------------------------------------------------

    def counts_by_code(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev.code] = out.get(ev.code, 0) + 1
        return dict(sorted(out.items()))

    def slo_violation_rate(self) -> float:
        if not self.observed:
            return 0.0
        viol = sum(1 for ev in self.events if ev.code == "BSPS201")
        return viol / self.observed

    def rollup(self) -> dict[str, Any]:
        """The summary dict embedded in stats/reports (count by code, rates)."""
        return {
            "events": len(self.events),
            "count_by_code": self.counts_by_code(),
            "observed": self.observed,
            "slo_violation_rate": self.slo_violation_rate(),
            "baseline_ratio": self.baseline_ratio,
            "recalibrations": len(self.recalibrations),
        }

    def format_events(self, *, limit: int = 20) -> list[str]:
        return [ev.format() for ev in self.events[:limit]]

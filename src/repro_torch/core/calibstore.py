"""Persistent calibration store + robust online refitting of (g, l, e).

Every safety mechanism in the runtime — Eq. 1-priced admission, the BSPS1xx
static verifier, the BSPS2xx health monitor — judges reality against machine
parameters measured once at job start (``calibrate()``) and trusted forever.
This module closes that loop (DESIGN.md §11): every :class:`HyperstepRunner`
run appends one :class:`MeasurementRecord` to a :class:`CalibrationStore`
(in-memory, optionally an append-only JSONL file), keyed by a *machine
fingerprint* (backend, device kind/count, dtype) plus a *block-shape band*
(power-of-4 bucket of per-hyperstep link words — plans in the same band move
comparable traffic per sync, so their records fit one parameter set).

The fitter is the BSF verification method run in reverse: instead of checking
predictions against measurements, it re-derives (g, l, e) *from* the
measurements, robustly. Two stages:

1. **Outlier screen** (Theil–Sen spirit): measured/predicted ratios are
   MAD-rejected around the *sample* median. The first-dispatch jit spike and
   a sporadically fault-injected stall are minority outliers and get dropped;
   a *sustained* drift moves the median itself and survives — exactly the
   distinction the BSPS220 drift detector needs.
2. **Fit** on the inliers: least squares on the additive surrogate
   ``measured·r − flops = g·comm + l·barriers + e·link_words`` when the
   design identifies the parameters; otherwise the excess time is attributed
   to the dominant identifiable column (median implied-``e`` over the
   external link, or implied-``l`` over the barriers). Both candidates are
   scored with the Eq. 1 ``max`` structure and the lower-median-residual one
   wins, so the additive surrogate can never beat the closed form it
   approximates.

Consumers: ``ServeEngine`` re-prices admission on the refit pack after a
drift event, and ``plan.autotune``/``enumerate_plans`` price candidates on a
fitted band pack when one exists.

The records and the JSONL schema are the JAX package's (``SCHEMA_VERSION``
1), so either package reads the other's file; ``fit_gle`` is the same numpy
arithmetic and gives equal floats on equal records. Only the fingerprint
differs: it names the torch device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from collections import deque
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.bsp import BSPAccelerator
from repro_torch.device import resolve_device

__all__ = [
    "CalibrationStore",
    "FitResult",
    "MeasurementRecord",
    "band_for",
    "fit_gle",
    "get_default_store",
    "machine_fingerprint",
    "plan_band",
    "set_default_store",
]

#: Environment variable naming the default store's JSONL path. Unset → the
#: process default store is memory-only.
ENV_STORE_PATH = "REPRO_CALIBSTORE"

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Keying: machine fingerprint × block-shape band
# ---------------------------------------------------------------------------


def machine_fingerprint(dtype: str = "float32", device: Any = None) -> str:
    """The hardware identity records are keyed on: backend, device kind/count, dtype.

    Keys on the torch device: ``device`` (resolved by the port's device
    rule: ``None`` is the CUDA card, and raises without one) gives the
    backend and the device's name, e.g.
    ``cuda:NVIDIA_H100_80GB_HBM3:x1:bfloat16``; the count is the number of
    devices of that backend. Deliberately excludes the pack's *values* — the
    whole point is that two packs measured on the same hardware at different
    times share records.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device.index)
        count = torch.cuda.device_count()
    else:
        kind, count = device.type, 1
    return f"{device.type}:{kind.replace(' ', '_')}:x{count}:{dtype}"


def band_for(words_per_hyperstep: float) -> int:
    """Block-shape band: the power-of-4 bucket of per-hyperstep link words.

    Plans whose hypersteps move traffic within a 4x window share fixed-cost
    behaviour (the Fig. 4 size effect: small tokens pay t0, large ones the
    asymptotic bandwidth), so their measurements fit one (g, l, e) set.
    """
    w = max(float(words_per_hyperstep), 1.0)
    return int(math.log(w) / math.log(4.0))


def plan_band(plan: Any) -> int:
    """The band a :class:`StreamPlan` records into and is priced from.

    Uses the declared per-hyperstep link traffic (every streamed token, down
    and up — the closed-form Eq. 1 link side), so producer (runner recording)
    and consumer (autotune / engine refit lookup) agree byte-for-byte.
    """
    words = (sum(t.words for t in plan.inputs)
             + sum(t.words for t in plan.outputs))
    return band_for(words)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeasurementRecord:
    """One measured run: the aggregates the (g, l, e) surrogate regresses on."""

    fingerprint: str
    band: int
    plan: str
    hypersteps: int
    dispatches: int            # execution-mode barriers (priced at l)
    flops: float               # priced compute work of the measured steps
    comm_words: float          # inner h-relation total — g's regressor
    supersteps: float          # inner barrier total — l's regressor (with dispatches)
    link_words: float          # external words moved, down + up — e's regressor
    measured_seconds: float    # bulk-synchronous wall time of the run
    predicted_seconds: float   # Eq. 1 price at run time (outlier screening)
    r: float                   # compute rate of the pack the run priced on
    faulty: bool = False       # an injector fired during this run (not pre-filtered)
    schema: int = SCHEMA_VERSION

    @property
    def barriers(self) -> float:
        return self.supersteps + self.dispatches

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "MeasurementRecord":
        raw = json.loads(line)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class FitResult:
    """A refit (g, l, e) with its evidence: sample counts + confidence."""

    g: float
    l: float
    e: float
    samples: int               # records considered
    inliers: int               # records that survived the outlier screen
    rejected: int              # records the screen dropped (jit spikes, stalls)
    residual: float            # median |pred − meas|/meas of the winning model
    confidence: float          # inlier fraction damped by the residual, in [0, 1]
    method: str                # "lstsq" (full design) or "implied" (degenerate)

    def row(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _predict_units(rec: MeasurementRecord, g: float, l: float, e: float) -> float:
    """Eq. 1-structured price of one record in FLOP units.

    ``max(compute side, link side)`` over the run's aggregates plus the
    execution mode's own dispatch barriers — the same shape
    ``HyperstepRunner._predicted_seconds_for`` charges, so fit residuals are
    measured against the model the consumers will actually price with.
    """
    compute = rec.flops + g * rec.comm_words + l * rec.supersteps
    return max(compute, e * rec.link_words) + l * rec.dispatches


def _median_rel_residual(recs: Sequence[MeasurementRecord],
                         g: float, l: float, e: float) -> float:
    errs = []
    for rec in recs:
        pred = _predict_units(rec, g, l, e) / max(rec.r, 1e-12)
        errs.append(abs(pred - rec.measured_seconds)
                    / max(rec.measured_seconds, 1e-12))
    return float(np.median(errs)) if errs else math.inf


def fit_gle(records: Iterable[MeasurementRecord], *, prior: BSPAccelerator,
            min_samples: int = 4) -> FitResult | None:
    """Robustly refit (g, l, e) from measured records; None if under-evidenced.

    ``prior`` supplies the values kept for parameters the records cannot
    identify (an all-zero regressor column) and the starting point the
    implied-parameter fallback perturbs. Returns None when fewer than
    ``min_samples`` records exist or the screen leaves fewer than 3 inliers.
    """
    recs = list(records)
    if len(recs) < max(int(min_samples), 3):
        return None

    # Stage 1 — MAD screen on measured/predicted ratios *within the sample*:
    # a minority of slow records (the jit spike, an injected stall) is
    # rejected; a sustained shift moves the median and is kept, which is what
    # lets a post-drift window refit to the new reality.
    ratios = np.asarray([rec.measured_seconds / max(rec.predicted_seconds, 1e-12)
                         for rec in recs])
    med = float(np.median(ratios))
    mad = float(np.median(np.abs(ratios - med)))
    tol = max(3.0 * 1.4826 * mad, 0.25 * med)
    keep = np.abs(ratios - med) <= tol
    inl = [rec for rec, k in zip(recs, keep) if bool(k)]
    rejected = len(recs) - len(inl)
    if len(inl) < 3:
        return None

    # Stage 2a — least squares on the additive surrogate over the inliers.
    # A column only *identifies* its parameter if it actually varies across
    # the window; a near-constant column (the segment engine re-running one
    # plan shape) would happily absorb any sustained shift regardless of
    # which resource really slowed down. Such columns keep the prior's
    # charge (subtracted from y) and attribution falls to the implied
    # fallback below, which blames the link first — the physical reading of
    # a sustained dma stall.
    y = np.asarray([rec.measured_seconds * rec.r - rec.flops for rec in inl],
                   dtype=float)
    X = np.asarray([[rec.comm_words, rec.barriers, rec.link_words]
                    for rec in inl], dtype=float)
    params = [float(prior.g), float(prior.l), float(prior.e)]
    candidates: list[tuple[str, list[float]]] = []
    active: list[int] = []
    adj = y.copy()
    for j in range(3):
        col = X[:, j]
        if float(np.max(np.abs(col))) <= 0.0:
            continue
        cv = float(np.std(col)) / max(abs(float(np.mean(col))), 1e-12)
        if cv > 0.1:
            active.append(j)
        else:
            adj = adj - params[j] * col
    if active and len(inl) >= len(active):
        sub = X[:, active]
        if np.linalg.matrix_rank(sub) == len(active):
            sol, *_ = np.linalg.lstsq(sub, adj, rcond=None)
            if np.all(np.isfinite(sol)) and np.all(sol >= 0.0):
                fitted = list(params)
                for j, v in zip(active, sol):
                    fitted[j] = float(v)
                candidates.append(("lstsq", fitted))

    # Stage 2b — degenerate design (every record the same shape, the common
    # case for a segment engine re-running one plan): attribute the excess
    # time to the dominant identifiable column, median over inliers.
    implied = list(params)
    links = np.asarray([rec.link_words for rec in inl])
    barrs = np.asarray([rec.barriers for rec in inl])
    if float(links.max(initial=0.0)) > 0.0:
        implied[2] = max(float(np.median(
            (y - implied[1] * barrs) / np.maximum(links, 1e-12))), 0.0)
    elif float(barrs.max(initial=0.0)) > 0.0:
        implied[1] = max(float(np.median(y / np.maximum(barrs, 1e-12))), 0.0)
    candidates.append(("implied", implied))

    # Stage 2c — uniform rescale for the *overprice* direction: when the
    # machine is measured faster than the prior predicts, the additive
    # implied fallback clamps at 0 and explains nothing. A Theil–Sen-style
    # global scale on (g, l, e) captures calibration bias directly. Only
    # offered when the prior overprices — an *underprice* (a slowdown) is
    # blamed on the link first via the implied candidate above, which is the
    # physical reading of a sustained dma stall.
    scale = float(np.median([
        rec.measured_seconds * rec.r
        / max(_predict_units(rec, *params), 1e-12) for rec in inl]))
    if 0.0 < scale < 1.0:
        candidates.append(("scaled", [p * scale for p in params]))

    method, best, best_res = "implied", implied, math.inf
    for name, cand in candidates:
        res = _median_rel_residual(inl, *cand)
        if res < best_res:
            method, best, best_res = name, cand, res
    confidence = (len(inl) / len(recs)) * max(0.0, 1.0 - min(best_res, 1.0))
    return FitResult(g=best[0], l=best[1], e=best[2], samples=len(recs),
                     inliers=len(inl), rejected=rejected,
                     residual=best_res, confidence=confidence, method=method)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class CalibrationStore:
    """Append-only measurement store with per-(fingerprint, band) refitting.

    ``path`` makes it durable: existing JSONL records load on construction
    (corrupt lines skipped — the file is append-only across crashes) and every
    :meth:`add` appends one line. A write error disables persistence for the
    rest of the process (``io_error``) rather than failing the run that was
    being measured. Memory is bounded to the ``maxlen`` most recent records.
    """

    def __init__(self, path: str | None = None, *, maxlen: int = 4096) -> None:
        self.path = path or None
        self._records: deque[MeasurementRecord] = deque(maxlen=int(maxlen))
        self._lock = threading.Lock()
        self.io_error: str | None = None
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._records.append(MeasurementRecord.from_json(line))
                    except (ValueError, TypeError, KeyError):
                        continue  # torn tail line from a crashed appender

    def __len__(self) -> int:
        return len(self._records)

    def add(self, rec: MeasurementRecord) -> None:
        with self._lock:
            self._records.append(rec)
            if self.path and self.io_error is None:
                try:
                    with open(self.path, "a") as f:
                        # heal a torn tail from a crashed appender: never glue
                        # a new record onto an unterminated line
                        if f.tell() > 0:
                            with open(self.path, "rb") as r:
                                r.seek(-1, os.SEEK_END)
                                if r.read(1) != b"\n":
                                    f.write("\n")
                        f.write(rec.to_json() + "\n")
                except OSError as e:
                    self.io_error = str(e)

    def record_run(self, *, plan: Any, machine: BSPAccelerator,
                   records: Sequence[Any], hypersteps: int, dispatches: int,
                   predicted_seconds: float, measured_seconds: float,
                   faulty: bool = False,
                   dtype: str = "float32",
                   device: Any = None) -> MeasurementRecord | None:
        """Fold one HyperstepRunner run into the store (the automatic hook)."""
        if plan is None or machine is None or hypersteps <= 0 or not records:
            return None
        # The regressor must match the pricing side byte-for-byte: the fitted
        # e multiplies the same link words ``plan.predicted_seconds`` will
        # charge, whichever schedule (exact enumeration vs closed form) the
        # plan's size selects. Measured per-record fetch words (absent in
        # compiled mode) are only a fallback for planless stream programs.
        try:
            planned = float(plan.total_fetch_words()
                            + plan.total_writeback_words())
        except (AttributeError, TypeError, ValueError):
            planned = 0.0
        if planned > 0:
            num = max(int(getattr(plan, "num_hypersteps", hypersteps)), 1)
            link_words = planned * (int(hypersteps) / num)
        else:
            link_words = float(sum(
                getattr(r, "fetch_words", 0)
                + getattr(r, "initial_fetch_words", 0)
                + getattr(r, "writeback_words", 0) for r in records))
        rec = MeasurementRecord(
            fingerprint=machine_fingerprint(dtype, device),
            band=plan_band(plan),
            plan=str(getattr(plan, "name", "") or "hyperstep"),
            hypersteps=int(hypersteps),
            dispatches=int(dispatches),
            flops=float(plan.mean_flops) * int(hypersteps),
            comm_words=float(plan.comm_words_per_hyperstep) * int(hypersteps),
            supersteps=float(plan.supersteps_per_hyperstep) * int(hypersteps),
            link_words=link_words,
            measured_seconds=float(measured_seconds),
            predicted_seconds=float(predicted_seconds),
            r=float(machine.r),
            faulty=bool(faulty),
        )
        self.add(rec)
        return rec

    def records(self, *, fingerprint: str | None = None,
                band: int | None = None,
                window: int | None = None) -> list[MeasurementRecord]:
        """Matching records, oldest first; ``window`` keeps the most recent N."""
        with self._lock:
            out = [r for r in self._records
                   if (fingerprint is None or r.fingerprint == fingerprint)
                   and (band is None or r.band == band)]
        if window is not None and window > 0:
            out = out[-int(window):]
        return out

    def bands(self, fingerprint: str | None = None) -> dict[int, int]:
        """Record count per band (for reports and store summaries)."""
        out: dict[int, int] = {}
        for r in self.records(fingerprint=fingerprint):
            out[r.band] = out.get(r.band, 0) + 1
        return dict(sorted(out.items()))

    def fit(self, *, prior: BSPAccelerator, fingerprint: str | None = None,
            band: int | None = None, window: int | None = None,
            min_samples: int = 4) -> FitResult | None:
        """Refit (g, l, e) from the matching records; None if under-evidenced."""
        return fit_gle(
            self.records(fingerprint=fingerprint, band=band, window=window),
            prior=prior, min_samples=min_samples)

    def refit_machine(self, machine: BSPAccelerator, *,
                      fingerprint: str | None = None, band: int | None = None,
                      window: int | None = None, min_samples: int = 4,
                      min_confidence: float = 0.2,
                      device: Any = None) -> BSPAccelerator | None:
        """The pack with measured (g, l, e) swapped in, or None.

        Everything else (p, r, L, E, host level) is carried over from
        ``machine`` unchanged — the fit re-prices the link and barrier terms,
        it does not re-measure the compute rate. Returns None when no
        matching band exists, the fit is under-evidenced, or its confidence
        is below ``min_confidence`` — callers fall back to closed-form Eq. 1.
        Without a ``fingerprint`` the records of ``device`` (default: the
        card, and raises without one) are fitted.
        """
        if fingerprint is None:
            fingerprint = machine_fingerprint(device=device)
        fit = self.fit(prior=machine, fingerprint=fingerprint, band=band,
                       window=window, min_samples=min_samples)
        if fit is None or fit.confidence < float(min_confidence):
            return None
        return dataclasses.replace(machine, g=fit.g, l=fit.l, e=fit.e)

    def summary(self) -> dict[str, Any]:
        """The rollup dict embedded in reports (dryrun cells, benchmarks)."""
        with self._lock:
            n = len(self._records)
            fps = sorted({r.fingerprint for r in self._records})
        return {
            "records": n,
            "fingerprints": fps,
            "bands": self.bands(),
            "path": self.path,
            "io_error": self.io_error,
        }


# ---------------------------------------------------------------------------
# Process default store
# ---------------------------------------------------------------------------

_default_store: CalibrationStore | None = None
_default_lock = threading.Lock()


def get_default_store() -> CalibrationStore:
    """The process-wide store every runner records into by default.

    Durable iff ``REPRO_CALIBSTORE`` names a JSONL path at first use (the
    same variable the JAX package reads); memory-only otherwise.
    """
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = CalibrationStore(os.environ.get(ENV_STORE_PATH))
        return _default_store


def set_default_store(store: CalibrationStore | None) -> CalibrationStore | None:
    """Swap the process default store (tests, benchmarks); returns the old one."""
    global _default_store
    with _default_lock:
        old, _default_store = _default_store, store
    return old

"""One traced stretch of a cell, reduced to busy time, idle gaps and kernel
time by class.

``capture(fn)`` runs ``fn`` (whole units of the cell's work) under
``torch.profiler`` with CPU and CUDA activity, inside a harness span
``portbench.window`` that ends on a device synchronise, and reduces the
profile at once: nothing is written to disk. A kernel's class is, first,
that of the host span it was launched in (``kernel_scopes/<class>.txt``:
its ``span:`` lines are regular expressions over host span names, and the
harness's own span ``portbench.<class>`` counts too; the kernel is traced
back to the op that launched it by the profiler's correlation id, and the
op's start lies inside the span on the same thread), else the first class,
in name order, of the pattern files ``kernel_names/<class>.txt`` (one
regular expression a line) that matches its name. So GEMMs that the
program runs inside its attention are attention's, not matmul's. A file
``<class>.<any>.txt`` in either directory adds its lines to ``<class>``
(``class_lines``), so a new kernel or entry joins a class as a new file.
The program's own spans (``repro_torch.*``) in the stretch are reduced by
``program_spans.reduce_program`` into ``Trace.program``.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import pathlib
import re
import sys
import time
from typing import Any, Callable

import torch

__all__ = ["Trace", "capture", "reduce_profile", "class_lines", "kernel_classes",
           "kernel_scopes", "scope_of", "reduce_events", "merge"]

HERE = pathlib.Path(__file__).resolve().parent
WINDOW = "portbench.window"
#: the class files, read when called: patterns over kernel names, and host
#: spans and program functions (``spans.py``) whose kernels a class takes
NAMES = HERE / "kernel_names"
SCOPES = HERE / "kernel_scopes"


@dataclasses.dataclass
class Trace:
    """A traced stretch: its host length, the union of kernel intervals in
    it, the device seconds of each kernel class, the kernels by device time
    and the idle gaps by what the host was doing (each at most 10), and the
    program's spans (``program_spans.reduce_program``: count, host s, idle
    s and device s a span name)."""

    window_s: float
    busy_s: float
    class_s: dict[str, float]
    device_ops: list[list]
    idle_gaps: list[list]
    unmatched: list[str]
    kernels: int
    program: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)


def class_lines(root: pathlib.Path) -> dict[str, list[str]]:
    """The stripped lines of the ``.txt`` files under ``root`` by class, the
    class of a file being its name up to the first dot (``attention.txt``
    and ``attention.mla.txt`` are both attention's): classes in name order,
    each class's files in file-name order."""
    out: dict[str, list[str]] = {}
    for f in sorted(root.glob("*.txt")):
        out.setdefault(f.name.split(".")[0], []).extend(
            ln.strip() for ln in f.read_text().splitlines())
    return dict(sorted(out.items()))


def kernel_classes(root: pathlib.Path | None = None) -> list[tuple[str, re.Pattern]]:
    """(class, pattern over kernel names) of each class with a pattern under
    ``root`` (default ``NAMES``), in class order: one regular expression a
    line of its files."""
    out = []
    for cls, lines in class_lines(root or NAMES).items():
        pats = [ln for ln in lines if ln and not ln.startswith("#")]
        if pats:
            out.append((cls, re.compile("|".join(f"(?:{p})" for p in pats))))
    return out


def kernel_scopes(root: pathlib.Path | None = None) -> list[tuple[str, re.Pattern]]:
    """(class, pattern over host span names) of each class of scope files
    under ``root`` (default ``SCOPES``), in class order; the class's own
    harness span ``portbench.<class>`` included."""
    out = []
    for cls, lines in class_lines(root or SCOPES).items():
        pats = [re.escape(f"portbench.{cls}") + "$"]
        for ln in lines:
            key, _, value = ln.partition(":")
            if key == "span" and value.strip():
                pats.append(value.strip())
        out.append((cls, re.compile("|".join(f"(?:{p})" for p in pats))))
    return out


def scope_of(kernels: list[tuple[str, float, float, int]], ops: dict[int, tuple[float, int]],
             spans: list[tuple[str, float, float, int]],
             scopes: list[tuple[str, re.Pattern]]) -> list[tuple[str, float, float, str | None]]:
    """Each kernel (name, start, end, the correlation id of the op that
    launched it) with the scope class of the host span its op (``ops``:
    correlation id -> (start, thread)) started in, or None."""
    inside: list[tuple[str, dict[int, tuple[list[float], list[float]]]]] = []
    for cls, pat in scopes:
        per: dict[int, list[tuple[float, float]]] = {}
        for n, s, e, tid in spans:
            if pat.search(n):
                per.setdefault(tid, []).append((s, e))
        merged = {tid: merge(iv) for tid, iv in per.items()}
        inside.append((cls, {tid: ([s for s, _ in iv], [e for _, e in iv])
                             for tid, iv in merged.items()}))
    out = []
    for n, s, e, corr in kernels:
        cls_of = None
        op = ops.get(corr)
        if op is not None:
            t, tid = op
            for cls, per in inside:
                starts, ends = per.get(tid, ((), ()))
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= ends[i]:
                    cls_of = cls
                    break
        out.append((n, s, e, cls_of))
    return out


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce_events(kernels: list[tuple[str, float, float, str | None]],
                  host: list[tuple[str, float, float]], window: tuple[float, float],
                  classes: list[tuple[str, re.Pattern]]) -> Trace:
    """Reduce kernel events (name, start s, end s, scope class or None) and
    host events (name, start s, end s) over ``window``."""
    w0, w1 = window
    ks = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in kernels if e > w0 and s < w1]
    busy = merge([(s, e) for _, s, e, _ in ks])
    busy_s = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    class_s: dict[str, float] = {}
    unmatched: dict[str, float] = {}
    unscoped: dict[str, float] = {}
    for n, s, e, c in ks:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        if c is not None:
            class_s[c] = class_s.get(c, 0.0) + (e - s)
        else:
            unscoped[n] = unscoped.get(n, 0.0) + (e - s)
    for n, sec in unscoped.items():
        for cls, pat in classes:
            if pat.search(n):
                class_s[cls] = class_s.get(cls, 0.0) + sec
                break
        else:
            unmatched[n] = sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps inside the window, named by the host event (the harness span
    # and the op) that began last among those running at each gap's middle
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted((s, e, n) for n, s, e in host if n != WINDOW)
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = {}
    active: list[tuple[float, float, str]] = []
    harness: list[tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, e, n = spans[i]
            heapq.heappush(harness if n.startswith("portbench.") else active, (-s, e, n))
            i += 1
        names = []
        for heap in (harness, active):
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            names.append(heap[0][2] if heap else "")
        key = " / ".join(n for n in names if n) or "no host event"
        idle[key] = idle.get(key, 0.0) + (g1 - g0)
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=w1 - w0, busy_s=busy_s, class_s=class_s,
                 device_ops=[[_label(n), s] for n, s in ops],
                 idle_gaps=[[_label(n), s] for n, s in gaps_out],
                 unmatched=sorted(unmatched, key=lambda n: -unmatched[n]), kernels=len(ks))


def _ns(ev: Any, what: str) -> float:
    """An event's start or end in seconds (the profiler's API differs by
    version: ``start_ns``/``end_ns`` or ``start_us``/``duration_us``)."""
    if hasattr(ev, f"{what}_ns"):
        return getattr(ev, f"{what}_ns")() * 1e-9
    start = ev.start_us() * 1e-6
    return start if what == "start" else start + ev.duration_us() * 1e-6


def capture(fn: Callable[[], Any]) -> tuple[Any, Trace]:
    """Run ``fn()`` traced; returns its result and the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = reduce_profile(prof.profiler.kineto_results.events())
    print(f"[trace] {tr.kernels} device events, reduced in "
          f"{time.perf_counter() - t0:.1f} s; busy {tr.busy_s:.4f} s of {tr.window_s:.4f} s; "
          f"device s by class {tr.class_s}; the 5 unmatched kernels with most time: "
          f"{[n[:80] for n in tr.unmatched[:5]]}; {len(tr.program)} program span names",
          file=sys.stderr)
    return out, tr


def reduce_profile(events: Any) -> Trace:
    """Reduce the profiler's events (``kineto_results.events()``) of a
    stretch run inside the span ``WINDOW``: the kernels, the ops that
    launched them and the host spans, then the harness's classes and the
    program's spans."""
    from torch.autograd import DeviceType

    from portbench.program_spans import reduce_program

    kernels, host, spans = [], [], []
    ops: dict[int, tuple[float, int]] = {}
    window = None
    for ev in events:
        name = ev.name()
        s, e = _ns(ev, "start"), _ns(ev, "end")
        if ev.device_type() == DeviceType.CUDA:
            # kernels, memcpy and memset; a span's device-side copy (a GPU
            # user annotation) is not work
            if not (name.startswith("portbench.")
                    or getattr(ev, "is_user_annotation", lambda: False)()):
                kernels.append((name, s, e, ev.linked_correlation_id()))
            continue
        tid = ev.start_thread_id()
        if ev.linked_correlation_id() == 0:
            ops[ev.correlation_id()] = (s, tid)
        spans.append((name, s, e, tid))
        if name == WINDOW:
            window = (s, e)
        else:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the profile holds no window span")
    tr = reduce_events(scope_of(kernels, ops, spans, kernel_scopes()), host, window,
                       kernel_classes())
    tr.program = reduce_program(kernels, ops, spans, window)
    return tr

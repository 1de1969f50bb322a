"""The program's own spans in a traced stretch, on the kernels' clock.

The port marks its phases and layers as ``torch.profiler`` host spans named
``repro_torch.<part>.<what>``: a ``generate`` call (``serve.generate``), its
prefill, each prefill chunk or token step (``serve.step``), each model layer
(``model.<mixer>``, ``model.<mlp>``, ``model.embed``, ``model.head``), the
train step's forward, backward and optimizer update, the batch fetch.
``reduce_program`` reduces those of a traced window to four numbers a name:

* ``count``: the spans of that name;
* ``host_s``: their host seconds inside the window (nested spans each count
  their whole length);
* ``idle_s``: the window's device-idle seconds (outside the union of kernel
  intervals) given to the name, each idle instant to the latest-started
  program span open at that instant, on any thread;
* ``device_s``: the device seconds of the kernels whose launching op started
  inside a span of that name, the innermost such span on the op's thread
  (``tracing.scope_of``'s rule).

It takes the lists ``tracing.reduce_profile`` gathers (kernels, ops, host
spans and the window), which stores the result as ``Trace.program``; the
readers of ``metrics/`` read it through :func:`program_of`.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Any

from portbench.tracing import merge

__all__ = ["PREFIX", "reduce_program", "program_of"]

#: the program's span names start with this
PREFIX = "repro_torch."


def _row() -> dict[str, float]:
    return {"count": 0, "host_s": 0.0, "idle_s": 0.0, "device_s": 0.0}


def reduce_program(kernels: list[tuple[str, float, float, int]],
                   ops: dict[int, tuple[float, int]],
                   spans: list[tuple[str, float, float, int]],
                   window: tuple[float, float]) -> dict[str, dict[str, float]]:
    """Kernels (name, start s, end s, correlation id of the launching op),
    ops (correlation id -> (start s, thread)) and host spans (name, start s,
    end s, thread) over ``window``: ``{span name: {count, host_s, idle_s,
    device_s}}`` for the program's spans in it."""
    w0, w1 = window
    prog = sorted((max(s, w0), min(e, w1), n, tid) for n, s, e, tid in spans
                  if n.startswith(PREFIX) and e > w0 and s < w1)
    out: dict[str, dict[str, float]] = {}
    for s, e, n, _ in prog:
        row = out.setdefault(n, _row())
        row["count"] += 1
        row["host_s"] += e - s

    # idle: walk each gap between the kernels, split where the latest-started
    # open span changes (a span starts, or the top one ends)
    busy = merge([(max(s, w0), min(e, w1)) for _, s, e, _ in kernels if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    heap: list[tuple[float, float, str]] = []       # (-start, end, name): latest, innermost
    i = 0
    for g0, g1 in gaps:
        t = g0
        while t < g1:
            while i < len(prog) and prog[i][0] <= t:
                s, e, n, _ = prog[i]
                heapq.heappush(heap, (-s, e, n))
                i += 1
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            nxt = g1
            if i < len(prog):
                nxt = min(nxt, prog[i][0])
            if heap:
                nxt = min(nxt, heap[0][1])
                out[heap[0][2]]["idle_s"] += nxt - t
            t = nxt

    # device: each kernel to the innermost program span its op started in,
    # on the op's thread (spans on one thread nest)
    per: dict[int, tuple[list[float], list[float], list[str], list[int]]] = {}
    for s, e, n, tid in sorted(prog, key=lambda p: (p[3], p[0], -p[1])):
        starts, ends, names, parent = per.setdefault(tid, ([], [], [], []))
        j = len(starts) - 1
        while j >= 0 and ends[j] < s:
            j = parent[j]
        starts.append(s)
        ends.append(e)
        names.append(n)
        parent.append(j)
    for _, s, e, corr in kernels:
        op = ops.get(corr)
        if op is None or e <= w0 or s >= w1:
            continue
        t, tid = op
        if tid not in per:
            continue
        starts, ends, names, parent = per[tid]
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0 and ends[j] < t:
            j = parent[j]
        if j >= 0:
            out[names[j]]["device_s"] += min(e, w1) - max(s, w0)
    return out


def program_of(run: Any) -> dict[str, dict[str, float]]:
    """The traced stretch's program spans (``reduce_program``'s result, as
    ``trace.program``), or nothing where the run was not traced."""
    return run.trace.program if run.trace is not None else {}

"""The program's spans reduced on made-up events (``program_spans``): idle
time given to the latest-started open span and conserved, device time to
the innermost span on the launching op's thread, the harness's own
reduction untouched by them; and the readers of the metrics built on
them."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench import program_spans, run, tracing
from portbench.program_spans import reduce_program

GEN, STEP, MAMBA, MOE = ("repro_torch.serve.generate", "repro_torch.serve.step",
                         "repro_torch.model.mamba", "repro_torch.model.moe")


def _idle(kernels, window):
    w0, w1 = window
    busy = tracing.merge([(max(s, w0), min(e, w1)) for _, s, e, _ in kernels
                          if e > w0 and s < w1])
    return (w1 - w0) - sum(e - s for s, e in busy)


def test_idle_goes_to_the_latest_started_open_span():
    # generate [0, 10] holds a step [1, 9] holding mamba [2, 4] and moe [5, 8];
    # kernels cover [3, 6]; a span of another thread [8.5, 9.5] starts last
    spans = [(GEN, 0.0, 10.0, 1), (STEP, 1.0, 9.0, 1), (MAMBA, 2.0, 4.0, 1),
             (MOE, 5.0, 8.0, 1), ("repro_torch.data.fetch", 8.5, 9.5, 2),
             ("aten::mm", 2.5, 3.5, 1), ("portbench.window", 0.0, 10.0, 1)]
    kernels = [("k", 3.0, 6.0, 1)]
    got = reduce_program(kernels, {}, spans, (0.0, 10.0))
    idle = {n: r["idle_s"] for n, r in got.items()}
    assert idle == pytest.approx({GEN: 1.0 + 0.5, STEP: 1.0 + 0.5 + 0.0, MAMBA: 1.0,
                                  MOE: 2.0, "repro_torch.data.fetch": 1.0})
    assert got[GEN]["count"] == 1 and got[STEP]["host_s"] == pytest.approx(8.0)
    assert "aten::mm" not in got and "portbench.window" not in got
    assert sum(idle.values()) == pytest.approx(_idle(kernels, (0.0, 10.0)))


@pytest.mark.parametrize("seed", range(4))
def test_idle_of_the_spans_and_outside_them_adds_up_to_the_windows(seed):
    rng = np.random.default_rng(seed)
    kernels = []
    for i in range(200):
        s = float(rng.uniform(-1.0, 11.0))
        kernels.append((f"k{i}", s, s + float(rng.exponential(0.05)), i))
    spans = []
    for tid in (1, 2):
        t = float(rng.uniform(-0.5, 0.5))
        while t < 10.5:        # nested runs of steps and layers on each thread
            e = t + float(rng.uniform(0.2, 1.0))
            spans.append((STEP, t, e, tid))
            a = t
            for name in (MAMBA, MOE):
                b = a + (e - a) * float(rng.uniform(0.1, 0.6))
                spans.append((name, a, b, tid))
                a = b
            t = e + float(rng.uniform(0.0, 0.3))
    window = (0.0, 10.0)
    got = reduce_program(kernels, {}, spans, window)
    # idle outside every program span, worked out apart
    w0, w1 = window
    busy = tracing.merge([(max(s, w0), min(e, w1)) for _, s, e, _ in kernels
                          if e > w0 and s < w1])
    inside = tracing.merge([(max(s, w0), min(e, w1)) for _, s, e, _ in spans
                            if e > w0 and s < w1])
    covered = sum(e - s for s, e in inside)
    both = sum(max(0.0, min(e, y) - max(s, x)) for s, e in busy for x, y in inside)
    outside = (w1 - w0) - covered - (sum(e - s for s, e in busy) - both)
    total = sum(r["idle_s"] for r in got.values())
    assert abs(total + outside - _idle(kernels, window)) < 1e-9


def test_device_time_follows_the_launching_ops_thread():
    spans = [(STEP, 0.0, 10.0, 1), (MOE, 2.0, 4.0, 1), ("repro_torch.optim.update", 2.0, 4.0, 2)]
    ops = {1: (3.0, 1),      # inside moe, on its thread
           2: (3.0, 2),      # same time, the other thread's update
           3: (5.0, 1),      # the step, after moe ended
           4: (5.0, 2),      # thread 2 outside every span
           5: (3.0, 9)}      # a thread with no span
    kernels = [("a", 3.1, 3.3, 1), ("b", 3.2, 3.7, 2), ("c", 5.1, 5.2, 3), ("d", 6.0, 7.0, 4),
               ("e", 3.0, 3.5, 5), ("f", 9.5, 11.0, 3), ("g", 1.0, 2.0, 99)]
    got = reduce_program(kernels, ops, spans, (0.0, 10.0))
    dev = {n: r["device_s"] for n, r in got.items()}
    # f is cut at the window's end
    assert dev == pytest.approx({STEP: 0.1 + 0.5, MOE: 0.2, "repro_torch.optim.update": 0.5})


def test_program_spans_leave_the_harness_reduction_as_it_was():
    classes, scopes = tracing.kernel_classes(), tracing.kernel_scopes()
    harness = [("portbench.attention", 1.0, 2.0, 7), ("portbench.optimizer", 8.0, 9.0, 7)]
    program = [(GEN, 0.0, 10.0, 7), ("repro_torch.model.attn", 0.9, 2.1, 7),
               ("repro_torch.optim.update", 7.9, 9.1, 7), (STEP, 3.0, 5.0, 7)]
    ops = {1: (1.5, 7), 2: (3.5, 7), 3: (8.5, 7), 4: (4.0, 7)}
    kernels = [("nvjet_gemm", 1.6, 1.7, 1), ("nvjet_gemm", 3.6, 4.6, 2), ("adam", 8.6, 8.7, 3),
               ("flash_fwd_kernel", 4.1, 4.3, 4)]

    def reduced(spans):
        host = [(n, s, e) for n, s, e, _ in spans]
        return tracing.reduce_events(tracing.scope_of(kernels, ops, spans, scopes), host,
                                     (0.0, 10.0), classes)

    plain, with_program = reduced(harness), reduced(harness + program)
    assert with_program.busy_s == plain.busy_s
    assert with_program.class_s == plain.class_s
    assert with_program.device_ops == plain.device_ops
    assert plain.class_s == pytest.approx({"attention": 0.3, "matmul": 1.0, "optimizer": 0.1})


def _run(program, traced_units=2):
    trace = tracing.Trace(window_s=10.0, busy_s=4.0, class_s={}, device_ops=[], idle_gaps=[],
                          unmatched=[], kernels=0)
    if program is not None:
        trace.program = program
    return run.Run(cfg={}, traffic={}, units=1, window_s=1.0, work={}, model_flops=0.0,
                   traced_units=traced_units, traced_work=None, trace=trace, spans={},
                   counters={})


def _r(count, host_s=0.0, idle_s=0.0, device_s=0.0):
    return {"count": count, "host_s": host_s, "idle_s": idle_s, "device_s": device_s}


PROGRAM = {GEN: _r(5, host_s=3.25), "repro_torch.serve.prefill": _r(5, host_s=2.5),
           STEP: _r(400, host_s=9.6), MAMBA: _r(2800, idle_s=2.0),
           "repro_torch.model.attn": _r(400, idle_s=0.3), MOE: _r(1600, idle_s=1.2),
           "repro_torch.model.dense": _r(1600, idle_s=0.4),
           "repro_torch.data.fetch": _r(2, host_s=0.0031),
           "repro_torch.optim.update": _r(2, host_s=0.5, device_s=0.3978)}

#: each new metric and its value from ``PROGRAM`` by hand
EXPECTED = {"host_step_ms.decode": 24.0, "layer_idle_ms.mamba.decode": 5.0,
            "layer_idle_ms.attn.decode": 0.75, "layer_idle_ms.moe.decode": 3.0,
            "layer_idle_ms.dense.decode": 1.0, "after_prefill_ms.ttft": 150.0,
            "fetch_ms.train": 1.55, "update_ms.train": 198.9}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_gives_the_value_by_hand(metric):
    assert run.reader(metric)(metric, _run(PROGRAM)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_reads_nothing_without_the_programs_spans(metric):
    read = run.reader(metric)
    assert read(metric, _run(None)) is None
    assert read(metric, _run({})) is None
    assert read(metric, dataclasses.replace(_run(None), trace=None)) is None


def test_a_layer_the_stretch_never_ran_reads_nothing():
    assert run.reader("layer_idle_ms.slstm.decode")("layer_idle_ms.slstm.decode",
                                                    _run(PROGRAM)) is None


def test_the_readers_import_nothing_of_the_program():
    from portbench.test_portbench_imports import imported

    for path in [run.HERE / "program_spans.py",
                 *(run.HERE / "metrics" / f"{m.split('.')[0]}.py" for m in EXPECTED)]:
        assert "repro_torch" not in imported(path), path
    assert program_spans.PREFIX == "repro_torch."

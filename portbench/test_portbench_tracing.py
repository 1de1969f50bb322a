"""The trace's reduction on made-up events (busy time as a union, kernels
classed by the host span they were launched in before their names), and the
harness's spans around program functions."""

from __future__ import annotations

import pytest
import torch

from portbench import spans, tracing


def test_kernel_scopes_name_their_own_span_and_the_flash_backward():
    scopes = dict(tracing.kernel_scopes())
    assert scopes["attention"].search("portbench.attention")
    assert scopes["attention"].search("autograd::engine::evaluate_function: "
                                      "FlashAttentionBackward")
    assert not scopes["attention"].search("aten::mm")
    assert scopes["optimizer"].search("portbench.optimizer")


def test_a_file_adds_its_lines_to_the_class_its_name_begins_with(tmp_path, monkeypatch):
    """``<class>.<any>.txt`` adds to ``<class>``: its name patterns, its
    spans and its wraps, which run inside ``portbench.<class>``; the classes
    keep their order."""
    names, scopes = tmp_path / "names", tmp_path / "scopes"
    names.mkdir()
    scopes.mkdir()
    (names / "attention.txt").write_text("flash_fwd\n")
    (names / "attention.mla.txt").write_text("# the latent kernels\nmla_decode\n")
    (names / "matmul.txt").write_text("gemm\n")
    (scopes / "attention.txt").write_text("span: FlashAttentionBackward\n")
    (scopes / "attention.mla.txt").write_text("span: MlaBackward\nwrap: a.b:mla_attend\n")
    (scopes / "optimizer.txt").write_text("wrap: a.b:update\n")
    classes = tracing.kernel_classes(names)
    assert [c for c, _ in classes] == ["attention", "matmul"]
    assert classes[0][1].search("mla_decode_kernel") and classes[0][1].search("flash_fwd")
    monkeypatch.setattr(tracing, "SCOPES", scopes)
    got = dict(tracing.kernel_scopes())
    assert list(got) == ["attention", "optimizer"]
    assert all(got["attention"].search(n) for n in ("portbench.attention", "MlaBackward",
                                                    "FlashAttentionBackward"))
    assert not got["attention"].search("portbench.attention.mla")
    assert spans.wraps() == [("attention", "a.b", "mla_attend"), ("optimizer", "a.b", "update")]


def test_the_benchmarks_classes_are_those_of_its_files():
    assert [c for c, _ in tracing.kernel_classes()] == ["attention", "matmul", "scan"]
    assert [c for c, _ in tracing.kernel_scopes()] == ["attention", "optimizer"]


def test_a_kernel_takes_the_class_of_the_span_its_op_started_in():
    scopes = tracing.kernel_scopes()
    spans_ = [("portbench.attention", 1.0, 2.0, 7),
              ("autograd::engine::evaluate_function: FlashAttentionBackward", 5.0, 6.0, 8),
              ("portbench.optimizer", 8.0, 9.0, 7)]
    ops = {1: (1.5, 7),      # inside the attention span
           2: (1.5, 8),      # same time, another thread
           3: (5.5, 8),      # inside the backward, on its thread
           4: (3.0, 7),      # outside every span
           5: (8.0, 7)}      # the optimizer span itself
    kernels = [("gemm_a", 1.6, 1.7, 1), ("gemm_b", 1.6, 1.7, 2), ("gemm_c", 5.6, 5.7, 3),
               ("gemm_d", 3.1, 3.2, 4), ("adam", 8.1, 8.2, 5), ("gemm_e", 4.0, 4.1, 99)]
    got = [c for *_, c in tracing.scope_of(kernels, ops, spans_, scopes)]
    assert got == ["attention", None, "attention", None, "optimizer", None]


def test_scoped_kernels_leave_the_name_classes():
    classes = tracing.kernel_classes()
    kernels = [("nvjet_gemm", 0.0, 1.0, "attention"), ("nvjet_gemm", 1.0, 3.0, None),
               ("flash_fwd_kernel", 3.0, 3.5, None), ("adam_step", 3.5, 4.0, "optimizer"),
               ("memcpy", 5.0, 5.5, None)]
    tr = tracing.reduce_events(kernels, [("aten::copy_", 4.0, 6.0)], (0.0, 10.0), classes)
    assert tr.class_s == {"attention": 1.5, "matmul": 2.0, "optimizer": 0.5}
    assert tr.busy_s == pytest.approx(4.5) and tr.window_s == 10.0
    assert tr.unmatched == ["memcpy"]
    assert tr.device_ops[0] == ["nvjet_gemm", 3.0]
    assert dict(tr.idle_gaps) == pytest.approx({"aten::copy_": 1.0, "no host event": 4.5})


def test_busy_time_is_the_union_of_kernel_intervals():
    kernels = [("a", 0.0, 2.0, None), ("b", 1.0, 3.0, None), ("c", 9.0, 12.0, None)]
    tr = tracing.reduce_events(kernels, [], (0.0, 10.0), tracing.kernel_classes())
    assert tr.busy_s == pytest.approx(4.0)


def _twice(x):
    return 2 * x


class _Adder:
    def add(self, x):
        return x + 1


def test_wrapped_functions_run_in_their_span_and_are_restored(tmp_path, monkeypatch):
    import sys
    import types

    mod = types.ModuleType("portbench_test_spans_mod")
    mod.twice, mod.Adder = _twice, type("Adder", (_Adder,), {})
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    (tmp_path / "alpha.txt").write_text(f"# a comment\nwrap: {mod.__name__}:twice\n"
                                        f"wrap: {mod.__name__}:Adder.add\n"
                                        f"wrap: {mod.__name__}:gone\nwrap: no_such_module:f\n")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.wrapped(tmp_path) as names:
            assert mod.twice(torch.ones(2)).tolist() == [2.0, 2.0]
            assert mod.Adder().add(1) == 2
    assert names == [f"{mod.__name__}:twice", f"{mod.__name__}:Adder.add"]
    assert [e.name for e in prof.events()].count("portbench.alpha") == 2
    assert mod.twice is _twice and "add" not in vars(mod.Adder)


def test_the_programs_wrapped_names_exist():
    """Each ``wrap:`` line names a function the program has today."""
    import importlib

    for _, module, attr in spans.wraps():
        owner = importlib.import_module(module)
        for part in attr.split("."):
            owner = getattr(owner, part)
        assert callable(owner), (module, attr)


class _Event:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, end, *, cuda=False, tid=1, corr=0, linked=0):
        self._name, self._s, self._e = name, start, end
        self._cuda, self._tid, self._corr, self._linked = cuda, tid, corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return round(self._s * 1e9)

    def end_ns(self):
        return round(self._e * 1e9)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def test_a_profile_is_reduced_with_the_programs_spans():
    """One decode-like step in a window of 10 s: the program's spans are
    reduced into ``Trace.program`` beside the harness's classes, and the
    readers read them from there."""
    from portbench import program_spans, run

    gen, step, moe = "repro_torch.serve.generate", "repro_torch.serve.step", "repro_torch.model.moe"
    host = [("portbench.window", 0.0, 10.0, 1, 0), (gen, 0.5, 9.5, 1, 0),
            ("repro_torch.serve.prefill", 0.5, 1.0, 1, 0), (step, 1.0, 5.0, 1, 0),
            (moe, 1.5, 3.5, 1, 0), ("aten::mm", 2.0, 2.2, 1, 11),
            ("portbench.attention", 4.0, 4.5, 1, 0), ("aten::bmm", 4.1, 4.2, 1, 12),
            ("repro_torch.optim.update", 6.0, 7.0, 2, 0), ("aten::add", 6.5, 6.6, 2, 13)]
    device = [("nvjet_gemm", 2.5, 3.0, 11), ("flash_fwd_kernel", 4.3, 4.4, 12),
              ("adam", 6.7, 7.2, 13), ("portbench.attention", 4.0, 4.5, 0)]
    events = ([_Event(n, s, e, tid=tid, corr=corr) for n, s, e, tid, corr in host]
              + [_Event(n, s, e, cuda=True, linked=corr) for n, s, e, corr in device])
    tr = tracing.reduce_profile(events)
    assert tr.window_s == pytest.approx(10.0) and tr.busy_s == pytest.approx(1.1)
    assert tr.class_s == pytest.approx({"matmul": 0.5, "attention": 0.1})
    kernels = [(n, s, e, c) for n, s, e, c in device if c]
    ops = {corr: (s, tid) for _, s, _, tid, corr in host if corr}
    spans = [(n, s, e, tid) for n, s, e, tid, _ in host]
    want = program_spans.reduce_program(kernels, ops, spans, (0.0, 10.0))
    assert set(tr.program) == set(want) == {gen, "repro_torch.serve.prefill", step, moe,
                                            "repro_torch.optim.update"}
    for name, row in want.items():
        assert tr.program[name] == pytest.approx(row), name
    assert tr.program[moe]["device_s"] == pytest.approx(0.5)
    assert tr.program["repro_torch.optim.update"]["device_s"] == pytest.approx(0.5)
    assert tr.program[step]["count"] == 1 and tr.program[step]["host_s"] == pytest.approx(4.0)
    # the card idles in [1.5, 2.5) and [3.0, 3.5) inside the MoE layer
    assert tr.program[moe]["idle_s"] == pytest.approx(1.5)
    traced = run.Run(cfg={}, traffic={}, units=1, window_s=1.0, work={}, model_flops=0.0,
                     traced_units=1, traced_work=None, trace=tr, spans={}, counters={})
    # the idle given to a program span: prefill 0.5, step 0.5 + 0.8 + 0.6,
    # MoE 1.5, generate 1.0 + 2.3, the update 0.7; 7.9 s in all
    assert sum(row["idle_s"] for row in tr.program.values()) == pytest.approx(7.9)
    read = {m: run.reader(m)(m, traced) for m in
            ("host_step_ms.decode", "layer_idle_ms.moe.decode", "after_prefill_ms.ttft",
             "update_ms.train", "layer_idle_ms.mamba.decode", "layer_idle_share.moe.decode",
             "layer_idle_share.mamba.decode")}
    assert read == pytest.approx({"host_step_ms.decode": 4000.0,
                                  "layer_idle_ms.moe.decode": 1500.0,
                                  "after_prefill_ms.ttft": 8500.0, "update_ms.train": 500.0,
                                  "layer_idle_ms.mamba.decode": None,
                                  "layer_idle_share.moe.decode": 100 * 1.5 / 7.9,
                                  "layer_idle_share.mamba.decode": None})


def test_a_profile_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError, match="no window span"):
        tracing.reduce_profile([_Event("aten::mm", 0.0, 1.0, corr=1)])

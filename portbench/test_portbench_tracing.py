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

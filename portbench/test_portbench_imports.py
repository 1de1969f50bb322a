"""What the benchmark's modules import: never JAX or the JAX package
(``repro``; top-level names compared whole, since the program's name
``repro_torch`` begins with it), and in the yardstick (the reference, the
counts, the weights, the modules of the kinds (``archs/``), the trace's
reduction) nothing of the program either."""

from __future__ import annotations

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference", "count", "weights.py", "tracing.py", "metrics", "archs",
             "program_spans.py")


def imported(path: pathlib.Path) -> set[str]:
    """The top-level names of the modules a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.relative_to(HERE).parts[0] in YARDSTICK],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def test_the_names_are_compared_whole():
    src = HERE / "run.py"
    assert "repro_torch" in src.read_text()
    assert imported(src) & FORBIDDEN == set()


def test_nothing_reads_the_jax_benchmarks():
    for path in SOURCES:
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path


def test_a_loaded_jax_package_is_found_by_its_whole_name():
    from portbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.kernels.ops", "torch"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core", "jax.numpy"]) == ["jax", "repro"]


def test_no_card_means_no_result(capsys, monkeypatch):
    import torch

    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(run, "set_environment", lambda: None)
    code = run.main(["--workload", "minicpm-2b.train-s2048", "--seed", "3", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "no CUDA card" in out.err

"""The port's package rules: no JAX, no JAX package, one launch site, and the
device rule (the card unless the caller names the CPU)."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "ml_dtypes"), \
            f"{path.name} imports {name}"


def test_port_and_chip_smoke_import_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES)
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):",
        "    sys.modules[name] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        "import importlib",
        *(f"importlib.import_module({m!r})" for m in modules),
        "import chip_smoke",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
        "for k, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_only_the_launch_site_touches_the_library():
    offenders = []
    for path in PORT_FILES:
        if path.name == "pipeline.py":
            continue
        text = path.read_text()
        if "ctypes" in _imported_modules(path) or "CDLL" in text or "library()" in text:
            offenders.append(str(path.relative_to(ROOT)))
    assert not offenders, f"only kernels/pipeline.py may load or call the library: {offenders}"


def test_kernel_modules_launch_through_the_pipeline():
    for name in ("streamed_dot", "streamed_matmul", "flash_attention", "ssm_scan"):
        text = (PORT / "kernels" / f"{name}.py").read_text()
        assert "pipeline.lower(" in text and "pipeline.launch(" in text
        assert f"{name}.launches += 1" in text


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_guess_the_device(no_cuda):
    """With no device named and no CUDA device, every entry point raises
    instead of running on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.calibrate import calibrate, default_machine
    from repro_torch.core.hyperstep import HyperstepRunner
    from repro_torch.core.stream import StreamSet
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config("minicpm-2b", smoke=True)
    params = M.init_params(cfg, 0, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    stream = StreamSet().create(np.zeros(8, np.float32), 4)
    calls = [
        lambda: generate(cfg, params, prompt, steps=2),
        lambda: M.init_params(cfg, 0),
        lambda: M.forward(cfg, params, prompt),
        lambda: M.decode_step(cfg, params, M.init_cache(cfg, 1, 8, device="cpu"), prompt),
        lambda: M.init_cache(cfg, 1, 8),
        lambda: make_serve_step(cfg),
        lambda: make_prefill_step(cfg),
        lambda: calibrate(fast=True),
        lambda: default_machine(),
        lambda: HyperstepRunner(lambda s, t: s, [stream]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

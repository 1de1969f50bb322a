"""The benchmark's own tests: CPU tests at smoke sizes, and card tests
marked ``gpu`` that skip from the ``card`` fixture where there is none."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import run  # noqa: E402

#: smoke shapes of each traffic kind; the checked spans so short that the
#: last tenth of a row's positions fills over 30% of its last span, as 20 of
#: a cell's 256 served tokens fill its last span of 64
SMOKE_TRAFFIC = {
    "train": dict(batch=2, seq_len=32),
    "decode": dict(batch=4, prompt_len=8, new_tokens=8, check_span=2),
    "ttft": dict(prompt_lens=[8, 16, 24, 32, 40], check_requests=16),
    "score": dict(batch=2, seq_len=32, check_span=8),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (from a fixture) where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")


def smoke_config(name: str, dtype: str = "float32") -> dict:
    """The configuration ``configs/<name>.json`` cut to its smoke widths,
    ``smoke/configs/<name>.json``: every key of the kind kept, so each
    mixer, MLP and head of its cells runs. Both files are found under
    ``run.HERE`` when called, so a test can move them."""
    cfg = json.loads((run.HERE / "configs" / f"{name}.json").read_text())
    cfg.update(json.loads((run.HERE / "smoke" / "configs" / f"{name}.json").read_text()),
               dtype=dtype)
    return cfg


def smoke_traffic(name: str) -> dict:
    tr = json.loads((run.HERE / "traffic" / f"{name}.json").read_text())
    tr.update(SMOKE_TRAFFIC[tr["kind"]])
    return tr


@pytest.fixture
def smoke():
    return smoke_config, smoke_traffic

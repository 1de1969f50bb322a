"""On the card (marker ``gpu``; skips from the ``card`` fixture elsewhere):
a short run of the cheapest cell prints the contract's result, and the
fp8 control at that cell's own size comes out not correct.

    python -m pytest -q -m gpu portbench/test_portbench_card.py
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run
from portbench.kinds import score

CELL = "jamba-v0.1-52b.score-s4096"


@pytest.mark.gpu
def test_a_short_run_prints_the_result(card):
    res = run.run_cell(CELL, 2**31 + 5, 3.0, False)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"score_tokens_per_s", "setup_s"}


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size(card):
    wl = run.find(run.manifest()["workloads"], CELL, "workload")
    cfg = run.load_json(run.HERE / "configs" / f"{wl['config']}.json", "configuration")
    traffic = run.load_json(run.HERE / "traffic" / f"{wl['traffic']}.json", "traffic")
    limits = json.loads((run.HERE / "limits" / f"{CELL}.json").read_text())
    ctx = run.Context(CELL, cfg, traffic, 11, 0.0, torch.device("cuda"))
    numbers = dict(score.control_numbers(ctx))
    assert any(v > limits[k] for k, v in numbers.items())

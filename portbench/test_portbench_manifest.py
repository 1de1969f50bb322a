"""``BENCHMARK.json`` against the benchmark's contract: names, units and
lines in the allowed characters, every per-layer metric moving one
end-to-end metric of the cells it lists, every file a cell needs found by
name (the module of each mixer or MLP kind the built-ins lack too), and the
run length within what a full check of 24 cells can hold."""

from __future__ import annotations

import json
import re

import pytest

from portbench import run
from portbench.count import work

BENCH = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
#: the mixer and MLP kinds the harness's built-in code knows
BUILTIN_KINDS = {"attn", "mamba", "dense", "moe", "none"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|_dim$|_rank$|per_tok)",
                   re.IGNORECASE)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for word in BENCH["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
    assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"]), c["reduced"]


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        mine, per = run.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert per, w["name"]


def test_per_layer_metrics_move_one_metric_of_their_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        for cell in m["workloads"]:
            mine, _ = run.cell_metrics(BENCH, cell)
            assert m["moves"] in {e["name"] for e in mine}, (m["name"], cell)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    wl = run.find(BENCH["workloads"], cell, "workload")
    cfg = run.load_json(run.HERE / "configs" / f"{wl['config']}.json", "configuration")
    conf = run.find(BENCH["configs"], wl["config"], "configuration")
    assert conf["file"] == f"portbench/configs/{wl['config']}.json"
    assert cfg["source"] == conf["source"] and cfg["reduced"] == conf["reduced"]
    for kind in {k for block in cfg["pattern"] for k in block} - BUILTIN_KINDS:
        assert (run.HERE / "archs" / f"{kind}.py").is_file(), kind
    traffic = run.load_json(run.HERE / "traffic" / f"{wl['traffic']}.json", "traffic")
    assert (run.HERE / "kinds" / f"{traffic['kind']}.py").exists()
    assert (run.HERE / "limits" / f"{cell}.json").exists()
    _, per = run.cell_metrics(BENCH, cell)
    for m in per:
        assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_has_its_smoke_widths(config):
    """``smoke/configs/<config>.json`` cuts the configuration for the CPU
    tests: keys of the configuration, each a number."""
    cfg = run.load_json(run.HERE / "configs" / f"{config}.json", "configuration")
    cut = run.load_json(run.HERE / "smoke" / "configs" / f"{config}.json", "smoke widths")
    assert cut and set(cut) <= set(cfg)
    assert all(isinstance(v, (int, float)) for v in cut.values())


def test_control_widths_are_of_cells_of_the_benchmark():
    cells = {w["name"] for w in BENCH["workloads"]}
    for f in (run.HERE / "smoke" / "controls").glob("*.json"):
        assert f.stem in cells, f.name


def test_configurations_are_the_published_widths():
    cfgs = {c["name"]: run.load_json(run.ROOT / c["file"], "configuration")
            for c in BENCH["configs"]}
    assert round(work.param_count(cfgs["minicpm-2b"]) / 1e6) == 2725
    assert round(work.param_count(cfgs["jamba-v0.1-52b"]) / 1e6) == 13295
    jamba = cfgs["jamba-v0.1-52b"]
    assert (jamba["moe_experts"], jamba["moe_top_k"], jamba["d_model"]) == (16, 2, 4096)


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200

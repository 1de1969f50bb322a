"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``)
whose ``kind`` picks its driver (``kinds/<kind>.py``). Set-up makes the
weights from the seed on the card and warms the cell's own shapes; the
window runs whole units of the traffic (steps, calls, requests) for
``--seconds``; with ``--trace 1`` one more stretch runs under the profiler
and the cell's per-layer metrics (``metrics/<metric>.py``) are read from
the window and the trace. Then the program's state is freed, the plain
reference (``reference/``) checks what the window's program produced
against the limits in ``limits/<cell>.json``, and the last line of
standard output is the result as one JSON object. It exits non-zero and
prints no result without enough CUDA cards, without the program, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level module names that must not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's build and kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


class Refused(Exception):
    """A run that prints no result: the exit code and why."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def set_environment() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


# -- the manifest --------------------------------------------------------------------


def manifest(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise Refused(2, f"no {path}")
    return json.loads(path.read_text())


def find(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise Refused(2, f"no {what} named {name!r}")


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The cell's end-to-end metrics (those whose ``workloads`` list it, or
    have none) and its per-layer metrics (those whose ``workloads`` list
    it)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    per = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return e2e, per


def load_json(path: pathlib.Path, what: str) -> dict:
    if not path.exists():
        raise Refused(2, f"no {what} file {path}")
    return json.loads(path.read_text())


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else the
    reader of its family, ``metrics/<metric up to the first dot>.py``."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise Refused(2, f"no reader for per-layer metric {metric!r}")


# -- a cell's context ---------------------------------------------------------------


@dataclasses.dataclass
class Context:
    cell: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    device: Any

    def program_config(self, **over):
        """The program's ``ModelConfig`` built from the configuration file."""
        from repro_torch.configs.base import Block, ModelConfig

        names = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: v for k, v in self.cfg.items() if k in names and k != "pattern"}
        kw["pattern"] = tuple(Block(m, mlp) for m, mlp in self.cfg["pattern"])
        kw.update(over)
        return ModelConfig(**kw)


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads: the window (units done, host
    seconds, the counted work and model FLOPs of its units), the traced
    stretch (its units, their work and the reduced trace), the harness's
    spans and the program's counters."""

    cfg: dict
    traffic: dict
    units: int
    window_s: float
    work: dict
    model_flops: float
    traced_units: int
    traced_work: dict | None
    trace: Any
    spans: dict
    counters: dict


def work_of(ctx: Context, shapes: list[dict], cache: dict) -> tuple[dict, float]:
    """(work totals, model FLOPs) summed over units of the given shapes."""
    from portbench.count import work

    flops: dict[str, float] = {}
    nbytes, model = 0.0, 0.0
    per: dict[str, list[float]] = {}
    for shape in shapes:
        key = json.dumps(shape, sort_keys=True)
        if key not in cache:
            items = work.unit(ctx.cfg, ctx.traffic, **shape)
            cache[key] = (work.totals(items), work.model_flops(ctx.cfg, ctx.traffic, **shape))
        tot, mf = cache[key]
        model += mf
        nbytes += tot["bytes"]
        for k, v in tot["flops"].items():
            flops[k] = flops.get(k, 0.0) + v
        for cls, row in tot["class"].items():
            acc = per.setdefault(cls, [0.0, 0.0, 0.0])
            for i in range(3):
                acc[i] += row[i]
    return {"flops": flops, "bytes": nbytes, "class": per}, model


# -- one run ----------------------------------------------------------------------------


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: Any = "cuda",
             bench: dict | None = None, cfg: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None) -> dict:
    """Set up, measure and check one cell; returns the result object. The
    overrides (``bench``, ``cfg``, ``traffic``, ``limits``) serve the CPU
    tests."""
    import torch

    t_start = T_START
    bench = bench or manifest()
    wl = find(bench["workloads"], cell, "workload")
    cfg = cfg or load_json(HERE / "configs" / f"{wl['config']}.json", "configuration")
    traffic = traffic or load_json(HERE / "traffic" / f"{wl['traffic']}.json", "traffic")
    if limits is None:
        path = HERE / "limits" / f"{cell}.json"
        limits = json.loads(path.read_text()) if path.exists() else {}
    e2e_defs, per_defs = cell_metrics(bench, cell)
    cuda = torch.device(device).type == "cuda"
    ctx = Context(cell, cfg, traffic, int(seed) % 2**64, float(seconds), torch.device(device))
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    driver = kind.Driver(ctx)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    phase(f"start ({cell}, seed {seed})")
    driver.set_up()
    phase("set-up")
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # the window: whole units until the time is up, all of them and all
    # of their time counted
    n0 = len(driver.shapes)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = 0
    while True:
        driver.run_unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    phase(f"window: {units} units in {window_s:.3f} s")
    window_shapes = driver.shapes[n0:n0 + units]
    traced = None
    if trace:
        from portbench import spans, tracing

        with spans.wrapped() as names:
            _, traced = tracing.capture(
                lambda: [driver.run_unit() for _ in range(kind.TRACED_UNITS)])
        phase(f"traced stretch (spans around {names})")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    metrics: dict[str, dict] = {}
    if trace:
        cache: dict = {}
        wwork, mflops = work_of(ctx, window_shapes, cache)
        twork, _ = work_of(ctx, driver.shapes[n0 + units:], cache)
        run = Run(cfg=cfg, traffic=traffic, units=units, window_s=window_s, work=wwork,
                  model_flops=mflops, traced_units=kind.TRACED_UNITS, traced_work=twork,
                  trace=traced, spans=driver.spans(), counters=driver.counters)
        for m in per_defs:
            value = reader(m["name"])(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(units, window_s), setup_s=setup_s)
        for m in e2e_defs:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    attempted, failed = units, driver.failed
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from portbench.reference.model import exact_fp32

    exact_fp32()
    checks = {}
    correct = failed == 0
    numbers = driver.check()
    phase("check")
    for name, value in numbers:
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and limit is not None and math.isfinite(value) and value <= limit
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": device_block(cuda, wl["chips"], peak, traced)}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}
    if cuda:
        result["card"] = card()
    result["checks"] = checks
    return result


def phase(what: str) -> None:
    print(f"[portbench] {time.perf_counter() - T_START:9.2f} s  {what}", file=sys.stderr,
          flush=True)


def device_block(cuda: bool, chips: int, peak: int, traced: Any) -> dict:
    import torch

    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips if cuda else 1, "memory_peak_bytes": peak}
    if traced is not None:
        out["busy_s"] = traced.busy_s
        out["window_s"] = traced.window_s
    return out


def card() -> dict:
    """The card's name, power limit and clocks, as ``nvidia-smi`` reads them."""
    q = "name,power.limit,clocks.max.sm,clocks.sm"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return {"nvidia_smi": out.strip().splitlines()[0]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    try:
        import torch

        if not torch.cuda.is_available():
            raise Refused(3, "no CUDA card: torch.cuda.is_available() is false")
        wl = find(manifest()["workloads"], args.workload, "workload")
        if torch.cuda.device_count() < wl["chips"]:
            raise Refused(3, f"{args.workload} needs {wl['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        if importlib.util.find_spec("repro_torch") is None:
            raise Refused(4, "the program (repro_torch, under src/) is not in this checkout")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        bad = forbidden_modules()
        if bad:
            raise Refused(5, f"loaded in this process: {bad}")
    except Refused as e:
        print(f"[portbench] no result: {e}", file=sys.stderr)
        return e.code
    for name, c in result["checks"].items():
        print(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"[check] correct = {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

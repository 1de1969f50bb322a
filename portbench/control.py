"""The controls of the cells' checks, run on the card at each cell's size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed the control (the plain reference computed with fp8 products:
``reference.model.Ref(quant=True)``) stands in the program's place, and its
readings of the cell's compared numbers are printed, one JSON line a seed,
with those of the faults the cell's kind plants in the reference
(``fault_numbers``): the upper readings the cell's limits are set below.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from run import ROOT, Context, find, load_json, manifest, set_environment  # noqa: F401

HERE = ROOT / "portbench"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from portbench.reference.model import exact_fp32

    exact_fp32()
    wl = find(manifest()["workloads"], args.workload, "workload")
    cfg = load_json(HERE / "configs" / f"{wl['config']}.json", "configuration")
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json", "traffic")
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(args.workload, cfg, traffic, seed % 2**64, 0.0, torch.device("cuda"))
        out = {"workload": args.workload, "seed": seed,
               "control": dict(kind.control_numbers(ctx))}
        if hasattr(kind, "fault_numbers"):
            out["faults"] = {k: dict(v) for k, v in kind.fault_numbers(ctx).items()}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

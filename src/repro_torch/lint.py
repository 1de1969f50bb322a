"""Static lint over the plans the port's code constructs.

``python -m repro_torch.lint`` builds every plan and runner the port's
kernels, algorithms, serve engine and training loop construct — at small
shapes, nothing executes or compiles — runs
:func:`repro_torch.core.verify.verify_plan` /
:func:`~repro_torch.core.verify.verify_runner` over each against the
calibrated pack of the device (:func:`repro_torch.core.calibrate.default_machine`:
the card unless ``--device cpu``), and prints a diagnostics table.
``--check`` exits non-zero when any target fails to build or produces an
error-severity finding, so a plan regression (a corrupted seek schedule,
an aliased up-stream, a blown budget) fails before it reaches a launch.

Targets are registered explicitly: each is the plan its constructor makes at
the shapes given here. The kernels' targets are their launch plans (the
matmul at every variant's tile, the scan's forward with its tape and its
backward); the examples' targets are the plans the port's examples build
(:mod:`repro_torch.examples`).

Run: ``PYTHONPATH=src python -m repro_torch.lint [--check] [--device cpu]``
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Any, Callable

from repro_torch.core.verify import Diagnostic, format_diagnostics

__all__ = ["target", "run_lint", "main"]

_TARGETS: list[tuple[str, Callable[[Any, Any], list[Diagnostic]]]] = []


def target(name: str):
    """Register ``fn(machine, device) -> diagnostics`` as lint target ``name``."""
    def deco(fn: Callable[[Any, Any], list[Diagnostic]]):
        _TARGETS.append((name, fn))
        return fn
    return deco


# --------------------------------------------------------------- targets ----


@target("core/hyperstep:inner_product")
def _lint_quickstart(machine, device) -> list[Diagnostic]:
    """The quickstart's §3.1 inner product: two streams, one runner."""
    import numpy as np

    from repro_torch.core import HyperstepRunner, StreamSet
    from repro_torch.core.verify import verify_runner

    ss = StreamSet()
    sv = ss.create(np.zeros(1 << 14, np.float32), 4096, name="v")
    su = ss.create(np.zeros(1 << 14, np.float32), 4096, name="u")
    runner = HyperstepRunner(lambda a, t: a, [sv, su], machine=machine, device=device)
    return verify_runner(runner)


@target("distributed/cannon:two_level")
def _lint_cannon(machine, device) -> list[Diagnostic]:
    import numpy as np

    from repro_torch.core.verify import verify_runner
    from repro_torch.distributed.cannon import make_cannon_runner

    m_blocks = 2
    a = np.ones((16, 16), np.float32)
    b = np.ones((16, 16), np.float32)
    runner, _, _ = make_cannon_runner(a, b, m_blocks, machine=machine, device=device)
    return verify_runner(runner, num_hypersteps=m_blocks ** 3)


@target("distributed/cannon:two_level_mesh")
def _lint_cannon_mesh(machine, device) -> list[Diagnostic]:
    """The Cannon runner given ``mesh=`` at a 1×1 grid: the plan and MOVE
    walk it verifies are the mesh-free runner's."""
    import numpy as np

    from repro_torch.core.verify import verify_runner
    from repro_torch.distributed.cannon import make_cannon_runner
    from repro_torch.launch.mesh import Mesh

    m_blocks = 2
    a = np.ones((16, 16), np.float32)
    runner, _, _ = make_cannon_runner(a, a, m_blocks, mesh=Mesh({"data": 1, "model": 1}),
                                      machine=machine, device=device)
    return verify_runner(runner, num_hypersteps=m_blocks ** 3)


@target("examples/bsps_spmv:ell_blocks")
def _lint_spmv(machine, device) -> list[Diagnostic]:
    from repro_torch.core.verify import verify_runner
    from repro_torch.examples import bsps_spmv

    cols, vals, x = bsps_spmv.make_ell_blocks(64, 0.1, block_rows=16)
    runner, _, _ = bsps_spmv.make_spmv_runner(cols, vals, x, machine, device=device)
    return verify_runner(runner)


@target("core/plan:packed_decode")
def _lint_packed_decode(machine, device) -> list[Diagnostic]:
    from repro_torch.core.plan import packed_decode_plan
    from repro_torch.core.verify import verify_plan

    plan = packed_decode_plan(
        lanes=4, steps=16, flops_per_token=2e6,
        params_words=1 << 16, kv_words_per_lane=4096.0)
    return verify_plan(plan, machine)


@target("launch/engine:packed_decode")
def _lint_engine(machine, device) -> list[Diagnostic]:
    """The plan :class:`ServeEngine` prices a segment with, for minicpm-2b's
    smoke config at 8 lanes over a 512-position pool (``_decode_plan``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import batched_scratch, packed_decode_plan
    from repro_torch.core.verify import verify_plan
    from repro_torch.models import model as M

    cfg = get_config("minicpm-2b", smoke=True)
    lanes, pool, segment = 8, 512, 8
    cache_bytes = M.cache_bytes(cfg, lanes, pool)
    params = M.count_params(cfg)
    plan = packed_decode_plan(
        lanes=lanes, steps=segment, flops_per_token=2.0 * params, params_words=params,
        kv_words_per_lane=(cache_bytes / 4) / (lanes * pool) * (pool / 2 + segment / 2),
        scratch=(batched_scratch("kv_pool", cache_bytes // lanes, lanes),),
        name=f"engine_{cfg.name}_B{lanes}")
    return verify_plan(plan, machine)


@target("train/loop:host_plan")
def _lint_loop(machine, device) -> list[Diagnostic]:
    """The training loop's plan: a batch down-stream and a checkpoint
    up-stream every 2 steps, minicpm-2b's smoke config (nothing is written)."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import host_plan
    from repro_torch.core.verify import verify_plan
    from repro_torch.data.pipeline import BatchStream, DataConfig, TokenStream
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import CheckpointStream

    cfg = get_config("minicpm-2b", smoke=True)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    steps = 8
    batches = BatchStream(TokenStream(data), steps)
    ckpt = CheckpointStream("checkpoints", every=2, num_tokens=steps,
                            state_words=3 * M.count_params(cfg) + 1)
    plan = host_plan([batches], out_streams=[ckpt], out_every=[2],
                     flops_per_hyperstep=6.0 * M.count_params(cfg) * 4 * 64,
                     name=f"train_{cfg.name}")
    return verify_plan(plan, machine)


@target("kernels/streamed_matmul:variants")
def _lint_matmul(machine, device) -> list[Diagnostic]:
    """The matmul's launch plans at every variant's tile: the m ≤ 16
    variants at 4 rows (K split over a cluster), the others at 512³ (fp32
    for ``simt_f32``), and a split-K plan."""
    import torch

    from repro_torch.core.verify import verify_plan
    from repro_torch.kernels.streamed_matmul import VARIANTS, decode_plan, matmul_plan

    diags: list[Diagnostic] = []
    for name, (bm, bn, bk) in VARIANTS.items():
        if name in ("decode", "decode_deep", "decode_cp"):
            plan = decode_plan(4, 2304, 5760, 4, deep=name != "decode")
        else:
            dtype = torch.float32 if name == "simt_f32" else torch.bfloat16
            plan = matmul_plan(512, 512, 512, block_m=bm, block_n=bn, block_k=bk, dtype=dtype)
        diags += verify_plan(plan, machine)
    diags += verify_plan(matmul_plan(64, 4096, 64, block_m=64, block_n=64, block_k=32,
                                     split_k=4), machine)
    return diags


@target("kernels/flash_attention:gqa")
def _lint_attention(machine, device) -> list[Diagnostic]:
    from repro_torch.core.verify import verify_plan
    from repro_torch.kernels.flash_attention import BLOCK_KV, BLOCK_Q, attention_plan

    plan = attention_plan(1, 4, 2, 256, 256, 64, block_q=BLOCK_Q, block_kv=BLOCK_KV)
    return verify_plan(plan, machine)


@target("kernels/streamed_dot:inner_product")
def _lint_dot(machine, device) -> list[Diagnostic]:
    from repro_torch.core.verify import verify_plan
    from repro_torch.kernels.streamed_dot import dot_plan

    return verify_plan(dot_plan(16, 4096), machine) + verify_plan(
        dot_plan(16, 4096, cores=4), machine)


@target("kernels/ssm_scan:chunked")
def _lint_ssm(machine, device) -> list[Diagnostic]:
    """The scan's plan, and its launch plan with the backward's tape."""
    from repro_torch.core.verify import verify_plan
    from repro_torch.kernels.ssm_scan import ssm_plan

    return verify_plan(ssm_plan(1, 256, 128, 16, chunk=64), machine) + verify_plan(
        ssm_plan(1, 256, 128, 16, chunk=64, block_d=64, tape=True), machine)


@target("kernels/ssm_scan:backward")
def _lint_ssm_bwd(machine, device) -> list[Diagnostic]:
    """The scan's backward launch plan at its own geometry."""
    from repro_torch.core.verify import verify_plan
    from repro_torch.kernels.ssm_scan import BWD_STAGE, bwd_geometry, ssm_bwd_plan

    block_d = bwd_geometry(16)[1]
    return verify_plan(ssm_bwd_plan(2, 256, 200, 16, chunk=BWD_STAGE, block_d=block_d),
                       machine)


@target("launch/dryrun:stream_plans")
def _lint_dryrun_plans(machine, device) -> list[Diagnostic]:
    """The hot-spot plans the dry-run report records, at a smoke shape."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import stream_plan_report

    class _Collect:
        def __init__(self):
            self.diags: list[Diagnostic] = []

        def ingest_diagnostics(self, diags):
            self.diags.extend(diags)

    sink = _Collect()
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    stream_plan_report(cfg, ShapeSpec("lint", 256, 1, "prefill"), machine, health=sink)
    return sink.diags


# ------------------------------------------------------------------ CLI ----


def run_lint(check: bool = False, *, device: Any = None, machine: Any = None) -> int:
    """Run every target on ``machine`` (default: the calibrated pack of
    ``device``); print the table; return the exit code."""
    from repro_torch.core.calibrate import default_machine
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    machine = machine if machine is not None else default_machine(device=device)
    failures = 0
    errors = 0
    rows: list[str] = []
    for name, fn in _TARGETS:
        try:
            diags = fn(machine, device)
        except Exception:
            failures += 1
            rows.append(f"BUILD-FAIL  {name}")
            traceback.print_exc()
            continue
        n_err = sum(d.severity == "error" for d in diags)
        n_warn = sum(d.severity == "warn" for d in diags)
        n_info = len(diags) - n_err - n_warn
        errors += n_err
        status = "FAIL" if n_err else "ok"
        rows.append(f"{status:10s}  {name}  "
                    f"({n_err} error, {n_warn} warn, {n_info} info)")
        if diags:
            rows.append(format_diagnostics(diags))
    print(f"repro_torch.lint: {len(_TARGETS)} plan targets on {machine.name}")
    print("\n".join(rows))
    bad = failures + errors
    if bad:
        print(f"repro_torch.lint: {errors} error finding(s), "
              f"{failures} target build failure(s)")
    else:
        print("repro_torch.lint: all plans verify clean")
    return 1 if (check and bad) else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="statically verify the BSPS plans the port constructs")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on error findings or build failures")
    ap.add_argument("--device", default=None,
                    help="the pack's device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    return run_lint(check=args.check, device=args.device)


if __name__ == "__main__":
    sys.exit(main())

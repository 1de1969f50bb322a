"""Two-level Cannon matrix multiplication as a BSPS program (paper §3.2).

The full Algorithm 2, executed through the port's runtime:
``repro_torch.distributed.cannon.cannon_plan`` prices the construction with
Eq. 2, ``autotune`` picks the outer block count M under the machine's
local-memory budget, and ``make_cannon_runner`` runs the product through a
multi-core :class:`~repro_torch.core.hyperstep.HyperstepRunner` — per-core
pseudo-streams Σ^A/Σ^B (the ``MOVE`` reuse as cursor seeks), the inner
Cannon (:func:`~repro_torch.distributed.cannon.cannon_matmul` over the ranks
when this runs inside a rank group of N² ≥ 4 ranks, the local product on a
1×1 grid otherwise; each local product on the port's matmul kernel) as the
per-hyperstep BSP program, and C blocks written back on the cores' DMA
lanes.

The hyperstep loop runs in **compiled mode**: the whole M³ walk — including
the MOVE seeks — is one replay via ``HyperstepRunner.compile``; the
instrumented host loop is run once for the largest M to show the
dispatch-overhead gap.

Prints the Eq. 2 prediction next to the measured time, the paper's §6
validation. Run: python -m repro_torch.examples.bsps_cannon [n] [M] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any

import numpy as np
import torch.distributed as dist

from repro_torch.core import plan as planlib
from repro_torch.core.calibrate import calibrate
from repro_torch.device import resolve_device
from repro_torch.distributed.cannon import (
    cannon_compiled_state,
    cannon_plan,
    gather_c,
    make_cannon_runner,
)
from repro_torch.launch.mesh import make_host_mesh

__all__ = ["grid", "choose_m", "run_compiled", "main"]


def grid(device: Any) -> tuple[int, Any]:
    """(N, mesh): the rank grid when this runs in a rank group of N² ≥ 4
    ranks, else (1, None)."""
    if dist.is_initialized():
        n = math.isqrt(dist.get_world_size())
        if n > 1 and n * n == dist.get_world_size():
            return n, make_host_mesh(n, device=device)
    return 1, None


def choose_m(n: int, n_grid: int, acc) -> tuple[Any, list]:
    """Eq. 2 picks M before anything runs: larger outer blocks are
    predicted cheaper until local memory runs out."""
    cands = [{"m_blocks": m} for m in (1, 2, 4, 8, 16)
             if n % (m * n_grid) == 0 and n // (m * n_grid) >= 8]
    return planlib.autotune(lambda m_blocks: cannon_plan(n, m_blocks, n_grid), cands, acc)


def run_compiled(a: np.ndarray, b: np.ndarray, m_blocks: int, n_grid: int, mesh: Any, acc,
                 device) -> tuple[np.ndarray, dict[str, float]]:
    """C and the predicted-vs-measured row of the second of two compiled
    runs of one runner (the first warms it)."""
    n = a.shape[0]
    runner, outs, _ = make_cannon_runner(a, b, m_blocks, n_grid=n_grid, mesh=mesh,
                                         machine=acc, device=device)
    runner.run(cannon_compiled_state(n, m_blocks, device=device),
               num_hypersteps=m_blocks**3, compiled=True)
    runner.reset_records()
    runner.run(cannon_compiled_state(n, m_blocks, device=device),
               num_hypersteps=m_blocks**3, compiled=True)
    return gather_c(outs, n, m_blocks, n_grid), runner.predicted_vs_measured()


def main(argv: list[str] | None = None) -> dict[int, float]:
    """Run the example; returns each run M's max error against ``a @ b``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.bsps_cannon")
    ap.add_argument("n", type=int, nargs="?", default=512)
    ap.add_argument("m", type=int, nargs="?", default=None)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n
    acc = calibrate(device=device)
    n_grid, mesh = grid(device)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)

    best, choices = choose_m(n, n_grid, acc)
    for c in choices:
        tag = "ok " if c.feasible else "OOM"
        print(f"  [autotune] M={c.params['m_blocks']:2d} {tag} "
              f"predicted={c.predicted_seconds * 1e3:8.2f}ms "
              f"vmem={c.plan.vmem_bytes / 1e6:.1f}MB")
    print(f"  [autotune] picked M={best.params['m_blocks']} (Eq. 2)")

    run_ms = [args.m] if args.m is not None else sorted({best.params["m_blocks"], 2, 4})
    errs = {}
    for m_blocks in run_ms:
        if n % (m_blocks * n_grid) != 0:
            continue
        c, row = run_compiled(a, b, m_blocks, n_grid, mesh, acc, device)
        err = errs[m_blocks] = float(np.abs(c - a @ b).max())
        k = n // (m_blocks * n_grid)
        print(f"n={n} N={n_grid} M={m_blocks} k={k}: err={err:.2e} "
              f"measured={row['measured_seconds'] * 1e3:.1f}ms "
              f"predicted={row['predicted_seconds'] * 1e3:.1f}ms "
              f"(x{row['pred_over_meas']:.2f}) "
              f"[compiled: {m_blocks**3} hypersteps, 1 replay] "
              f"bw_heavy pred={row['bandwidth_heavy_predicted']:.0f} "
              f"meas={row['bandwidth_heavy_measured']:.0f}")

    # the dispatch-overhead gap: the same program in both modes, one reused
    # runner each so the compiled timing excludes the first run
    valid_ms = [m for m in run_ms if n % (m * n_grid) == 0]
    if not valid_ms:
        print(f"  [modes] no M in {run_ms} divides n={n} on the "
              f"{n_grid}×{n_grid} grid; skipping the mode comparison")
        return errs
    m_cmp = max(valid_ms)
    runner, outs, _ = make_cannon_runner(a, b, m_cmp, n_grid=n_grid, mesh=mesh, machine=acc,
                                         device=device)
    state0 = lambda: cannon_compiled_state(n, m_cmp, device=device)  # noqa: E731
    runner.run(state0(), num_hypersteps=m_cmp**3, compiled=True)   # warm up
    t0 = time.perf_counter()
    runner.run(state0(), num_hypersteps=m_cmp**3, compiled=True)
    comp_s = time.perf_counter() - t0
    h_runner, h_outs, h_state0 = make_cannon_runner(
        a, b, m_cmp, n_grid=n_grid, mesh=mesh, machine=acc, compiled=False, device=device)
    h_runner.run(h_state0, num_hypersteps=m_cmp**3)     # warm up
    t0 = time.perf_counter()
    h_runner.run(h_state0, num_hypersteps=m_cmp**3)
    host_s = time.perf_counter() - t0
    gap = float(np.abs(gather_c(outs, n, m_cmp, n_grid) - gather_c(h_outs, n, m_cmp, n_grid)).max())
    if gap >= 1e-4:
        raise RuntimeError(f"compiled and host-loop C differ by {gap:.3g}")
    print(f"  [modes] M={m_cmp}: host loop {host_s * 1e3:.1f}ms vs "
          f"compiled {comp_s * 1e3:.1f}ms ({host_s / comp_s:.1f}x, "
          f"{m_cmp**3 / comp_s:.0f} hypersteps/s)")
    return errs


if __name__ == "__main__":
    main()

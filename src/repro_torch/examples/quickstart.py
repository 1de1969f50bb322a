"""Quickstart: the three layers of the BSPS framework in one file.

1. the paper's cost model — predict whether a workload is bandwidth- or
   compute-heavy on a BSP accelerator (the Epiphany-III pack, and the pack
   calibrated on the device this runs on);
2. a BSPS *program* — the §3.1 inner product executed in hypersteps with
   prefetch overlap, each hyperstep's dot product on the ``streamed_dot``
   kernel (its plain version on the CPU);
3. the LM framework on top — one training step of an assigned architecture
   (qwen2-moe-a2.7b's smoke config: on the card its attention, head dim 16,
   runs on the flash kernel and its projections on the matmul kernel).

Run: python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    EPIPHANY_III,
    BSPAccelerator,
    HyperstepCost,
    HyperstepRunner,
    StreamSet,
    cannon_k_equal,
    inner_product_cost,
)
from repro_torch.core.calibrate import default_machine
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.steps import make_train_step

__all__ = ["cost_rows", "inner_product", "lm_step", "main"]


def cost_rows(packs: list[BSPAccelerator]) -> list[dict[str, Any]]:
    """Per pack: the §3.1 inner product of 2^20 floats in tokens of 4096
    (Eq. 1's seconds) and whether its hypersteps are bandwidth-heavy."""
    rows = []
    for acc in packs:
        t = inner_product_cost(acc, N=1 << 20, C=4096)
        h = HyperstepCost(bsp_flops=2 * 4096, fetch_words=[2 * 4096])
        rows.append({"name": acc.name, "e": acc.e, "seconds": acc.flops_to_seconds(t),
                     "bandwidth_heavy": bool(h.bandwidth_heavy(acc))})
    return rows


def demo_cost_model(device: torch.device) -> None:
    print("== 1. BSPS cost model (paper Eq. 1 / Eq. 2) ==")
    for row in cost_rows([EPIPHANY_III, default_machine(device=device)]):
        regime = "bandwidth" if row["bandwidth_heavy"] else "compute"
        print(f"  {row['name']:16s} e={row['e']:7.1f} flop/word | inner product of "
              f"2^20 floats: {row['seconds'] * 1e3:8.3f} ms, {regime}-heavy hypersteps")
    k_eq = cannon_k_equal(dataclasses.replace(EPIPHANY_III, g=1.0))
    print(f"  Cannon k_equal on Epiphany-III (optimised writes): {k_eq:.1f} "
          "(paper Fig. 5: ~8)")


def inner_product(v: np.ndarray, u: np.ndarray, token: int,
                  device: torch.device) -> tuple[float, HyperstepRunner]:
    """v·u through a :class:`HyperstepRunner` over two streams of ``token``
    floats, each hyperstep adding one token pair's ``ops.dot``."""
    ss = StreamSet()
    sv, su = ss.create(v, token), ss.create(u, token)
    runner = HyperstepRunner(lambda a, t: a + ops.dot(t[0], t[1]), [sv, su], device=device)
    out = runner.run(torch.zeros((), dtype=torch.float32, device=device))
    return float(out), runner


def demo_bsps_program(device: torch.device) -> None:
    print("== 2. hyperstep execution with prefetch (paper Fig. 1) ==")
    rng = np.random.default_rng(0)
    v = rng.standard_normal(1 << 16).astype(np.float32)
    u = rng.standard_normal(1 << 16).astype(np.float32)
    out, runner = inner_product(v, u, 4096, device)
    bw_heavy = sum(r.bandwidth_heavy for r in runner.records)
    print(f"  v·u = {out:.2f} (numpy: {float(np.dot(v, u)):.2f}) in "
          f"{len(runner.records)} hypersteps, {bw_heavy} bandwidth-heavy")


def lm_step(cfg, params: Any, tokens: torch.Tensor, device: torch.device) -> dict[str, float]:
    """One AdamW step (constant lr 1e-3) on ``{"tokens", "labels"}`` =
    ``tokens``; the step's metrics."""
    opt = AdamW(schedule=constant(1e-3))
    step = make_train_step(cfg, opt, device=device)
    _, _, metrics = step(params, opt.init(params), {"tokens": tokens, "labels": tokens})
    return {k: float(v) for k, v in metrics.items()}


def demo_lm_step(device: torch.device) -> dict[str, float]:
    """One train step of qwen2-moe-a2.7b's smoke config; its metrics."""
    print("== 3. one training hyperstep of an assigned arch (smoke config) ==")
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    params = M.init_params(cfg, 0, device=device)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen).to(device)
    m = lm_step(cfg, params, toks, device)
    print(f"  {cfg.name}: loss {m['loss']:.4f} moe_aux {m['moe_aux']:.4f} "
          f"grad_norm {m['grad_norm']:.3f}")
    return m


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    demo_cost_model(device)
    demo_bsps_program(device)
    demo_lm_step(device)


if __name__ == "__main__":
    main()

"""Dry-run plan report: a cell's hot-spot StreamPlans, priced without running.

For an (arch × shape) cell this prices the two kernel hot-spots — the FFN
product and attention — on a machine pack: the planner
(:func:`repro_torch.core.plan.autotune`) scores the card's own tiles with
Eq. 1 and records the chosen blocks, their predicted seconds, their local
memory and the static verifier's findings beside the cell's useful FLOPs
(:func:`repro_torch.core.roofline.model_flops`). The default pack is the
card's, calibrated (:func:`repro_torch.core.calibrate.default_machine`).

The JAX package's dry run also lowers and compiles every cell for a pod of
fake devices and reads XLA's cost and memory analyses; that part has no
counterpart here (a step's counted work comes from
:func:`repro_torch.core.roofline.count` on the card instead).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
      --shape train_4k [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Any

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import plan as planlib
from repro_torch.core import roofline as rf
from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.calibrate import default_machine
from repro_torch.core.calibstore import get_default_store
from repro_torch.core.health import HealthMonitor
from repro_torch.kernels.flash_attention import BLOCK_KV, BLOCK_Q, attention_plan
from repro_torch.kernels.streamed_matmul import VARIANTS, matmul_plan

__all__ = ["analytic_extra_flops", "stream_plan_report", "matmul_candidates",
           "attention_candidates", "plan_record", "main"]


def analytic_extra_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """FLOPs of the three recurrent bodies that the JAX package's XLA count
    sees once a scan (its dry run adds these to the count):

    * sLSTM per-step recurrence: 2·d·4dh matvec + ~30·d gates per token;
    * mLSTM chunk body (chunk=128): scores/pv ≈ 4·ck·di + state read/update
      ≈ 4·di·dh per token;
    * mamba chunk body: ≈ 10·di·ds per token (cum/exp/einsums).

    ×3 when training (fwd + ~2× bwd).
    """
    counts = {"slstm": 0, "mlstm": 0, "mamba": 0}
    for _, b in cfg.blocks():
        if b.mixer in counts:
            counts[b.mixer] += 1
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mult = 3.0 if shape.kind == "train" else 1.0
    d = cfg.d_model
    dh_s = d // cfg.num_heads
    extra = counts["slstm"] * (2 * d * 4 * dh_s + 30 * d)
    di_m = cfg.mlstm_expand * d
    dh_m = di_m // cfg.num_heads
    ck = 128
    extra += counts["mlstm"] * (4 * ck * di_m + 4 * di_m * dh_m)
    extra += counts["mamba"] * (10 * cfg.ssm_d_inner * cfg.ssm_d_state)
    return extra * tokens * mult


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def matmul_candidates(m: int, k: int, n: int) -> list[dict[str, int]]:
    """The tiles the card's bf16 matmul launches for an m-row product:
    the m ≤ 16 variants' (``decode``, ``decode_deep``, ``decode_cp``)
    or the larger ones' (``wgmma``, ``wgmma_cp``), from ``VARIANTS``."""
    names = (("decode", "decode_deep", "decode_cp") if m <= 16 else ("wgmma", "wgmma_cp"))
    tiles = sorted({VARIANTS[v] for v in names})
    return [{"block_m": bm, "block_n": bn, "block_k": bk} for bm, bn, bk in tiles]


def attention_candidates(sq: int, skv: int) -> list[dict[str, int]]:
    """The flash kernel's one block shape (``BLOCK_Q`` × ``BLOCK_KV``)."""
    return [{"block_q": BLOCK_Q, "block_kv": BLOCK_KV}]


def stream_plan_report(
    cfg: ModelConfig, shape: ShapeSpec, acc: BSPAccelerator | None = None,
    *, chips: int = 1, health: Any = None, device: Any = None,
) -> dict[str, Any]:
    """Chip-level StreamPlans for the cell's kernel hot-spots.

    For each hot-spot the planner enumerates the candidate blocks
    (:func:`matmul_candidates`, :func:`attention_candidates`), scores them
    with Eq. 1 on ``acc`` (default: the calibrated pack of ``device``, the
    card unless ``device="cpu"``) and records the chosen blocks, the
    predicted seconds, the local memory and the verifier's findings.

    ``chips`` divides the batch/token dimensions so the plan prices one
    chip's slice of the cell.
    """
    if acc is None:
        acc = default_machine(device=device)

    def pick(build, candidates):
        # closed-form scoring: production-shaped grids make the exact fetch
        # enumeration cost seconds per candidate for no ranking benefit
        best, _ = planlib.autotune(build, candidates, acc, exact=False)
        if health is not None:
            health.ingest_diagnostics(best.diagnostics)
        return {
            **best.params,
            "predicted_seconds": best.predicted_seconds,
            "vmem_bytes": best.plan.vmem_bytes,
            "bandwidth_heavy": best.plan.bandwidth_heavy(acc, exact=False),
            "diagnostics": [d.format() for d in best.diagnostics],
        }

    report: dict[str, Any] = {}
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    tokens = max(1, -(-tokens // chips))           # per-chip slice (batch DP)
    batch = max(1, -(-shape.global_batch // chips))
    d_ff = cfg.d_ff or cfg.moe_d_ff or 4 * cfg.d_model

    def build_mm(block_m, block_n, block_k):
        # matmul_plan rounds ragged dims up to block multiples itself
        return matmul_plan(
            tokens, cfg.d_model, d_ff,
            block_m=block_m, block_n=block_n, block_k=block_k,
            dtype=torch.bfloat16,
        )

    report["ffn_matmul"] = pick(build_mm, matmul_candidates(tokens, cfg.d_model, d_ff))

    sq = 1 if shape.kind == "decode" else shape.seq_len
    skv = shape.seq_len
    d_head = cfg.head_dim_

    def build_attn(block_q, block_kv):
        return attention_plan(
            batch, cfg.num_heads, max(cfg.num_kv_heads, 1),
            _round_up(sq, block_q), _round_up(skv, block_kv), d_head,
            block_q=block_q, block_kv=block_kv,
            causal=True, q_offset=skv - sq, dtype=torch.bfloat16,
        )

    report["attention"] = pick(build_attn, attention_candidates(sq, skv))
    return report


def plan_record(arch: str, shape_name: str, acc: BSPAccelerator | None = None, *,
                device: Any = None) -> dict[str, Any]:
    """The dry-run record of one cell: the JAX package's keys where the
    port has the quantity (``stream_plans``, ``plan_diagnostics``,
    ``health``, ``calibstore``), the pack's name, and the cell's useful
    FLOPs with the recurrent bodies' analytic FLOPs."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if acc is None:
        acc = default_machine(device=device)
    health = HealthMonitor(name=f"dryrun_{arch}_{shape_name}")
    plans = stream_plan_report(cfg, shape, acc, chips=1, health=health)
    total, active = cfg.param_counts()
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    return {
        "arch": arch, "shape": shape_name, "chips": 1, "kind": shape.kind,
        "machine": acc.name,
        "stream_plans": plans,
        "plan_diagnostics": sorted(
            {line for hs in plans.values() for line in hs.get("diagnostics", ())}),
        "health": health.rollup(),
        "calibstore": get_default_store().summary(),
        "model_flops": rf.model_flops(params=total, active_params=active, tokens=tokens,
                                      training=shape.kind == "train"),
        "analytic_extra_flops": analytic_extra_flops(cfg, shape),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="price a cell's hot-spot StreamPlans")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--device", default=None,
                    help="the pack's device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    rec = plan_record(args.arch, args.shape, device=args.device)
    mm, attn = rec["stream_plans"]["ffn_matmul"], rec["stream_plans"]["attention"]
    print(f"[dryrun] {args.arch} {args.shape} on {rec['machine']}: ffn_matmul blocks "
          f"{mm['block_m']}x{mm['block_n']}x{mm['block_k']} predicted "
          f"{mm['predicted_seconds']:.6g} s; attention blocks {attn['block_q']}x"
          f"{attn['block_kv']} predicted {attn['predicted_seconds']:.6g} s; "
          f"{len(rec['plan_diagnostics'])} diagnostic(s); model_flops "
          f"{rec['model_flops']:.6g}", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

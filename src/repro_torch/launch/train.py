"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

Runs the end-to-end training loop (data stream → train step per hyperstep →
checkpoint/restart, :func:`repro_torch.train.loop.train`) on the card, or on
the CPU with ``--device cpu``. ``--smoke`` selects the reduced same-family
config. minicpm-2b trains on its WSD schedule, every other arch on linear
warmup + cosine; batches come from the seeded synthetic source.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import linear_warmup_cosine, wsd
from repro_torch.train.loop import TrainConfig, train


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    # minicpm's distinctive recipe is WSD; everything else gets cosine
    sched = (wsd(args.lr, warmup=10, total=args.steps)
             if args.arch == "minicpm-2b"
             else linear_warmup_cosine(args.lr, warmup=10, total=args.steps))
    opt = AdamW(schedule=sched)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.seed)
    out = train(cfg, tcfg, opt, data_cfg=data, device=device)
    final = out["history"][-1]
    row = out["plan_row"] or {}
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"[done] arch={args.arch} steps={args.steps} "
          f"final_loss={final['loss']:.4f} devices={devices} "
          f"stragglers={len(out['stragglers'])}")
    if row:
        print(f"[predicted_vs_measured] pred={row['predicted_seconds']:.4g}s "
              f"meas={row['measured_seconds']:.4g}s "
              f"ratio={row['pred_over_meas']:.3g} "
              f"bw_heavy pred={row['bandwidth_heavy_predicted']:.0f} "
              f"meas={row['bandwidth_heavy_measured']:.0f}")


if __name__ == "__main__":
    main()

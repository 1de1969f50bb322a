"""End-to-end training driver: data pipeline → hypersteps → checkpoints.

The full production path (stream-backed data with prefetch, the train step,
checkpointing, straggler monitor, auto-resume) on a language model. Defaults
to a ~10M-param model that trains a few hundred steps in minutes;
``--params 100m`` selects the ~100M-param configuration (same code path,
more FLOPs).

Run: python -m repro_torch.examples.train_lm --steps 300 [--device cpu]
Kill it mid-run and re-run with the same --ckpt-dir: it resumes exactly.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any

import numpy as np

from repro_torch.configs.base import Block, ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import count_params
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.loop import TrainConfig, train

__all__ = ["SIZES", "make_config", "main"]

SIZES = {
    # name: (layers, d_model, heads, d_ff, vocab) — params incl. embeddings
    "10m": (4, 256, 4, 1024, 8192),      # ≈ 7.5M
    "100m": (12, 768, 12, 3072, 32768),  # ≈ 135M (GPT-2-small-ish)
}


def make_config(size: str) -> ModelConfig:
    n_l, d, h, ff, v = SIZES[size]
    return ModelConfig(
        name=f"train-lm-{size}", family="dense", num_layers=n_l, d_model=d,
        num_heads=h, num_kv_heads=h, d_ff=ff, vocab_size=v,
        pattern=(Block("attn", "dense"),), rope_theta=1e4,
        dtype="float32", scan_layers=False, remat="none",
    )


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--params", choices=list(SIZES), default="10m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    cfg = make_config(args.params)
    print(f"[config] {cfg.name}: {count_params(cfg) / 1e6:.1f}M params")

    opt = AdamW(schedule=linear_warmup_cosine(args.lr, warmup=20, total=args.steps))
    out = train(
        cfg,
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=max(args.steps // 4, 25), log_every=20),
        opt,
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                            global_batch=args.batch),
        device=args.device,
    )
    hist = out["history"]
    print(f"[done] steps={len(hist)} "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} | "
          f"median step {np.median([h['step_seconds'] for h in hist]) * 1e3:.0f}ms | "
          f"stragglers {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()

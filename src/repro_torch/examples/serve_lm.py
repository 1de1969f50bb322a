"""Batched serving example: continuous decode over a request batch.

Uses the serve path of the framework (KV/state caches, the decode step as a
hyperstep) for one of the assigned architectures. Each decode step is a
hyperstep: resident cache state + one streamed token per request.

Run: python -m repro_torch.examples.serve_lm --arch jamba-v0.1-52b [--device cpu]
(smoke-sized configs of the hybrid/ssm archs show cache types beyond KV).
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prefill
from repro_torch.models import model as M
from repro_torch.train.steps import make_serve_step

__all__ = ["serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params: Any, prompt: torch.Tensor, gen: int, temperature: float,
          device: torch.device, seed: int = 1) -> dict[str, Any]:
    """Prefill ``prompt`` (B, S) token by token, then decode ``gen`` tokens,
    each sampled from softmax(logits / temperature) with a generator seeded
    ``seed``. Returns the prefill's last logits, the sampled tokens (B,
    gen), the prefill seconds, each decode step's seconds and the cache
    length."""
    batch, prompt_len = prompt.shape
    cache = M.init_cache(cfg, batch, prompt_len + gen, device=device)
    serve_step = make_serve_step(cfg, device=device)
    rng = torch.Generator(device=device).manual_seed(seed)

    # prefill: the whole prompt, one decode step a token
    t0 = time.perf_counter()
    logits, cache = make_prefill(cfg, device=device)(params, cache, prompt.to(torch.int32))
    _sync(device)
    prefill_s = time.perf_counter() - t0
    first = logits[:, -1].float()

    times, tokens = [], []
    for _ in range(gen):
        probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=rng)
        tokens.append(tok)
        t0 = time.perf_counter()
        logits, cache = serve_step(params, cache, {"tokens": tok.to(torch.int32)})
        _sync(device)
        times.append(time.perf_counter() - t0)
    return {"prefill_logits": first, "tokens": torch.cat(tokens, dim=1),
            "prefill_s": prefill_s, "times": times, "cache_len": int(cache["len"])}


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="jamba-v0.1-52b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = M.init_params(cfg, 0, device=device)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen)
    out = serve(cfg, params, prompt.to(device), args.gen, args.temperature, device)

    p50, p99 = np.percentile(out["times"], [50, 99])
    print(f"[serve] {args.arch} (smoke) batch={args.batch}: "
          f"prefill {out['prefill_s'] * 1e3:.0f}ms for {args.prompt_len} tokens | "
          f"decode p50 {p50 * 1e3:.1f}ms p99 {p99 * 1e3:.1f}ms | "
          f"{args.batch / p50:.0f} tok/s | cache len {out['cache_len']}")
    return out


if __name__ == "__main__":
    main()

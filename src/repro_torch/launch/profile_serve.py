"""Where a decode step's time goes: torch.profiler over the serve path.

``python -m repro_torch.launch.profile_serve [--arch minicpm-2b] [--steps 4]``

Serves ``--arch`` at full width on the CUDA card (random weights from a seed;
at the depth one card holds, ``configs.card_config``),
prefills a ``--batch`` × ``--prompt-len`` prompt at the autotuned block,
then profiles ``--steps`` greedy decode steps and one full-sequence forward
(``make_prefill_step`` over the prompt). For each it prints the host wall
time, the device's busy share of it, and the operators and kernels that take
the most host and device time. Run it on the card; it refuses to run
without one.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import card_config
from repro_torch.launch.serve import compiled_serve_fns, make_prefill, prefill_block_size
from repro_torch.models import model as M
from repro_torch.train.steps import make_prefill_step


def _report(name: str, prof, wall: float, calls: int, rows: int) -> None:
    events = prof.key_averages()
    # the device's own events (kernels, copies), as the table's "Self CUDA
    # time total" counts them: an operator's row repeats its kernels' time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    print(f"[profile] {name}: host wall {wall / calls * 1e3:.2f} ms per call, device busy "
          f"{device_us / calls / 1e3:.2f} ms per call "
          f"({device_us / 1e6 / wall:.1%} of wall, under the profiler)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=rows))
    print(events.table(sort_by="self_device_time_total", row_limit=rows))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    cfg = card_config(args.arch)
    params = M.init_params(cfg, 0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1)).to("cuda")
    cache = M.init_cache(cfg, args.batch, args.prompt_len + 2 * args.steps + 2, device="cuda")
    block = prefill_block_size(cfg, args.batch, args.prompt_len, device="cuda")
    logits, cache = make_prefill(cfg, block, device="cuda")(params, cache, prompt)
    _, decode_fn = compiled_serve_fns(cfg, 0.0, device="cuda")
    gen = torch.Generator(device="cuda")
    _, logits, cache, gen = decode_fn(params, logits, cache, gen)    # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, logits, cache, gen = decode_fn(params, logits, cache, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"{args.arch} ({cfg.num_layers} layers) batch {args.batch}, {args.steps} "
            "decode steps", prof, wall, args.steps, args.rows)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        _, logits, cache, gen = decode_fn(params, logits, cache, gen)
    torch.cuda.synchronize()
    print(f"[profile] without the profiler: "
          f"{(time.perf_counter() - t0) / args.steps * 1e3:.2f} ms/step")

    step = make_prefill_step(cfg, device="cuda")
    step(params, {"tokens": prompt})                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    print(f"[profile] forward without the profiler: "
          f"{(time.perf_counter() - t0) / args.steps * 1e3:.2f} ms/call")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, {"tokens": prompt})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"{args.arch} ({cfg.num_layers} layers) forward over {args.batch} x "
            f"{args.prompt_len}", prof, wall, 1, args.rows)


if __name__ == "__main__":
    main()

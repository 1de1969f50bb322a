"""Where a decode step's or a train step's time goes: torch.profiler over
the serve path, or over the train step with ``--train`` (at the depth and
expert count one card trains, ``configs.card_train_config``, printed where
it cuts the published config).

``python -m repro_torch.launch.profile_serve [--arch minicpm-2b] [--steps 4] [--context N]``
``python -m repro_torch.launch.profile_serve --train [--arch A] [--batch 4 --prompt-len 256]``
``python -m repro_torch.launch.profile_serve --train-loop [--steps 8]``

Serves ``--arch`` at full width on the CUDA card (random weights from a seed;
at the depth one card holds, ``configs.card_config``),
prefills a ``--batch`` × ``--prompt-len`` prompt at the autotuned block,
then profiles ``--steps`` greedy decode steps and one full-sequence forward
(``make_prefill_step`` over the prompt); the decode's CUDA-event time and
its peak memory above the resident tensors are printed beside. With
``--context N`` the cache holds N positions and the decode steps run at its
end. With ``--train`` it instead takes ``--steps`` AdamW steps of
``make_train_step`` on one ``--batch`` × ``--prompt-len`` batch (after a
warm-up step), times the loss and its gradients apart from the optimizer
update (CUDA events), and profiles one step. With ``--train-loop`` it runs
the training loop (``train/loop.train``, synthetic batches of ``--batch``
× ``--prompt-len``) for ``--steps`` steps in turns — compiled, host loop,
host loop, compiled — and the bare step in a plain loop, printing each
run's step walls beside the card's SM clock, power draw and temperature
(``nvidia-smi``) before and after, and the host syncs one step makes
(``torch.cuda.set_sync_debug_mode``), then profiles three steps of each
mode (the init included).
For each profile it prints the host wall time, the device's busy share of
it, and the operators and kernels that take the most host and device time.
Run it on the card; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import card_config, card_train_config, get_config
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


def _device_ms(fn) -> tuple[float, object]:
    """``fn()``'s result and the CUDA-event ms from its first launch to its
    last (idle gaps included), after a synchronise."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def profile_train(cfg, args) -> None:
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.steps import make_grad_fn, make_train_step

    params = M.init_params(cfg, 0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len + 1),
                         generator=torch.Generator().manual_seed(1)).to("cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW(wsd(peak_lr=2e-3, warmup=4, total=100))
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cuda")
    params, state, _ = step(params, state, batch)                 # warm-up
    name = (f"{args.arch} ({cfg.num_layers} layers, remat {cfg.remat}) train step over "
            f"{args.batch} x {args.prompt_len}")
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        ms, (params, state, _) = _device_ms(lambda: step(params, state, batch))
        walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[profile] {name}: wall {walls[-1]:.1f} ms, CUDA events {ms:.1f} ms")

    grads_of = make_grad_fn(cfg, device="cuda")
    grad_ms, (g, _) = _device_ms(lambda: grads_of(params, batch))
    opt_ms, _ = _device_ms(lambda: opt.update(g, state, params))
    print(f"[profile] {name}: loss and gradients {grad_ms:.1f} ms, AdamW update "
          f"{opt_ms:.1f} ms (CUDA events, run apart)")
    del g
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(name, prof, wall, 1, args.rows)


def _card_state() -> str:
    """The card's SM clock, power draw and temperature, as nvidia-smi reads them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def profile_train_loop(cfg, args) -> None:
    from repro_torch.core.calibrate import default_machine
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.steps import make_train_step

    machine = default_machine(device="cuda")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.prompt_len,
                      global_batch=args.batch, seed=0)
    opt = lambda: AdamW(wsd(peak_lr=2e-3, warmup=8, total=100))
    name = f"{args.arch} ({cfg.num_layers} layers) train loop over {args.batch} x {args.prompt_len}"

    def run(compiled: bool, steps: int):
        return train(cfg, TrainConfig(steps=steps, log_every=10 ** 6, compiled=compiled), opt(),
                     data_cfg=data, machine=machine, calibstore=False, log=lambda s: None,
                     device="cuda")

    for compiled in (True, False, False, True):
        before = _card_state()
        t0 = time.perf_counter()
        out = run(compiled, args.steps)
        wall = time.perf_counter() - t0
        walls = [round(h["step_seconds"] * 1e3, 1) for h in out["history"]]
        print(f"[profile] {name}, {'compiled' if compiled else 'host loop'}: {wall:.2f} s "
              f"with init; step ms {walls}; card before [{before}] after [{_card_state()}]")
        del out
        torch.cuda.empty_cache()

    params = M.init_params(cfg, 0, device="cuda")
    o = opt()
    state = o.init(params)
    step = make_train_step(cfg, o, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len + 1)), dtype=torch.int32, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = _card_state()
    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 1))
    print(f"[profile] {name}, bare step: step ms {walls}; card before [{before}] after "
          f"[{_card_state()}]")
    # the host syncs one step makes (what keeps a compiled run from running
    # ahead of the card), as torch's sync debug mode reports them
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, state, m = step(params, state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = ["/".join(w.filename.rsplit("/", 2)[-2:]) + f":{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    print(f"[profile] {name}, bare step: {len(syncs)} host syncs under "
          f"set_sync_debug_mode, called from {sorted(set(syncs))}")
    del params, state, step, batch
    torch.cuda.empty_cache()

    for compiled in (True, False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run(compiled, 3)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(f"{name}, {'compiled' if compiled else 'host loop'}, 3 steps with init",
                prof, wall, 1, args.rows)
        del out
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--context", type=int, default=0,
                    help="cache positions: the decode steps run at the end of a cache this "
                         "long (default: the prompt and the steps)")
    ap.add_argument("--train", action="store_true",
                    help="profile make_train_step instead of the serve path")
    ap.add_argument("--train-loop", action="store_true",
                    help="time and profile the training loop in both modes and the bare step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    if args.train or args.train_loop:
        # the depth and expert count one card trains (configs.card_train_config)
        cfg, full = card_train_config(args.arch), get_config(args.arch)
        if (cfg.num_layers, cfg.moe_experts) != (full.num_layers, full.moe_experts):
            print(f"[profile] {args.arch} cut to train on one card: {cfg.num_layers} of "
                  f"{full.num_layers} layers, {cfg.moe_experts} of {full.moe_experts} experts "
                  f"(top-{cfg.moe_top_k}), published widths, {M.count_params(cfg) / 1e9:.3f} B "
                  f"parameters")
    else:
        cfg = card_config(args.arch)
    if args.train_loop:
        profile_train_loop(cfg, args)
        return
    if args.train:
        profile_train(cfg, args)
        return
    params = M.init_params(cfg, 0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1)).to("cuda")
    max_len = max(args.context, args.prompt_len + 2 * args.steps + 2)
    cache = M.init_cache(cfg, args.batch, max_len, device="cuda")
    block = prefill_block_size(cfg, args.batch, args.prompt_len, device="cuda")
    logits, cache = make_prefill(cfg, block, device="cuda")(params, cache, prompt)
    if args.context:
        # decode at the end of the long cache: the positions past the prompt
        # hold zeros, and what the read costs does not depend on their values
        cache["len"] = max_len - 2 * args.steps - 2
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

    def decode_steps():
        nonlocal logits, cache, gen
        for _ in range(args.steps):
            _, logits, cache, gen = decode_fn(params, logits, cache, gen)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ms, _ = _device_ms(decode_steps)
    print(f"[profile] without the profiler: "
          f"{(time.perf_counter() - t0) / args.steps * 1e3:.2f} ms/step, CUDA events "
          f"{ms / args.steps:.3f} ms/step; cache of {max_len} positions, peak "
          f"{(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB above the "
          f"{resident / 2**30:.2f} GiB resident")

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

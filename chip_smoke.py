#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the shapes the serve path gives it
(and one ragged shape), times it beside the plain version and one library
call, runs the paper's §3.1 inner product through the hyperstep runner in
both execution modes, and serves minicpm-2b at full width and depth (random
weights from a seed) through ``generate`` and ``make_prefill_step``. Every
check that fails raises, and the script exits non-zero. It imports neither
JAX nor the JAX package.

Output, in order: progress lines; the card's name and power limit as
``nvidia-smi`` reports them; one JSON line with a row per kernel; and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 before
running anything.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.calibrate import default_machine  # noqa: E402
from repro_torch.core.hyperstep import HyperstepRunner  # noqa: E402
from repro_torch.core.plan import host_plan  # noqa: E402
from repro_torch.core.stream import StreamSet  # noqa: E402
from repro_torch.kernels import ops, pipeline, ref  # noqa: E402
from repro_torch.launch.serve import generate, make_prefill, prefill_block_size  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.steps import make_prefill_step  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# peak rate of their type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
L2_BYTES = 50 * 2**20
# the H100 SXM's boost clock (1.98 GHz): torch.cuda._sleep spins for clock
# cycles, at most this many per second
SPIN_CYCLES_PER_S = 1.98e9

KERNEL_META = {
    "streamed_dot": ("src/repro_torch/kernels/csrc/streamed_dot.cu",
                     "src/repro/kernels/streamed_dot.py:32"),
    "streamed_matmul": ("src/repro_torch/kernels/csrc/streamed_matmul.cu",
                        "src/repro/kernels/streamed_matmul.py:44"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:40"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_ms(fn, arg_sets, iters: int) -> tuple[float, float]:
    """Mean device ms per call of ``fn(*args)`` over ``iters`` calls, cycling
    through ``arg_sets`` (sized past the L2 cache, so every call reads its
    inputs from device memory), timed with CUDA events after a warm-up.

    A small kernel finishes before the host has enqueued the next one, so
    events around a plain loop time the host's enqueue rate. A spin kernel
    ahead of the start event holds the card for twice the loop's measured
    enqueue time: the whole loop is queued before the first timed launch
    runs, and the events see the launches back to back. Returns the
    device ms and the host's enqueue ms per call."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, enqueue_s * 1e3 / iters


def copies_past_l2(make, nbytes: int) -> list:
    """Independent input sets enough that cycling them overflows the L2 (at
    most 16: the inputs of the small ragged shapes stay in the L2)."""
    return [make(i) for i in range(min(16, max(2, -(-2 * L2_BYTES // nbytes))))]


def randn(shape, dtype, seed: int, scale: float = 1.0) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: each kernel against its plain version --------------------------------


def check_matmul(rows: dict) -> None:
    # bf16 output of fp32 sums taken in different orders: at most one bf16 ulp
    # apart (2^-7 relative), so the tolerance is two ulps of the largest output
    shapes = [(4, 2304, 5760), (4, 5760, 2304), (1024, 2304, 5760), (1024, 5760, 2304),
              (300, 200, 130)]
    for idx, (m, k, n) in enumerate(shapes):
        sets = copies_past_l2(
            lambda i, m=m, k=k, n=n: (randn((m, k), torch.bfloat16, 10 * i + 1),
                                      randn((k, n), torch.bfloat16, 10 * i + 2, k ** -0.5)),
            (m * k + k * n) * 2)
        a, b = sets[0]
        got, want = ops.matmul(a, b), ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        check(err <= tol, f"streamed_matmul {m}x{k}x{n}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda a, b: ops.matmul(a, b), sets, 50)
        plain, _ = bench_ms(lambda a, b: ref.matmul_ref(a, b), sets, 20)
        lib, _ = bench_ms(torch.matmul, sets, 50)
        b_ms, b_by = bound((m * k + k * n + m * n) * 2, 2.0 * m * n * k, "bf16")
        log(f"[kernel] streamed_matmul {m}x{k}x{n}: max_abs_err={err:.3g} (tol {tol:.3g}) "
            f"ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} torch.matmul_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if idx == 0:   # the decode up-projection: the launch the serve path repeats most
            rows["streamed_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                           bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def check_dot(rows: dict) -> None:
    # fp32 sums in another order: bounded by a small multiple of eps·Σ|v_i u_i|
    for idx, (n, c) in enumerate([(1 << 22, 8192), (5000, 512)]):
        sets = copies_past_l2(lambda i, n=n: (randn((n,), torch.float32, 10 * i + 3),
                                              randn((n,), torch.float32, 10 * i + 4)), 8 * n)
        v, u = sets[0]
        got, want = ops.dot(v, u, token_size=c), ref.dot_ref(v, u)
        torch.cuda.synchronize()
        err = (got - want).abs().item()
        tol = 1e-6 * (v * u).abs().sum().item()
        check(err <= tol, f"streamed_dot n={n}: err {err} > {tol}")
        ms, enqueue = bench_ms(lambda v, u: ops.dot(v, u, token_size=c), sets, 50)
        plain, _ = bench_ms(ref.dot_ref, sets, 50)
        lib, _ = bench_ms(torch.dot, sets, 50)
        b_ms, b_by = bound(8 * n + 4, 2.0 * n, "fp32")
        log(f"[kernel] streamed_dot n={n} token={c}: abs_err={err:.3g} (tol {tol:.3g}) "
            f"ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} torch.dot_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        if idx == 0:
            rows["streamed_dot"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                        bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def check_flash(rows: dict) -> None:
    # fp32 softmax on both sides from the same bf16 inputs, one bf16 rounding
    # of the output: two ulps of the largest output
    for idx, (b, hq, hkv, s, d) in enumerate([(4, 36, 36, 256, 64), (2, 8, 2, 100, 64)]):
        sets = copies_past_l2(
            lambda i, b=b, hq=hq, hkv=hkv, s=s, d=d: (
                randn((b, hq, s, d), torch.bfloat16, 10 * i + 5),
                randn((b, hkv, s, d), torch.bfloat16, 10 * i + 6),
                randn((b, hkv, s, d), torch.bfloat16, 10 * i + 7)),
            (b * hq * s * d + 2 * b * hkv * s * d) * 2)
        q, k, v = sets[0]
        got, want = ops.attention(q, k, v), ref.attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        check(err <= tol, f"flash_attention {b}x{hq}/{hkv}x{s}x{d}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda q, k, v: ops.attention(q, k, v), sets, 50)
        plain, _ = bench_ms(lambda q, k, v: ref.attention_ref(q, k, v), sets, 20)
        lib = None
        if hq == hkv:
            lib, _ = bench_ms(
                lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True), sets, 50)
        pairs = s * (s + 1) // 2          # the (query, key) pairs causal masking keeps
        b_ms, b_by = bound((2 * b * hq * s * d + 2 * b * hkv * s * d) * 2,
                           4.0 * b * hq * d * pairs, "bf16")
        log(f"[kernel] flash_attention b{b} h{hq}/{hkv} s{s} d{d}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
            f"sdpa_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        if idx == 0:
            rows["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                           bound_ms=b_ms, bound_by=b_by, library_ms=lib)


# -- phase 3: the §3.1 inner product through the hyperstep runner --------------------


def inner_product(machine) -> None:
    n, c = 1 << 26, 1 << 22                  # 64 Mi floats per vector, 16 tokens
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n, dtype=np.float32)
    u = rng.standard_normal(n, dtype=np.float32)
    want = float(np.dot(v.astype(np.float64), u.astype(np.float64)))
    tol = 1e-6 * float(np.abs(v.astype(np.float64) * u).sum())
    for compiled in (False, True):
        ss = StreamSet()
        sv, su = ss.create(v, c, name="v"), ss.create(u, c, name="u")
        runner = HyperstepRunner(
            lambda acc, t: acc + ops.dot(t[0], t[1]), [sv, su],
            plan=host_plan([sv, su], flops_per_hyperstep=2.0 * c, name="inner_product"),
            machine=machine)
        got = float(runner.run(torch.zeros((), device="cuda"), compiled=compiled))
        row = runner.predicted_vs_measured()
        check(abs(got - want) <= tol, f"inner product ({'compiled' if compiled else 'measure'}"
              f" mode) {got} vs {want}")
        check(row["fetch_words_planned"] == row["fetch_words_measured"],
              f"inner product words {row}")
        log(f"[inner_product] mode={'compiled' if compiled else 'measure'} n={n} C={c} "
            f"alpha={got:.6g} ref={want:.6g} row={json.dumps(row)}")


# -- phase 4: the slice ------------------------------------------------------------------


def reference_check() -> None:
    """A 2-layer cut of minicpm-2b at full width on the card (bf16, kernels)
    against the same weights in float32 on the CPU (plain versions)."""
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    params = M.init_params(cfg, 0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(2))
    got = M.forward(cfg, params, toks.cuda(), device="cuda").float().cpu()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu = {"embed": {k: t.float().cpu() for k, t in params["embed"].items()},
           "final_norm": {k: t.float().cpu() for k, t in params["final_norm"].items()},
           "stack": [[{g: {k: t.float().cpu() for k, t in blk[g].items()} for g in blk}
                      for blk in per] for per in params["stack"]]}
    want = M.forward(cfg32, cpu, toks, device="cpu")
    err = (got - want).abs().max().item()
    # bf16 activations against fp32: ~2^-8 relative per rounding over two
    # layers, bounded here at 5% of the largest logit
    tol = 0.05 * want.abs().max().item()
    check(bool(torch.isfinite(got).all()), "non-finite logits on the card")
    check(err <= tol, f"2-layer forward on the card vs fp32 CPU: {err} > {tol}")
    log(f"[reference] minicpm-2b 2 layers, card bf16 vs cpu fp32 logits: max_abs_err={err:.4g}"
        f" (tol {tol:.4g})")


def serve_slice(machine) -> dict:
    cfg = get_config("minicpm-2b")
    batch, prompt_len, steps = 4, 256, 32
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = M.count_params(cfg)
    log(f"[slice] minicpm-2b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params bf16, init {time.perf_counter() - t0:.1f}s")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1)).to("cuda")

    counts = {}

    def delta(before):
        now = ops.launch_counts()
        return {k: now[k] - before[k] for k in now}

    before = ops.launch_counts()
    toks, stats = generate(cfg, params, prompt, steps=steps, machine=machine, device="cuda")
    counts["generate_compiled_first"] = delta(before)
    before = ops.launch_counts()
    toks2, stats = generate(cfg, params, prompt, steps=steps, machine=machine, device="cuda")
    counts["generate_compiled"] = delta(before)
    check(torch.equal(toks, toks2), "two greedy generate calls disagree")
    check(tuple(toks.shape) == (batch, prompt_len + steps), f"tokens shape {tuple(toks.shape)}")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size, "token ids out of range")
    tok_s = steps * batch / stats.decode_total_seconds
    log(f"[slice] generate compiled: prefill_ms={stats.prefill_seconds * 1e3:.2f} "
        f"decode_tok_s={tok_s:.1f} ({steps} tokens x batch {batch} in "
        f"{stats.decode_total_seconds * 1e3:.1f} ms) "
        f"predicted_vs_measured={json.dumps(stats.plan_row)}")

    before = ops.launch_counts()
    toks3, stats_m = generate(cfg, params, prompt, steps=steps, machine=machine,
                              device="cuda", compiled=False)
    counts["generate_measure"] = delta(before)
    check(torch.equal(toks, toks3), "measure-mode generate disagrees with compiled mode")
    tok_s_m = steps * batch / stats_m.decode_total_seconds
    p50 = float(np.median(stats_m.decode_seconds)) * 1e3
    log(f"[slice] generate measure: prefill_ms={stats_m.prefill_seconds * 1e3:.2f} "
        f"decode_tok_s={tok_s_m:.1f} step_p50_ms={p50:.2f} "
        f"predicted_vs_measured={json.dumps(stats_m.plan_row)}")

    block = prefill_block_size(cfg, batch, prompt_len, machine)
    cache = M.init_cache(cfg, batch, prompt_len, device="cuda")
    pre_logits, _ = make_prefill(cfg, block, device="cuda")(params, cache, prompt)
    before = ops.launch_counts()
    step = make_prefill_step(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd_logits = step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    counts["prefill_step"] = delta(before)
    check(tuple(fwd_logits.shape) == (batch, prompt_len, cfg.padded_vocab),
          f"forward logits shape {tuple(fwd_logits.shape)}")
    check(bool(torch.isfinite(fwd_logits).all()), "non-finite forward logits")
    last = fwd_logits[:, -1].float()
    err = (last - pre_logits[:, -1].float()).abs().max().item()
    # the two paths differ only in attention (flash kernel vs dense cache
    # read), each output rounded to bf16 (2^-8 relative); over 40 layers such
    # one-ulp differences grow to a few percent of the activations — bounded
    # here at 5% of the largest logit
    tol = 0.05 * last.abs().max().item()
    check(err <= tol, f"forward vs chunked-prefill last logits: {err} > {tol}")
    agree = float((last.argmax(-1) == pre_logits[:, -1].float().argmax(-1)).float().mean())
    log(f"[slice] make_prefill_step: ms={fwd_ms:.2f} (prefill block {block}); last-position "
        f"logits vs generate's prefill: max_abs_diff={err:.4g} (tol {tol:.4g}), "
        f"argmax agreement {agree:.2f}")
    log(f"[slice] launches per call: {json.dumps(counts)}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = pipeline.build_library()
    pipeline.library()
    log(f"[build] {lib} in {time.perf_counter() - t0:.1f}s")
    for src in pipeline.SOURCES:
        for line in (lib.parent / (src + ".log")).read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"[ptxas] {src}: {line.strip()}")

    rows: dict[str, dict] = {}
    check_matmul(rows)
    check_dot(rows)
    check_flash(rows)

    machine = default_machine(device="cuda")
    log(f"[machine] {machine}")
    reference_check()

    # the main path: every launch count starts at 0 here and is read at the end
    ops.reset_launch_counts()
    inner_product(machine)
    serve_slice(machine)
    launches = ops.launch_counts()
    log(f"[main path] launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name], **rows[name]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

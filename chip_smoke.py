#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the shapes the serve paths give it
(and ragged shapes), times it beside the plain version and one library call
where there is one, and checks 2-layer full-width cuts of minicpm-2b and
jamba-v0.1-52b on the card against float32 on the CPU. Then it drives the
two main paths, each with the launch counts set to 0 before it and read
after: the paper's §3.1 inner product through the hyperstep runner in both
execution modes plus minicpm-2b served at full width and depth, and
jamba-v0.1-52b served at full width with its depth cut to one period of 8
layers (random weights from a seed), each through ``generate`` and
``make_prefill_step``. The matmul's launches are also counted per variant:
every product of the forward and of a multi-row prefill must take the
wgmma variant, every decode product the m ≤ 16 one. On minicpm-2b's weights
the continuous-batching ``ServeEngine`` then serves 16 requests over 8
lanes (the ``engine`` phase): every request drained, the decode variant
launched per segment and the wgmma variant by the joins' prefills, no host
sync inside a steady-state segment, each lane's logits at every segment
boundary close to batch-1 ``generate``'s on the same tokens and every
greedy token one that such logits can pick, and a run with an injected dispatch
failure and page exhaustion giving a clean run's tokens. Every check that
fails raises, and the script exits non-zero. Each phase prints its wall
time. It imports neither JAX nor the JAX package.

Output, in order: progress lines; the card's name and power limit as
``nvidia-smi`` reports them; one JSON line with a row per kernel; and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 before
running anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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

from repro_torch.configs import Block, card_config, get_config  # noqa: E402
from repro_torch.core.calibrate import default_machine  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core.hyperstep import HyperstepRunner  # noqa: E402
from repro_torch.core.plan import host_plan  # noqa: E402
from repro_torch.core.stream import StreamSet  # noqa: E402
from repro_torch.kernels import ops, pipeline, ref  # noqa: E402
from repro_torch.kernels.ssm_scan import LANE_CHOICES, lanes_for, ssm_scan  # noqa: E402
from repro_torch.kernels.streamed_matmul import decode_split  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
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
# A packed lane (m = 8 rows in every product of a decode step) and the same
# request served alone (m = 1) round differently: the plain products (the
# attention projections, the tied LM head) take other library algorithms at
# another m, and each bf16 rounding that differs grows over 40 layers. The
# engine phase feeds the engine's own tokens to a batch-1 decode and holds
# the lane's logits, read at every segment boundary, within NEAR_TIE / 2 of
# the batch-1 logits at the same position (relative to the largest |logit|).
# Logits that close can only pick a token whose batch-1 logit is within
# NEAR_TIE of the top one, so every engine token must be: where the batch-1
# top-2 margin is wider, the token must be batch-1's. The first token comes
# from the batch-1 prefill in both runs and must be equal.
NEAR_TIE = 2.0 ** -4

KERNEL_META = {
    "streamed_dot": ("src/repro_torch/kernels/csrc/streamed_dot.cu",
                     "src/repro/kernels/streamed_dot.py:32"),
    "streamed_matmul": ("src/repro_torch/kernels/csrc/streamed_matmul.cu",
                        "src/repro/kernels/streamed_matmul.py:44"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:40"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:35"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Log the wall time of a phase, so that a later slice can budget."""
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")


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


def matmul_variant(fn) -> tuple[object, str]:
    """``fn()``'s result and the matmul variant its one launch took."""
    before = ops.matmul_variant_counts()
    out = fn()
    taken = [v for v, c in ops.matmul_variant_counts().items() if c != before[v]]
    check(len(taken) == 1, f"one matmul launch expected, variants {taken}")
    return out, taken[0]


def check_matmul(rows: dict) -> None:
    # bf16 output of fp32 sums taken in different orders: at most one bf16 ulp
    # apart (2^-7 relative), so the tolerance is two ulps of the largest output
    shapes = [(4, 2304, 5760), (4, 5760, 2304), (1024, 2304, 5760), (1024, 5760, 2304),
              (300, 200, 130),
              # the decode variant at one and at sixteen rows
              (1, 2304, 5760), (16, 2304, 5760), (1, 4096, 14336), (16, 4096, 14336),
              # the engine's packed step (8 lanes) and its joins' one-chunk
              # prefills (17-256 rows: one partial and one full 128-row tile)
              (8, 2304, 5760), (8, 5760, 2304), (100, 2304, 5760), (256, 5760, 2304),
              # jamba's dense MLPs and its untied LM head: decode and forward
              (4, 4096, 14336), (4, 14336, 4096), (1024, 4096, 14336), (1024, 14336, 4096),
              (4, 4096, 65536), (1024, 4096, 65536),
              # the wgmma variant at ragged m, n and k edges
              (1000, 2304, 5768), (1024, 4096, 65544)]
    for idx, (m, k, n) in enumerate(shapes):
        sets = copies_past_l2(
            lambda i, m=m, k=k, n=n: (randn((m, k), torch.bfloat16, 10 * i + 1),
                                      randn((k, n), torch.bfloat16, 10 * i + 2, k ** -0.5)),
            (m * k + k * n) * 2)
        a, b = sets[0]
        got, variant = matmul_variant(lambda: ops.matmul(a, b))
        want = ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        expect = "decode" if m <= 16 else ("wmma" if n % 8 or k % 8 else "wgmma")
        check(variant == expect, f"streamed_matmul {m}x{k}x{n} took {variant}, not {expect}")
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        check(err <= tol, f"streamed_matmul {m}x{k}x{n}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda a, b: ops.matmul(a, b), sets, 50)
        plain, _ = bench_ms(lambda a, b: ref.matmul_ref(a, b), sets, 20)
        lib, _ = bench_ms(torch.matmul, sets, 50)
        nbytes, flops = (m * k + k * n + m * n) * 2, 2.0 * m * n * k
        b_ms, b_by = bound(nbytes, flops, "bf16")
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if b_by == "operations"
                else f"{nbytes / ms / 1e9:.3f} TB/s")
        log(f"[kernel] streamed_matmul {m}x{k}x{n} variant={variant}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} ({rate}) enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
            f"torch.matmul_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})")
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
    # minicpm-2b's forward, a ragged GQA shape, jamba's forward (GQA 32/8), and
    # at head dim 128 ragged queries at the end of the keys and one decode row
    cases = [(4, 36, 36, 256, 256, 64), (2, 8, 2, 100, 100, 64), (4, 32, 8, 256, 256, 128),
             (2, 32, 8, 100, 300, 128), (4, 32, 8, 1, 300, 128)]
    for idx, (b, hq, hkv, sq, skv, d) in enumerate(cases):
        sets = copies_past_l2(
            lambda i, b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d: (
                randn((b, hq, sq, d), torch.bfloat16, 10 * i + 5),
                randn((b, hkv, skv, d), torch.bfloat16, 10 * i + 6),
                randn((b, hkv, skv, d), torch.bfloat16, 10 * i + 7)),
            (b * hq * sq * d + 2 * b * hkv * skv * d) * 2)
        q, k, v = sets[0]
        got, want = ops.attention(q, k, v), ref.attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        shape = f"b{b} h{hq}/{hkv} sq{sq} skv{skv} d{d}"
        check(err <= tol, f"flash_attention {shape}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda q, k, v: ops.attention(q, k, v), sets, 50)
        plain, _ = bench_ms(lambda q, k, v: ref.attention_ref(q, k, v), sets, 20)
        # SDPA's is_causal aligns the queries with the first keys; the port's
        # sit at the end (q_offset = skv - sq), so a ragged case passes a mask
        mask = (None if sq == skv else torch.ones(sq, skv, dtype=torch.bool, device="cuda")
                .tril(skv - sq))
        lib, _ = bench_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=hq != hkv), sets, 50)
        # the (query, key) pairs causal masking keeps
        pairs = sum(min(skv, skv - sq + i + 1) for i in range(sq))
        b_ms, b_by = bound((2 * b * hq * sq * d + 2 * b * hkv * skv * d) * 2,
                           4.0 * b * hq * d * pairs, "bf16")
        log(f"[kernel] flash_attention {shape}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
            f"sdpa_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})")
        if idx == 0:
            rows["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                           bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def _ssm_inputs(b, seq, di, ds, dtype, seed):
    """x, Δ, B, C in ``dtype``; A = -(1..d_state) per channel (jamba's init)
    and D in fp32. Δ ~ 0.05·|N(0,1)|, about what softplus(-4.6 + ...) gives."""
    return (randn((b, seq, di), dtype, seed), randn((b, seq, di), torch.float32, seed + 1,
                                                    0.05).abs().to(dtype),
            randn((b, seq, ds), dtype, seed + 2), randn((b, seq, ds), dtype, seed + 3),
            -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds)
            .contiguous(), randn((di,), torch.float32, seed + 4))


def check_ssm(rows: dict) -> None:
    # bf16 streams: the same fp32 scan from the same bf16 inputs, one bf16
    # rounding of the output on each side: two bf16 ulps (2·2^-8) of the
    # largest output. fp32: sums in another order and an fma over the
    # sequence, bounded at 1e-4 of the largest output.
    cases = [(4, 256, 8192, 16, torch.bfloat16, 3),      # jamba's forward
             (1, 4000, 8192, 16, torch.bfloat16, 2),     # long, ragged last chunk
             (4, 256, 8192, 16, torch.float32, 3),
             (2, 300, 1000, 8, torch.float32, 3)]        # ragged d_inner, d_state 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (b, seq, di, ds, dtype, plain_iters) in enumerate(cases):
        item = torch.tensor([], dtype=dtype).element_size()
        nbytes = (3 * b * seq * di + 2 * b * seq * ds) * item + (di * ds + di) * 4
        sets = copies_past_l2(lambda i, b=b, seq=seq, di=di, ds=ds, dtype=dtype:
                              _ssm_inputs(b, seq, di, ds, dtype, 10 * i + 20), nbytes)
        got, want = ops.selective_scan(*sets[0]), ref.ssm_scan_ref(*sets[0])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = (2 * 2 ** -8 if dtype == torch.bfloat16 else 1e-4) * want.float().abs().max().item()
        check(bool(torch.isfinite(got).all()), f"ssm_scan b{b} L{seq}: non-finite output")
        check(err <= tol, f"ssm_scan b{b} L{seq} di{di} ds{ds} {dtype}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda *a: ops.selective_scan(*a), sets, 50)
        plain, _ = bench_ms(ref.ssm_scan_ref, sets, plain_iters)
        b_ms, b_by = bound(nbytes, 10.0 * b * seq * di * ds, "fp32")
        # the exponentials alone, at the special-function unit's 16 a clock per SM
        exp_floor = b * seq * di * ds / (16 * sms * SPIN_CYCLES_PER_S) * 1e3
        log(f"[kernel] ssm_scan b{b} L{seq} di{di} ds{ds} {str(dtype)[6:]} "
            f"lanes={lanes_for(b, di, ds, sms)}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
            f"library=none bound_ms={b_ms:.4f} ({b_by}) exp_floor_ms={exp_floor:.4f}")
        if idx < 2:
            # the lanes-per-channel trade-off at the forward shape and at B 1:
            # each halving of the states per lane doubles the warps and adds
            # a shuffle round per position
            rule = lanes_for(b, di, ds, sms)
            for lanes in LANE_CHOICES:
                if lanes == rule:
                    continue
                other = ssm_scan(*sets[0], lanes=lanes)
                torch.cuda.synchronize()
                lerr = (other.float() - want.float()).abs().max().item()
                # every grouping sums in one order: the same bits
                check(torch.equal(other, got), f"ssm_scan lanes={lanes} differs from {rule}")
                lms, _ = bench_ms(lambda *a, n=lanes: ssm_scan(*a, lanes=n), sets, 50)
                log(f"[kernel] ssm_scan b{b} L{seq} di{di} ds{ds} lanes={lanes} (rule's "
                    f"{rule}): max_abs_err={lerr:.3g} ms={lms:.4f}")
        if idx == 0:
            rows["ssm_scan"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
    # the state resets per batch row: a row alone gives the bits it gives in the batch
    x, dt, bb, c, a, d = _ssm_inputs(3, 500, 8192, 16, torch.bfloat16, 90)
    full = ops.selective_scan(x, dt, bb, c, a, d)
    row = ops.selective_scan(*(t[1:2].contiguous() for t in (x, dt, bb, c)), a, d)
    check(torch.equal(full[1:2], row), "ssm_scan batch rows leak state")
    log("[kernel] ssm_scan batch-row isolation: row 1 alone equals row 1 in the batch")


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


def _cpu_fp32(tree):
    if isinstance(tree, dict):
        return {k: _cpu_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_fp32(v) for v in tree]
    return tree.float().cpu()


def reference_check(name: str, **cut) -> None:
    """A 2-layer cut of ``name`` at full width on the card (bf16, kernels)
    against the same weights in float32 on the CPU (plain versions)."""
    cfg = dataclasses.replace(get_config(name), num_layers=2, **cut)
    params = M.init_params(cfg, 0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(2))
    got = M.forward(cfg, params, toks.cuda(), device="cuda").float().cpu()
    cpu = _cpu_fp32(params)
    del params
    torch.cuda.empty_cache()
    want = M.forward(dataclasses.replace(cfg, dtype="float32"), cpu, toks, device="cpu")
    err = (got - want).abs().max().item()
    # bf16 activations against fp32: ~2^-8 relative per rounding over two
    # layers, bounded here at 5% of the largest logit
    tol = 0.05 * want.abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits on the card")
    check(err <= tol, f"{name}: 2-layer forward on the card vs fp32 CPU: {err} > {tol}")
    log(f"[reference] {name} 2 layers {[(b.mixer, b.mlp) for b in cfg.pattern]}, "
        f"{M.count_params(cfg) / 1e9:.3f} B params, card bf16 vs cpu fp32 logits: "
        f"max_abs_err={err:.4g} (tol {tol:.4g})")


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
        now = counts_now()
        return {k: now[k] - before[k] for k in now}

    before = counts_now()
    toks, stats = generate(cfg, params, prompt, steps=steps, machine=machine, device="cuda")
    counts["generate_compiled_first"] = delta(before)
    before = counts_now()
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

    before = counts_now()
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
    before = counts_now()
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
    # every MLP product of the forward and of generate's prefill (m = batch ·
    # block rows) took the wgmma variant, every decode product the m ≤ 16 one
    mlp = 3 * cfg.num_layers
    check(counts["prefill_step"]["streamed_matmul.wgmma"] == mlp
          and counts["prefill_step"]["streamed_matmul"] == mlp,
          f"minicpm forward matmul variants {counts['prefill_step']}")
    chunks = -(-prompt_len // block)
    for key in ("generate_compiled_first", "generate_compiled", "generate_measure"):
        c = counts[key]
        check(c["streamed_matmul.wgmma"] == mlp * chunks and c["streamed_matmul.wmma"] == 0
              and c["streamed_matmul.decode"] == c["streamed_matmul"] - mlp * chunks > 0,
              f"minicpm {key}: matmul variants {c} (prefill in {chunks} chunk(s) of {block})")
    log(f"[slice] matmul variants: forward {mlp} wgmma; generate's prefill "
        f"{chunks} chunk(s) of m = {batch * block}: {mlp * chunks} wgmma; decode "
        f"{counts['generate_compiled']['streamed_matmul.decode']} m <= 16")
    # the decode variant is one device launch per product (no split-K sum)
    log(f"[slice] matmul device launches per decode step: "
        f"{counts['generate_compiled']['streamed_matmul.decode'] / steps:g}")
    with phase("engine"):
        serve_engine(cfg, params, machine)
    return counts


# -- the continuous-batching engine on minicpm-2b's weights -------------------------------


def batch1_logits(cfg, params, prompt: torch.Tensor, tokens: list[int], max_len: int,
                  machine) -> torch.Tensor:
    """The fp32 logits ``generate``'s batch-1 decode gives before each of
    ``tokens``, fed those tokens in turn (teacher-forced), on the same
    functions: (len(tokens), vocab)."""
    block = prefill_block_size(cfg, 1, prompt.shape[0], machine)
    cache = M.init_cache(cfg, 1, max_len, device="cuda")
    logits, cache = make_prefill(cfg, block, device="cuda")(params, cache, prompt[None])
    fed = torch.tensor(tokens, dtype=torch.int32, device="cuda")
    out = []
    for i in range(len(tokens)):
        out.append(logits[0, -1].float())
        logits, cache = M.decode_step(cfg, params, cache, fed[i].view(1, 1), device="cuda")
    return torch.stack(out)


def engine_requests(cfg, n: int, seed: int) -> list[tuple[np.ndarray, int]]:
    """``n`` greedy requests from ``seed``: prompts of 16–256 tokens, 32–64
    new tokens each."""
    rng = np.random.default_rng(seed)
    lens = np.linspace(16, 256, n).astype(int)
    rng.shuffle(lens)
    return [(rng.integers(0, cfg.vocab_size, int(s)).astype(np.int32),
             int(rng.integers(32, 65))) for s in lens]


def run_engine(cfg, params, machine, requests, guard=None, watch=(), **kw):
    """Serve ``requests`` through a fresh engine; returns (engine, rid ->
    tokens, rid -> boundary logits). ``guard(prog)`` may wrap the compiled
    segment program first. For each rid in ``watch``, every segment boundary
    at which the request still runs keeps (tokens generated so far, its lane's
    fp32 logits for the next token), a copy on the card."""
    eng = ServeEngine(cfg, params, max_lanes=8, pool_seq=512, segment_len=8,
                      page_tokens=16, machine=machine, device="cuda", **kw)
    if guard is not None:
        guard(eng._runner._compiled_cache[eng.segment_len])
    for prompt, new in requests:
        eng.submit(prompt, new)
    seen = {rid: [] for rid in watch}
    for _ in range(1000):
        if not eng.queue and not eng.running:
            break
        eng.step_segment()
        for rid in watch:
            req = eng.running.get(rid)
            if req is not None:
                seen[rid].append((len(req.generated), eng._logits[req.lane, -1].clone()))
    return eng, eng.run_until_drained(), seen


def serve_engine(cfg, params, machine) -> None:
    requests = engine_requests(cfg, 16, seed=3)
    per_segment: list[dict] = []
    synced = {"guarded": 0}

    def guard(prog):
        """Count each segment's launches per variant; from the second segment
        on (steady state), run the replay under sync-debug mode "error": a
        host sync inside the segment raises."""
        inner = prog._call

        def call(*args):
            before = counts_now()
            steady = bool(per_segment)
            if steady:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            synced["guarded"] += steady
            now = counts_now()
            per_segment.append({k: now[k] - before[k] for k in now})
            return out

        prog._call = call

    # the 4 requests with the fewest new tokens are held against batch-1
    checked = sorted(range(len(requests)), key=lambda r: requests[r][1])[:4]
    before = counts_now()
    eng, out, seen = run_engine(cfg, params, machine, requests, guard=guard, watch=checked)
    total = {k: v - before[k] for k, v in counts_now().items()}
    st = eng.stats()
    check(len(out) == len(requests) and not eng.queue and not eng.running,
          f"engine drained {len(out)} of {len(requests)} requests")
    for rid, (prompt, new) in enumerate(requests):
        toks = out[rid]
        check(len(toks) == len(prompt) + new and np.array_equal(toks[:len(prompt)], prompt),
              f"engine request {rid}: {len(toks)} tokens for {len(prompt)} + {new}")
        check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"engine request {rid}: token ids out of range")
    codes = st["health"]["count_by_code"]
    check(not {"BSPS203", "BSPS211"} & set(codes), f"engine health events {st['health']}")
    log(f"[engine] {len(requests)} requests (prompts 16-256, 32-64 new tokens, greedy) over "
        f"{eng.max_lanes} lanes, pool {eng.pool_seq} positions x {eng.max_lanes} lanes "
        f"({M.cache_bytes(cfg, eng.max_lanes, eng.pool_seq) / 1e9:.2f} GB), segment "
        f"{eng.segment_len}: segments={st['segments']} tokens={st['tokens']} "
        f"tokens_per_s={st['tokens_per_s']:.1f} latency_p50_ms={st['latency_p50_s'] * 1e3:.2f} "
        f"latency_p99_ms={st['latency_p99_s'] * 1e3:.2f} mean_occupancy="
        f"{st['mean_occupancy']:.2f} prefill_ms_mean="
        f"{np.mean([r.prefill_seconds for r in eng.finished.values()]) * 1e3:.1f} "
        f"health={json.dumps(codes)}")
    verdicts = [(a["verdict"], a["measured_verdict"]) for a in eng.admission_log]
    log(f"[engine] admissions={st['admissions']} confirmed={st['admission_verdict_matches']} "
        f"(predicted, measured): {json.dumps(verdicts)} "
        f"first segment predicted_vs_measured={json.dumps(eng.segment_log[0])}")

    # every segment's products took the decode variant (m = 8 lanes), one
    # launch each; the joins' prefills took wgmma (blocks over 16 rows)
    mlp = 3 * cfg.num_layers
    for i, c in enumerate(per_segment):
        check(c["streamed_matmul.decode"] == c["streamed_matmul"] == mlp * eng.segment_len,
              f"engine segment {i}: matmul launches {c}")
    check(total["streamed_matmul.wgmma"] > 0 and total["streamed_matmul.decode"] > 0
          and total["streamed_matmul.wmma"] == total["streamed_matmul.decode_wmma"] == 0,
          f"engine matmul variants {total}")
    log(f"[engine] matmul launches per segment: decode {mlp * eng.segment_len} "
        f"({mlp} per packed step, every segment); whole run: {json.dumps(total)}")
    check(synced["guarded"] == len(per_segment) - 1 >= 1, f"sync guard {synced}")
    log(f"[engine] sync-debug: {synced['guarded']} steady-state segments replayed under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync inside a segment")

    # each checked request's engine tokens fed to a batch-1 decode: the
    # lane's logits at every boundary against batch-1's at the same position,
    # and every engine token against batch-1's logits before it
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {m: [decode_split(m, n, k, sms) for k, n in ((cfg.d_model, cfg.d_ff),
                                                          (cfg.d_ff, cfg.d_model))]
              for m in (1, eng.max_lanes)}
    log(f"[engine] decode matmul K split (up, down) at m = 1: {splits[1]}, at m = "
        f"{eng.max_lanes}: {splits[eng.max_lanes]}; near tie: margin < {NEAR_TIE:g} of the "
        f"largest |logit|, boundary logits held within {NEAR_TIE / 2:g}")
    for rid in checked:
        prompt, new = requests[rid]
        p = torch.from_numpy(prompt).cuda()
        got = out[rid][len(prompt):].tolist()
        lg1 = batch1_logits(cfg, params, p, got, eng.pool_seq, machine)
        scale = lg1.abs().amax(-1)
        top2 = torch.topk(lg1, 2, dim=-1)
        fed = torch.tensor(got, device="cuda")
        gaps = ((top2.values[:, 0] - lg1.gather(1, fed[:, None])[:, 0]) / scale).tolist()
        margins = ((top2.values[:, 0] - top2.values[:, 1]) / scale).tolist()
        want = top2.indices[:, 0].tolist()
        div = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        drifts = [((lg - lg1[n]).abs().max() / scale[n]).item() for n, lg in seen[rid]]
        picked = [got[n] == int(torch.argmax(lg)) for n, lg in seen[rid]]
        if rid == checked[0]:
            ref, _ = generate(cfg, params, p[None], steps=new, machine=machine,
                              max_len=eng.pool_seq, device="cuda")
            upto = new if div is None else div + 1
            check(ref[0, len(prompt):len(prompt) + upto].tolist() == want[:upto],
                  "batch-1 teacher-forced decode disagrees with generate")
        check(div != 0, f"engine request {rid}: first token differs from batch-1's")
        check(len(drifts) >= 2 and all(picked),
              f"engine request {rid}: boundary tokens {picked} are not their logits' argmax")
        check(max(drifts) < NEAR_TIE / 2,
              f"engine request {rid}: lane logits stray {max(drifts):.4g} from batch-1's at "
              f"the segment boundaries {[n for n, _ in seen[rid]]}: {drifts}")
        check(max(gaps) <= NEAR_TIE,
              f"engine request {rid}: token at step {int(np.argmax(gaps))} is {max(gaps):.4g} "
              f"below batch-1's top logit")
        at = "none" if div is None else (
            f"at step {div} (batch-1 margin {margins[div]:.4g}, engine token ranked "
            f"{int((lg1[div] > lg1[div, got[div]]).sum()) + 1})")
        tie = next((i for i in range(1, new) if margins[i] < NEAR_TIE), None)
        log(f"[engine] request {rid} (prompt {len(prompt)}, {new} new): first divergence from "
            f"batch-1 generate {at}; first near tie {tie}; lane logits vs batch-1 at "
            f"{len(drifts)} boundaries: max {max(drifts):.4g}; largest gap of an engine token "
            f"below the batch-1 top {max(gaps):.4g}")
    clean_prefix = {rid: out[rid] for rid in range(2)}
    del eng, out
    gc.collect()

    # a short run twice: clean, and with one failed dispatch and one exhausted
    # page pool — the same greedy tokens, the faults logged
    short = [(prompt, 16) for prompt, _ in requests[:2]]
    _, clean, _ = run_engine(cfg, params, machine, short)
    inj = FaultPlan([FaultSpec("dispatch_fail", at=(1,)),
                     FaultSpec("page_exhaust", at=(0,))]).replay()
    feng, faulty, _ = run_engine(cfg, params, machine, short, faults=inj, retry_backoff_s=0.0)
    codes = feng.health.counts_by_code()
    check(all(np.array_equal(clean[r], faulty[r]) for r in clean),
          "engine fault run: tokens differ from the clean run")
    check(codes.get("BSPS204") == 1 and codes.get("BSPS207") == 1 and "BSPS211" not in codes,
          f"engine fault run codes {codes}")
    check([(f.kind, f.index) for f in inj.trace] == [("page_exhaust", 0), ("dispatch_fail", 1)],
          f"engine fault run trace {inj.trace}")
    same = all(np.array_equal(clean[r], clean_prefix[r][:len(clean[r])]) for r in clean)
    log(f"[engine] fault run (dispatch_fail at dispatch 1, page_exhaust at check 0): "
        f"trace {[(f.kind, f.index) for f in inj.trace]}, codes {json.dumps(codes)}, tokens "
        f"equal to the clean run's; equal to the 16-request run's first 16: {same}")
    del feng
    gc.collect()


def serve_jamba(machine) -> dict:
    """jamba-v0.1-52b at its published widths, depth cut to one period."""
    cfg = card_config("jamba-v0.1-52b")
    batch, prompt_len, steps = 4, 256, 32
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"[jamba] jamba-v0.1-52b: {cfg.num_layers} of "
        f"{get_config('jamba-v0.1-52b').num_layers} layers "
        f"{[(b.mixer, b.mlp) for b in cfg.pattern]}, d_model {cfg.d_model}, "
        f"d_inner {cfg.ssm_d_inner}, d_state {cfg.ssm_d_state}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, {cfg.moe_experts} experts top-{cfg.moe_top_k} of d_ff "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {M.count_params(cfg) / 1e9:.3f} B params "
        f"bf16, init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1)).to("cuda")
    counts = {}

    def counted(key, fn):
        before = counts_now()
        out = fn()
        counts[key] = {k: v - before[k] for k, v in counts_now().items()}
        return out

    runs = []
    for key, compiled in (("generate_compiled_first", True), ("generate_compiled", True),
                          ("generate_measure", False)):
        toks, stats = counted(key, lambda c=compiled: generate(
            cfg, params, prompt, steps=steps, machine=machine, device="cuda", compiled=c))
        runs.append(toks)
        # a compiled run records the whole decode once; measure mode per step
        p50 = (f" step_p50_ms={float(np.median(stats.decode_seconds)) * 1e3:.2f}"
               if not compiled else "")
        log(f"[jamba] {key}: prefill_ms={stats.prefill_seconds * 1e3:.2f} "
            f"({prompt_len} decode steps, prefill block "
            f"{prefill_block_size(cfg, batch, prompt_len, machine)}) "
            f"decode_tok_s={steps * batch / stats.decode_total_seconds:.1f} "
            f"({steps} tokens x batch {batch} in {stats.decode_total_seconds * 1e3:.1f} ms)"
            f"{p50} predicted_vs_measured={json.dumps(stats.plan_row)}")
    check(all(torch.equal(runs[0], t) for t in runs[1:]),
          "jamba: the three greedy generate calls disagree")
    check(tuple(runs[0].shape) == (batch, prompt_len + steps), f"jamba tokens {runs[0].shape}")
    check(int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size,
          "jamba: token ids out of range")

    step = make_prefill_step(cfg, device="cuda")
    step(params, {"tokens": prompt})                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = counted("prefill_step", lambda: step(params, {"tokens": prompt}))
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (batch, prompt_len, cfg.padded_vocab),
          f"jamba forward logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "jamba: non-finite forward logits")
    fwd = counts["prefill_step"]
    check(fwd["ssm_scan"] == 7 and fwd["flash_attention"] == 1, f"jamba forward launches {fwd}")
    # the dense MLPs and the LM head: wgmma in the forward, m ≤ 16 in decode
    dense = 3 * sum(blk.mlp == "dense" for _, blk in cfg.blocks()) + 1
    check(fwd["streamed_matmul.wgmma"] == fwd["streamed_matmul"] == dense,
          f"jamba forward matmul variants {fwd}")
    for key in ("generate_compiled_first", "generate_compiled", "generate_measure"):
        c = counts[key]
        check(c["streamed_matmul.decode"] == c["streamed_matmul"] > 0,
              f"jamba {key}: matmul variants {c}")
    log(f"[jamba] make_prefill_step: ms={fwd_ms:.2f} (B {batch}, S {prompt_len})")
    # token-at-a-time prefill and decode: prompt_len + steps decode steps, the
    # decode variant one device launch per product
    log(f"[jamba] matmul device launches per decode step: "
        f"{counts['generate_compiled']['streamed_matmul.decode'] / (prompt_len + steps):g}")
    del logits

    # The forward against the token-at-a-time prefill on the same weights. At
    # the config's capacity factor 1.25 the decode step's capacity is
    # ceil(4·2/16·1.25) = 1 token per expert, so the two paths drop different
    # tokens by design (GShard); at 8.0 neither drops any.
    cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    last = make_prefill_step(cfg8, device="cuda")(params, {"tokens": prompt})[:, -1].float()
    pre, _ = make_prefill(cfg8, 1, device="cuda")(
        params, M.init_cache(cfg8, batch, prompt_len, device="cuda"), prompt)
    pre = pre[:, -1].float()
    err = (last - pre).abs().max().item()
    # the paths differ in attention (flash vs dense cache read), the scan
    # (the kernel over bf16 Δ vs the fp32 decode recurrence) and bf16
    # rounding points; over 8 layers bounded at 5% of the largest logit
    tol = 0.05 * pre.abs().max().item()
    agree = float((last.argmax(-1) == pre.argmax(-1)).float().mean())
    check(err <= tol, f"jamba forward vs token-at-a-time prefill at cf 8: {err} > {tol}")
    log(f"[jamba] last-position logits, forward vs generate's prefill at capacity factor 8: "
        f"max_abs_diff={err:.4g} (tol {tol:.4g}), argmax agreement {agree:.2f}")
    log(f"[jamba] launches per call: {json.dumps(counts)}")
    return counts


def counts_now() -> dict:
    """Launches per kernel, and the matmul's per variant."""
    return {**ops.launch_counts(),
            **{f"streamed_matmul.{v}": c for v, c in ops.matmul_variant_counts().items()}}


def main_path(name: str, drive) -> dict:
    """Drive one main path with every launch count set to 0 just before it;
    return the counts read just after."""
    ops.reset_launch_counts()
    with phase(name):
        drive()
    launches = ops.launch_counts()
    log(f"[main path] {name}: launches {json.dumps(counts_now())}")
    return launches


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
            if any(w in line for w in ("Compiling entry", "Used", "spill", "arning")):
                log(f"[ptxas] {src}: {line.strip()}")

    rows: dict[str, dict] = {}
    with phase("kernel checks"):
        check_matmul(rows)
        check_dot(rows)
        check_flash(rows)
        check_ssm(rows)

    with phase("calibration"):
        machine = default_machine(device="cuda")
    log(f"[machine] {machine}")
    with phase("reference checks"):
        reference_check("minicpm-2b")
        reference_check("jamba-v0.1-52b",
                        pattern=(Block("mamba", "dense"), Block("attn", "dense")))

    dense = main_path("minicpm-2b", lambda: (inner_product(machine), serve_slice(machine)))
    gc.collect()
    torch.cuda.empty_cache()      # minicpm's weights go before jamba's come
    hybrid = main_path("jamba-v0.1-52b", lambda: serve_jamba(machine))
    for name in ("streamed_dot", "streamed_matmul", "flash_attention"):
        check(dense[name] > 0, f"{name} was not launched on the minicpm-2b path")
    for name in ("streamed_matmul", "flash_attention", "ssm_scan"):
        check(hybrid[name] > 0, f"{name} was not launched on the jamba path")
    launches = {k: dense[k] + hybrid[k] for k in dense}

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

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the shapes the serve and train
paths give it (and ragged shapes, and the matmul's transposed operand
layouts: the tied LM head's (V, d) B and a train step's backward products;
flash at head dims 16, 32, 192 and 256 (8 and 48 zero-padded) in bf16 and
fp32, fp32 at train_lm's shape, jamba-train's fp32 cut and nemotron's D 192,
each fp32 instance checked free of spills, and the matmul at nemotron's and xlstm's shapes,
``decode_deep`` at the deep-K decode products beside ``decode_cp`` forced
on the same operands (bit for bit), and the copy variants ``wgmma_cp`` and
``decode_cp`` on operands TMA cannot describe, with their compiled
attributes checked free of spills), times it beside the plain version and one
library call where there is one, and checks 2-layer full-width cuts of
minicpm-2b and jamba-v0.1-52b on the card against float32 on the CPU, the
forward and, for minicpm-2b, the loss and every gradient; the scan's
backward kernel against its plain reverse walk at jamba's train shapes and
ragged ones, bit for bit across runs, lane counts and batch rows. Then it
drives ten main paths, each with the launch counts set to 0 before it
and read after: the paper's §3.1 inner product through the hyperstep runner in
both execution modes plus minicpm-2b served at full width and depth;
minicpm-2b's train step at full width and depth (4 AdamW steps, the loss
falling; then remat "dots" beside "full" in turns); the training loop (``train-loop``:
``repro_torch.train.loop.train`` on synthetic batches, minicpm-2b at full
width and depth for 8 steps in each execution mode, the losses equal bit
for bit and each step launching what the bare step launches, then a
crash/resume drill at full width and 2 layers with 4.9 GB checkpoints,
resumed bit for bit in both modes); jamba-v0.1-52b served at full width
with its depth cut to one period of 8 layers (random weights from a seed),
each served model through ``generate`` and ``make_prefill_step``;
jamba-v0.1-52b trained (``jamba-train``: a 2-layer published-width cut's
loss and every gradient leaf, bf16 and fp32 on the card, against fp32 on
the CPU; 4 AdamW steps at ``card_train_config``, 8 layers and 4 experts at
published widths, each step launching the scan 14 times, its backward 7
and flash twice; ``train()`` 3 steps in each mode, the losses equal bit
for bit); and the paper's algorithms (``bsps``): the §3.1 inner product over 16 cores from
cyclic streams, and two-level Cannon (Algorithm 2) at n = 16384, M = 4 on
one core and on a 4 × 4 grid, fp32 (the matmul's ``simt_f32`` variant)
and bf16 (``wgmma``), in both execution modes, each run beside its Eq. 2
prediction and held against the fp64 product. Before ``bsps`` come two
more: ``xlstm-1.3b`` at full width and depth (48 mLSTM/sLSTM layers: the
forward at B 4 x S 256, ``generate`` with the prompt prefilled
token-at-a-time in both modes, its last logits held to the forward's on
a 2-layer cut and printed by depth, 3 AdamW steps of its train step, and
a 2-layer cut against fp32 on the CPU)
and ``families``: starcoder2-15b, qwen2-moe-a2.7b, moonshot-v1-16b-a3b,
musicgen-large, qwen2-vl-7b and nemotron-4-340b at published widths and
``card_config`` depth (nemotron 4 of 96 layers), each a forward through
flash (nemotron's at head dim 192; musicgen's and qwen2-vl's also from
frontend embeds, qwen2-vl's at 3-axis positions), its last logits held to
``generate``'s prefill, ``generate`` with 16 new tokens (every product's
matmul variant predicted, nemotron's K = 73728 down projection on
``decode_deep``) and a 2-layer cut against fp32 on the CPU where its fp32
weights fit the host; then all ten configs' smoke cuts (head dim 16,
starcoder2's and nemotron's 8 zero-padded to 16) against fp32 on the CPU,
in fp32 at smoke depth and in bf16 at two layers. The
matmul's launches are also counted per variant: every product of the
forward, of a multi-row prefill and of the train step must take the wgmma
variant, every decode product the m ≤ 16 one. On minicpm-2b's weights the
continuous-batching ``ServeEngine`` then serves 16 requests over 8 lanes
(the ``engine`` phase): every request drained, the decode variant launched
per segment and the wgmma variant by the joins' prefills, no host sync
inside a steady-state segment, each lane's logits at every segment boundary
equal, bit for bit, to a batch-1 decode's on the same tokens and every
greedy token batch-1's, and a run with an injected dispatch failure and
page exhaustion giving a clean run's tokens. Six runs are also counted
(``repro_torch.core.roofline.count``), each in one extra run beside its
timed ones: minicpm-2b's forward, a decode step at batch 4 and the train
step; jamba-v0.1-52b's forward and train step; xlstm-1.3b's forward. Each
prints a ``[roofline]`` line (FLOPs, bytes, launches, the compute and
memory terms, MFU against the measured median wall, the roofline share,
which must not pass 1.05); a 2-layer minicpm-2b cut counts the same on the
card as on the CPU. The ``plans`` phase runs ``python -m
repro_torch.lint --check`` on the calibrated pack (clean) and prints the
dry-run report (``[dryrun]``) of minicpm-2b at ``train_4k`` and
``decode_32k``. The last two paths: ``mesh`` starts a world-1 ``nccl``
group (destroyed after it) and holds the mesh-bound modules on the
(data=1, model=1) mesh over it — minicpm-2b at full width and depth
through ``train(mesh=...)`` against ``train(mesh=None)``, 4 steps in each
mode, the losses equal bit for bit and the launches equal;
``cannon_matmul`` at 4096³ bf16 and fp32, two-level Cannon with ``mesh=``
and ``pipeline_apply`` at one stage, each bit for bit against the bare
product or stage; the host-level fit on one host; a sharded save and a
restore through a ``sharder`` of the 2-layer cut — and ``examples`` runs
the port's examples at their defaults, quickstart's train step of
qwen2-moe-a2.7b's smoke config (flash at head dim 16) included, train_lm's
300 fp32 steps with their wall and their fp32.d64 flash launches. One card:
no collective crosses ranks. Every check that fails raises,
and the script exits non-zero. Each phase prints its wall time. It imports
neither JAX nor the JAX package.

Output, in order: progress lines; the card's name and power limit as
``nvidia-smi`` reports them; one JSON line with a row per kernel (the
matmul's with a row per variant under ``variants``, flash's with a row per
timed kernel instance, dtype and head dim); and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 before
running anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch.configs import Block, card_config, card_train_config, get_config  # noqa: E402
from repro_torch.core.calibrate import default_machine, measure_fetch_model  # noqa: E402
from repro_torch.core.cost import cannon_k_equal, inner_product_cost  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.core.hyperstep import HyperstepRunner  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.plan import host_plan  # noqa: E402
from repro_torch.core.stream import StreamSet  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.distributed.cannon import gather_c, make_cannon_runner  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, pipeline, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_mod  # noqa: E402
from repro_torch.kernels import streamed_dot as dot_mod  # noqa: E402
from repro_torch.kernels import streamed_matmul as matmul_mod  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    LANE_CHOICES,
    SEGMENT,
    bwd_geometry,
    bwd_kernel_attrs,
    bwd_work_shapes,
    lanes_for,
    ssm_scan,
    ssm_scan_bwd,
    ssm_scan_with_tape,
)
from repro_torch.kernels.streamed_matmul import (  # noqa: E402
    VARIANTS,
    decode_fits,
    decode_split,
    deep_split,
    streamed_matmul,
)
from repro_torch import lint  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.launch.serve import generate, make_prefill, prefill_block_size  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.mamba import chunked_selective_scan  # noqa: E402
from repro_torch.models.flash import FlashAttention  # noqa: E402
from repro_torch.optim.adamw import AdamW, leaves  # noqa: E402
from repro_torch.optim.compress import tree_map  # noqa: E402
from repro_torch.optim.schedule import wsd  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    make_grad_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

# The H100 SXM's published peaks (``roofline.H100_SXM``): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate of their type (``roofline.kernel_bound``), the work
# from the kernel module's ``cost`` function.
HW = roofline.H100_SXM
L2_BYTES = 50 * 2**20
# the H100 SXM's boost clock (1.98 GHz): torch.cuda._sleep spins for clock
# cycles, at most this many per second
SPIN_CYCLES_PER_S = 1.98e9
# A packed lane (m = 8 rows in every product of a decode step) must round as
# the same request served alone (m = 1): every product is on the port's
# matmul, which takes one K split for m = 1 .. 8, and the norms and cache
# reads use reductions whose launch shape does not follow the batch. The
# engine phase feeds the engine's own tokens to a batch-1 decode and holds
# the lane's logits, read at every segment boundary, equal to batch-1's bit
# for bit; it also keeps the looser bound it had before: within NEAR_TIE / 2
# of the batch-1 logits (relative to the largest |logit|), every engine
# token within NEAR_TIE of batch-1's top logit. The first token comes from
# the batch-1 prefill in both runs and must be equal.
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
    # the JAX package has no Pallas backward: jax.grad through its
    # chunked_selective_scan
    "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/models/mamba.py:63"),
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


def bound(cost: roofline.KernelCost) -> tuple[float, str]:
    """(ms, what bounds it) of ``cost`` on the card's peaks."""
    t, by = roofline.kernel_bound(cost, HW)
    return t * 1e3, by


# -- phase 2: each kernel against its plain version --------------------------------


def matmul_variant(fn) -> tuple[object, str]:
    """``fn()``'s result and the matmul variant its one launch took."""
    before = ops.matmul_variant_counts()
    out = fn()
    taken = [v for v, c in ops.matmul_variant_counts().items() if c != before[v]]
    check(len(taken) == 1, f"one matmul launch expected, variants {taken}")
    return out, taken[0]


def _operands(m, k, n, a_layout, b_layout, i, pad=False):
    """Inputs of one timed set, A and B stored in their layouts; with
    ``pad``, A's rows a multiple of 8 elements apart (a view of padded rows,
    as the train step stages the logits' gradient for TMA)."""
    rows, cols = (m, k) if a_layout == "mk" else (k, m)
    a = randn((rows, -(-cols // 8) * 8 if pad else cols), torch.bfloat16, 10 * i + 1)[:, :cols]
    b = randn((k, n) if b_layout == "kn" else (n, k), torch.bfloat16, 10 * i + 2, k ** -0.5)
    return a, b


def _variant_row(rows: dict, variant: str, shape: str, **row) -> None:
    """Keep the first timed row of each matmul variant for the kernels line
    (``rows["streamed_matmul.<variant>"]``)."""
    rows.setdefault(f"streamed_matmul.{variant}", dict(shape=shape, **row))


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
              (1000, 2304, 5768), (1024, 4096, 65544),
              # two-level Cannon's bf16 local product (the bsps path)
              (4096, 4096, 4096),
              # nemotron-4-340b's MLP: decode up and forward up (its decode
              # down projection is check_matmul_deep's); xlstm-1.3b's forward
              # w_down
              (4, 18432, 73728), (1024, 18432, 73728), (1024, 4096, 2048)]
    cases = [(m, k, n, "mk", "kn", False) for m, k, n in shapes] + [
        # minicpm-2b's tied head x·Eᵀ, E (122753, 2304) read as the (n, k) B:
        # decode at 1, 4 and 8 rows, the train step's forward at 1024 (an odd
        # output row stride)
        (1, 2304, 122753, "mk", "nk", False), (4, 2304, 122753, "mk", "nk", False),
        (8, 2304, 122753, "mk", "nk", False), (1024, 2304, 122753, "mk", "nk", False),
        # one MLP product's backward at B 4 x S 256: dX = dC·Wᵀ (the (2304,
        # 5760) weight read as the (n, k) B) and dW = Xᵀ·dC (X read as the
        # (k, m) A), for the up and the down projection
        (1024, 5760, 2304, "mk", "nk", False), (2304, 1024, 5760, "km", "kn", False),
        (5760, 1024, 2304, "km", "kn", False),
        # the tied head's backward: dX = dC·E and dE = dCᵀ·X, dC's rows
        # padded to a multiple of 8 elements
        (1024, 122753, 2304, "mk", "kn", True), (122753, 1024, 2304, "km", "kn", True)]
    for idx, (m, k, n, al, bl, pad) in enumerate(cases):
        sets = copies_past_l2(
            lambda i, m=m, k=k, n=n, al=al, bl=bl, pad=pad: _operands(m, k, n, al, bl, i, pad),
            (m * k + k * n) * 2)
        a, b = sets[0]
        got, variant = matmul_variant(lambda: ops.matmul(a, b, a_layout=al, b_layout=bl))
        want = ref.matmul_ref(a, b, a_layout=al, b_layout=bl)
        torch.cuda.synchronize()
        expect = (("decode" if decode_fits(m, k) else "decode_deep") if m <= 16 and al == "mk"
                  else "wgmma_cp" if (n % 8 or k % 8) and (al, bl) == ("mk", "kn") and not pad
                  else "wgmma")
        check(variant == expect, f"streamed_matmul {m}x{k}x{n} {al}/{bl} took {variant}, "
              f"not {expect}")
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        check(err <= tol, f"streamed_matmul {m}x{k}x{n} {al}/{bl}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda a, b: ops.matmul(a, b, a_layout=al, b_layout=bl), sets, 50)
        plain, _ = bench_ms(lambda a, b: ref.matmul_ref(a, b, a_layout=al, b_layout=bl), sets,
                            20 if m * n * k < 2e11 else 3)
        # the library's product reads the same stored operands, transposed views
        lib, _ = bench_ms(lambda a, b: torch.matmul(a if al == "mk" else a.T,
                                                    b if bl == "kn" else b.T), sets, 50)
        cost = matmul_mod.cost(m, k, n, 2)
        nbytes, flops = cost.bytes, cost.flops
        b_ms, b_by = bound(cost)
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if b_by == "operations"
                else f"{nbytes / ms / 1e9:.3f} TB/s")
        log(f"[kernel] streamed_matmul {m}x{k}x{n} a={al}{' (padded rows)' if pad else ''} "
            f"b={bl} variant={variant}: "
            f"max_abs_err={err:.3g} (tol {tol:.3g}) ms={ms:.4f} ({rate}) enqueue_ms={enqueue:.4f} "
            f"plain_ms={plain:.4f} torch.matmul_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib)
        if idx == 0:   # the decode up-projection: the launch the serve path repeats most
            rows["streamed_matmul"] = row
        _variant_row(rows, variant, f"{m}x{k}x{n} a={al} b={bl}", **row)
    # a packed decode step's rows round as each row alone: one K split and
    # one kernel instance for m = 1 .. 8, in both B layouts and past the
    # decode block's A share (decode_deep)
    for k, n, bl in ((2304, 2304, "kn"), (2304, 5760, "kn"), (5760, 2304, "kn"),
                     (2304, 122753, "nk"), (73728, 18432, "kn")):
        a, b = _operands(8, k, n, "mk", bl, 7)
        full = ops.matmul(a, b, b_layout=bl)
        same = all(torch.equal(ops.matmul(a[i:i + 1], b, b_layout=bl), full[i:i + 1])
                   for i in range(8))
        check(same, f"streamed_matmul 8x{k}x{n} b={bl}: a row alone differs from the batch")
    log("[kernel] streamed_matmul decode rows 1..8: each row alone equals its row among 8, "
        "bitwise (2304x2304, 2304x5760, 5760x2304, the tied head 2304x122753 and, on "
        "decode_deep, 73728x18432)")
    # and m = 9 .. 16 share one instance and one split: the first m rows of
    # 16 alone equal their rows among 16 (decode_deep at starcoder2's K)
    a, b = _operands(16, 24576, 6144, "mk", "kn", 8)
    full = ops.matmul(a, b)
    same = all(torch.equal(ops.matmul(a[:r], b), full[:r]) for r in range(9, 16))
    check(same, "streamed_matmul 16x24576x6144: rows 1..m of 16 alone differ from the batch")
    log("[kernel] streamed_matmul decode_deep rows 9..16: the first m rows alone (m = 9 .. 15) "
        "equal their rows among 16, bitwise (24576x6144)")


# The deep-K decode products (m ≤ 16, A's K share past a decode block):
# nemotron-4-340b's down projection at 1, 4 and 8 rows, and at 16 rows its
# up projection, starcoder2-15b's and qwen2-vl-7b's down projections and
# nemotron's head with B as (k, n) and as (n, k)
DEEP_SHAPES = [(1, 73728, 18432, "kn"), (4, 73728, 18432, "kn"), (8, 73728, 18432, "kn"),
               (16, 18432, 73728, "kn"), (16, 24576, 6144, "kn"), (16, 18944, 3584, "kn"),
               (16, 18432, 256000, "kn"), (16, 18432, 256000, "nk")]


def _deep_operands(m, k, n, bl, i):
    a = randn((m, k), torch.bfloat16, 10 * i + 1)
    return a, randn((k, n) if bl == "kn" else (n, k), torch.bfloat16, 10 * i + 2, k ** -0.5)


def check_matmul_deep(rows: dict) -> None:
    """``decode_deep`` at :data:`DEEP_SHAPES` against its plain version
    within two bf16 ulps, its variant and its K split, timed beside the
    plain version, ``torch.matmul`` and ``decode_cp`` forced on the same
    operands, which must give ``decode_deep``'s bits (the same split,
    consumers and sum order; ``decode_cp`` takes no (n, k) B)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n, bl in DEEP_SHAPES:
        sets = copies_past_l2(lambda i, m=m, k=k, n=n, bl=bl: _deep_operands(m, k, n, bl, i),
                              (m * k + k * n) * 2)
        a, b = sets[0]
        got, variant = matmul_variant(lambda: ops.matmul(a, b, b_layout=bl))
        want = ref.matmul_ref(a, b, b_layout=bl)
        torch.cuda.synchronize()
        check(variant == "decode_deep", f"streamed_matmul {m}x{k}x{n} b={bl} took {variant}")
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        check(err <= tol, f"decode_deep {m}x{k}x{n} b={bl}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda a, b: ops.matmul(a, b, b_layout=bl), sets, 50)
        plain, _ = bench_ms(lambda a, b: ref.matmul_ref(a, b, b_layout=bl), sets, 3)
        lib, _ = bench_ms(lambda a, b: torch.matmul(a, b if bl == "kn" else b.T), sets, 50)
        cost = matmul_mod.cost(m, k, n, 2)
        nbytes = cost.bytes
        b_ms, b_by = bound(cost)
        cp = "decode_cp takes no (n, k) B"
        if bl == "kn":
            cp_c, cp_variant = matmul_variant(lambda: streamed_matmul(a, b, variant="decode_cp"))
            torch.cuda.synchronize()
            check(cp_variant == "decode_cp", f"{m}x{k}x{n} forced: took {cp_variant}")
            check(torch.equal(cp_c, got), f"decode_cp {m}x{k}x{n}: not decode_deep's bits")
            cp_ms, _ = bench_ms(lambda a, b: streamed_matmul(a, b, variant="decode_cp"),
                                sets, 20)
            cp = (f"decode_cp (forced, decode_deep's bits) ms={cp_ms:.4f} "
                  f"({nbytes / cp_ms / 1e9:.3f} TB/s, {b_ms / cp_ms:.1%} of the bound)")
            if (m, k, n) == (4, 73728, 18432):
                _variant_row(rows, "decode_cp", f"{m}x{k}x{n} a=mk b=kn (forced)",
                             max_abs_err=err, ms=cp_ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib)
            del cp_c
        del got, want
        if (m, k, n) == (4, 73728, 18432):
            _variant_row(rows, "decode_deep", f"{m}x{k}x{n} a=mk b={bl}", max_abs_err=err,
                         ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"[kernel] streamed_matmul {m}x{k}x{n} a=mk b={bl} variant={variant} "
            f"split={deep_split(m, n, k, sms)}: max_abs_err={err:.3g} (tol {tol:.3g}) "
            f"ms={ms:.4f} ({nbytes / ms / 1e9:.3f} TB/s, {b_ms / ms:.1%} of the bound) "
            f"enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} torch.matmul_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}); {cp}")
        del sets, a, b
        torch.cuda.empty_cache()


# The copy producers' shapes (m, k, n), default layouts. At 300 × 200 ×
# 130, 4 × 2304 × 5761 and 1024 × 2304 × 5761 B's rows are not 16 bytes
# apart (260 and 11,522 bytes) and the rule picks a copy variant; at
# 4 × 73728 × 18432 and 1024 × 2304 × 5760 the operands are aligned and the
# copy variant is forced beside the TMA variant the rule picks. Last, an LM
# head stored as (d, V) at minicpm's odd vocabulary (B 566 MB, rows 245,506
# bytes apart) at a decode step and at a 64-row chunk: bound by B's bytes.
CP_SHAPES = [(300, 200, 130), (4, 73728, 18432), (4, 2304, 5761), (1024, 2304, 5761),
             (1024, 2304, 5760), (4, 2304, 122753), (64, 2304, 122753)]
# the copy variants' instances whose compiled attributes are reported at
# bf16 and fp32 output (m picks the decode instance: 1-8 or 9-16 rows),
# beside the TMA ones
ATTR_INSTANCES = [("wgmma", 1024), ("wgmma_cp", 1024), ("decode_deep", 4),
                  ("decode_deep", 16), ("decode_cp", 4), ("decode_cp", 16)]


def check_matmul_cp(rows: dict) -> None:
    """The copy variants at :data:`CP_SHAPES` (4 × 73728 × 18432 is
    :func:`check_matmul_deep`'s) against the plain version within two bf16
    ulps, timed beside the plain version, ``torch.matmul`` and the bound;
    forced on aligned operands, bit for bit against the TMA variant the
    rule picks, timed beside it. Then the compiled attributes of
    :data:`ATTR_INSTANCES` at both output dtypes (``bsps_matmul_attrs``),
    each free of spills."""
    for m, k, n in CP_SHAPES:
        if any((m, k, n) == shape[:3] for shape in DEEP_SHAPES):
            continue
        sets = copies_past_l2(lambda i, m=m, k=k, n=n: _operands(m, k, n, "mk", "kn", i),
                              (m * k + k * n) * 2)
        a, b = sets[0]
        forced = None if n % 8 else "decode_cp" if m <= 16 else "wgmma_cp"
        got, variant = matmul_variant(lambda: streamed_matmul(a, b, variant=forced))
        want = ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        expect = "decode_cp" if m <= 16 else "wgmma_cp"
        check(variant == expect, f"streamed_matmul {m}x{k}x{n} took {variant}, not {expect}")
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        check(err <= tol, f"{variant} {m}x{k}x{n}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda a, b: streamed_matmul(a, b, variant=forced), sets, 50)
        plain, _ = bench_ms(ref.matmul_ref, sets, 20)
        lib, _ = bench_ms(torch.matmul, sets, 50)
        b_ms, b_by = bound(matmul_mod.cost(m, k, n, 2))
        tma = ""
        if forced:
            tma_c, tma_variant = matmul_variant(lambda: ops.matmul(a, b))
            check(torch.equal(tma_c, got), f"{variant} {m}x{k}x{n}: not {tma_variant}'s bits")
            tma_ms, _ = bench_ms(ops.matmul, sets, 50)
            tma = f"; {tma_variant} (the rule's) ms={tma_ms:.4f}, the same bits"
        log(f"[kernel] streamed_matmul {m}x{k}x{n} a=mk b=kn variant={variant}"
            f"{' (forced)' if forced else ''}: max_abs_err={err:.3g} (tol {tol:.3g}) "
            f"ms={ms:.4f} ({b_ms / ms:.1%} of the bound) enqueue_ms={enqueue:.4f} "
            f"plain_ms={plain:.4f} torch.matmul_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}){tma}")
        _variant_row(rows, variant, f"{m}x{k}x{n} a=mk b=kn", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        del sets, a, b, got, want
    device = torch.device("cuda")
    for variant, m in ATTR_INSTANCES:
        for out_dtype in (torch.bfloat16, torch.float32):
            attrs = matmul_mod.kernel_attrs(variant, m, device, out_dtype)
            name = "bf16" if out_dtype == torch.bfloat16 else "fp32"
            log(f"[kernel] streamed_matmul.{variant} attrs (m = {m}, {name} out): "
                f"{json.dumps(attrs)}")
            check(attrs["spill_bytes"] == 0, f"{variant} (m = {m}, {name} out) spills: {attrs}")


def check_matmul_f32(rows: dict) -> float:
    """The fp32 variant (``simt_f32``) against its plain version at ragged
    shapes, at m ≤ 16 and at Cannon's local product (4096³), in the default
    layouts and with B as (n, k) or A as (k, m); timed at 4096³, 1000 × 264 ×
    1031 and 4 × 2304 × 5760 beside the plain version and ``torch.matmul``
    (TF32 off). Prints whether C equals ``torch.matmul``'s bit for bit (a
    fact, not a check). Returns the 4096³ product's rate in FLOP/s."""
    # exact fp32 FMAs on both sides (TF32 off), sums in another order:
    # bounded at 1e-5 of the largest output
    rate = 0.0
    timed = {(4096, 4096, 4096), (1000, 264, 1031), (4, 2304, 5760)}
    cases = [(m, k, n, "mk", "kn") for m, k, n in
             [(4096, 4096, 4096), (1000, 264, 1031), (4, 2304, 5760), (16, 37, 9)]]
    # the transposed layouts (an fp32 model's dX = dC·Wᵀ and dW = Xᵀ·dC), ragged
    cases += [(m, k, n, al, bl) for al, bl in (("mk", "nk"), ("km", "kn"))
              for m, k, n in [(1000, 264, 1031), (2304, 1024, 5760), (129, 37, 130)]]
    for m, k, n, al, bl in cases:
        sets = copies_past_l2(
            lambda i, m=m, k=k, n=n, al=al, bl=bl: (
                randn((m, k) if al == "mk" else (k, m), torch.float32, 10 * i + 41),
                randn((k, n) if bl == "kn" else (n, k), torch.float32, 10 * i + 42)),
            (m * k + k * n) * 4)
        a, b = sets[0]
        got, variant = matmul_variant(lambda: ops.matmul(a, b, a_layout=al, b_layout=bl))
        want = ref.matmul_ref(a, b, a_layout=al, b_layout=bl)
        torch.cuda.synchronize()
        check(variant == "simt_f32", f"fp32 streamed_matmul {m}x{k}x{n} {al}/{bl} took {variant}")
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        check(err <= tol, f"fp32 streamed_matmul {m}x{k}x{n} {al}/{bl}: max err {err} > {tol}")
        head = (f"[kernel] streamed_matmul {m}x{k}x{n} fp32 a={al} b={bl} variant={variant}: "
                f"max_abs_err={err:.3g} (tol {tol:.3g}) equal_to_torch.matmul_bitwise="
                f"{torch.equal(got, want)}")
        if (m, k, n) not in timed or (al, bl) != ("mk", "kn"):
            log(head)
            continue
        ms, enqueue = bench_ms(ops.matmul, sets, 20)
        plain, _ = bench_ms(ref.matmul_ref, sets, 20)
        lib, _ = bench_ms(torch.matmul, sets, 20)
        cost = matmul_mod.cost(m, k, n, 4)
        flops = cost.flops
        b_ms, b_by = bound(cost)
        if (m, k, n) == (4096, 4096, 4096):
            rate = flops / ms * 1e3
            _variant_row(rows, "simt_f32", f"{m}x{k}x{n} fp32", max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(f"{head} ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound) "
            f"enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} torch.matmul_ms={lib:.4f} (TF32 off) "
            f"bound_ms={b_ms:.4f} ({b_by})")
    return rate


def ptxas_f32(log_text: str) -> None:
    """Print ``matmul_f32``'s registers and spills from the build's ptxas
    output, one line per instance (output dtype, operand layouts)."""
    entry, spills = None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = re.search(r"matmul_f32.*EE(f|13__nv_bfloat16)Lb([01])ELb([01])E", line)
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "Used" in line:
            out, a_kc, b_kc = entry.groups()
            inst = (f"{'fp32' if out == 'f' else 'bf16'} out, "
                    f"A {'(m, k)' if a_kc == '1' else '(k, m)'}, "
                    f"B {'(n, k)' if b_kc == '1' else '(k, n)'}")
            log(f"[ptxas] matmul_f32 ({inst}): {line.split(':', 1)[-1].strip()}; {spills}")
            entry = None


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
        b_ms, b_by = bound(dot_mod.cost(n, 4))
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
    # nemotron-4-340b's forward at head dim 192 (GQA 96/8)
    cases = [(4, 36, 36, 256, 256, 64), (2, 8, 2, 100, 100, 64), (4, 32, 8, 256, 256, 128),
             (2, 32, 8, 100, 300, 128), (4, 32, 8, 1, 300, 128), (4, 96, 8, 256, 256, 192)]
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
        b_ms, b_by = bound(flash_mod.cost(b, hq, hkv, sq, skv, d, 2))
        log(f"[kernel] flash_attention {shape}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
            f"sdpa_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib)
        if idx == 0:
            rows["flash_attention"] = row
        rows.setdefault(f"flash_attention.{flash_mod.variant_name(torch.bfloat16, d)}",
                        dict(shape=shape, **row))
        if idx in (0, 2, 5):
            check_flash_lse_and_grads(sets, shape, b_ms, lib)
    for case in FLASH_HEAD_DIM_CASES:
        check_flash_head_dim(rows, *case)
    for dtype in (torch.bfloat16, torch.float32):
        for d in flash_mod.HEAD_DIMS:
            attrs = flash_mod.kernel_attrs(d, dtype, torch.device("cuda"))
            name = flash_mod.variant_name(dtype, d)
            log(f"[kernel] flash_attention {name} attrs: {json.dumps(attrs)}")
            check(dtype == torch.bfloat16 or attrs["spill_bytes"] == 0,
                  f"flash_attention {name} spills {attrs['spill_bytes']} bytes a thread")
            if f"flash_attention.{name}" in rows:
                rows[f"flash_attention.{name}"].update(attrs)


# (label, B, Hq, Hkv, Sq, Skv, D, dtype): the fp32 kernel at train_lm's shape
# (the examples' fp32 10M LM, D 64), at jamba-train's fp32 cut (GQA 32/8,
# S 64, D 128) and at nemotron's D 192 (GQA 96/8), both kernels at
# quickstart's (qwen2-moe smoke: B 2, S 32, D 16) and at the smoke configs'
# D 8 (zero-padded to 16), ragged GQA at D 32 and D 48 (padded to 64), and
# D 256 (GQA 16/8)
FLASH_HEAD_DIM_CASES = [
    ("train_lm", 8, 4, 4, 256, 256, 64, torch.float32),
    ("jamba-train fp32 cut", 2, 32, 8, 64, 64, 128, torch.float32),
    ("nemotron", 4, 96, 8, 256, 256, 192, torch.float32),
    *[(label, *shape, dtype) for dtype in (torch.bfloat16, torch.float32)
      for label, shape in (("quickstart", (2, 4, 4, 32, 32, 16)),
                           ("smoke D 8", (2, 8, 2, 64, 64, 8)),
                           ("ragged", (2, 8, 2, 100, 130, 32)),
                           ("ragged", (2, 8, 2, 100, 130, 48)),
                           ("D 256", (4, 16, 8, 256, 256, 256)))],
]


def check_flash_head_dim(rows: dict, label, b, hq, hkv, sq, skv, d, dtype) -> None:
    """One head dim and dtype against the plain version (output and lse),
    within 2e-4 (fp32) or 2e-2 (bf16) absolute and relative, the output
    with lse equal to the output without, timed beside the plain version
    and SDPA (fp32: the math backend, TF32 off)."""
    sets = copies_past_l2(
        lambda i: (randn((b, hq, sq, d), dtype, 10 * i + 11),
                   randn((b, hkv, skv, d), dtype, 10 * i + 12),
                   randn((b, hkv, skv, d), dtype, 10 * i + 13)),
        (b * hq * sq * d + 2 * b * hkv * skv * d) * torch.finfo(dtype).bits // 8)
    q, k, v = sets[0]
    before = ops.flash_variant_counts()
    out, lse = ops.attention(q, k, v, return_lse=True)
    want, want_lse = ref.attention_ref_lse(q, k, v)
    torch.cuda.synchronize()
    after = ops.flash_variant_counts()
    name = flash_mod.variant_name(dtype, flash_mod.kernel_head_dim(d))
    shape = f"{label} b{b} h{hq}/{hkv} sq{sq} skv{skv} d{d} {str(dtype)[6:]}"
    check({v: after[v] - before[v] for v in after if after[v] != before[v]} == {name: 1},
          f"flash_attention {shape}: launches {after} from {before}, expected one {name}")
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    diff = (out.float() - want.float()).abs()
    err, lse_err = diff.max().item(), (lse - want_lse).abs().max().item()
    check(bool((diff <= tol + tol * want.float().abs()).all()) and lse_err <= 1e-3,
          f"flash_attention {shape}: max err {err} (tol {tol}), lse {lse_err} (tol 1e-3)")
    check(out.shape == q.shape and out.transpose(1, 2).is_contiguous(),
          f"flash_attention {shape}: output layout {out.shape} {out.stride()}")
    check(torch.equal(out, ops.attention(q, k, v)),
          f"flash_attention {shape}: the output with lse differs from the output without")
    ms, enqueue = bench_ms(lambda q, k, v: ops.attention(q, k, v), sets, 50)
    plain, _ = bench_ms(lambda q, k, v: ref.attention_ref(q, k, v), sets, 20)
    # SDPA aligns causal queries with the first keys: a ragged case passes
    # the port's mask (queries at the end); fp32 takes the math backend
    mask = (None if sq == skv else torch.ones(sq, skv, dtype=torch.bool, device="cuda")
            .tril(skv - sq))
    with sdpa_kernel(SDPBackend.MATH) if dtype == torch.float32 else contextlib.nullcontext():
        lib, _ = bench_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=hq != hkv), sets, 50)
    b_ms, b_by = bound(flash_mod.cost(b, hq, hkv, sq, skv, d, q.element_size()))
    log(f"[kernel] flash_attention {shape} ({name}): max_abs_err={err:.3g} (tol {tol}) "
        f"lse_err={lse_err:.3g} ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
        f"sdpa_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by})")
    rows.setdefault(f"flash_attention.{name}", dict(
        shape=shape, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib))


def check_flash_lse_and_grads(sets, shape: str, fwd_bound_ms: float, sdpa_ms: float) -> None:
    """The train step's flash: the kernel's lse against the plain version's
    and the FlashAttention Function's (dq, dk, dv) on the card against fp32
    CPU autograd through the plain version."""
    q, k, v = sets[0]
    (out, lse), (want_out, want) = (ops.attention(q, k, v, return_lse=True),
                                    ref.attention_ref_lse(q, k, v))
    torch.cuda.synchronize()
    # fp32 max and sum of exponentials on both sides from the same bf16
    # scores (O(1) here): 1e-3 absolute
    err = (lse - want).abs().max().item()
    check(err <= 1e-3, f"flash_attention {shape}: lse max err {err} > 1e-3")
    check(torch.equal(out, ops.attention(q, k, v)), f"flash_attention {shape}: the output "
          "with lse differs from the output without")
    ms, _ = bench_ms(lambda q, k, v: ops.attention(q, k, v, return_lse=True), sets, 50)
    log(f"[kernel] flash_attention {shape} return_lse: lse max_abs_err={err:.3g} (tol 1e-3) "
        f"ms={ms:.4f} sdpa_ms={sdpa_ms:.4f} bound_ms={fwd_bound_ms:.4f}")
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    g = torch.Generator(device="cuda").manual_seed(9)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(FlashAttention.apply(*qkv, True), qkv, do)
    cpu = [t.detach().float().cpu().requires_grad_(True) for t in (q, k, v)]
    ref_grads = torch.autograd.grad(FlashAttention.apply(*cpu, True), cpu, do.float().cpu())
    # bf16 inputs, P rounded to bf16 in the kernel's forward, bf16 outputs:
    # bounded at 2% of each gradient's largest entry
    errs = [((a.float().cpu() - b).abs().max() / b.abs().max()).item()
            for a, b in zip(got, ref_grads)]
    check(max(errs) <= 0.02, f"FlashAttention {shape}: (dq, dk, dv) relative errs {errs}")

    def fwd_bwd(q, k, v, fn):
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        torch.autograd.grad(fn(*qkv), qkv, do)

    bwd_ms, _ = bench_ms(lambda q, k, v: fwd_bwd(q, k, v, lambda *t: FlashAttention.apply(
        *t, True)), sets, 10)
    gqa = q.shape[1] != k.shape[1]
    lib_ms, _ = bench_ms(lambda q, k, v: fwd_bwd(q, k, v, lambda *t: F.scaled_dot_product_attention(
        *t, is_causal=True, enable_gqa=gqa)), sets, 10)
    # forward + backward: q, k, v read and o written, then q, k, v, o, dO read
    # and dq, dk, dv written (bf16); the forward's two products and the
    # backward's five (S and dP recomputed, dV, dQ, dK) on the causal pairs
    b, hq, s_len, d = q.shape
    nq, nkv = q.numel(), k.numel()
    pairs = s_len * (s_len + 1) // 2
    b_ms, b_by = bound(roofline.KernelCost(7 * 2.0 * b * hq * d * pairs, (6 * nq + 6 * nkv) * 2,
                                           "bf16"))
    log(f"[kernel] FlashAttention {shape} forward + backward (kernel forward, torch-op "
        f"backward): (dq, dk, dv) max err / max |grad| {[round(e, 5) for e in errs]} (tol "
        f"0.02) ms={bwd_ms:.4f} sdpa_fwd_bwd_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")


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
        sets = copies_past_l2(lambda i, b=b, seq=seq, di=di, ds=ds, dtype=dtype:
                              _ssm_inputs(b, seq, di, ds, dtype, 10 * i + 20),
                              int(ssm_mod.cost(b, seq, di, ds, item).bytes))
        got, want = ops.selective_scan(*sets[0]), ref.ssm_scan_ref(*sets[0])
        with_tape = ssm_scan_with_tape(*sets[0])[0]
        torch.cuda.synchronize()
        # the tape's stores leave y's arithmetic alone: the same bits, and a
        # hash to hold against another checkout's forward on these inputs
        check(torch.equal(with_tape, got), f"ssm_scan b{b} L{seq}: y differs with the tape")
        digest = hashlib.sha1(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                              .cpu().numpy().tobytes()).hexdigest()[:16]
        err = (got.float() - want.float()).abs().max().item()
        tol = (2 * 2 ** -8 if dtype == torch.bfloat16 else 1e-4) * want.float().abs().max().item()
        check(bool(torch.isfinite(got).all()), f"ssm_scan b{b} L{seq}: non-finite output")
        check(err <= tol, f"ssm_scan b{b} L{seq} di{di} ds{ds} {dtype}: max err {err} > {tol}")
        ms, enqueue = bench_ms(lambda *a: ops.selective_scan(*a), sets, 50)
        plain, _ = bench_ms(ref.ssm_scan_ref, sets, plain_iters)
        b_ms, b_by = bound(ssm_mod.cost(b, seq, di, ds, item))
        # the exponentials alone, at the special-function unit's 16 a clock per SM
        exp_floor = b * seq * di * ds / (16 * sms * SPIN_CYCLES_PER_S) * 1e3
        log(f"[kernel] ssm_scan b{b} L{seq} di{di} ds{ds} {str(dtype)[6:]} "
            f"lanes={lanes_for(b, di, ds, sms)}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) ms={ms:.4f} enqueue_ms={enqueue:.4f} plain_ms={plain:.4f} "
            f"library=none bound_ms={b_ms:.4f} ({b_by}) exp_floor_ms={exp_floor:.4f}; y the "
            f"same bits with the tape, sha1 {digest}")
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


BWD_NAMES = ("dx", "ddt", "db", "dc", "da", "dd")


def _scan_bwd_bound(b, seq, di, ds, item) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, the exponentials' time, the bound with
    the checkpoint tape) of the backward from its inputs. The bound is the
    larger of the function's bytes (x, Δ, B, C, dy, A, D read once; dx, dΔ,
    dB, dC, dA, dD written once) over the memory rate, its fp32 operations
    (``ssm_scan.SSM_BWD_FLOPS``, ``ssm_scan.bwd_cost``) over the fp32 peak,
    and its exponentials, one
    per (position, channel, state), at the special-function unit's 16 a
    clock per SM. Beside it, the same with the design's checkpoint tape
    (``bwd_work_shapes``' "h_ckpt", written by the forward and read back)
    added to the bytes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tape = int(np.prod(bwd_work_shapes(b, seq, di, ds)["h_ckpt"])) * 4
    cost = ssm_mod.bwd_cost(b, seq, di, ds, item)
    exp_ms = b * seq * di * ds / (16 * sms * SPIN_CYCLES_PER_S) * 1e3
    b_ms, b_by = bound(cost)
    if exp_ms > b_ms:
        b_ms, b_by = exp_ms, "operations"
    return b_ms, b_by, exp_ms, max(b_ms, (cost.bytes + 2 * tape) / HW.hbm_bandwidth * 1e3)


def device_ms_by_kernel(fn, args, iters: int, names) -> dict[str, float | None]:
    """Mean device ms a call of ``fn(*args)`` of each CUDA kernel whose
    name holds one of ``names``, from ``torch.profiler`` over ``iters``
    calls; None where the profiler shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    out: dict[str, float | None] = {n: None for n in names}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for n in names:
            if re.search(n, ev.key) and us > 0:
                out[n] = (out[n] or 0.0) + us / 1e3 / iters
    return out


def check_ssm_bwd(rows: dict) -> None:
    """The scan's backward kernel against ``ssm_scan_bwd_ref`` on the same
    inputs. Tolerances: fp32 sums in another order and ex2.approx for exp,
    1e-4 of each gradient's largest entry; bf16 streams, the same fp32 walk
    from the same bf16 inputs with dx, dΔ, dB, dC rounded once to bf16 on
    each side (two bf16 ulps of the largest), dA and dD fp32 (1e-4). The
    forward's tape is held against the plain walk's states (1e-4 of the
    largest: ex2.approx), its y against y without the tape (bit for bit).
    Every case's gradients are the same bits in a second run and from the
    tape of every forward lane grouping. Times: the backward launch from a
    tape, the forward's time with and without the tape, the backward from
    its inputs (the forward with the tape, then the backward: the row's
    ms), and the profiler's split of the backward into its kernel and its
    sum step. Beside: the plain walk's time and torch autograd through the
    port's ``chunked_selective_scan`` (forward and backward), for scale."""
    cases = [(4, 256, 8192, 16, torch.bfloat16, 2),      # jamba's train step
             (4, 256, 8192, 16, torch.float32, 2),
             (2, 300, 1000, 16, torch.bfloat16, 3),      # ragged d_inner and L
             (1, 130, 200, 8, torch.float32, 3),         # d_state 8, ragged
             (1, 4000, 8192, 16, torch.bfloat16, 1)]     # B 1, long
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (b, seq, di, ds, dtype, plain_iters) in enumerate(cases):
        item = torch.tensor([], dtype=dtype).element_size()
        nbytes = (3 * b * seq * di + 2 * b * seq * ds) * item

        def make(i, b=b, seq=seq, di=di, ds=ds, dtype=dtype):
            return (*_ssm_inputs(b, seq, di, ds, dtype, 10 * i + 60),
                    randn((b, seq, di), dtype, 10 * i + 65))

        sets = copies_past_l2(make, nbytes)
        # the tape: y the same bits, the states the plain walk's
        y_plain = ssm_scan(*sets[0][:6])
        y, tape = ssm_scan_with_tape(*sets[0][:6])
        check(torch.equal(y, y_plain), f"ssm_scan b{b} L{seq}: y differs with the tape")
        want_tape = ref.ssm_scan_tape_ref(*sets[0][:3], sets[0][4], SEGMENT)
        check(tape is not None and tape.shape == want_tape.shape,
              f"ssm_scan b{b} L{seq}: tape {None if tape is None else tuple(tape.shape)}")
        tape_err = (tape - want_tape).abs().max().item() / want_tape.abs().max().item()
        check(tape_err <= 1e-4, f"ssm_scan b{b} L{seq}: tape vs the plain walk {tape_err}")
        del want_tape
        got = ssm_scan_bwd(*sets[0])
        want = ref.ssm_scan_bwd_ref(*sets[0])
        torch.cuda.synchronize()
        errs, abs_err = [], 0.0
        for name, g, w in zip(BWD_NAMES, got, want):
            check(bool(torch.isfinite(g).all()), f"ssm_scan_bwd {name}: non-finite")
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            tol = 2 * 2 ** -8 if g.dtype == torch.bfloat16 else 1e-4
            check(err <= tol * scale, f"ssm_scan_bwd b{b} L{seq} di{di} ds{ds} {dtype} "
                  f"{name}: max err {err} > {tol} x {scale}")
            errs.append(f"{name} {err / scale:.3g} (tol {tol:.3g})")
            abs_err = max(abs_err, err)
        del want
        check(all(torch.equal(g, h) for g, h in zip(got, ssm_scan_bwd(*sets[0]))),
              f"ssm_scan_bwd b{b} L{seq}: two runs differ")
        groupings = [n for n in LANE_CHOICES if 2 * n <= ds]
        for lanes in groupings:
            other = ssm_scan_bwd(*sets[0], tape=ssm_scan_with_tape(*sets[0][:6], lanes=lanes)[1])
            check(all(torch.equal(g, h) for g, h in zip(got, other)),
                  f"ssm_scan_bwd b{b} L{seq}: the tape of a {lanes}-lane forward differs")
        del got, other
        iters = 20 if seq * b * di < 2 ** 24 else 10
        taped = [(*s, ssm_scan_with_tape(*s[:6])[1]) for s in sets]
        bwd_ms, _ = bench_ms(lambda *a: ssm_scan_bwd(*a[:7], tape=a[7]), taped, iters)
        fwd_ms, _ = bench_ms(lambda *a: ssm_scan(*a[:6]), sets, iters)
        fwd_tape_ms, _ = bench_ms(lambda *a: ssm_scan_with_tape(*a[:6]), sets, iters)
        ms, _ = bench_ms(ssm_scan_bwd, sets, iters)
        split = device_ms_by_kernel(lambda *a: ssm_scan_bwd(*a[:7], tape=a[7]), taped[0], 5,
                                    ("ssm_scan_bwd_kernel", "ssm_scan_bwd_sum_kernel"))
        del taped
        plain, _ = bench_ms(ref.ssm_scan_bwd_ref, sets, plain_iters)

        def chunked_fwd_bwd(x, dt, bb, c, a, d, dy):
            live = [t.detach().requires_grad_(True) for t in (x, dt, bb, c, a, d)]
            y, _ = chunked_selective_scan(*live)
            return torch.autograd.grad(y, live, dy.float())

        chunked = bench_ms(chunked_fwd_bwd, sets, 3)[0] if b * seq <= 1024 else None
        b_ms, b_by, exp_ms, tape_ms = _scan_bwd_bound(b, seq, di, ds, item)
        lanes, block_d, seg, stage = bwd_geometry(ds)
        attrs = bwd_kernel_attrs(ds, dtype, torch.device("cuda"))
        kern, summ = (f"{v:.4f}" if v is not None else "not measured" for v in split.values())
        log(f"[kernel] ssm_scan_bwd b{b} L{seq} di{di} ds{ds} {str(dtype)[6:]} lanes={lanes} "
            f"block_d={block_d} segment={seg} stage={stage} registers={attrs['registers']} "
            f"spill_bytes={attrs['spill_bytes']} smem={attrs['smem_bytes']} "
            f"blocks_per_sm={attrs['blocks_per_sm']}: max err / max |grad| "
            f"{'; '.join(errs)}; tape vs plain walk {tape_err:.3g} (tol 1e-4), y with the tape "
            f"bit-equal; bit-equal across 2 runs and the tapes of {groupings}-lane forwards; "
            f"ms={ms:.4f} from the inputs (forward with tape + backward); backward launch "
            f"{bwd_ms:.4f} (kernel {kern}, sum step {summ}; profiler), forward {fwd_ms:.4f}, "
            f"with tape {fwd_tape_ms:.4f} (tape overhead {fwd_tape_ms - fwd_ms:.4f}); backward + "
            f"tape overhead {bwd_ms + fwd_tape_ms - fwd_ms:.4f}; plain_ms={plain:.4f} "
            f"chunked_autograd_ms={'not measured' if chunked is None else f'{chunked:.4f}'} "
            f"library=none bound_ms={b_ms:.4f} ({b_by}; exponentials {exp_ms:.4f}) "
            f"bound_with_tape_ms={tape_ms:.4f} ({ms / b_ms:.1f}x the bound from the inputs, "
            f"{(bwd_ms + fwd_tape_ms - fwd_ms) / b_ms:.1f}x as backward + tape overhead)")
        if idx == 0:
            rows["ssm_scan_bwd"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain,
                                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del sets
        gc.collect()
        torch.cuda.empty_cache()
    # a row alone gives the bits it gives in the batch
    args = make(0, 4, 100, 8192, 16, torch.bfloat16)
    full = ssm_scan_bwd(*args)
    row = ssm_scan_bwd(*(t[1:2].contiguous() for t in args[:4]), *args[4:6],
                       args[6][1:2].contiguous())
    check(all(torch.equal(g[1:2], r) for g, r in zip(full[:4], row[:4])),
          "ssm_scan_bwd: a row alone differs from the row in its batch")
    log("[kernel] ssm_scan_bwd batch-row isolation: row 1's dx, dΔ, dB, dC alone equal "
        "the batch's")


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


# -- the bsps path: the paper's §3.1 and §3.2 algorithms ---------------------------------


def cyclic_inner_product() -> None:
    """Algorithm 1 on p = 16 cores (Epiphany-III's count): each vector of
    2^26 fp32 dealt out cyclically (``create_cyclic``), 2^22 components a
    core in 16 tokens of 2^18; each hyperstep sums ``ops.dot`` over the 16
    cores' tokens. Both execution modes, priced on the calibrated 16-core
    pack."""
    p, n, c = 16, 1 << 26, 1 << 18
    machine = default_machine(p, device="cuda")
    rng = np.random.default_rng(6)
    v = rng.standard_normal(n, dtype=np.float32)
    u = rng.standard_normal(n, dtype=np.float32)
    want = float(np.dot(v.astype(np.float64), u.astype(np.float64)))
    tol = 1e-6 * float(np.abs(v.astype(np.float64) * u).sum())
    eq1 = machine.flops_to_seconds(inner_product_cost(machine, n, c))
    for compiled in (False, True):
        ss = StreamSet()
        vs, us = ss.create_cyclic(v, p, c, name="v"), ss.create_cyclic(u, p, c, name="u")
        per_core = [[vs[s], us[s]] for s in range(p)]
        runner = HyperstepRunner(
            lambda acc, t: acc + sum(ops.dot(t[0][s], t[1][s]) for s in range(p)), per_core,
            cores=p, plan=host_plan(per_core[0], flops_per_hyperstep=2.0 * c, name="cyclic_ip"),
            machine=machine)
        got = float(runner.run(torch.zeros((), device="cuda"), compiled=compiled))
        row = runner.predicted_vs_measured()
        mode = "compiled" if compiled else "measure"
        check(abs(got - want) <= tol, f"cyclic inner product ({mode}) {got} vs {want}")
        check(row["fetch_words_planned"] == row["fetch_words_measured"],
              f"cyclic inner product words {row}")
        log(f"[bsps] cyclic inner product mode={mode} p={p} n={n} C={c} "
            f"({vs[0].num_tokens} tokens a core): alpha={got:.6g} ref={want:.6g} (tol "
            f"{tol:.3g}) inner_product_cost={eq1:.6g} s (Eq. 1) row={json.dumps(row)}")


def cannon_reference(a: torch.Tensor, b: torch.Tensor, m_blocks: int):
    """The fp64 product of the stored operands on the card (a check, not the
    path), max(|A|·|B|), and for bf16 operands a bound on each element's
    error in a bf16 run, from the magnitudes its roundings act on.

    The run forms each of C's outer blocks as P_0 + P_1 + ... + P_{M-1}
    (P_s = A_is·B_sj, s in the plan's order) with a bf16 accumulator: the
    kernel sums each P_s's K terms in fp32 (within K·2^-23·(|A|·|B|)_s,
    an ulp an addition, so a truncating adder is covered too) and rounds
    it to bf16 (u·|P_s|, u = 2^-8), and the accumulator rounds each partial
    sum S_s = P_0 + ... + P_s, s ≥ 1 (u·|S_s|). Carried through the M
    additions, each element's error is at most
    (1 + u)^(2M)·(u·(Σ_s |P_s| + Σ_{s≥1} |S_s|) + γ_K·Σ_s (|A|·|B|)_s),
    γ_K = K·2^-23 / (1 - K·2^-23), with the P_s and S_s of that element."""
    n = a.shape[0]
    big = n // m_blocks
    ad, bd = a.to("cuda", torch.float64), b.to("cuda", torch.float64)
    want = torch.zeros((n, n), dtype=torch.float64, device="cuda")
    absab = torch.zeros_like(want)
    magnitudes = torch.zeros_like(want) if a.dtype == torch.bfloat16 else None
    for s in range(m_blocks):
        # every outer block (i, j) adds its P_s in the same order s = 0 .. M-1
        cut = slice(s * big, (s + 1) * big)
        part = ad[:, cut] @ bd[cut, :]
        want += part
        absab += ad[:, cut].abs() @ bd[cut, :].abs()
        if magnitudes is not None:
            magnitudes += part.abs_()
            if s:
                magnitudes += want.abs()
        del part
    del ad, bd
    scale = absab.max().item()
    if magnitudes is None:
        return want, scale, None
    u, gamma = 2.0**-8, big * 2.0**-23 / (1 - big * 2.0**-23)
    bnd = magnitudes.mul_(u).add_(absab, alpha=gamma).mul_((1 + u) ** (2 * m_blocks))
    return want, scale, bnd


def cannon_runs(rate_f32: float) -> None:
    """Two-level Cannon (Algorithm 2), n = 16384, M = 4 (K = 4096): N = 1
    (the card as one core) and N = 4 (16 virtual cores, k = 1024), fp32 and
    bf16, measure and compiled mode: 8 runs of 64 hypersteps, 8.8 TFLOP
    each. A and B: standard normal fp32 from a seed (1 GiB each), in pinned
    host memory, the bf16 runs on their rounded copies. C is held against
    the fp64 product of the same operands (:func:`cannon_reference`): fp32
    within 1e-4 of max(|A|·|B|), bf16 within each element's bound. A ninth
    run repeats fp32 N = 1 in measure mode from the pageable numpy arrays,
    to show what staging them costs the fetch."""
    n, m_blocks = 16384, 4
    rng = np.random.default_rng(7)
    pageable = [rng.standard_normal((n, n), dtype=np.float32) for _ in range(2)]
    host = {torch.float32: [torch.from_numpy(x).pin_memory() for x in pageable]}
    host[torch.bfloat16] = [t.to(torch.bfloat16).pin_memory() for t in host[torch.float32]]
    base = {}
    for dtype, (a, b) in host.items():
        want, scale, bnd = cannon_reference(a, b, m_blocks)
        tol = 1e-4 * scale
        for n_grid in (1, 4):
            machine = default_machine(n_grid * n_grid, device="cuda")
            for compiled in (False, True):
                name = (f"{str(dtype)[6:]} N={n_grid} "
                        f"{'compiled' if compiled else 'measure'}")
                c_dev = cannon_run(a, b, m_blocks, n_grid, machine, compiled, rate_f32, name)
                check(bool(torch.isfinite(c_dev).all()), f"cannon {name}: non-finite C")
                diff = (c_dev.double() - want).abs()
                err = diff.max().item()
                if bnd is None:
                    check(err <= tol, f"cannon {name}: max|C - C64| {err} > {tol}")
                    held = f"tol {tol:.4g}, 1e-4·max(|A|·|B|) = 1e-4·{scale:.6g}"
                else:
                    worst = (diff / bnd).max().item()
                    check(worst <= 1.0, f"cannon {name}: |C - C64| past its bound, "
                          f"{worst} of it at worst")
                    held = (f"each element within its bound: at worst {worst:.3g} of it; "
                            f"bound max {bnd.max().item():.4g}, median "
                            f"{bnd.median().item():.4g}; max(|A|·|B|)={scale:.6g}")
                del diff
                first = base.setdefault(dtype, c_dev)
                rel = ((c_dev.float() - first.float()).abs().max()
                       / first.float().abs().max()).item()
                if dtype == torch.float32:
                    check(rel <= 1e-5, f"cannon {name}: {rel} from the N=1 measure run")
                log(f"[bsps] cannon {name}: max|C - C64|={err:.4g} ({held}); "
                    f"max|C - C(N=1 measure)| / max|C|={rel:.3g}")
        if dtype == torch.float32:
            # the same run from the numpy arrays themselves: pageable host
            # memory, which the measure-mode lanes pin token by token
            c_dev = cannon_run(*pageable, m_blocks, 1, default_machine(1, device="cuda"),
                               False, rate_f32, "float32 N=1 measure (pageable numpy operands)")
            check(torch.equal(c_dev, base[dtype]), "cannon from numpy operands differs")
        del want, bnd
        base.pop(dtype)
        gc.collect()
        torch.cuda.empty_cache()


def cannon_run(a, b, m_blocks, n_grid, machine, compiled, rate_f32, name):
    """One run: build and verify the runner, run its 64 hypersteps, hold the
    word counts and launches, print Eq. 2 beside the measurement; returns C
    on the card.

    The verify must find no fault. Its one allowed finding is BSPS162, a
    warning that the plan's exact and closed-form pricing give opposite
    verdicts: the closed form charges a C write-back every hyperstep, the
    exact walk once an outer product, and at N = 4 the compute side is
    mostly 64·N·l, so the verdict flips for a calibrated l in a narrow
    range. Both verdicts are printed."""
    n = a.shape[0]
    k = n // (m_blocks * n_grid)
    runner, outs, state0 = make_cannon_runner(a, b, m_blocks, n_grid=n_grid,
                                              machine=machine, compiled=compiled)
    diags = runner.verify(m_blocks**3)
    check(all(d.code == "BSPS162" for d in diags), f"cannon {name}: verify {diags}")
    variant = "simt_f32" if runner.plan.inputs[0].dtype == torch.float32 else "wgmma"
    before = counts_now()
    t0 = time.perf_counter()
    runner.run(state0, num_hypersteps=m_blocks**3, compiled=compiled)
    wall = time.perf_counter() - t0
    used = {key: v - before[key] for key, v in counts_now().items()}
    check(used[f"streamed_matmul.{variant}"] == used["streamed_matmul"] == m_blocks**3,
          f"cannon {name}: launches {used}")
    plan = runner.plan
    check(runner.total_fetch_words == sum(plan.fetch_schedule()),
          f"cannon {name}: fetched {runner.total_fetch_words}")
    for recs in runner.core_records:
        check(sum(r.writeback_words for r in recs) == k * k * m_blocks**2,
              f"cannon {name}: write-back words")
        if not compiled:
            check(len(recs) == m_blocks**3 and all(r.fetch_words == 2 * k * k for r in recs[:-1]),
                  f"cannon {name}: per-hyperstep fetch words")
    row = runner.predicted_vs_measured()
    # Eq. 2 again with the compute priced at the measured fp32 rate (the
    # pack's r is a bf16 rate); e and l keep their seconds
    ratio = rate_f32 / machine.r
    pack32 = dataclasses.replace(machine, r=rate_f32, e=machine.e * ratio, l=machine.l * ratio)
    runner.machine = pack32
    pred32 = runner.predicted_seconds()
    runner.machine = machine
    # the two sides of Eq. 2's max for one hyperstep at this k, in FLOP
    work = n_grid * (2.0 * k**3 + 2.0 * k**2 * machine.g + machine.l)
    link = 2.0 * k**2 * machine.e
    rec = runner.records
    # the measured verdict is a majority vote of the hypersteps that moved
    # words, each voting fetch + write-back against compute
    moved = [r for r in rec if r.fetch_words or r.writeback_words] or rec
    votes = (f"{sum(r.bandwidth_heavy for r in moved)} of {len(moved)} hypersteps vote "
             f"bandwidth-heavy; per hyperstep median compute "
             f"{np.median([r.compute_seconds for r in moved]) * 1e3:.3f} ms, fetch "
             f"{np.median([r.fetch_seconds for r in moved]) * 1e3:.3f} ms, write-back "
             f"{np.median([r.writeback_seconds for r in moved]) * 1e3:.3f} ms")
    log(f"[bsps] cannon {name}: k={k}, 64 hypersteps, wall {wall:.3f} s; "
        f"predicted_vs_measured={json.dumps(row)}; Eq. 2 at the fp32 rate "
        f"{rate_f32 / 1e12:.2f} TFLOP/s: {pred32:.6g} s (bandwidth_heavy "
        f"{plan.bandwidth_heavy(pack32)}); cannon_k_equal(pack, N={n_grid})="
        f"{cannon_k_equal(machine, n_grid):.6g} vs k={k}; pack p={machine.p} "
        f"e={machine.e:.6g} l={machine.l:.6g} ({machine.flops_to_seconds(machine.l) * 1e3:.4g} "
        f"ms); a hyperstep's N(2k³+2k²g+l)={work:.4g} vs 2k²e={link:.4g} FLOP; plan "
        f"bandwidth_heavy={plan.bandwidth_heavy(machine, exact=True)} (exact walk), "
        f"{plan.bandwidth_heavy(machine, exact=False)} (closed form); measured compute "
        f"{sum(r.compute_seconds for r in rec):.4f} s, "
        f"fetch {sum(r.fetch_seconds + r.initial_fetch_seconds for r in rec):.4f} s, "
        f"fetch wait {sum(r.fetch_wait_seconds for r in rec):.4f} s, write-back "
        f"{sum(r.writeback_seconds for r in rec):.4f} s; {votes}; launches "
        f"{used['streamed_matmul']} {variant}; verify: {[d.code for d in diags] or 'clean'}")
    c = torch.as_tensor(gather_c(outs, n, m_blocks, n_grid)).to("cuda")
    del runner, outs
    return c


def bsps_path(rate_f32: float) -> None:
    cyclic_inner_product()
    cannon_runs(rate_f32)


# -- the mesh path: the mesh-bound modules over a world-1 nccl group ---------------------


def _train_losses(cfg, compiled: bool, machine, mesh) -> tuple[list, list, dict, float]:
    """``train()`` on the card from seed 0, 4 steps of B 4 x S 256 synthetic
    batches (seed 0), AdamW on WSD (peak 2e-3, warmup 8), under ``mesh`` or
    none: the losses, the step walls (per step in the host loop, the
    segment's average compiled), the launches and the run's wall."""
    opt = AdamW(wsd(peak_lr=2e-3, warmup=8, total=100))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=4, seed=0)
    before = counts_now()
    t0 = time.perf_counter()
    out = train_loop.train(cfg, train_loop.TrainConfig(steps=4, log_every=1000, compiled=compiled),
                           opt, data_cfg=data, machine=machine, mesh=mesh, log=lambda _: None,
                           device="cuda")
    wall = time.perf_counter() - t0
    hist = out["history"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return ([h["loss"] for h in hist], [h["step_seconds"] for h in hist],
            {k: v - before[k] for k, v in counts_now().items()}, wall)


def mesh_train(machine, mesh) -> None:
    """minicpm-2b at full width and depth, ``train(mesh=...)`` on the (data=1,
    model=1) mesh against ``train(mesh=None)``, 4 steps in each execution
    mode: the losses equal bit for bit and the launches equal (at one rank
    every gather, reduction and placement is an identity)."""
    cfg = get_config("minicpm-2b")
    for compiled in (True, False):
        mode = "compiled" if compiled else "host loop"
        plain = _train_losses(cfg, compiled, machine, None)
        meshed = _train_losses(cfg, compiled, machine, mesh)
        check(all(np.isfinite(plain[0])), f"mesh ({mode}): losses {plain[0]}")
        check(meshed[0] == plain[0],
              f"mesh ({mode}): train(mesh) losses {meshed[0]} != train(mesh=None) {plain[0]}")
        check(meshed[2] == plain[2],
              f"mesh ({mode}): launches {meshed[2]} != mesh=None's {plain[2]}")
        ratios = [m / p for m, p in zip(meshed[1], plain[1])]
        log(f"[mesh] train {mode}: minicpm-2b {cfg.num_layers} layers, 4 steps, losses equal "
            f"bit for bit {[round(x, 4) for x in plain[0]]}; step wall ms mesh "
            f"{[round(x * 1e3, 1) for x in meshed[1]]} vs none "
            f"{[round(x * 1e3, 1) for x in plain[1]]}, ratio {[round(r, 4) for r in ratios]} "
            f"(median {float(np.median(ratios)):.4f}); run wall {meshed[3]:.1f} s vs "
            f"{plain[3]:.1f} s (with the init and placement); launches "
            f"{json.dumps(meshed[2])}")


def mesh_cannon(mesh) -> None:
    """``cannon_matmul`` on the 1×1 mesh against the bare local product at
    4096³, bf16 (wgmma) and fp32 (simt_f32), bit for bit; two-level Cannon
    with ``mesh=`` against ``mesh=None`` at n 4096, M 4, N 1."""
    from repro_torch.distributed.cannon import cannon_matmul, two_level_cannon
    from repro_torch.models.layers import ops_matmul

    for dtype in (torch.bfloat16, torch.float32):
        a, b = randn((4096, 4096), dtype, 61), randn((4096, 4096), dtype, 62)
        c = cannon_matmul(a, b, mesh=mesh)
        want = ops_matmul(a, b)
        check(torch.equal(c.to_local(), want) and tuple(c.shape) == (4096, 4096),
              f"cannon_matmul {dtype} on the 1x1 mesh differs from the local product")
        log(f"[mesh] cannon_matmul 4096^3 {dtype} on the 1x1 mesh: bit for bit the local "
            f"product ({matmul_variant(lambda: ops_matmul(a, b))[1]})")
    rng = np.random.default_rng(63)
    a = rng.standard_normal((4096, 4096)).astype(np.float32)
    b = rng.standard_normal((4096, 4096)).astype(np.float32)
    c_mesh, _ = two_level_cannon(a, b, 4, mesh=mesh, device="cuda")
    c_none, _ = two_level_cannon(a, b, 4, device="cuda")
    check(np.array_equal(c_mesh, c_none), "two_level_cannon(mesh=) differs from mesh=None")
    err = float(np.abs(c_mesh.astype(np.float64) - a.astype(np.float64) @ b).max())
    check(err < 1e-2, f"two_level_cannon: max error {err} against the fp64 product")
    log(f"[mesh] two_level_cannon n 4096 M 4 N 1: mesh= equals mesh=None bit for bit; "
        f"max error {err:.3g} against fp64")


def mesh_pipeline(mesh) -> None:
    """``pipeline_apply`` at one stage (the model axis) against the stage
    applied directly, bit for bit: 6 microbatches of (256, 2304) bf16."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models.layers import ops_matmul

    w = randn((1, 2304, 2304), torch.bfloat16, 64, scale=2304 ** -0.5)
    xs = randn((6, 256, 2304), torch.bfloat16, 65)
    stage = lambda p, x: torch.tanh(ops_matmul(x, p))  # noqa: E731
    out = pipeline_apply(stage, w, xs, mesh=mesh, axis="model")
    want = torch.stack([stage(w[0], x) for x in xs])
    check(torch.equal(out, want), "pipeline_apply at one stage differs from the stage")
    log("[mesh] pipeline_apply, 1 stage, 6 microbatches: bit for bit the stage applied directly")


def mesh_calibrate(machine) -> None:
    """``calibrate_host_level`` on the (host=1, data=1, model=1) mesh: one
    host, both terms 0."""
    from repro_torch.core.calibrate import calibrate_host_level
    from repro_torch.launch.mesh import make_host_core_mesh

    core_mesh = make_host_core_mesh(1)
    acc = calibrate_host_level(machine, core_mesh)
    check(core_mesh.shape == {"host": 1, "data": 1, "model": 1}
          and (acc.hosts, acc.g_host, acc.l_host) == (1, 0.0, 0.0),
          f"calibrate_host_level on {core_mesh.shape}: {acc}")
    log(f"[mesh] calibrate_host_level on {core_mesh.shape}: hosts {acc.hosts}, g_host "
        f"{acc.g_host}, l_host {acc.l_host}")


def mesh_checkpoint(mesh) -> None:
    """A sharded save of the 2-layer full-width minicpm-2b cut's training
    state (parameters and moments placed on the mesh) and ``restore`` with
    a ``sharder`` that places it again: the same files as an unsharded
    save, every restored shard equal to the saved one."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.shardspec import P

    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    n = M.count_params(cfg)
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    check(free >= 1.5 * 12 * n, f"mesh checkpoint: {free / 1e9:.1f} GB free under {root}")
    params = M.init_params(cfg, 0, device="cuda")
    opt = AdamW(wsd(peak_lr=2e-3, warmup=8, total=100))
    opt_state = opt.init(params)
    specs = sh.param_specs(cfg, mesh, params)
    state_specs = {"params": specs, "opt_state": {"m": specs, "v": specs, "step": P()}}
    state = {"params": sh.logical_to_sharding(mesh, params, specs),
             "opt_state": sh.logical_to_sharding(mesh, opt_state, state_specs["opt_state"])}
    del params, opt_state
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_mesh_", dir=root))
    try:
        t0 = time.perf_counter()
        ckpt.save(str(tmp), 1, state, data_state={"cursor": 1, "seed": 0})
        save_s = time.perf_counter() - t0
        names = sorted(f.name for f in (tmp / "step_00000001").iterdir())
        check(names == ["manifest.json", "opt_state.npz", "params.npz"],
              f"mesh checkpoint files {names}")
        t0 = time.perf_counter()
        got, data_state = ckpt.restore(
            str(tmp), 1, state,
            sharder=lambda g, tree: sh.logical_to_sharding(mesh, tree, state_specs[g]))
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a.to_local(), b.to_local())
                   for a, b in zip(leaves(got), leaves(state)))
        check(same and data_state == {"cursor": 1, "seed": 0},
              "mesh checkpoint: a restored shard differs from the saved one")
        written = sum(f.stat().st_size for f in (tmp / "step_00000001").iterdir())
        log(f"[mesh] sharded checkpoint of {n / 1e9:.3f} B params (2 layers): save "
            f"{save_s:.2f} s, {written / 1e9:.3f} GB ({', '.join(names)}); restore through a "
            f"sharder {restore_s:.2f} s; every shard equal")
        del got, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def mesh_path(machine) -> None:
    """The mesh-bound modules on the card: a world-1 ``nccl`` group, the
    (data=1, model=1) mesh over it, and every check above; the group is
    destroyed before this returns. No collective crosses ranks here: the
    machine has one card."""
    from repro_torch.distributed import group
    from repro_torch.launch.mesh import make_host_mesh

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    rdv = Path(tempfile.mkdtemp(prefix="rendezvous_", dir=root))
    group.start(0, 1, rendezvous_dir=str(rdv))
    try:
        check(torch.distributed.get_backend() == "nccl", "the card's rank group is not on nccl")
        mesh = make_host_mesh()
        check(mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is not None,
              f"the host mesh over the world-1 group: {mesh}")
        mesh_train(machine, mesh)
        mesh_cannon(mesh)
        mesh_pipeline(mesh)
        mesh_calibrate(machine)
        mesh_checkpoint(mesh)
    finally:
        group.end()
        shutil.rmtree(rdv, ignore_errors=True)


# -- the examples path: the port's examples on the card ----------------------------------


def examples_path() -> None:
    """Every example at its defaults, with its printed checks held here:
    quickstart's three demos (the third a train step of qwen2-moe-a2.7b's
    smoke config, its attention at head dim 16 on the flash kernel), serve_lm,
    serve_engine, train_lm, bsps_cannon and bsps_spmv."""
    from repro_torch.examples import (
        bsps_cannon,
        bsps_spmv,
        quickstart,
        serve_engine,
        serve_lm,
        train_lm,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    walls = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    before = counts_now()
    _, _, lm = run("quickstart", lambda: (quickstart.demo_cost_model(dev),
                                          quickstart.demo_bsps_program(dev),
                                          quickstart.demo_lm_step(dev)))
    step = {k: v - before[k] for k, v in counts_now().items() if v != before[k]}
    check(np.isfinite(lm["loss"]) and np.isfinite(lm["grad_norm"]) and lm["grad_norm"] > 0,
          f"quickstart's train step: loss {lm['loss']}, grad norm {lm['grad_norm']}")
    check(step.get("flash_attention.bf16.d16", 0) > 0 and step.get("streamed_matmul", 0) > 0,
          f"quickstart's train step launches {step}")
    rng = np.random.default_rng(0)
    v = rng.standard_normal(1 << 16).astype(np.float32)
    u = rng.standard_normal(1 << 16).astype(np.float32)
    got, _ = quickstart.inner_product(v, u, 4096, dev)
    want = float(np.dot(v.astype(np.float64), u))
    check(abs(got - want) <= 1e-4 * np.abs(v * u).sum(),
          f"quickstart: v·u {got} against numpy's {want}")
    out = run("serve_lm", lambda: serve_lm.main([]))
    check(out["cache_len"] == 96 and tuple(out["tokens"].shape) == (8, 64),
          f"serve_lm: cache len {out['cache_len']}, tokens {tuple(out['tokens'].shape)}")
    done = run("serve_engine", lambda: serve_engine.main([]))
    check(sorted(done) == list(range(6)), f"serve_engine: drained {sorted(done)}")
    tmp = Path(tempfile.mkdtemp(prefix="train_lm_", dir=ROOT / "build"))
    before = counts_now()
    try:
        hist = run("train_lm", lambda: train_lm.main(["--ckpt-dir", str(tmp)]))["history"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lm_flash = counts_now()["flash_attention.fp32.d64"] - before["flash_attention.fp32.d64"]
    losses = [h["loss"] for h in hist]
    check(len(losses) == 300 and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train_lm: {len(losses)} steps, loss {losses[0]} -> {losses[-1]}")
    layers = train_lm.make_config("10m").num_layers
    check(lm_flash == len(losses) * layers,
          f"train_lm: {lm_flash} fp32.d64 flash launches, not {len(losses)} x {layers}")
    log(f"[examples] train_lm: {len(losses)} fp32 steps in {walls['train_lm']:.2f} s, "
        f"{lm_flash} fp32.d64 flash launches, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    errs = run("bsps_cannon", lambda: bsps_cannon.main([]))
    check(all(e < 1e-2 for e in errs.values()), f"bsps_cannon: errors {errs}")
    err = run("bsps_spmv", lambda: bsps_spmv.main([]))
    check(err < 1e-3, f"bsps_spmv: error {err}")
    log(f"[examples] quickstart's train step (qwen2-moe-a2.7b smoke, bf16, head dim 16): "
        f"loss {lm['loss']:.4f}, moe_aux {lm['moe_aux']:.4f}, grad_norm {lm['grad_norm']:.4f}; "
        f"quickstart's launches {json.dumps(step)}")
    log(f"[examples] walls s {json.dumps({k: round(w, 2) for k, w in walls.items()})}")


# -- phase 4: the slice ------------------------------------------------------------------


def _cpu_fp32(tree):
    if isinstance(tree, dict):
        return {k: _cpu_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_fp32(v) for v in tree]
    return tree.float().cpu()


def host_available_bytes() -> int:
    """The host memory the kernel reports available (``MemAvailable``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def reference_check(name: str, **cut) -> None:
    """A 2-layer cut of ``name`` at full width on the card (bf16, kernels)
    against the same weights in float32 on the CPU (plain versions), by
    :func:`card_vs_cpu`. A cut whose fp32 weights would take more than half
    the host's available memory is not run, and the reckoning is printed."""
    cfg = dataclasses.replace(get_config(name), num_layers=2, **cut)
    n = M.count_params(cfg)
    avail = host_available_bytes()
    if 2 * 4 * n > avail:
        log(f"[reference] {name} 2 layers: not run on the CPU: {n / 1e9:.3f} B params are "
            f"{4 * n / 1e9:.1f} GB in fp32, more than half the host's {avail / 1e9:.1f} GB "
            f"available (the fp32 forward's temporaries come on top)")
        return
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(2))
    card_vs_cpu("reference", f"{name} 2 layers", cfg, toks)


def card_vs_cpu(tag: str, label: str, cfg, toks: torch.Tensor, rel_tol: float = 0.05) -> dict:
    """``cfg``'s forward on the card (its dtype, the kernels) against the
    same weights in float32 on the CPU (plain versions), on ``toks``: the
    logits finite and within ``rel_tol`` of the largest. The CPU's MoE
    layers take the routes the card's took (``moe.route_hook``): a near tie
    of the router between bf16 and fp32 would send a token to other experts.
    Returns the card forward's launches."""
    n = M.count_params(cfg)
    params = M.init_params(cfg, 0, device="cuda")
    routes: list[torch.Tensor] = []

    def record(probs, top_e):
        routes.append(top_e.cpu())
        return top_e

    before = counts_now()
    with moe_mod.route_hook(record):
        got = M.forward(cfg, params, toks.cuda(), device="cuda")[0].float().cpu()
    launched = {k: v - before[k] for k, v in counts_now().items() if v != before[k]}
    cpu = _cpu_fp32(params)
    del params
    torch.cuda.empty_cache()
    replay = iter(routes)
    with moe_mod.route_hook(lambda probs, top_e: next(replay)):
        want = M.forward(dataclasses.replace(cfg, dtype="float32"), cpu, toks, device="cpu")[0]
    check(next(replay, None) is None, f"{label}: the CPU forward routed fewer tokens")
    err = (got - want).abs().max().item()
    tol = rel_tol * want.abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits on the card")
    check(err <= tol, f"{label}: forward on the card vs fp32 CPU: {err} > {tol}")
    log(f"[{tag}] {label} {[(b.mixer, b.mlp) for b in cfg.pattern]}, "
        f"{n / 1e9:.3f} B params, card {cfg.dtype} vs cpu fp32 logits: "
        f"max_abs_err={err:.4g} (tol {tol:.4g})"
        + (f"; {len(routes)} MoE routings replayed on the CPU" if routes else ""))
    return launched


#: 2-layer cuts of the 8-layer smoke configs, each block kind once
SMOKE_CUTS = {"jamba-v0.1-52b": (Block("mamba", "moe"), Block("attn", "dense")),
              "xlstm-1.3b": (Block("mlstm", "none"), Block("slstm", "none"))}


def smoke_forwards() -> None:
    """Each config's smoke cut (random weights from seed 0, B 2 x S 64) on
    the card against its fp32 CPU forward (:func:`card_vs_cpu`), flash
    launched once an attention layer, at head dim 16 on the kernel built for
    it and 8 zero-padded to 16: in fp32 at full smoke depth (sums in another
    order: within 1e-3 of the largest logit), and in the smoke config's
    bf16 at two layers (jamba's and xlstm's 8 cut to each block kind once)
    within the 2-layer cuts' 5%."""
    for name in SMOKE:
        smoke = get_config(name, smoke=True)
        toks = torch.randint(0, smoke.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(3))
        for cfg, rel_tol in ((dataclasses.replace(smoke, dtype="float32"), 1e-3),
                             (dataclasses.replace(smoke, num_layers=2,
                                                  pattern=SMOKE_CUTS.get(name, smoke.pattern)),
                              0.05)):
            launched = card_vs_cpu("families", f"{name} smoke {cfg.num_layers} layers (head "
                                   f"dim {cfg.head_dim_})", cfg, toks, rel_tol)
            attn = sum(blk.mixer == "attn" for _, blk in cfg.blocks())
            run = flash_mod.variant_name(getattr(torch, cfg.dtype),
                                         flash_mod.kernel_head_dim(cfg.head_dim_))
            check(launched.get("flash_attention", 0) == attn
                  and launched.get(f"flash_attention.{run}", 0) == attn
                  and launched.get("streamed_matmul", 0) > 0,
                  f"{name} smoke forward launches {launched}, expected {attn} {run}")


def _loss_and_grads(cfg, params, batch, device):
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = M.loss_fn(cfg, live, batch["tokens"], batch["labels"], device=device)
    return float(loss.detach()), torch.autograd.grad(loss, leaves(live))


def train_reference_check() -> None:
    """A 2-layer full-width cut of minicpm-2b: the loss and every gradient
    leaf on the card (bf16; the matmul kernel forward and backward, the
    flash kernel forward, remat "full") against float32 autograd on the CPU
    through the plain versions, on the same weights and tokens."""
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    params = M.init_params(cfg, 0, device="cuda")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 129))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    loss, grads = _loss_and_grads(cfg, params, {k: v.cuda() for k, v in batch.items()}, "cuda")
    grads = [g.float().cpu() for g in grads]
    cpu = tree_map(lambda t: t.float().cpu(), params)
    del params
    torch.cuda.empty_cache()
    want_loss, want = _loss_and_grads(dataclasses.replace(cfg, dtype="float32"), cpu, batch,
                                      "cpu")
    # bf16 weights, activations and gradients against fp32 over two layers:
    # the loss (a mean over 256 positions) within 1%, each gradient leaf
    # within 5% of its largest entry
    errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(grads, want)]
    check(all(torch.isfinite(g).all() for g in grads), "train cut: non-finite gradients")
    check(abs(loss - want_loss) <= 0.01 * want_loss,
          f"train cut: loss {loss} on the card vs {want_loss} on the CPU")
    check(max(errs) <= 0.05, f"train cut: gradient errors {errs}")
    log(f"[reference] minicpm-2b 2 layers train: card bf16 loss {loss:.5f} vs cpu fp32 "
        f"{want_loss:.5f}; {len(errs)} gradient leaves, max err / max |grad| "
        f"{max(errs):.4g} (tol 0.05), median {float(np.median(errs)):.4g}")


def count_check() -> None:
    """A 2-layer full-width cut of minicpm-2b (bf16) counts the same work on
    the card as on the CPU (``roofline.count``): its forward and its train
    step at B 2 x S 64, the FLOPs, the bytes, the kernels' table and every
    torch op's, equal. On the CPU each kernel wrapper records its kernel's
    formula in place of its plain version's ops."""
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 65))
    counts = {}
    for device in ("cuda", "cpu"):
        params = M.init_params(cfg, 0, device=device)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device=device),
                 "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64, device=device)}
        with roofline.count() as fwd:
            make_prefill_step(cfg, device=device)(params, {"tokens": batch["tokens"]})
        opt = AdamW(wsd(peak_lr=2e-3, warmup=4, total=100))
        state = opt.init(params)
        step = make_train_step(cfg, opt, device=device)
        with roofline.count() as train:
            step(params, state, batch)
        counts[device] = (fwd, train)
        del params, state, step
        torch.cuda.empty_cache()
    for (card, cpu), what in zip(zip(counts["cuda"], counts["cpu"]), ("forward", "train step")):
        diff = {k: (card.ops.get(k), cpu.ops.get(k)) for k in set(card.ops) | set(cpu.ops)
                if card.ops.get(k) != cpu.ops.get(k)}
        check(card.flops == cpu.flops and card.bytes == cpu.bytes
              and card.kernels == cpu.kernels and not diff,
              f"2-layer minicpm-2b {what}: the card counts {card.flops} FLOPs, {card.bytes} "
              f"bytes, kernels {card.kernels}; the CPU {cpu.flops}, {cpu.bytes}, "
              f"{cpu.kernels}; ops that differ (card, CPU) {diff}")
        log(f"[roofline] 2-layer minicpm-2b {what} (B 2 x S 64): card and CPU count the same "
            f"{card.flops:.10g} FLOPs, {card.bytes:.10g} bytes, {card.launches} kernel calls "
            f"{json.dumps({k: v[0] for k, v in card.kernels.items()})}, "
            f"{sum(v[0] for v in card.ops.values())} torch ops")


def train_slice() -> dict:
    """minicpm-2b's train step at full width and depth (40 layers, bf16,
    remat "full"), B 4 x S 256, AdamW on MiniCPM's WSD schedule: 4 steps on
    one batch from a seed."""
    cfg = get_config("minicpm-2b")
    check(cfg.remat == "full" and cfg.dtype == "bfloat16", f"minicpm-2b: {cfg.remat}, {cfg.dtype}")
    batch, seq, steps = 4, 256, 4
    params = M.init_params(cfg, 0, device="cuda")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (batch, seq + 1))
    data = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device="cuda"),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64, device="cuda")}
    # warmup over the 4 steps to 2e-3: a bf16 parameter moves only by more
    # than half an ulp, and the last step's 2.2e-3 (update and decay) moves
    # the norm scales (1.0, ulp 2^-8 below) too
    opt = AdamW(wsd(peak_lr=2e-3, warmup=4, total=100))
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cuda")
    first = [p.clone() for p in leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, dev_ms, metrics, per_step = [], [], [], []
    for _ in range(steps):
        before = counts_now()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, state, m = step(params, state, data)
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dev_ms.append(start.elapsed_time(end))
        per_step.append({k: v - before[k] for k, v in counts_now().items()})
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    moved = sum(not torch.equal(a, b) for a, b in zip(first, leaves(params)))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"train losses {losses}")
    check(all(np.isfinite(norms)) and min(norms) > 0, f"train grad norms {norms}")
    check(moved == len(first), f"train: {len(first) - moved} of {len(first)} leaves unmoved")
    # per step: the forward's products, their recompute under remat (the
    # periods, not the head) and two backward products each; flash forward
    # and its recompute per layer; every product on wgmma (m = 1024 rows)
    # by layout: the forward's and the recompute's products (the head's with
    # E read as (n, k)), each dX = dC·Wᵀ with W read as (n, k) (the head's
    # dC·E plain), each dW = Xᵀ·dC with X read as (k, m)
    prods = products_per_forward(cfg)
    for c in per_step:
        check(c["streamed_matmul"] == c["streamed_matmul.wgmma"] == 4 * prods - 1
              and c["streamed_matmul.mk/kn"] == 2 * prods - 1
              and c["streamed_matmul.mk/nk"] == c["streamed_matmul.km/kn"] == prods
              and c["flash_attention"] == 2 * cfg.num_layers,
              f"train step launches {c}")
    wall = float(np.median(walls))
    log(f"[train] minicpm-2b {cfg.num_layers} layers remat={cfg.remat}, B {batch} x S {seq}, "
        f"AdamW wsd peak 2e-3: losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, lr {[m['lr'] for m in metrics]}; every one of "
        f"{len(first)} parameter leaves moved")
    log(f"[train] step wall median {wall * 1e3:.1f} ms (all {[round(w * 1e3, 1) for w in walls]}), "
        f"{batch * seq / wall:.0f} tokens/s, device ms per step (CUDA events) "
        f"{[round(d, 1) for d in dev_ms]}, max_memory_allocated {peak / 1e9:.2f} GB")
    log(f"[train] launches per step: {json.dumps(per_step[-1])} (products per forward {prods})")
    roofline_run("minicpm-2b train step (B 4 x S 256)", lambda: step(params, state, data), wall,
                 cfg, batch * seq, True)
    params, state = remat_dots_beside_full(cfg, opt, params, state, data, step, prods)
    del params, state, first, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"per_step": per_step[-1], "wall": wall}


def _loop(cfg, steps: int, compiled: bool, machine, faults=None,
          **kw) -> tuple[dict, list, dict]:
    """One ``train()`` run on the card from seed 0: B 4 x S 256 synthetic
    batches (seed 0), AdamW on WSD (peak 2e-3, warmup 8). Returns the
    result, the log lines and the launches the run made."""
    lines: list[str] = []
    opt = AdamW(wsd(peak_lr=2e-3, warmup=8, total=100))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=4, seed=0)
    before = counts_now()
    out = train_loop.train(
        cfg, train_loop.TrainConfig(steps=steps, log_every=1000, compiled=compiled, **kw),
        opt, data_cfg=data, machine=machine, log=lines.append, faults=faults, device="cuda")
    return out, lines, {k: v - before[k] for k, v in counts_now().items()}


def remat_dots_beside_full(cfg, opt, params, state, data, step, prods: int):
    """minicpm-2b's train step under remat "dots" beside "full", on the same
    weights and batch, five of each in turns (dots, full, full, dots, ...): each
    step's wall and peak memory, the launches of a "dots" step (3 matmul
    launches a product: the kept forward products are not launched again;
    flash twice a layer, its forward recomputed as under "full"), and the
    gradient half's peak above the resident weights and moments in each
    mode. Returns the stepped (params, state)."""
    steps = {"full": step,
             "dots": make_train_step(dataclasses.replace(cfg, remat="dots"), opt, device="cuda")}
    walls, peaks, per_step = {"full": [], "dots": []}, {"full": 0, "dots": 0}, {}
    for remat in ("dots", "full", "full", "dots") * 2 + ("dots", "full"):
        before = counts_now()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, m = steps[remat](params, state, data)
        torch.cuda.synchronize()
        walls[remat].append(time.perf_counter() - t0)
        peaks[remat] = max(peaks[remat], torch.cuda.max_memory_allocated())
        per_step[remat] = {k: v - before[k] for k, v in counts_now().items() if v != before[k]}
        check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])),
              f"train step under remat {remat}: loss {float(m['loss'])}")
    c = per_step["dots"]
    check(c["streamed_matmul"] == c["streamed_matmul.wgmma"] == 3 * prods
          and c["streamed_matmul.mk/kn"] == c["streamed_matmul.mk/nk"]
          == c["streamed_matmul.km/kn"] == prods
          and c["flash_attention"] == 2 * cfg.num_layers,
          f"remat dots train step launches {c}")
    grad_peaks, grads_gb = {}, {}
    for remat in ("full", "dots"):
        grads_of = make_grad_fn(dataclasses.replace(cfg, remat=remat), device="cuda")
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads, _ = grads_of(params, data)
        torch.cuda.synchronize()
        grad_peaks[remat] = torch.cuda.max_memory_allocated() - base
        grads_gb[remat] = (torch.cuda.memory_allocated() - base) / 1e9
        del grads
    med = {r: float(np.median(w)) * 1e3 for r, w in walls.items()}
    log(f"[train] remat dots beside full (same weights and batch, in turns): step wall "
        f"median dots {med['dots']:.1f} ms {[round(w * 1e3, 1) for w in walls['dots']]}, "
        f"full {med['full']:.1f} ms {[round(w * 1e3, 1) for w in walls['full']]} (dots/full "
        f"{med['dots'] / med['full']:.4f}); step peak max_memory_allocated dots "
        f"{peaks['dots'] / 1e9:.2f} GB, full {peaks['full'] / 1e9:.2f} GB; the gradient "
        f"half's peak above the resident {base / 1e9:.2f} GB dots {grad_peaks['dots'] / 1e9:.3f} "
        f"GB, full {grad_peaks['full'] / 1e9:.3f} GB (the gradients it returns {grads_gb['dots']:.3f} "
        f"and {grads_gb['full']:.3f} GB)")
    log(f"[train] remat dots launches per step: {json.dumps(c)} (3 x {prods} products)")
    return params, state


def _prefetch_depth(lines: list) -> int:
    """The prefetch depth the run's last re-pricing set (0: never started)."""
    found = re.findall(r"prefetch depth -> (\d+)", "\n".join(lines))
    return int(found[-1]) if found else 0


def train_loop_slice(machine, bare: dict) -> None:
    """The training loop (``repro_torch.train.loop.train``) on the card.

    (a) minicpm-2b at full width and depth (40 layers, bf16, remat "full"),
    8 steps in compiled mode and then, from a fresh seed-0 init, 8 steps of
    the host loop, no checkpoint directory: both losses falling, equal bit
    for bit between the modes (the same eager step on the same batches),
    each step launching what the bare step of ``train_slice`` launches, and
    the plan row's fetch words as planned. (b) the crash/resume drill at
    full width with the depth cut 40 -> 2 (a 4.9 GB checkpoint): 6 steps,
    a checkpoint every 3, in both modes; a dispatch failure mid-interval
    resumes once (BSPS212) and gives the uncrashed run's losses bit for
    bit. The uncrashed runs write no checkpoint (a checkpoint copies the
    state and changes no bit of it); one save and one restore of the last
    state are timed apart."""
    cfg = get_config("minicpm-2b")
    runs = {}
    for compiled in (True, False):
        t0 = time.perf_counter()
        out, lines, launched = _loop(cfg, 8, compiled, machine)
        wall = time.perf_counter() - t0
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        mode = "compiled" if compiled else "host loop"
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train loop ({mode}) losses {losses}")
        want = {k: 8 * v for k, v in bare["per_step"].items()}
        check(launched == want, f"train loop ({mode}) launches {launched}, 8 bare steps {want}")
        row = out["plan_row"]
        check(row["fetch_words_planned"] == row["fetch_words_measured"],
              f"train loop ({mode}) plan row {row}")
        steps_s = [h["step_seconds"] for h in hist]
        step_ms = float(np.median(steps_s)) * 1e3
        runs[compiled] = losses
        log(f"[train-loop] {mode}: minicpm-2b {cfg.num_layers} layers, 8 steps in {wall:.1f} s "
            f"(with the init; the run is priced on the calibrated pack): losses "
            f"{[round(x, 4) for x in losses]}")
        log(f"[train-loop] {mode}: step wall median {step_ms:.1f} ms "
            f"({'the run wall / 8' if compiled else 'per-step records'}; all "
            f"{[round(x * 1e3, 1) for x in steps_s]}), bare step median {bare['wall'] * 1e3:.1f} "
            f"ms, loop overhead {step_ms - bare['wall'] * 1e3:+.1f} ms a step; pred_over_meas "
            f"{row['pred_over_meas']:.4g} (predicted {row['predicted_seconds']:.4g} s, measured "
            f"{row['measured_seconds']:.4g} s), verdict predicted "
            f"{'bandwidth-heavy' if row['bandwidth_heavy_predicted'] else 'compute'} / measured "
            f"{'bandwidth-heavy' if row['bandwidth_heavy_measured'] else 'compute'}, fetch words "
            f"{row['fetch_words_measured']:.0f}; prefetch depth {_prefetch_depth(lines)}, "
            f"stragglers {out['stragglers']}, health {out['health']['count_by_code']}")
        per_step = {k: v // 8 for k, v in launched.items()}
        log(f"[train-loop] {mode}: launches per step {json.dumps(per_step)}")
        del out, hist
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[True] == runs[False],
          f"train loop: compiled losses {runs[True]} != host loop {runs[False]}")
    log("[train-loop] compiled and host-loop losses equal bit for bit")
    crash_drill(machine)


def crash_drill(machine) -> None:
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    n = M.count_params(cfg)
    ckpt_bytes = 4 * n * 3 + 4     # fp32 parameters and two fp32 moments, the step
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    # a run keeps at most two checkpoints; its directory goes before the next
    # run, and the timed save comes after the last
    check(free >= 2.5 * ckpt_bytes,
          f"crash drill: {free / 1e9:.1f} GB free under {root}, needs "
          f"{2.5 * ckpt_bytes / 1e9:.1f} GB")
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_drill_", dir=root))
    try:
        for compiled in (True, False):
            mode = "compiled" if compiled else "host loop"
            t0 = time.perf_counter()
            base, _, _ = _loop(cfg, 6, compiled, machine)
            base_s = time.perf_counter() - t0
            want = [h["loss"] for h in base["history"]]
            del base
            # compiled: the second dispatch (steps 3..5); host loop: the
            # dispatch of hyperstep 4 — after the step-3 checkpoint either way
            inj = FaultPlan([FaultSpec("dispatch_fail", at=(1 if compiled else 4,))]).replay()
            t0 = time.perf_counter()
            out, lines, _ = _loop(cfg, 6, compiled, machine, ckpt_dir=str(tmp / "crash"),
                                  ckpt_every=3, max_restarts=2, faults=inj)
            crash_s = time.perf_counter() - t0
            got = [h["loss"] for h in out["history"]]
            codes = out["health"]["count_by_code"]
            latest = ckpt.latest_step(str(tmp / "crash"))
            check(out["resumes"] == 1 and codes.get("BSPS212", 0) == 1,
                  f"crash drill ({mode}): resumes {out['resumes']}, health {codes}")
            check(got == want, f"crash drill ({mode}): losses {got} != uncrashed {want}")
            check(latest == 6, f"crash drill ({mode}): latest step {latest}")
            log(f"[train-loop] crash drill ({mode}): minicpm-2b 2 layers, {n / 1e9:.3f} B "
                f"params, 6 steps: uncrashed (no checkpoint) {base_s:.1f} s; checkpoint every "
                f"3, crashed at "
                f"dispatch {1 if compiled else 4} and resumed {out['resumes']}x (BSPS212 "
                f"{codes.get('BSPS212', 0)}) {crash_s:.1f} s; losses equal bit for bit "
                f"{[round(x, 4) for x in got]}; latest_step {latest}; "
                f"{[ln for ln in lines if ln.startswith('[resume] restored')]}")
            state = {"params": out["params"], "opt_state": out["opt_state"]}
            del out
            shutil.rmtree(tmp / "crash")
        # one save and one restore of the last state, timed: the copy to
        # host (snapshot) apart from the files' write
        t0 = time.perf_counter()
        snap = ckpt.snapshot(state)
        copy_s = time.perf_counter() - t0
        ckpt.save(str(tmp / "timed"), 6, snap, data_state={"cursor": 6, "seed": 0},
                  blocking=True)
        save_s = time.perf_counter() - t0
        del snap
        step_dir = tmp / "timed" / "step_00000006"
        written = sum(f.stat().st_size for f in step_dir.iterdir())
        want_params = [t.clone() for t in leaves(state["params"])]
        for t in leaves(state):
            t.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(str(tmp / "timed"), 6, state, copy_into=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(leaves(state["params"]), want_params)),
              "crash drill: restored parameters differ from the saved ones")
        log(f"[train-loop] checkpoint of {n / 1e9:.3f} B params: save {save_s:.2f} s (copy "
            f"to host {copy_s:.2f} s, then crc32, npz, fsync, rename), {written / 1e9:.3f} GB "
            f"written ({written / save_s / 1e9:.2f} GB/s); restore (read, crc32, copy to the "
            f"card) {restore_s:.2f} s; latest_step {ckpt.latest_step(str(tmp / 'timed'))}")
        del state, want_params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


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
    del fwd_logits
    # the roofline of the forward and of one decode step at batch 4, each
    # counted in one run beside its timed ones
    walls = [fwd_ms / 1e3] + timed_walls(lambda: step(params, {"tokens": prompt}), 2)
    roofline_run("minicpm-2b forward (B 4 x S 256)", lambda: step(params, {"tokens": prompt}),
                 float(np.median(walls)), cfg, batch * prompt_len, False)
    cache = M.init_cache(cfg, batch, prompt_len + 1, device="cuda")
    logits, cache = make_prefill(cfg, block, device="cuda")(params, cache, prompt)
    serve = make_serve_step(cfg, device="cuda")
    nxt = {"tokens": logits[:, -1:].argmax(-1)}
    # every call decodes position prompt_len from the same cache
    walls = timed_walls(lambda: serve(params, cache, nxt), 5)
    roofline_run("minicpm-2b decode step (batch 4)", lambda: serve(params, cache, nxt),
                 float(np.median(walls)), cfg, batch, False)
    del cache, logits
    log(f"[slice] launches per call: {json.dumps(counts)}")
    # every product of the forward and of generate's prefill (m = batch ·
    # block rows) took the wgmma variant, every decode product the m ≤ 16 one:
    # per layer q, k, v, o and the MLP's three, and the tied head
    mlp = products_per_forward(cfg)
    check(counts["prefill_step"]["streamed_matmul.wgmma"] == mlp
          and counts["prefill_step"]["streamed_matmul"] == mlp,
          f"minicpm forward matmul variants {counts['prefill_step']}")
    chunks = -(-prompt_len // block)
    for key in ("generate_compiled_first", "generate_compiled", "generate_measure"):
        c = counts[key]
        check(c["streamed_matmul.wgmma"] == mlp * chunks and c["streamed_matmul.wgmma_cp"] == 0
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


def batch_invariance_probe(cfg, params, lanes: int, pool: int) -> dict[str, float]:
    """Each op of a packed decode step on ``lanes`` rows against each row
    alone, as batch-1 decode runs it, at full width on the first layer's
    weights: the largest |difference| (0.0: the same bits). The ops marked
    "before" are the forms the port ran until the lanes were made
    batch-invariant: a one-row norm reduction and the batched cache
    products, measured for the record."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers

    g = torch.Generator(device="cuda").manual_seed(11)
    blk = params["stack"][0][0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    x = torch.randn((lanes, 1, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randn((lanes, hq, 1, hd), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((lanes, pool, hkv, hd), generator=g, device="cuda")
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    lens = torch.randint(1, pool, (lanes,), generator=g, device="cuda")

    def cache_read(q, k, v, n):
        return attn.dense_cache_attention(q, k, v, kv_valid_len=n)

    def einsum_read(q, k, v, n):   # before: batched products
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.float())

    row_ops = {
        "rmsnorm": lambda x: layers.apply_norm(cfg, blk["ln1"], x),
        "rmsnorm, one reduction per row (before)": lambda x: x.float().square().mean(-1),
        "q projection (matmul kernel)": lambda x: layers.ops_matmul(x, blk["mixer"]["wq"]),
        "mlp down (matmul kernel)": lambda x: layers.ops_matmul(
            x.repeat(1, 1, cfg.d_ff // cfg.d_model + 1)[..., :cfg.d_ff], blk["mlp"]["w_down"]),
        "tied head (matmul kernel, (n, k) B)": lambda x: layers.lm_head(cfg, params["embed"], x),
    }
    out = {}
    for name, fn in row_ops.items():
        full = fn(x)
        out[name] = max((fn(x[i:i + 1]) - full[i:i + 1]).float().abs().max().item()
                        for i in range(lanes))
    for name, fn in (("dense cache attention", cache_read),
                     ("cache products by einsum (before)", einsum_read)):
        full = fn(q, k, v, lens)
        out[name] = max((fn(q[i:i + 1], k[i:i + 1], v[i:i + 1], int(lens[i]))
                         - full[i:i + 1]).float().abs().max().item() for i in range(lanes))
    torch.cuda.synchronize()
    return out


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
    mlp = products_per_forward(cfg)
    for i, c in enumerate(per_segment):
        check(c["streamed_matmul.decode"] == c["streamed_matmul"] == mlp * eng.segment_len,
              f"engine segment {i}: matmul launches {c}")
    check(total["streamed_matmul.wgmma"] > 0 and total["streamed_matmul.decode"] > 0
          and total["streamed_matmul.wgmma_cp"] == total["streamed_matmul.decode_cp"]
          == total["streamed_matmul.decode_deep"] == 0,
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
    probe = batch_invariance_probe(cfg, params, eng.max_lanes, eng.pool_seq)
    log(f"[engine] batch invariance per op (largest |difference| of a row alone against "
        f"its row among {eng.max_lanes}; 0 is the same bits): {json.dumps(probe)}")
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
        # batch-1's greedy token, as generate takes it: the argmax (the first
        # of tied logits; topk may order a bf16 tie either way)
        want = torch.argmax(lg1, dim=-1).tolist()
        div = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        drifts = [((lg - lg1[n]).abs().max() / scale[n]).item() for n, lg in seen[rid]]
        picked = [got[n] == int(torch.argmax(lg)) for n, lg in seen[rid]]
        bitwise = [torch.equal(lg, lg1[n]) for n, lg in seen[rid]]
        if rid == checked[0]:
            ref, _ = generate(cfg, params, p[None], steps=new, machine=machine,
                              max_len=eng.pool_seq, device="cuda")
            upto = new if div is None else div + 1
            check(ref[0, len(prompt):len(prompt) + upto].tolist() == want[:upto],
                  "batch-1 teacher-forced decode disagrees with generate")
        check(div != 0, f"engine request {rid}: first token differs from batch-1's")
        # batch invariance: the lane's logits are batch-1's, bit for bit, at
        # every boundary, so every engine token is batch-1's greedy token (a
        # teacher-forced decode whose own argmax is always the token fed is
        # batch-1's free-running greedy decode, which is generate's)
        check(all(bitwise), f"engine request {rid}: lane logits differ from batch-1's at "
              f"boundaries {[n for (n, _), b in zip(seen[rid], bitwise) if not b]} "
              f"(largest drift {max(drifts):.4g}; ops: {json.dumps(probe)})")
        check(div is None, f"engine request {rid}: token {div} differs from batch-1's greedy "
              f"token")
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
            f"{len(drifts)} boundaries: bitwise equal {sum(bitwise)}/{len(bitwise)}, max drift "
            f"{max(drifts):.4g}; largest gap of an engine token below the batch-1 top "
            f"{max(gaps):.4g}")
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
    # the attention projections, the dense MLPs and the LM head: wgmma in the
    # forward, m ≤ 16 in decode
    dense = products_per_forward(cfg)
    check(fwd["streamed_matmul.wgmma"] == fwd["streamed_matmul"] == dense,
          f"jamba forward matmul variants {fwd}")
    for key in ("generate_compiled_first", "generate_compiled", "generate_measure"):
        c = counts[key]
        check(c["streamed_matmul.decode"] == c["streamed_matmul"] > 0,
              f"jamba {key}: matmul variants {c}")
    log(f"[jamba] make_prefill_step: ms={fwd_ms:.2f} (B {batch}, S {prompt_len})")
    walls = [fwd_ms / 1e3] + timed_walls(lambda: step(params, {"tokens": prompt}), 2)
    roofline_run(f"jamba-v0.1-52b forward ({cfg.num_layers} layers, B 4 x S 256)",
                 lambda: step(params, {"tokens": prompt}), float(np.median(walls)), cfg,
                 batch * prompt_len, False)
    # token-at-a-time prefill and decode: prompt_len + steps decode steps, the
    # decode variant one device launch per product
    log(f"[jamba] matmul device launches per decode step: "
        f"{counts['generate_compiled']['streamed_matmul.decode'] / (prompt_len + steps):g}")
    del logits

    # The forward against the token-at-a-time prefill on the same weights. At
    # the config's capacity factor 1.25 the decode step's capacity is
    # ceil(4·2/16·1.25) = 1 token per expert, so the two paths drop different
    # tokens by design (GShard); at 8.0 neither drops any. The paths round
    # differently (flash vs the dense cache read, the scan kernel vs the fp32
    # decode recurrence, bf16 rounding points), and top-2 routing turns a
    # near tie of the router into other experts, whose difference reaches
    # the last position through the Mamba state. So the prefill is fed the
    # routes the forward took (``moe.route_hook``) and its logits are held
    # to the forward's; the routes it takes on its own, their flips and the
    # router's margin at each flip are printed beside.
    cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    n_moe = sum(blk.mlp == "moe" for _, blk in cfg.blocks())
    k = cfg.moe_top_k

    def prefill_last(hook):
        with moe_mod.route_hook(hook):
            pre, _ = make_prefill(cfg8, 1, device="cuda")(
                params, M.init_cache(cfg8, batch, prompt_len, device="cuda"), prompt)
        return pre[:, -1].float()

    fwd_routes: list[torch.Tensor] = []               # per MoE layer, (B, S, k)

    def record(probs, top_e):
        fwd_routes.append(top_e.view(batch, prompt_len, k))
        return top_e

    with moe_mod.route_hook(record):
        last = make_prefill_step(cfg8, device="cuda")(params, {"tokens": prompt})[:, -1].float()
    check(len(fwd_routes) == n_moe, f"jamba: {len(fwd_routes)} routings in a forward")
    calls = iter(range(n_moe * prompt_len))

    def replay(probs, top_e):                         # call c: layer c % n, position c // n
        c = next(calls)
        return fwd_routes[c % n_moe][:, c // n_moe]

    pre = prefill_last(replay)
    check(next(calls, None) is None, "jamba: the prefill routed fewer tokens than the forward")
    err = (last - pre).abs().max().item()
    # over 8 layers bounded at 5% of the largest logit
    tol = 0.05 * pre.abs().max().item()
    agree = float((last.argmax(-1) == pre.argmax(-1)).float().mean())
    check(err <= tol, f"jamba forward vs token-at-a-time prefill on the forward's routes: "
          f"{err} > {tol}")

    own: list[tuple[torch.Tensor, torch.Tensor]] = []  # the prefill's routes and margins

    def own_routes(probs, top_e):
        top = torch.topk(probs, k + 1, dim=-1).values
        own.append((top_e, top[:, k - 1] - top[:, k]))
        return top_e

    free = prefill_last(own_routes)
    top2 = (last - free).abs().max().item()
    top2_agree = float((last.argmax(-1) == free.argmax(-1)).float().mean())
    # a flip in the first MoE layer comes from rounding alone; later layers
    # also take the flips of the layers before them, through the Mamba state
    flips, margins = [], []
    for j in range(n_moe):
        e = torch.stack([t for t, _ in own[j::n_moe]], 1)          # (B, S, k)
        gap = torch.stack([g for _, g in own[j::n_moe]], 1)        # (B, S)
        flip = (e.sort(-1).values != fwd_routes[j].sort(-1).values).any(-1)
        flips.append(int(flip.sum()))
        margins.append(round(gap[flip].max().item(), 4) if flip.any() else None)
    log(f"[jamba] last-position logits, forward vs generate's prefill at capacity factor 8 "
        f"on the forward's top-{k} routes: max_abs_diff={err:.4g} (tol {tol:.4g}), argmax "
        f"agreement {agree:.2f}; on the prefill's own routes: max_abs_diff={top2:.4g}, argmax "
        f"agreement {top2_agree:.2f}, tokens routed to other experts per MoE layer {flips} of "
        f"{batch * prompt_len}, widest router margin (k-th minus next probability) at a flip "
        f"per MoE layer {margins}")
    log(f"[jamba] launches per call: {json.dumps(counts)}")
    return counts


# -- jamba-v0.1-52b's train step -----------------------------------------------------


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float().cpu() - want)
                 / torch.linalg.vector_norm(want))


def jamba_train_reference() -> None:
    """A 2-layer cut of jamba at published widths (Mamba + MoE, attention +
    dense; 4 experts top-2), B 2 x S 64: the loss and every gradient leaf
    on the card in bf16 (the scan's kernels forward and backward, the
    matmul kernel forward and backward, the flash kernel forward) and in
    fp32 (the same kernels' fp32 paths, ``simt_f32``) against fp32 autograd
    on the CPU through the plain versions, every MoE layer on the routes of
    the bf16 run (``moe.route_hook``). fp32: sums in another order over
    4096- to 14336-term products and a 64-step recurrence, each leaf within
    1e-3 (relative L2). bf16 weights, activations and gradients against
    fp32: the loss within 1%, each leaf within 0.1 (relative L2; a one-period
    cut at smoke widths came within 0.02-0.061 over 8 layers)."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=2, moe_experts=4,
                              pattern=(Block("mamba", "moe"), Block("attn", "dense")))
    f32 = dataclasses.replace(cfg, dtype="float32")
    n = M.count_params(cfg)
    check(6 * 4 * n <= host_available_bytes(),
          f"jamba train cut: {n / 1e9:.3f} B fp32 params and their gradients do not fit the host")
    params = M.init_params(cfg, 0, device="cuda")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    routes: list[torch.Tensor] = []

    def grads_on(cfg, params, device, hook):
        with moe_mod.route_hook(hook):
            return _loss_and_grads(cfg, params, {k: v.to(device) for k, v in batch.items()},
                                   device)

    def record(probs, top_e):
        routes.append(top_e.cpu())
        return top_e

    def replay():
        it = iter(routes)
        return lambda probs, top_e: next(it).to(top_e.device)

    before = counts_now()
    loss, got = grads_on(cfg, params, "cuda", record)
    check(counts_now()["ssm_scan_bwd"] - before["ssm_scan_bwd"] == 1,
          "jamba train cut: the scan's backward kernel was not launched once")
    got = [g.float().cpu() for g in got]
    p32 = tree_map(lambda t: t.float(), params)
    del params
    loss32, got32 = grads_on(f32, p32, "cuda", replay())
    got32 = [g.cpu() for g in got32]
    cpu = tree_map(lambda t: t.cpu(), p32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    want_loss, want = grads_on(f32, cpu, "cpu", replay())
    e16 = [_rel_l2(g, w) for g, w in zip(got, want)]
    e32 = [_rel_l2(g, w) for g, w in zip(got32, want)]
    check(all(bool(torch.isfinite(g).all()) for g in got), "jamba train cut: non-finite grads")
    check(max(e32) <= 1e-3, f"jamba train cut: fp32 card gradients vs the CPU's {e32}")
    check(abs(loss - want_loss) <= 0.01 * want_loss,
          f"jamba train cut: loss {loss} on the card vs {want_loss} on the CPU")
    check(max(e16) <= 0.1, f"jamba train cut: bf16 card gradients vs fp32 {e16}")
    log(f"[jamba-train] reference: 2 layers {[(b.mixer, b.mlp) for b in cfg.pattern]}, "
        f"{cfg.moe_experts} experts, {n / 1e9:.3f} B params, B 2 x S 64, {len(routes)} MoE "
        f"routings replayed; loss card bf16 {loss:.5f} / fp32 {loss32:.5f} vs cpu fp32 "
        f"{want_loss:.5f}; {len(e16)} gradient leaves, relative L2 vs cpu fp32: bf16 max "
        f"{max(e16):.4g} (tol 0.1) median {float(np.median(e16)):.4g}, fp32 max "
        f"{max(e32):.3g} (tol 1e-3)")
    log(f"[jamba-train] reference: bf16 relative L2 per leaf {[round(e, 4) for e in e16]}")


def train_jamba() -> dict:
    """jamba-v0.1-52b's train step at ``card_train_config`` (8 layers, 4
    experts top-2, published widths; bf16, remat "full"), B 4 x S 256,
    AdamW on WSD: 4 steps on one batch from a seed, then the loss and
    gradients and the AdamW update timed apart."""
    cfg = card_train_config("jamba-v0.1-52b")
    check(cfg.remat == "full" and cfg.dtype == "bfloat16", f"jamba: {cfg.remat}, {cfg.dtype}")
    batch, seq, steps = 4, 256, 4
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    opt = AdamW(wsd(peak_lr=2e-3, warmup=4, total=100))
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (batch, seq + 1))
    data = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device="cuda"),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64, device="cuda")}
    step = make_train_step(cfg, opt, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    walls, dev_ms, losses, norms, per_step = [], [], [], [], []
    for _ in range(steps):
        before = counts_now()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, state, m = step(params, state, data)
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dev_ms.append(start.elapsed_time(end))
        per_step.append({k: v - before[k] for k, v in counts_now().items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)) and min(norms) > 0,
          f"jamba train losses {losses}, grad norms {norms}")
    # per step: 7 Mamba layers' scans forward and in the period's recompute
    # under remat "full", each backward once; flash forward and recompute;
    # every product on wgmma: the forward's (4 attention, 12 dense MLP, the
    # head), the recompute's (all but the head) and dX, dW of each
    prods = products_per_forward(cfg)
    for c in per_step:
        check(c["ssm_scan"] == 14 and c["ssm_scan_bwd"] == 7 and c["flash_attention"] == 2
              and c["streamed_matmul"] == c["streamed_matmul.wgmma"] == 4 * prods - 1,
              f"jamba train step launches {c}")
    grads_of = make_grad_fn(cfg, device="cuda")
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    start.record()
    grads, _ = grads_of(params, data)
    mid.record()
    opt.update(grads, state, params)
    end.record()
    end.synchronize()
    grad_ms, adamw_ms = start.elapsed_time(mid), mid.elapsed_time(end)
    wall = float(np.median(walls))
    log(f"[jamba-train] jamba-v0.1-52b card_train_config: {cfg.num_layers} of "
        f"{get_config('jamba-v0.1-52b').num_layers} layers, {cfg.moe_experts} of "
        f"{get_config('jamba-v0.1-52b').moe_experts} experts top-{cfg.moe_top_k}, "
        f"{M.count_params(cfg) / 1e9:.3f} B params, remat {cfg.remat}, B {batch} x S {seq}, "
        f"init {init_s:.1f} s: losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}")
    log(f"[jamba-train] step wall median {wall * 1e3:.1f} ms (all "
        f"{[round(w * 1e3, 1) for w in walls]}), {batch * seq / wall:.0f} tokens/s, device ms "
        f"per step (CUDA events) {[round(d, 1) for d in dev_ms]}; apart: loss and gradients "
        f"{grad_ms:.1f} ms, AdamW {adamw_ms:.1f} ms; max_memory_allocated {peak / 1e9:.2f} GB")
    log(f"[jamba-train] launches per step: {json.dumps(per_step[-1])} (products per forward "
        f"{prods})")
    del grads
    roofline_run(f"jamba-v0.1-52b train step ({cfg.num_layers} layers, {cfg.moe_experts} "
                 f"experts, B 4 x S 256)", lambda: step(params, state, data), wall, cfg,
                 batch * seq, True)
    del params, state, step, grads_of
    gc.collect()
    torch.cuda.empty_cache()
    return per_step[-1]


def train_loop_jamba(machine, bare: dict) -> None:
    """``train/loop.train`` at ``card_train_config``'s jamba: 3 steps in
    each execution mode from a fresh seed-0 init, no checkpoint directory
    (a checkpoint would be ~58 GB): the losses equal bit for bit between
    the modes, each step launching what the bare step launches."""
    cfg = card_train_config("jamba-v0.1-52b")
    runs = {}
    for compiled in (True, False):
        t0 = time.perf_counter()
        out, _, launched = _loop(cfg, 3, compiled, machine)
        wall = time.perf_counter() - t0
        losses = [h["loss"] for h in out["history"]]
        steps_ms = [round(h["step_seconds"] * 1e3, 1) for h in out["history"]]
        mode = "compiled" if compiled else "host loop"
        check(all(np.isfinite(losses)), f"jamba train loop ({mode}) losses {losses}")
        want = {k: 3 * v for k, v in bare.items()}
        check(launched == want, f"jamba train loop ({mode}) launches {launched}, 3 bare {want}")
        runs[compiled] = losses
        log(f"[jamba-train] loop {mode}: 3 steps in {wall:.1f} s with the init, losses "
            f"{[round(x, 4) for x in losses]}, step ms {steps_ms}")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[True] == runs[False],
          f"jamba train loop: compiled losses {runs[True]} != host loop {runs[False]}")
    log("[jamba-train] loop: compiled and host-loop losses equal bit for bit")


def jamba_train_path(machine) -> None:
    jamba_train_reference()
    gc.collect()
    torch.cuda.empty_cache()
    bare = train_jamba()
    train_loop_jamba(machine, bare)


# -- the remaining families: xlstm-1.3b and the six attention configs -----------------


def _last_logits_close(name: str, fwd: torch.Tensor, pre: torch.Tensor) -> str:
    """Hold the forward's last-position logits to a prefill's under the
    minicpm path's bound (5% of the largest logit); returns the summary."""
    err = (fwd - pre).abs().max().item()
    tol = 0.05 * pre.abs().max().item()
    check(err <= tol, f"{name}: forward vs prefill last logits: {err} > {tol}")
    agree = float((fwd.argmax(-1) == pre.argmax(-1)).float().mean())
    return f"max_abs_diff={err:.4g} (tol {tol:.4g}), argmax agreement {agree:.2f}"


def serve_xlstm(machine) -> None:
    """xlstm-1.3b at its published widths and full depth (48 layers, 7 mLSTM
    : 1 sLSTM), random weights from seed 0: the forward at B 4 x S 256, and
    generate (prompt 256 prefilled token-at-a-time, 32 new tokens) in both
    execution modes; then 3 AdamW steps of its train step. The forward
    against the prefill is :func:`xlstm_depth_probe`'s."""
    cfg = get_config("xlstm-1.3b")
    batch, prompt_len, steps = 4, 256, 32
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"[xlstm] xlstm-1.3b: {cfg.num_layers} layers {[b.mixer for b in cfg.pattern]} a "
        f"period, d_model {cfg.d_model}, {cfg.num_heads} heads, mLSTM d_inner "
        f"{cfg.mlstm_expand * cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{M.count_params(cfg) / 1e9:.3f} B params bf16, init {time.perf_counter() - t0:.1f}s")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1)).to("cuda")
    prods = products_per_forward(cfg)
    counts = {}

    def counted(key, fn):
        before = counts_now()
        out = fn()
        counts[key] = {k: v - before[k] for k, v in counts_now().items()}
        return out

    step = make_prefill_step(cfg, device="cuda")
    step(params, {"tokens": prompt})                     # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = counted("prefill_step", lambda: step(params, {"tokens": prompt}))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    fwd = counts["prefill_step"]
    check(tuple(logits.shape) == (batch, prompt_len, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "xlstm: forward logits")
    check(fwd["streamed_matmul"] == fwd["streamed_matmul.wgmma"] == prods
          and fwd["flash_attention"] == 0, f"xlstm forward launches {fwd} ({prods} products)")
    log(f"[xlstm] make_prefill_step (B {batch}, S {prompt_len}): wall ms "
        f"{[round(w * 1e3, 1) for w in walls]}; {prods} products, all wgmma")
    del logits
    roofline_run("xlstm-1.3b forward (B 4 x S 256)", lambda: step(params, {"tokens": prompt}),
                 float(np.median(walls)), cfg, batch * prompt_len, False)

    runs = []
    for key, compiled in (("generate_compiled", True), ("generate_measure", False)):
        toks, stats = counted(key, lambda c=compiled: generate(
            cfg, params, prompt, steps=steps, machine=machine, device="cuda", compiled=c))
        runs.append(toks)
        c = counts[key]
        want = serve_variants(cfg, batch, prompt_len, 1, steps)
        check(want == {"decode": prods * (prompt_len + steps)}
              and c["streamed_matmul"] == c["streamed_matmul.decode"] == want["decode"]
              and c["flash_attention"] == 0, f"xlstm {key}: launches {c}")
        p50 = (f" step_p50_ms={float(np.median(stats.decode_seconds)) * 1e3:.2f}"
               if not compiled else "")
        log(f"[xlstm] {key}: prefill_ms={stats.prefill_seconds * 1e3:.2f} ({prompt_len} "
            f"decode steps, block {prefill_block_size(cfg, batch, prompt_len, machine)}) "
            f"decode_tok_s={steps * batch / stats.decode_total_seconds:.1f} ({steps} tokens x "
            f"batch {batch} in {stats.decode_total_seconds * 1e3:.1f} ms){p50} "
            f"predicted_vs_measured={json.dumps(stats.plan_row)}")
    check(torch.equal(runs[0], runs[1]), "xlstm: compiled and measure-mode tokens differ")
    check(tuple(runs[0].shape) == (batch, prompt_len + steps)
          and 0 <= int(runs[0].min()) and int(runs[0].max()) < cfg.vocab_size,
          f"xlstm tokens {tuple(runs[0].shape)}")
    log(f"[xlstm] matmul launches per decode step: {prods} decode "
        f"({counts['generate_compiled']['streamed_matmul.decode']} per generate)")
    del params, step
    gc.collect()
    torch.cuda.empty_cache()
    train_xlstm(cfg, prods)


def train_xlstm(cfg, prods: int) -> None:
    """3 AdamW steps of xlstm-1.3b's train step at full depth, remat "full",
    B 4 x S 256 on one batch from a seed."""
    check(cfg.remat == "full", f"xlstm remat {cfg.remat}")
    batch, seq = 4, 256
    params = M.init_params(cfg, 0, device="cuda")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (batch, seq + 1))
    data = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32, device="cuda"),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64, device="cuda")}
    opt = AdamW(wsd(peak_lr=2e-3, warmup=3, total=100))
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step = [], [], []
    for _ in range(3):
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: v - before[k] for k, v in counts_now().items()})
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"xlstm train losses {losses}")
    # the forward's products, their recompute (the periods, not the head)
    # and two backward products each, all wgmma (m = 1024 rows)
    for c in per_step:
        check(c["streamed_matmul"] == c["streamed_matmul.wgmma"] == 4 * prods - 1,
              f"xlstm train step launches {c}")
    log(f"[xlstm-train] {cfg.num_layers} layers remat={cfg.remat}, B {batch} x S {seq}, AdamW "
        f"wsd peak 2e-3: losses {[round(x, 4) for x in losses]}; step wall ms "
        f"{[round(w * 1e3, 1) for w in walls]}, {batch * seq / float(np.median(walls)):.0f} "
        f"tokens/s; max_memory_allocated {peak / 1e9:.2f} GB; launches per step "
        f"{json.dumps(per_step[-1])}")
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()


def xlstm_depth_probe() -> None:
    """The forward's last logits against the token-at-a-time prefill's, at
    full width, B 4 x 64 positions, 2 (one mLSTM and one sLSTM block), 8,
    16 and 48 layers, bf16 and fp32. The chunked and the recurrent form
    round differently, and the random-weight stack amplifies a rounding
    difference with depth, in the JAX package's own forward and decode too
    (``tests/test_torch_xlstm.py``). So the minicpm path's bound (5% of the
    largest logit) is held on the 2-layer bf16 cut, and the deeper stacks'
    differences are printed."""
    base = get_config("xlstm-1.3b")
    batch, seq = 4, 64
    prompt = torch.randint(0, base.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1)).to("cuda")
    rows = []
    for dtype in ("bfloat16", "float32"):
        for layers in (2, 8, 16, 48):
            cut = {"pattern": (Block("mlstm", "none"), Block("slstm", "none"))} if layers == 2 else {}
            cfg = dataclasses.replace(base, num_layers=layers, dtype=dtype, **cut)
            params = M.init_params(cfg, 0, device="cuda")
            fwd = M.forward(cfg, params, prompt, device="cuda")[0][:, -1].float()
            pre, _ = make_prefill(cfg, 1, device="cuda")(
                params, M.init_cache(cfg, batch, seq, device="cuda"), prompt)
            pre = pre[:, -1].float()
            if (dtype, layers) == ("bfloat16", 2):
                log(f"[xlstm] forward vs token-at-a-time prefill, 2-layer bf16 cut (held): "
                    f"{_last_logits_close('xlstm 2-layer cut', fwd, pre)}")
            rows.append(f"{dtype[:4]} {layers}: {(fwd - pre).abs().max().item():.4g} "
                        f"(max |logit| {pre.abs().max().item():.4g})")
            del params, fwd, pre
            gc.collect()
            torch.cuda.empty_cache()
    log(f"[xlstm] forward vs token-at-a-time prefill by depth, max_abs_diff of the last "
        f"logits: {'; '.join(rows)}")


def xlstm_path(machine) -> None:
    serve_xlstm(machine)
    xlstm_depth_probe()
    reference_check("xlstm-1.3b", pattern=(Block("mlstm", "none"), Block("slstm", "none")))


#: the attention-only families of the ``families`` path, at ``card_config`` depth
FAMILIES = ("starcoder2-15b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "musicgen-large",
            "qwen2-vl-7b", "nemotron-4-340b")
#: every config, in the smoke cut the JAX package's tests use (head dim 16,
#: starcoder2's and nemotron's 8)
SMOKE = ("minicpm-2b", "codeqwen1.5-7b", "jamba-v0.1-52b", "xlstm-1.3b", *FAMILIES)


def _forward_vs_prefill(cfg, params, prompt, block: int):
    """The last-position logits of ``make_prefill_step`` and of generate's
    prefill (chunks of ``block``) on ``prompt``, and the MoE routings
    replayed. An MoE stack runs both at capacity factor 8 (no token
    dropped) and the prefill takes the forward's routes (``moe.route_hook``,
    as the jamba path does): the two paths round differently (flash against
    the dense cache read), and a near tie of the router would send a token
    to other experts."""
    batch, prompt_len = prompt.shape
    cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0) if cfg.moe_experts else cfg
    routes: list[torch.Tensor] = []                       # per MoE layer, (B, S, k)

    def record(probs, top_e):
        routes.append(top_e.view(batch, prompt_len, -1))
        return top_e

    with moe_mod.route_hook(record):
        last = make_prefill_step(cfg8, device="cuda")(params, {"tokens": prompt})[:, -1].float()
    n_moe = len(routes)
    cursor = [0] * n_moe
    calls = iter(range(10**9))

    def replay(probs, top_e):                   # call c: MoE layer c % n_moe of its chunk
        layer = next(calls) % n_moe
        span = top_e.shape[0] // batch
        at = cursor[layer]
        cursor[layer] += span
        return routes[layer][:, at:at + span].reshape(-1, top_e.shape[1])

    with moe_mod.route_hook(replay):
        pre, _ = make_prefill(cfg8, block, device="cuda")(
            params, M.init_cache(cfg8, batch, prompt_len, device="cuda"), prompt)
    check(all(c == prompt_len for c in cursor), f"{cfg.name}: prefill routed {cursor}")
    return last, pre[:, -1].float(), n_moe


def vision_positions(batch: int, seq: int) -> torch.Tensor:
    """qwen2-vl's 3-axis (temporal, height, width) ids of a 16-wide patch
    grid, one frame: (3, B, S)."""
    i = torch.arange(seq, device="cuda")
    pos = torch.stack([torch.zeros_like(i), i // 16, i % 16])
    return pos[:, None].expand(3, batch, seq)


def serve_family(name: str, machine) -> dict:
    """One family at published widths and ``card_config`` depth, random
    weights from seed 0: the forward at B 4 x S 256 through flash (and from
    frontend embeds, with qwen2-vl's 3-axis positions), its last logits
    against generate's prefill, generate with 16 new tokens."""
    t_start = time.perf_counter()
    cfg = card_config(name)
    batch, prompt_len, steps = 4, 256, 16
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    attn = sum(blk.mixer == "attn" for _, blk in cfg.blocks())
    log(f"[families] {name}: {cfg.num_layers} of {get_config(name).num_layers} layers "
        f"{[(b.mixer, b.mlp) for b in cfg.pattern]}, d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim_}, d_ff {cfg.d_ff or cfg.moe_d_ff}"
        + (f", {cfg.moe_experts} experts top-{cfg.moe_top_k} + {cfg.moe_shared_experts} shared"
           if cfg.moe_experts else "")
        + f", {cfg.norm_type}, {cfg.mlp_activation}, positions {cfg.rope_type}, vocab "
        f"{cfg.vocab_size}: {M.count_params(cfg) / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t_start:.1f}s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"on the card")
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1)).to("cuda")
    prods = products_per_forward(cfg)
    counts = {}

    def counted(key, fn):
        before = counts_now()
        out = fn()
        counts[key] = {k: v - before[k] for k, v in counts_now().items()}
        return out

    step = make_prefill_step(cfg, device="cuda")
    step(params, {"tokens": prompt})                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = counted("prefill_step", lambda: step(params, {"tokens": prompt}))
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (batch, prompt_len, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), f"{name}: forward logits")
    fwd = counts["prefill_step"]
    check(fwd["streamed_matmul"] == fwd["streamed_matmul.wgmma"] == prods
          and fwd["flash_attention"] == attn, f"{name} forward launches {fwd}")
    line = (f"[families] {name} make_prefill_step (B {batch}, S {prompt_len}): ms={fwd_ms:.2f}; "
            f"{prods} products wgmma, {attn} flash (head dim {cfg.head_dim_})")
    if cfg.frontend != "none":
        g = torch.Generator(device="cuda").manual_seed(3)
        embeds = torch.randn((batch, prompt_len, cfg.d_model), generator=g,
                             device="cuda").to(torch.bfloat16)
        pos = vision_positions(batch, prompt_len) if cfg.rope_type == "mrope" else None
        emb = counted("prefill_step_embeds", lambda: step(
            params, {"embeds": embeds, **({"positions": pos} if pos is not None else {})}))
        check(bool(torch.isfinite(emb).all()) and counts["prefill_step_embeds"] == fwd,
              f"{name}: forward from embeds {counts['prefill_step_embeds']}")
        line += (f"; from embeds" + (" at 3-axis grid positions" if pos is not None else "")
                 + ": the same launches, finite")
        del emb, embeds
    log(line)

    block = prefill_block_size(cfg, batch, prompt_len, machine)
    last, pre, replayed = _forward_vs_prefill(cfg, params, prompt, block)
    how = (f", the forward's top-{cfg.moe_top_k} routes replayed in {replayed} MoE layers at "
           f"capacity factor 8" if replayed else "")
    log(f"[families] {name} last-position logits, forward vs generate's prefill (block "
        f"{block}{how}): {_last_logits_close(name, last, pre)}")
    del logits, last, pre
    toks, stats = counted("generate", lambda: generate(
        cfg, params, prompt, steps=steps, machine=machine, device="cuda"))
    check(tuple(toks.shape) == (batch, prompt_len + steps)
          and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size, f"{name} tokens")
    c = counts["generate"]
    want = serve_variants(cfg, batch, prompt_len, block, steps)
    # the prefill reads its cache with torch ops, not flash
    check(all(c[f"streamed_matmul.{v}"] == n for v, n in want.items())
          and c["streamed_matmul"] == sum(want.values()) and c["flash_attention"] == 0
          and c["streamed_matmul.decode_cp"] == c["streamed_matmul.wgmma_cp"] == 0,
          f"{name} generate launches {c}, expected {want}")
    if name == "nemotron-4-340b":   # K = 73728 down projections: one a layer
        check(decode_variants(cfg, batch) == {"decode": 21, "decode_deep": 4}
              and c["streamed_matmul.decode_deep"] == 4 * steps,
              f"nemotron decode step variants {decode_variants(cfg, batch)}, generate {c}")
    log(f"[families] {name} generate: prefill_ms={stats.prefill_seconds * 1e3:.2f} "
        f"(block {block}) decode_tok_s="
        f"{steps * batch / stats.decode_total_seconds:.1f} ({steps} tokens x batch {batch} in "
        f"{stats.decode_total_seconds * 1e3:.1f} ms); matmul variants per decode step "
        f"{json.dumps(decode_variants(cfg, batch))} (m = {batch}), whole call "
        f"{json.dumps(want)}; wall {time.perf_counter() - t_start:.1f} s with the init")
    del params, step, toks
    gc.collect()
    torch.cuda.empty_cache()
    reference_check(name)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def families_path(machine) -> None:
    for name in FAMILIES:
        t0 = time.perf_counter()
        serve_family(name, machine)
        log(f"[families] {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    smoke_forwards()
    log(f"[families] the {len(SMOKE)} smoke forwards: {time.perf_counter() - t0:.1f} s")


def products_per_forward(cfg) -> int:
    """The port's matmul launches in one forward of ``cfg``: q, k, v and o of
    each attention layer, mLSTM's w_up, w_z and w_down, sLSTM's w_in and
    w_out, three per gated dense MLP and two per plain one, and the LM head
    (tied or not); the Mamba, per-head xLSTM and expert products are plain
    ones, as the JAX package leaves them to XLA."""
    return len(product_shapes(cfg))


def product_shapes(cfg) -> list[tuple[int, int]]:
    """(k, n) of each of the port's matmul launches in one forward or
    decode step of ``cfg``, in :func:`products_per_forward`'s count."""
    d, hd = cfg.d_model, cfg.head_dim_
    mlp = 3 if cfg.mlp_activation in ("swiglu", "geglu") else 2
    di = cfg.mlstm_expand * d
    out = [(d, cfg.padded_vocab)]
    for _, blk in cfg.blocks():
        if blk.mixer == "attn":
            out += [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
                    (d, cfg.num_kv_heads * hd), (cfg.num_heads * hd, d)]
        elif blk.mixer == "mlstm":
            out += [(d, di), (d, di), (di, d)]
        elif blk.mixer == "slstm":
            out += [(d, 4 * d), (d, d)]
        if blk.mlp == "dense":
            out += [(d, cfg.d_ff)] * (mlp - 1) + [(cfg.d_ff, d)]
    return out


def serve_variants(cfg, batch: int, prompt_len: int, block: int, steps: int) -> dict[str, int]:
    """The matmul launches per variant of one ``generate`` call: the
    prefill's chunks of ``block`` positions (a leading partial chunk first;
    wgmma where a chunk has more than 16 rows), then ``steps`` decode
    steps at ``batch`` rows."""
    lead = prompt_len % block or block
    rows = [batch * lead] + [batch * block] * ((prompt_len - lead) // block) + [batch] * steps
    out: dict[str, int] = {}
    for m in rows:
        per = {"wgmma": products_per_forward(cfg)} if m > 16 else decode_variants(cfg, m)
        for v, n in per.items():
            if n:
                out[v] = out.get(v, 0) + n
    return out


def decode_variants(cfg, m: int) -> dict[str, int]:
    """The matmul variant each product of one decode step at ``m`` rows
    takes, counted: the decode variant where A's K share fits a block
    (``decode_fits``), decode_deep where it does not (nemotron-4-340b's down
    projection, K = 73728)."""
    out = {"decode": 0, "decode_deep": 0}
    for k, _ in product_shapes(cfg):
        out["decode" if decode_fits(m, k) else "decode_deep"] += 1
    return out


def counts_now() -> dict:
    """Launches per kernel, the matmul's per variant and per operand layout,
    and flash's per kernel instance."""
    return {**ops.launch_counts(),
            **{f"streamed_matmul.{v}": c for v, c in ops.matmul_variant_counts().items()},
            **{f"streamed_matmul.{v}": c for v, c in ops.matmul_layout_counts().items()},
            **{f"flash_attention.{v}": c for v, c in ops.flash_variant_counts().items()}}


def roofline_run(name: str, run, wall_s: float, cfg, tokens: int, training: bool) -> dict:
    """Count one more run of ``run()`` — never a timed one — with
    ``roofline.count`` and print its ``[roofline]`` line: the counted FLOPs,
    bytes and kernel launches, the three terms, the model's useful FLOPs
    (6·N·D training, 2·N·D inference; N active for MoE), the run's measured
    median wall ``wall_s``, MFU = model FLOPs / (wall × the bf16 peak) and
    roofline_share = the dominant term's time / wall. A share past 1.05
    puts the run faster than the card can go: a counting bug, and the check
    fails. The kernels the count recorded must be the launches the wrappers
    counted in the same run."""
    torch.cuda.synchronize()
    before = ops.launch_counts()
    with roofline.count(device="cuda") as c:
        run()
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    recorded = {k: v[0] for k, v in c.kernels.items()}
    check(recorded == launched, f"{name}: the count recorded {recorded}, the wrappers "
          f"launched {launched}")
    total, active = cfg.param_counts()
    mf = roofline.model_flops(params=total, active_params=active, tokens=tokens,
                              training=training)
    rep = roofline.analyze(name, c, model_flops_global=mf, hw=HW)
    mfu = mf / (wall_s * HW.peak_flops)
    share = rep.step_seconds / wall_s
    row = {"run": name, "flops": c.flops, "bytes": c.bytes, "launches": c.launches,
           "kernel_launches": recorded, "kernel_flops": sum(v[1] for v in c.kernels.values()),
           "kernel_bytes": sum(v[2] for v in c.kernels.values()),
           "compute_s": rep.compute_seconds, "memory_s": rep.memory_seconds,
           "dominant": rep.dominant, "model_flops": mf, "useful_ratio": rep.useful_flops_ratio,
           "wall_s": wall_s, "mfu": mfu, "roofline_share": share,
           "peak_device_gb": c.peak_device_bytes / 1e9}
    log(f"[roofline] {json.dumps(row)}")
    check(share <= 1.05, f"{name}: roofline_share {share:.4g} > 1.05 — the count puts the "
          "run faster than the card can go")
    return row


def timed_walls(run, n: int) -> list[float]:
    """Wall seconds of ``n`` calls of ``run()``, the card synchronised
    around each."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def main_path(name: str, drive) -> dict:
    """Drive one main path with every launch count set to 0 just before it;
    return the counts read just after (per kernel, and the matmul's per
    variant and per layout)."""
    ops.reset_launch_counts()
    with phase(name):
        drive()
    launches = counts_now()
    log(f"[main path] {name}: launches {json.dumps(launches)}")
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
    ptxas_f32((lib.parent / "streamed_matmul.cu.log").read_text())

    rows: dict[str, dict] = {}
    with phase("kernel checks"):
        check_matmul(rows)
        check_matmul_deep(rows)
        check_matmul_cp(rows)
        check_dot(rows)
        check_flash(rows)
        check_ssm(rows)
        check_ssm_bwd(rows)
        rate_f32 = check_matmul_f32(rows)

    with phase("calibration"):
        machine = default_machine(device="cuda")
        fetch_bw, fetch_t0 = measure_fetch_model()
    log(f"[machine] {machine}; measure_fetch_model: {fetch_bw:.6g} words/s "
        f"({fetch_bw * 4 / 1e9:.4g} GB/s), t0 {fetch_t0 * 1e6:.3f} us; fp32 product rate "
        f"{rate_f32 / 1e12:.4g} TFLOP/s (simt_f32, 4096³) beside r {machine.r / 1e12:.4g} "
        f"TFLOP/s")
    with phase("reference checks"):
        reference_check("minicpm-2b")
        reference_check("jamba-v0.1-52b",
                        pattern=(Block("mamba", "dense"), Block("attn", "dense")))
        train_reference_check()
        count_check()
    with phase("plans"):
        check(lint.run_lint(check=True, device="cuda", machine=machine) == 0,
              f"lint --check: error findings or build failures on {machine.name}")
        log(f"[lint] python -m repro_torch.lint --check on {machine.name}: clean")
        for shape in ("train_4k", "decode_32k"):
            log(f"[dryrun] {json.dumps(dryrun.plan_record('minicpm-2b', shape, machine))}")

    dense = main_path("minicpm-2b", lambda: (inner_product(machine), serve_slice(machine)))
    gc.collect()
    torch.cuda.empty_cache()      # the serve weights go before the train step's come
    bare: dict = {}
    train = main_path("train", lambda: bare.update(train_slice()))
    gc.collect()
    torch.cuda.empty_cache()
    loop = main_path("train-loop", lambda: train_loop_slice(machine, bare))
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = main_path("jamba-v0.1-52b", lambda: serve_jamba(machine))
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_train = main_path("jamba-train", lambda: jamba_train_path(machine))
    gc.collect()
    torch.cuda.empty_cache()
    recurrent = main_path("xlstm-1.3b", lambda: xlstm_path(machine))
    gc.collect()
    torch.cuda.empty_cache()
    families = main_path("families", lambda: families_path(machine))
    gc.collect()
    torch.cuda.empty_cache()
    paper = main_path("bsps", lambda: bsps_path(rate_f32))
    gc.collect()
    torch.cuda.empty_cache()
    meshed = main_path("mesh", lambda: mesh_path(machine))
    gc.collect()
    torch.cuda.empty_cache()
    examples = main_path("examples", examples_path)
    for name in ("streamed_dot", "streamed_matmul", "flash_attention"):
        check(dense[name] > 0, f"{name} was not launched on the minicpm-2b path")
    for name in ("streamed_matmul", "flash_attention"):
        check(train[name] > 0, f"{name} was not launched on the train path")
        check(loop[name] > 0, f"{name} was not launched on the train-loop path")
    for name in ("streamed_matmul", "flash_attention", "ssm_scan"):
        check(hybrid[name] > 0, f"{name} was not launched on the jamba path")
    for name in ("ssm_scan", "ssm_scan_bwd", "streamed_matmul", "flash_attention"):
        check(hybrid_train[name] > 0, f"{name} was not launched on the jamba-train path")
    check(recurrent["streamed_matmul"] > 0, "streamed_matmul was not launched on the xlstm path")
    for name in ("streamed_matmul", "flash_attention"):
        check(families[name] > 0, f"{name} was not launched on the families path")
    for name in ("streamed_dot", "streamed_matmul"):
        check(paper[name] > 0, f"{name} was not launched on the bsps path")
    for name in ("streamed_matmul", "flash_attention"):
        check(meshed[name] > 0, f"{name} was not launched on the mesh path")
    check(examples["streamed_dot"] > 0, "streamed_dot was not launched on the examples path")
    paths = (dense, train, loop, hybrid, hybrid_train, recurrent, families, paper, meshed,
             examples)
    launches = {k: sum(p[k] for p in paths) for k in dense}

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name], **rows[name]})
    # the matmul's variants, each at the shape its row was timed at, with its
    # launches on the main paths (0 for the variants no main path takes)
    matmul = next(row for row in kernels if row["name"] == "streamed_matmul")
    matmul["variants"] = [
        {"name": v, "launches": launches[f"streamed_matmul.{v}"], **rows[f"streamed_matmul.{v}"]}
        for v in VARIANTS]
    # flash's kernel instances (dtype, the head dim run at), each timed one
    # at the shape its row was timed at, with its launches on the main paths
    flash = next(row for row in kernels if row["name"] == "flash_attention")
    flash["variants"] = [
        {"name": v, "launches": launches[f"flash_attention.{v}"], **rows[f"flash_attention.{v}"]}
        for v in ops.flash_variant_counts() if f"flash_attention.{v}" in rows]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time kernels at fixed shapes, for whichever ``repro_torch`` is on the
path: the parent/change timer of the port's kernels.

From a checkout's root, on the card:

    PYTHONPATH=src python src/repro_torch/launch/time_kernels.py --label change \\
        [--kernel matmul flash flash_bwd scan_bwd]

Run by file path, it times the package that ``PYTHONPATH`` names, so two
checkouts can be compared in one call on one card, in turns (A, B, B, A).
Both read the same inputs, made on the card from ``chip_smoke.py``'s seeds.
Each line starts ``[time_kernels] <label>: <kernel>``:

- ``matmul``: at :data:`MATMUL_SHAPES` (default layouts, bf16), the device
  ms of ``streamed_matmul`` on the variant the rule picks, on every variant
  the package lets a caller force there, and, where an operand is one TMA
  cannot describe, with both operands first staged into aligned copies
  (``tma_rows``, the copy timed with the product) so that a TMA variant
  runs; each with the variant that launched and a sha1 of the output; then
  ``torch.matmul`` on the same operands.
- ``flash``: the fp32 flash kernel at ``chip_smoke.py``'s head-dim cases:
  ms, max error of the output and of the lse against the plain version,
  whether two calls gave the same bits, a sha1 and the instance's compiled
  attributes.
- ``flash_bwd``: the bf16 attention backward as ``FlashAttention.backward``
  runs it from the saved forward (the kernel where the package has one,
  else the torch ops), at minicpm-2b's train step (B 8, H 36, S 2048, D 64)
  and jamba's (B 4, H 32/8, S 256, D 128), causal: ms, its bound (the
  package's ``bwd_cost`` where it has one: 10·d a kept pair at the bf16
  peak), the torch-op ``_flash_bwd``'s ms, SDPA forward + backward's ms
  (the library yardstick), each gradient's largest error against the
  torch ops over its largest entry, whether two calls gave the same bits,
  a sha1 of the three, and each pass's compiled attributes.
- ``scan_bwd``: a sha1 of the scan's y at ``check_ssm``'s four shapes; the
  forward's ms at jamba's train shape (B 4 × L 256, bf16 and fp32) and at
  B 1 × L 4000 in bf16; the backward with and from the forward's tape where
  the package writes one (``ssm_scan_with_tape``), else from its inputs at
  each lane count.

Device ms per call come from CUDA events over ``--iters`` calls cycling
through input sets past the 50 MB L2, with the card held by a spin kernel
while the loop is queued (``chip_smoke.py``'s ``bench_ms``). It refuses to
run without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import time
import types

import torch
import torch.nn.functional as F

from repro_torch.core import roofline
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as scan
from repro_torch.kernels import streamed_matmul as mm
from repro_torch.models import flash as flash_fn

SPIN_CYCLES_PER_S = 1.98e9
L2_BYTES = 50 * 2**20

#: (m, k, n) of the matmul timings: chip_smoke.py's CP_SHAPES (B's rows 260
#: and 11,522 bytes apart at n = 130 and 5761; aligned at 4 × 73728 × 18432
#: and 1024 × 2304 × 5760), then an LM head stored as (d, V) at minicpm's
#: odd vocabulary, B 566 MB with rows 245,506 bytes apart, at a decode
#: step and at a 64-row chunk
MATMUL_SHAPES = ((300, 200, 130), (4, 73728, 18432), (4, 2304, 5761), (1024, 2304, 5761),
                 (1024, 2304, 5760), (4, 2304, 122753), (64, 2304, 122753))

#: (label, B, Hq, Hkv, Sq, Skv, D): chip_smoke.py's fp32 head-dim cases
FLASH_SHAPES = (
    ("train_lm", 8, 4, 4, 256, 256, 64),
    ("quickstart", 2, 4, 4, 32, 32, 16),
    ("smoke D 8", 2, 8, 2, 64, 64, 8),
    ("ragged", 2, 8, 2, 100, 130, 32),
    ("ragged", 2, 8, 2, 100, 130, 48),
    ("jamba-train fp32 cut", 2, 32, 8, 64, 64, 128),
    ("nemotron", 4, 96, 8, 256, 256, 192),
    ("D 256", 4, 16, 8, 256, 256, 256),
)


def _bench_ms(fn, sets, iters: int) -> float:
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _randn(shape, dtype, seed: int, scale: float = 1.0) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _copies(make, nbytes: int) -> list:
    """``make(i)`` for enough i that the sets overflow the L2 (2 to 16)."""
    return [make(i) for i in range(min(16, max(2, -(-2 * L2_BYTES // nbytes))))]


def _sha1(t: torch.Tensor) -> str:
    return hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]


def _launched(fn):
    """``fn()``'s result and the one matmul variant it launched."""
    before = ops.matmul_variant_counts()
    out = fn()
    taken = [v for v, c in ops.matmul_variant_counts().items() if c != before[v]]
    if len(taken) != 1:
        raise RuntimeError(f"one matmul launch expected, variants {taken}")
    return out, taken[0]


def time_matmul(tag: str, iters: int) -> None:
    for m, k, n in MATMUL_SHAPES:
        sets = _copies(lambda i, m=m, k=k, n=n: (
            _randn((m, k), torch.bfloat16, 10 * i + 1),
            _randn((k, n), torch.bfloat16, 10 * i + 2, k ** -0.5)), (m * k + k * n) * 2)
        a, b = sets[0]
        reps = iters if m * k * n < 1e10 else max(1, iters * 2 // 5)
        runs = {}
        for forced in (None, *mm.VARIANTS):
            try:
                runs[forced] = _launched(lambda: mm.streamed_matmul(a, b, variant=forced))
            except ValueError:
                continue
        picked = runs[None][1]
        for forced, (out, variant) in runs.items():
            if forced is not None and variant == picked:
                continue
            ms = _bench_ms(lambda a, b: mm.streamed_matmul(a, b, variant=forced), sets, reps)
            print(f"{tag} matmul {m}x{k}x{n} variant={variant}"
                  f"{' (forced)' if forced else ''} ms={ms:.4f} sha1={_sha1(out)}", flush=True)
        del runs
        def staged(a, b):
            return mm.streamed_matmul(mm.tma_rows(a), mm.tma_rows(b))

        if mm.tma_rows(a) is not a or mm.tma_rows(b) is not b:
            out, variant = _launched(lambda: staged(a, b))
            ms = _bench_ms(staged, sets, reps)
            print(f"{tag} matmul {m}x{k}x{n} variant={variant} (staged by tma_rows, the copy "
                  f"included) ms={ms:.4f} sha1={_sha1(out)}", flush=True)
            del out
        lib = _bench_ms(torch.matmul, sets, reps)
        print(f"{tag} matmul {m}x{k}x{n} torch.matmul ms={lib:.4f}", flush=True)
        del sets, a, b
        torch.cuda.empty_cache()


def time_flash(tag: str, iters: int) -> None:
    for label, b, hq, hkv, sq, skv, d in FLASH_SHAPES:
        sets = _copies(lambda i, b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d: (
            _randn((b, hq, sq, d), torch.float32, 10 * i + 11),
            _randn((b, hkv, skv, d), torch.float32, 10 * i + 12),
            _randn((b, hkv, skv, d), torch.float32, 10 * i + 13)),
            (b * hq * sq * d + 2 * b * hkv * skv * d) * 4)
        q, k, v = sets[0]
        out, lse = ops.attention(q, k, v, return_lse=True)
        want, want_lse = ref.attention_ref_lse(q, k, v)
        same = torch.equal(out, ops.attention(q, k, v))
        err = (out - want).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        digest = hashlib.sha1(out.contiguous().view(torch.int32).cpu().numpy()
                              .tobytes()).hexdigest()[:16]
        ms = _bench_ms(lambda q, k, v: ops.attention(q, k, v), sets, iters)
        dk = flash.kernel_head_dim(d)
        attrs = flash.kernel_attrs(dk, torch.float32, q.device)
        print(f"{tag} flash {label} b{b} h{hq}/{hkv} sq{sq} skv{skv} d{d} (fp32.d{dk}): "
              f"ms={ms:.4f} max_abs_err={err:.3g} lse_err={lse_err:.3g} "
              f"bits_repeat={same} sha1={digest} attrs={attrs}", flush=True)
        del sets, q, k, v
        torch.cuda.empty_cache()


#: (label, B, Hq, Hkv, S, D) of the backward's timings, causal
FLASH_BWD_SHAPES = (("minicpm-2b train", 8, 36, 36, 2048, 64),
                    ("jamba train", 4, 32, 8, 256, 128))


def time_flash_bwd(tag: str, iters: int) -> None:
    for label, b, hq, hkv, s_len, d in FLASH_BWD_SHAPES:
        nbytes = (3 * b * hq * s_len * d + 2 * b * hkv * s_len * d) * 2

        def make(i, b=b, hq=hq, hkv=hkv, s_len=s_len, d=d):
            q = _randn((b, hq, s_len, d), torch.bfloat16, 10 * i + 21)
            k = _randn((b, hkv, s_len, d), torch.bfloat16, 10 * i + 22)
            v = _randn((b, hkv, s_len, d), torch.bfloat16, 10 * i + 23)
            out, lse = ops.attention(q, k, v, return_lse=True)
            return q, k, v, out, lse, _randn((b, hq, s_len, d), torch.bfloat16, 10 * i + 24)

        sets = _copies(make, nbytes)
        scale = d ** -0.5

        def backward(q, k, v, out, lse, dout):     # the Function's backward, from its saved forward
            ctx = types.SimpleNamespace(saved_tensors=(q, k, v, out, lse),
                                        args=(True, scale, 1024, 1024))
            return flash_fn.FlashAttention.backward(ctx, dout)[:3]

        def torch_op(q, k, v, out, lse, dout):
            return flash_fn._flash_bwd(q, k, v, out, lse, dout, True, scale, 1024, 1024)

        def sdpa(q, k, v, out, lse, dout):
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*qkv, is_causal=True, enable_gqa=hq != hkv)
            return torch.autograd.grad(o, qkv, dout)

        got, again, want = backward(*sets[0]), backward(*sets[0]), torch_op(*sets[0])
        errs = [round(((g.float() - w.float()).abs().max() / w.float().abs().max()).item(), 5)
                for g, w in zip(got, want)]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        digest = hashlib.sha1(b"".join(g.view(torch.int16).cpu().numpy().tobytes()
                                       for g in got)).hexdigest()[:16]
        del got, again, want
        ms = _bench_ms(backward, sets, iters)
        op_ms = _bench_ms(torch_op, sets, max(1, iters // 10))
        lib_ms = _bench_ms(sdpa, sets, iters)
        if hasattr(flash, "bwd_cost"):
            t, by = roofline.kernel_bound(flash.bwd_cost(b, hq, hkv, s_len, s_len, d, 2),
                                          roofline.H100_SXM)
            bound = f"{t * 1e3:.4f} ({by})"
            attrs = {p: flash.bwd_kernel_attrs(d, p, sets[0][0].device) for p in ("dq", "dkv")}
        else:
            bound, attrs = "none (no backward kernel)", {}
        print(f"{tag} flash_bwd {label} b{b} h{hq}/{hkv} s{s_len} d{d} causal: ms={ms:.4f} "
              f"bound_ms={bound} torch_op_ms={op_ms:.4f} sdpa_fwd_bwd_ms={lib_ms:.4f} "
              f"errs_vs_torch_op={errs} bits_repeat={same} sha1={digest} attrs={attrs}",
              flush=True)
        del sets
        torch.cuda.empty_cache()


def _scan_inputs(b, seq, di, ds, dtype, seed):
    """``chip_smoke.py``'s ``_ssm_inputs``: x, Δ, B, C; A = -(1..d_state); D."""
    return (_randn((b, seq, di), dtype, seed),
            _randn((b, seq, di), torch.float32, seed + 1, 0.05).abs().to(dtype),
            _randn((b, seq, ds), dtype, seed + 2), _randn((b, seq, ds), dtype, seed + 3),
            -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds)
            .contiguous(), _randn((di,), torch.float32, seed + 4))


def time_scan_bwd(tag: str, iters: int) -> None:
    for b, seq, di, ds, dtype in ((4, 256, 8192, 16, torch.bfloat16),
                                  (1, 4000, 8192, 16, torch.bfloat16),
                                  (4, 256, 8192, 16, torch.float32),
                                  (2, 300, 1000, 8, torch.float32)):
        y = ops.selective_scan(*_scan_inputs(b, seq, di, ds, dtype, 20))
        digest = hashlib.sha1(y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                              .cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"{tag} scan y b{b} L{seq} di{di} ds{ds} {str(dtype)[6:]} sha1 {digest}",
              flush=True)
    taped = hasattr(scan, "ssm_scan_with_tape")
    for b, seq, dtype in ((4, 256, torch.bfloat16), (4, 256, torch.float32),
                          (1, 4000, torch.bfloat16)):
        # check_ssm_bwd's input sets with dy
        sets = _copies(lambda i, b=b, seq=seq, dtype=dtype: (
            *_scan_inputs(b, seq, 8192, 16, dtype, 10 * i + 60),
            _randn((b, seq, 8192), dtype, 10 * i + 65)),
            (3 * b * seq * 8192 + 2 * b * seq * 16) * dtype.itemsize)
        reps = max(1, iters * 2 // 5) if seq <= 256 else max(1, iters // 5)
        shape = f"b{b} L{seq} di8192 ds16 {str(dtype)[6:]}"
        fwd = _bench_ms(lambda *a: scan.ssm_scan(*a[:6]), sets, reps)
        whole = _bench_ms(scan.ssm_scan_bwd, sets, reps)
        if taped:
            with_tape = _bench_ms(lambda *a: scan.ssm_scan_with_tape(*a[:6]), sets, reps)
            tapes = [(*s, scan.ssm_scan_with_tape(*s[:6])[1]) for s in sets]
            bwd = _bench_ms(lambda *a: scan.ssm_scan_bwd(*a[:7], tape=a[7]), tapes, reps)
            print(f"{tag} scan_bwd {shape}: forward {fwd:.4f} ms, with tape {with_tape:.4f} "
                  f"(overhead {with_tape - fwd:.4f}); backward launch {bwd:.4f}; backward + "
                  f"tape overhead {bwd + with_tape - fwd:.4f}; from the inputs {whole:.4f}",
                  flush=True)
            del tapes
        else:
            by_lanes = {n: _bench_ms(lambda *a, n=n: scan.ssm_scan_bwd(*a, lanes=n), sets, reps)
                        for n in scan.LANE_CHOICES}
            print(f"{tag} scan_bwd {shape}: forward {fwd:.4f} ms; backward from the inputs "
                  f"{whole:.4f} (rule), by lanes { {n: round(v, 4) for n, v in by_lanes.items()} }",
                  flush=True)
        del sets
        torch.cuda.empty_cache()


KERNELS = {"matmul": time_matmul, "flash": time_flash, "flash_bwd": time_flash_bwd,
           "scan_bwd": time_scan_bwd}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--kernel", nargs="+", choices=sorted(KERNELS), default=sorted(KERNELS))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device; it times the kernels on the card")
    for name in args.kernel:
        KERNELS[name](f"[time_kernels] {args.label}:", args.iters)


if __name__ == "__main__":
    main()

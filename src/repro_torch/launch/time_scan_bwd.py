"""Time the selective scan's backward at jamba's train shape, and hash the
forward's outputs, for whichever ``repro_torch`` is on the path.

From a checkout's root, on the card:

    PYTHONPATH=src python src/repro_torch/launch/time_scan_bwd.py --label change

Run by file path, it times the package that ``PYTHONPATH`` names, so two
checkouts can be compared in one call on one card, in turns (A, B, B, A).
Both read the same inputs, made on the card from ``chip_smoke.py``'s seeds.
Its ``[time_scan_bwd]`` lines give:

- a sha1 of y at ``check_ssm``'s four shapes (the same digest as
  ``chip_smoke.py`` prints);
- at B 4 × L 256 × 8192 × 16, in bf16 and fp32, and at B 1 × L 4000 in bf16:
  the forward's device ms;
- where the package's forward writes the backward's checkpoint tape
  (``ssm_scan_with_tape``): the forward with the tape, the backward launch
  from the tape, and the backward from its inputs;
- else the backward from its inputs at each lane count it takes
  (``ssm_scan_bwd(..., lanes=)``).

Device ms per call come from CUDA events over ``--iters`` calls cycling
through input sets past the 50 MB L2, with the card held by a spin kernel
while the loop is queued (``chip_smoke.py``'s ``bench_ms``). It refuses to
run without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as scan

SPIN_CYCLES_PER_S = 1.98e9
L2_BYTES = 50 * 2**20


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


def _inputs(b, seq, di, ds, dtype, seed):
    """``chip_smoke.py``'s ``_ssm_inputs``: x, Δ, B, C; A = -(1..d_state); D."""
    return (_randn((b, seq, di), dtype, seed),
            _randn((b, seq, di), torch.float32, seed + 1, 0.05).abs().to(dtype),
            _randn((b, seq, ds), dtype, seed + 2), _randn((b, seq, ds), dtype, seed + 3),
            -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds)
            .contiguous(), _randn((di,), torch.float32, seed + 4))


def _sets(b, seq, di, ds, dtype):
    """``check_ssm_bwd``'s input sets with dy, enough to overflow the L2."""
    nbytes = (3 * b * seq * di + 2 * b * seq * ds) * dtype.itemsize
    n = min(16, max(2, -(-2 * L2_BYTES // nbytes)))
    return [(*_inputs(b, seq, di, ds, dtype, 10 * i + 60),
             _randn((b, seq, di), dtype, 10 * i + 65)) for i in range(n)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_scan_bwd: no CUDA device; it times the kernels on the card")
    tag = f"[time_scan_bwd] {args.label}:"
    for b, seq, di, ds, dtype in ((4, 256, 8192, 16, torch.bfloat16),
                                  (1, 4000, 8192, 16, torch.bfloat16),
                                  (4, 256, 8192, 16, torch.float32),
                                  (2, 300, 1000, 8, torch.float32)):
        y = ops.selective_scan(*_inputs(b, seq, di, ds, dtype, 20))
        digest = hashlib.sha1(y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                              .cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"{tag} y b{b} L{seq} di{di} ds{ds} {str(dtype)[6:]} sha1 {digest}", flush=True)
    taped = hasattr(scan, "ssm_scan_with_tape")
    for b, seq, dtype in ((4, 256, torch.bfloat16), (4, 256, torch.float32),
                          (1, 4000, torch.bfloat16)):
        sets = _sets(b, seq, 8192, 16, dtype)
        iters = args.iters if seq <= 256 else max(1, args.iters // 2)
        shape = f"b{b} L{seq} di8192 ds16 {str(dtype)[6:]}"
        fwd = _bench_ms(lambda *a: scan.ssm_scan(*a[:6]), sets, iters)
        whole = _bench_ms(scan.ssm_scan_bwd, sets, iters)
        if taped:
            with_tape = _bench_ms(lambda *a: scan.ssm_scan_with_tape(*a[:6]), sets, iters)
            tapes = [(*s, scan.ssm_scan_with_tape(*s[:6])[1]) for s in sets]
            bwd = _bench_ms(lambda *a: scan.ssm_scan_bwd(*a[:7], tape=a[7]), tapes, iters)
            print(f"{tag} {shape}: forward {fwd:.4f} ms, with tape {with_tape:.4f} (overhead "
                  f"{with_tape - fwd:.4f}); backward launch {bwd:.4f}; backward + tape "
                  f"overhead {bwd + with_tape - fwd:.4f}; from the inputs {whole:.4f}",
                  flush=True)
            del tapes
        else:
            by_lanes = {n: _bench_ms(lambda *a, n=n: scan.ssm_scan_bwd(*a, lanes=n), sets, iters)
                        for n in scan.LANE_CHOICES}
            print(f"{tag} {shape}: forward {fwd:.4f} ms; backward from the inputs {whole:.4f} "
                  f"(rule), by lanes { {n: round(v, 4) for n, v in by_lanes.items()} }",
                  flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

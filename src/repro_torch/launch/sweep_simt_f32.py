"""Time tile configurations of the matmul's fp32 variant (``simt_f32``).

``python -m repro_torch.launch.sweep_simt_f32 [--size 4096] [--iters 20]``

Builds ``kernels/csrc/sweep/simt_f32_sweep.cu`` with the kernel library's
nvcc flags (each configuration it lists is one instance of the kernel: a
tile, and A as (m, k) or as its (k, m) transpose), then prints for each:
its tile, the registers and local (spill) bytes ptxas gave it, whether C
equals ``torch.matmul``'s bit for bit (and its largest difference), and
its device ms at ``--size``³ over ``--iters`` launches (CUDA events, four
input sets past the L2), beside ``torch.matmul`` fp32 (TF32 off) timed
before and after. Run it on the card; it refuses to run without one.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import pipeline


def _ms(fn, sets, iters: int) -> float:
    for args in sets:
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    device = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    sweep = pipeline.sweep_kernels()
    n = args.size
    g = torch.Generator(device=device).manual_seed(0)
    sets = [tuple(torch.randn(n, n, device=device, generator=g) for _ in range(3))
            for _ in range(4)]
    stream = torch.cuda.current_stream(device).cuda_stream
    # the configuration's tile, registers and layout, as bsps_sweep_f32 fills them
    info = torch.zeros(10, dtype=torch.int32)

    def launch(cfg, a, b, c):
        err = sweep.bsps_sweep_f32(cfg, info.data_ptr(), stream, a.data_ptr(), b.data_ptr(),
                                   c.data_ptr(), n, n, n)
        if err:
            raise RuntimeError(f"configuration {cfg}: CUDA error {err}")

    def library(a, b, c):
        torch.matmul(a, b, out=c)

    flops = 2.0 * n**3
    lib_ms = _ms(library, sets, args.iters)
    print(f"[sweep] {torch.cuda.get_device_name(device)}; torch.matmul fp32 {n}³: "
          f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s)", flush=True)
    for cfg in range(sweep.bsps_sweep_f32_count()):
        a, b, c = sets[0]
        launch(cfg, a, b, c)
        bm, bn, bk, stages, regs, used, local, smem, lm, a_mk = info.tolist()
        want = torch.matmul(a if a_mk else a.T, b)
        same, err = torch.equal(c, want), ((c - want).abs().max() / want.abs().max()).item()
        ms = _ms(lambda *t, cfg=cfg: launch(cfg, *t), sets, args.iters)
        print(f"[sweep] {bm}x{bn}x{bk} tile, {stages} stages, lanes {lm}x{32 // lm}, "
              f"consumer registers {regs}, A as {'(m, k)' if a_mk else '(k, m)'}: "
              f"ptxas {used} registers, {local} local bytes, {smem} shared bytes; "
              f"equal to torch.matmul {same} (max error {err:.3g} of max |C|); {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    lib_ms = _ms(library, sets, args.iters)
    print(f"[sweep] torch.matmul fp32 {n}³ again: {lib_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()

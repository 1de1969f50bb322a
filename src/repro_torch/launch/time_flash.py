"""Time the fp32 flash kernel at every head dim ``chip_smoke.py`` runs it
at, for whichever ``repro_torch`` is on the path.

From a checkout's root, on the card:

    PYTHONPATH=src python src/repro_torch/launch/time_flash.py --label change

Run by file path, it times the package that ``PYTHONPATH`` names, so two
checkouts can be compared in one call on one card, in turns (A, B, B, A).
Both read the same inputs: ``chip_smoke.py``'s ``check_flash_head_dim``
sets, made on the card from its seeds. Its ``[time_flash]`` lines give,
for each shape: the device ms of ``ops.attention`` (the fp32 instance it
launches), the max error of the output and of the lse against the plain
version, whether two calls gave the same bits, a sha1 of the output, and
the instance's registers, spilled bytes, shared memory and blocks an SM
(``flash_attention.kernel_attrs``).

Device ms per call come from CUDA events over ``--iters`` calls cycling
through input sets past the 50 MB L2, with the card held by a spin kernel
while the loop is queued (``chip_smoke.py``'s ``bench_ms``). It refuses to
run without a card.
"""

from __future__ import annotations

import argparse
import hashlib

import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.launch.time_scan_bwd import L2_BYTES, _bench_ms, _randn

#: (label, B, Hq, Hkv, Sq, Skv, D): chip_smoke.py's fp32 head-dim cases
SHAPES = (
    ("train_lm", 8, 4, 4, 256, 256, 64),
    ("quickstart", 2, 4, 4, 32, 32, 16),
    ("smoke D 8", 2, 8, 2, 64, 64, 8),
    ("ragged", 2, 8, 2, 100, 130, 32),
    ("ragged", 2, 8, 2, 100, 130, 48),
    ("jamba-train fp32 cut", 2, 32, 8, 64, 64, 128),
    ("nemotron", 4, 96, 8, 256, 256, 192),
    ("D 256", 4, 16, 8, 256, 256, 256),
)


def _sets(b, hq, hkv, sq, skv, d):
    nbytes = (b * hq * sq * d + 2 * b * hkv * skv * d) * 4
    n = min(16, max(2, -(-2 * L2_BYTES // nbytes)))
    return [(_randn((b, hq, sq, d), torch.float32, 10 * i + 11),
             _randn((b, hkv, skv, d), torch.float32, 10 * i + 12),
             _randn((b, hkv, skv, d), torch.float32, 10 * i + 13)) for i in range(n)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_flash: no CUDA device; it times the kernels on the card")
    tag = f"[time_flash] {args.label}:"
    for label, b, hq, hkv, sq, skv, d in SHAPES:
        sets = _sets(b, hq, hkv, sq, skv, d)
        q, k, v = sets[0]
        out, lse = ops.attention(q, k, v, return_lse=True)
        want, want_lse = ref.attention_ref_lse(q, k, v)
        same = torch.equal(out, ops.attention(q, k, v))
        err = (out - want).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        digest = hashlib.sha1(out.contiguous().view(torch.int32).cpu().numpy()
                              .tobytes()).hexdigest()[:16]
        ms = _bench_ms(lambda q, k, v: ops.attention(q, k, v), sets, args.iters)
        dk = flash.kernel_head_dim(d)
        attrs = flash.kernel_attrs(dk, torch.float32, q.device)
        print(f"{tag} {label} b{b} h{hq}/{hkv} sq{sq} skv{skv} d{d} (fp32.d{dk}): "
              f"ms={ms:.4f} max_abs_err={err:.3g} lse_err={lse_err:.3g} "
              f"bits_repeat={same} sha1={digest} attrs={attrs}", flush=True)
        del sets, q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

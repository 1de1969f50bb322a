"""The work of one kernel call, from its shapes: frozen copies of the
arithmetic of the port's kernel modules' ``cost`` functions (the matmul,
flash attention, the selective scan and its backward) as of the benchmark's
first version. Operations, the bytes of the inputs read once and of the
outputs written once, and the operations' type ("bf16" on the tensor
cores, "fp32" on the FMA pipes)."""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["Cost", "matmul", "flash", "flash_bwd", "scan", "scan_bwd", "causal_pairs",
           "SSM_FLOPS", "SSM_BWD_FLOPS"]

#: fp32 operations a (position, channel, state) of the scan and its backward
SSM_FLOPS = 10.0
SSM_BWD_FLOPS = 18.0


class Cost(NamedTuple):
    flops: float
    bytes: float
    kind: str


def matmul(m: float, k: float, n: float, itemsize: int, out_itemsize: int | None = None) -> Cost:
    """(m, k) x (k, n): 2mkn operations; A and B read, C written once."""
    out_itemsize = out_itemsize or itemsize
    return Cost(2.0 * m * k * n, float((m * k + k * n) * itemsize + m * n * out_itemsize),
                "bf16" if itemsize == 2 else "fp32")


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs causal masking keeps, the queries the last ``sq``
    of ``skv`` positions: query i sees keys 0 .. skv - sq + i."""
    lo = max(1, skv - sq + 1)
    return skv * (skv + 1) // 2 - (lo - 1) * lo // 2


def flash(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, itemsize: int, *,
          causal: bool = True, lse: bool = False) -> Cost:
    """Attention forward: 4·d operations a kept (query, key) pair; Q, K, V
    read and O (and the fp32 lse) written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    return Cost(4.0 * b * hq * d * pairs, float(nbytes + (4 * b * hq * sq if lse else 0)),
                "bf16" if itemsize == 2 else "fp32")


def flash_bwd(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, itemsize: int, *,
              causal: bool = True) -> Cost:
    """Attention backward: the scores again, dP, dS's two products and dV,
    10·d operations a kept pair; Q, K, V, O, dO and lse read, dQ, dK, dV
    written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * skv * d) * itemsize + 4 * b * hq * sq
    return Cost(10.0 * b * hq * d * pairs, float(nbytes), "bf16" if itemsize == 2 else "fp32")


def scan(bsz: int, seq: int, d_inner: int, d_state: int, itemsize: int) -> Cost:
    """The selective scan: x, Δ, B, C read and y written once, fp32 A, D."""
    nbytes = (3 * bsz * seq * d_inner + 2 * bsz * seq * d_state) * itemsize \
        + (d_inner * d_state + d_inner) * 4
    return Cost(SSM_FLOPS * bsz * seq * d_inner * d_state, float(nbytes), "fp32")


def scan_bwd(bsz: int, seq: int, d_inner: int, d_state: int, itemsize: int) -> Cost:
    nbytes = (5 * bsz * seq * d_inner + 4 * bsz * seq * d_state) * itemsize \
        + 2 * (d_inner * d_state + d_inner) * 4
    return Cost(SSM_BWD_FLOPS * bsz * seq * d_inner * d_state, float(nbytes), "fp32")

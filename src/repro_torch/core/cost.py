"""BSP and BSPS cost functions (paper §1–3).

BSP cost of a k-superstep program:
    T = Σ_i ( max_s w_i(s) + g·h_i + l ),   h_i = max_s max(t_i(s), r_i(s))

BSPS cost of an H-hyperstep program (paper Eq. 1):
    T̃ = Σ_h max( T_h , e · max_s Σ_{i ∈ O_s} C_i )

plus the paper's closed forms:
    inner product  T = n·max(2C, 2Ce) + p + (p-1)g + l,  n = N/(pC)      (§3.1)
    Cannon (BSP)   T_cannon = N(2k³ + k²g + l)                            (§3.2)
    Cannon (BSPS)  T̃_cannon = M³·max( N(2k³ + 2k²g + l), 2k²e )  (Eq. 2)

and the k_equal crossover the paper validates experimentally (Fig. 5).

These are in FLOP units; use :meth:`BSPComputer.flops_to_seconds` for wall time.
The three-term pod-level generalisation (``core/roofline.py``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.bsp import BSPAccelerator, BSPComputer

__all__ = [
    "SuperstepCost",
    "HyperstepCost",
    "bsp_cost",
    "bsps_cost",
    "inner_product_cost",
    "cannon_bsp_cost",
    "cannon_bsps_cost",
    "cannon_hyperstep",
    "cannon_k_equal",
]


@dataclasses.dataclass(frozen=True)
class SuperstepCost:
    """One BSP superstep: per-processor work, transmitted and received words."""

    work: Sequence[float]          # w_i(s), FLOPs per processor
    transmitted: Sequence[float]   # t_i(s), words
    received: Sequence[float]      # r_i(s), words

    @property
    def h_relation(self) -> float:
        return max(max(self.transmitted, default=0.0), max(self.received, default=0.0))

    def cost(self, machine: BSPComputer) -> float:
        return max(self.work, default=0.0) + machine.g * self.h_relation + machine.l


@dataclasses.dataclass(frozen=True)
class HyperstepCost:
    """One hyperstep: its BSP program cost and the per-core stream volume.

    Eq. 1 sums C_i over *all* opened streams O_s of core s — down *and* up.
    ``fetch_words[s]`` is the volume core s streams down for the *next*
    hyperstep; ``writeback_words[s]`` is the volume of finished output tokens
    it streams up during this hyperstep. Both ride the same external link, so
    the link side of the ``max`` is their sum.

    The hyperstep's compute side is a full *inner BSP program* on the p-core
    grid, ``Σ_i (max_s w_i(s) + g·h_i + l)``: ``bsp_flops`` is the work term
    (the sum of per-superstep critical paths), ``comm_words`` the summed
    h-relations ``Σ_i h_i`` in words, and ``supersteps`` the superstep count
    (each pays one barrier ``l``). With ``comm_words = supersteps = 0`` the
    hyperstep degenerates to the single-core pure-compute case. Two-level
    Cannon (paper Eq. 2) is one hyperstep with ``bsp_flops = N·2k³``,
    ``comm_words = N·2k²``, ``supersteps = N`` and ``fetch_words = [2k²]·p``.

    The *host* level (DESIGN.md §8) applies the superstep term once more,
    recursively: ``host_comm_words`` is the host-level h-relation (max words
    any one host exchanges with the others during this hyperstep — FSDP
    all-gathers, gradient reduce-scatters, Cannon block rotations between
    hosts) and ``host_supersteps`` the number of host-level barriers. They
    are priced with the *outer* pair ``(g_host, l_host)`` and added on top
    of the device-level max — the device term T_device is itself the inner
    program a host-level superstep runs, so the recursion is
    ``T_host = T_device + g_host·h_host + l_host·s_host``.
    """

    bsp_flops: float
    fetch_words: Sequence[float]
    writeback_words: Sequence[float] = ()
    comm_words: float = 0.0
    supersteps: float = 0.0
    host_comm_words: float = 0.0
    host_supersteps: float = 0.0

    def compute_cost(self, machine: BSPComputer) -> float:
        """The inner BSP program's cost: Σ_i (max_s w_i(s) + g·h_i + l)."""
        return (self.bsp_flops + machine.g * self.comm_words
                + machine.l * self.supersteps)

    def link_cost(self, acc: BSPAccelerator) -> float:
        """e · max_s Σ_{i ∈ O_s} C_i over both stream directions (Eq. 1).

        The max is over each core's *combined* down+up volume — a core heavy
        on fetch and another heavy on write-back do not add up across cores.
        """
        fw, ww = list(self.fetch_words), list(self.writeback_words)
        n = max(len(fw), len(ww))
        if n == 0:
            return 0.0
        fw += [0.0] * (n - len(fw))
        ww += [0.0] * (n - len(ww))
        return acc.e * max(f + w for f, w in zip(fw, ww))

    def fetch_cost(self, acc: BSPAccelerator) -> float:
        return acc.e * max(self.fetch_words, default=0.0)

    def writeback_cost(self, acc: BSPAccelerator) -> float:
        return acc.e * max(self.writeback_words, default=0.0)

    def host_cost(self, acc: BSPAccelerator) -> float:
        """The outer superstep term ``g_host·h_host + l_host·s_host``."""
        return (acc.g_host * self.host_comm_words
                + acc.l_host * self.host_supersteps)

    def device_cost(self, acc: BSPAccelerator) -> float:
        """T_device: the Eq. 1 max over compute and link, no host term."""
        return max(self.compute_cost(acc), self.link_cost(acc))

    def cost(self, acc: BSPAccelerator) -> float:
        """Full recursive cost: T_device + g_host·h_host + l_host·s_host."""
        return self.device_cost(acc) + self.host_cost(acc)

    def bandwidth_heavy(self, acc: BSPAccelerator) -> bool:
        """True if moving tokens (either direction) dominates (paper §2)."""
        return self.link_cost(acc) > self.compute_cost(acc)


def bsp_cost(supersteps: Sequence[SuperstepCost], machine: BSPComputer) -> float:
    """Total BSP cost T of a program given per-superstep accounting."""
    return sum(s.cost(machine) for s in supersteps)


def bsps_cost(hypersteps: Sequence[HyperstepCost], acc: BSPAccelerator) -> float:
    """Total BSPS cost T̃ (paper Eq. 1)."""
    return sum(h.cost(acc) for h in hypersteps)


# ---------------------------------------------------------------------------
# Closed forms from the paper's worked examples
# ---------------------------------------------------------------------------


def inner_product_cost(acc: BSPAccelerator, N: int, C: int) -> float:
    """BSPS cost of the §3.1 inner product of two N-vectors with token size C.

    T = n·max(2C, 2Ce) + p + (p-1)g + l  with  n = N/(pC) hypersteps.
    Bandwidth-heavy iff e > 1.
    """
    n = math.ceil(N / (acc.p * C))
    hyper = n * max(2.0 * C, 2.0 * C * acc.e)
    reduction = acc.p + (acc.p - 1) * acc.g + acc.l
    return hyper + reduction


def cannon_bsp_cost(machine: BSPComputer, N: int, k: int) -> float:
    """BSP cost of inner-level Cannon on an N×N core grid, k×k inner blocks."""
    return N * (2.0 * k**3 + k**2 * machine.g + machine.l)


def cannon_bsps_cost(acc: BSPAccelerator, n: int, M: int, N: int | None = None) -> float:
    """BSPS cost of two-level Cannon (paper Eq. 2) for n×n matrices.

    M = outer blocks per dimension, N = core-grid side (default √p),
    k = n/(N·M) = inner block side. T̃ = M³ · max( N(2k³ + 2k²g + l), 2k²e ).
    """
    if N is None:
        N = acc.core_grid_side()
    if n % (N * M) != 0:
        raise ValueError(f"n={n} must be divisible by N*M={N * M} (paper pads with zeros)")
    k = n // (N * M)
    return M**3 * cannon_hyperstep(acc, k, N).cost(acc)


def cannon_hyperstep(acc: BSPAccelerator, k: int, N: int) -> HyperstepCost:
    """One hyperstep of two-level Cannon (the per-step term of Eq. 2).

    The inner BSP program is N supersteps of Cannon on the N×N core grid:
    work N·2k³, h-relation 2k² per superstep (one k×k block of A and of B
    shifted per core), one barrier each — ``compute_cost`` is exactly
    ``N(2k³ + 2k²g + l)``. The link side is the prefetch of the next outer
    block's two k² tokens per core.
    """
    return HyperstepCost(
        bsp_flops=N * 2.0 * k**3,
        comm_words=N * 2.0 * k**2,
        supersteps=float(N),
        fetch_words=[2.0 * k**2] * acc.p,
    )


def cannon_k_equal(acc: BSPAccelerator, N: int | None = None,
                   k_max: float = 4096.0) -> float:
    """Inner block size k at which Cannon hypersteps flip bandwidth↔compute heavy.

    Solves N(2k³ + 2k²g + l) = 2k²e (paper Eq. 2, LHS = RHS). The compute side
    grows ~k³ and the fetch side ~k², so above the *largest* root hypersteps are
    compute heavy; we return that root — the paper's k_equal (≈8 on Epiphany-III,
    validated against measurements in Fig. 5).

    Note the diff is not monotone: at very small k the latency term N·l dominates
    the compute side, so a bandwidth-heavy *window* may exist between two roots
    (or, with the paper's pessimistic contested-network g = 5.59, no window at
    all — the window appears with the optimized-write g ≲ 1 the paper measured
    for core-to-core writes, which Cannon's shifts use). Returns:

    * the largest crossover k, if fetch dominates somewhere in (0, k_max];
    * 0.0 if compute dominates for every k (never bandwidth heavy);
    * ``math.inf`` if fetch still dominates at k_max (always bandwidth heavy).
    """
    if N is None:
        N = int(math.isqrt(acc.p))

    def diff(k: float) -> float:
        compute = N * (2.0 * k**3 + 2.0 * k**2 * acc.g + acc.l)
        return compute - 2.0 * k**2 * acc.e

    if diff(k_max) < 0:
        return math.inf
    # Scan down from k_max for the largest sign change, then bisect.
    hi = k_max
    lo = None
    k = k_max
    while k > 1e-3:
        k *= 0.98
        if diff(k) < 0:
            lo = k
            break
        hi = k
    if lo is None:
        return 0.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if diff(mid) < 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)

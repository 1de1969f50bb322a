"""BSP computer and BSP accelerator parameter packs (paper §1–2).

The paper defines:
  * a BSP computer by ``(p, g, l, r)`` — processors, inverse network bandwidth
    (FLOPs/word), synchronisation latency (FLOPs), compute rate (FLOP/s);
  * a **BSP accelerator** by ``(p, r, g, l, e, L, E)`` — adding ``e``, the inverse
    bandwidth to a shared external memory pool (FLOPs/word), local memory ``L``
    (words) and external memory ``E`` (words).

All ``g``/``l``/``e`` values are in FLOPs (per data word where applicable), so costs
computed from them are hardware-independent; divide by ``r`` for seconds.

The only preset is the paper's own hardware (Epiphany-III on the Parallella,
the measured values of §5). A pack for the card is measured by
:func:`repro_torch.core.calibrate.calibrate`, never written down by hand.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "BSPComputer",
    "BSPAccelerator",
    "EPIPHANY_III",
    "WORD_BYTES",
]

# The paper sets one data word = one float (4 bytes on Epiphany); packs carry
# their own word size.
WORD_BYTES = 4


@dataclasses.dataclass(frozen=True)
class BSPComputer:
    """Classic BSP machine ``(p, g, l, r)``.

    g and l are measured in FLOPs (g per data word), r in FLOP/s per processor.
    """

    p: int
    g: float
    l: float
    r: float
    word_bytes: int = WORD_BYTES
    name: str = "bsp"

    def __post_init__(self) -> None:
        if self.p <= 0:
            raise ValueError(f"p must be positive, got {self.p}")
        if self.g < 0 or self.l < 0 or self.r <= 0:
            raise ValueError("g, l must be >= 0 and r > 0")

    def flops_to_seconds(self, flops: float) -> float:
        return flops / self.r


@dataclasses.dataclass(frozen=True)
class BSPAccelerator(BSPComputer):
    """BSP accelerator ``(p, r, g, l, e, L, E)`` (paper §2).

    e : inverse bandwidth to the shared external memory pool, FLOPs per word.
    L : local (scratchpad) memory per core, in words. Prefetching (double
        buffering) halves the *effective* local memory — see
        :meth:`effective_local_words`.
    E : external memory pool size, in words.

    The optional third pricing level (DESIGN.md §8) views a *mesh of hosts*,
    each running the whole device hyperstep program, as one more BSP machine
    wrapped around it: ``hosts`` machines exchanging ``h_host`` words per
    host-level superstep at ``g_host`` FLOPs/word with barrier cost ``l_host``
    FLOPs. The superstep term ``g·h + l`` is applied recursively — a
    host-level hyperstep costs ``T_device + g_host·h_host + l_host·s_host``
    with ``T_device`` the already-composed Eq. 2 device term. Defaults
    (``hosts=1``, ``g_host=l_host=0``) make single-host plans price exactly
    as before.
    """

    e: float = 0.0
    L: int = 0
    E: int = 0
    hosts: int = 1
    g_host: float = 0.0
    l_host: float = 0.0

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.e < 0:
            raise ValueError(f"e must be >= 0, got {self.e}")
        if self.L <= 0 or self.E <= 0:
            raise ValueError("L and E must be positive (words)")
        if self.E < self.L:
            raise ValueError("external memory E must be >= local memory L")
        if self.hosts <= 0:
            raise ValueError(f"hosts must be positive, got {self.hosts}")
        if self.g_host < 0 or self.l_host < 0:
            raise ValueError("g_host and l_host must be >= 0")

    # -- derived quantities -------------------------------------------------

    def effective_local_words(self, prefetch: bool = True) -> int:
        """Usable words of local memory per core.

        The paper (§2, Hypersteps): "prefetching data halves the effective local
        memory size, since storage needs to be reserved for the buffer that holds
        the next token."
        """
        return self.L // 2 if prefetch else self.L

    def max_token_words(self, n_streams_per_core: int = 1, prefetch: bool = True) -> int:
        """Largest token size C (words) so n open streams fit per core."""
        if n_streams_per_core <= 0:
            raise ValueError("need at least one stream")
        return self.effective_local_words(prefetch) // n_streams_per_core

    def core_grid_side(self) -> int:
        """N = √p for square-core-grid algorithms (Cannon, paper §3.2)."""
        n = int(math.isqrt(self.p))
        if n * n != self.p:
            raise ValueError(
                f"p={self.p} on {self.name} is not a square core grid; "
                "pass the grid side N explicitly")
        return n


def _epiphany() -> BSPAccelerator:
    # Paper §5: 600 MHz, ~1 FLOP / 5 cycles for compiled BSPS code;
    # e ≈ 43.4 FLOP/float (11 MB/s contested DMA read), g ≈ 5.59, l ≈ 136.
    # L = 32 kB SRAM, E = 32 MB shared DRAM; single-precision words (4 B).
    r = 600e6 / 5.0
    return BSPAccelerator(
        p=16, g=5.59, l=136.0, r=r, e=43.4,
        L=32 * 1024 // 4, E=32 * 1024 * 1024 // 4,
        word_bytes=4, name="epiphany-iii",
    )


EPIPHANY_III = _epiphany()

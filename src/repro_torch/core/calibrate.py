"""Calibrate a BSPAccelerator parameter pack for the device the port runs on.

The paper (§5) measures (r, g, l, e) for the Epiphany-III; the port does the
same for its card so the cost model's predictions can be held against
measured hyperstep timings (§6 methodology). On a CUDA device:

* ``r`` is the rate of a bf16 matrix product on the card, timed with CUDA
  events;
* ``e`` is ``r`` over the external link's rate in words/s, the link being
  pinned host RAM → device memory (the copy the hyperstep runner's DMA lane
  makes);
* ``l`` is the measured per-hyperstep latency of a near-empty
  :class:`~repro_torch.core.hyperstep.HyperstepRunner` run (a launch plus a
  bulk sync);
* ``L`` is the device memory (the runner's local memory), ``E`` the host RAM.

On the CPU (``device="cpu"``) the same probes run in float32 with the JAX
package's host geometry for ``L``/``E``. No number of this module is ever
copied from another machine's pack.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.bsp import BSPAccelerator
from repro_torch.device import resolve_device

__all__ = [
    "calibrate",
    "default_machine",
    "measure_flops_rate",
    "measure_external_bandwidth",
    "measure_hyperstep_latency",
]

WORD_BYTES = 4   # the link is priced in float32 words, as in the JAX package


def _time(fn: Callable[[], Any], device: torch.device, repeats: int = 5) -> float:
    """Discard a first (warm-up) call, then the median of ``repeats``.

    On a CUDA device each repeat is timed with CUDA events around ``fn``;
    on the CPU with the host clock.
    """
    fn()
    ts = []
    for _ in range(max(int(repeats), 3)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_flops_rate(device: Any = None, n: int = 4096) -> float:
    """FLOP/s of an n×n matrix product: bf16 on the card, float32 on the CPU."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    g = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((n, n), generator=g).to(device, dtype)
    dt = _time(lambda: a @ a, device)
    return 2 * n**3 / dt


def measure_external_bandwidth(device: Any = None, nbytes: int = 1 << 28) -> float:
    """Host RAM -> device words/s (the e-link), float32 words.

    On the card the source is pinned host memory, as in the runner's lanes.
    """
    device = resolve_device(device)
    src = torch.zeros(nbytes // WORD_BYTES, dtype=torch.float32)
    if device.type == "cuda":
        src = src.pin_memory()
        dt = _time(lambda: src.to(device, non_blocking=True), device)
    else:
        dt = _time(lambda: src.clone(), device)
    return (nbytes / WORD_BYTES) / dt


def measure_hyperstep_latency(device: Any = None, steps: int = 16) -> float:
    """Per-hyperstep fixed overhead (seconds) — the machine's l.

    The paper's l is the barrier cost; here its analogue is what one
    near-empty hyperstep of the runner costs: staging a tiny token, one
    small device operation, and the bulk sync.
    """
    from repro_torch.core.hyperstep import HyperstepRunner
    from repro_torch.core.stream import StreamSet

    device = resolve_device(device)
    ss = StreamSet()
    s1 = ss.create(np.zeros(16 * steps, np.float32), 16)
    runner = HyperstepRunner(lambda acc, t: acc + t[0].sum(), [s1],
                             prefetch=False, device=device)
    runner.run(torch.zeros((), device=device))
    # record 0 pays first-use costs (allocator, pinned pool) — drop it
    recs = runner.records[1:] or runner.records
    return float(np.median([r.step_seconds for r in recs]))


def _host_ram_bytes() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 1 << 34


def calibrate(p: int = 1, *, fast: bool = False, device: Any = None) -> BSPAccelerator:
    """Measure (r, e, l) on ``device`` (default: the card) and return the pack.

    ``fast=True`` shrinks the probes — good enough for a launcher's
    predicted row; every parameter is still measured.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        n, nbytes = (2048, 1 << 26) if fast else (8192, 1 << 28)
    else:
        n, nbytes = (256, 1 << 22) if fast else (768, 1 << 26)
    r = measure_flops_rate(device, n=n)
    words_per_s = measure_external_bandwidth(device, nbytes=nbytes)
    l = measure_hyperstep_latency(device, steps=8 if fast else 32) * r
    e = r / words_per_s  # FLOPs per word
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        local = props.total_memory // WORD_BYTES
        external = max(_host_ram_bytes() // WORD_BYTES, local)
        name = f"cuda:{props.name}"
    else:
        local, external = (1 << 25) // WORD_BYTES, (1 << 34) // WORD_BYTES
        name = "cpu-host"
    return BSPAccelerator(
        p=p, g=0.0, l=l, r=r, e=e, L=local, E=external,
        word_bytes=WORD_BYTES, name=name,
    )


_MACHINE_CACHE: dict[tuple, BSPAccelerator] = {}


def default_machine(p: int = 1, device: Any = None) -> BSPAccelerator:
    """The process-wide calibrated pack, measured once per (p, device).

    Hot paths that need a machine but were given none (``generate()``) use
    this instead of calling :func:`calibrate` per request.
    """
    device = resolve_device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    key = (int(p), str(device), name)
    pack = _MACHINE_CACHE.get(key)
    if pack is None:
        pack = _MACHINE_CACHE[key] = calibrate(p, fast=True, device=device)
    return pack


default_machine.cache_clear = _MACHINE_CACHE.clear

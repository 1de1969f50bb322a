"""Card-level roofline: the paper's BSPS cost generalised to three terms.

The paper's hyperstep cost is ``max(T_h, e·ΣC_i)`` — compute against
external-memory fetch. A training or serving step on a card has three
resources that overlap, so a step's cost model is

    T_step ≈ max( compute, memory, collective )

with, over ``chips`` cards,

    compute    = FLOPs            / (chips × peak FLOP/s)
    memory     = bytes            / (chips × HBM bytes/s)
    collective = collective bytes / (chips × link bytes/s)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled step. PyTorch has no compiled step to ask, so the port counts the
work it runs (:func:`count`): the FLOPs and bytes of every torch op the
dispatcher sees, and for each hand-written kernel (launched through ctypes,
which the dispatcher never sees) the formula of its module's ``cost``
function. On one card ``chips`` is 1 and the collective bytes are 0.

Hardware constants: NVIDIA H100 SXM5 80 GB (data sheet, dense, at its 700 W
power limit) — 989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s HBM3, 80 GB,
NVLink 4 (18 links of 25 GB/s a direction).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Iterator, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["HardwareSpec", "H100_SXM", "RooflineReport", "Count", "KernelCost", "analyze",
           "count", "counted", "uncounted", "kernel_bound", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per chip, FLOP/s (bf16)
    hbm_bandwidth: float       # per chip, bytes/s
    ici_bandwidth: float       # per chip per link, bytes/s
    ici_links: int = 2         # links participating per collective direction
    hbm_bytes: float = 16e9
    peak_flops_fp32: float = 0.0   # per chip, FLOP/s (fp32, no tensor cores)

    @property
    def link_bandwidth(self) -> float:
        return self.ici_bandwidth * self.ici_links

    def peak(self, kind: str) -> float:
        """Peak FLOP/s for operations of ``kind``: "bf16" or "fp32"."""
        return {"bf16": self.peak_flops, "fp32": self.peak_flops_fp32}[kind]


H100_SXM = HardwareSpec(
    name="h100-sxm5-80gb",
    peak_flops=989e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=25e9,
    ici_links=18,
    hbm_bytes=80e9,
    peak_flops_fp32=67e12,
)


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """Three-term roofline for one (arch × shape × device) run."""

    name: str
    chips: int
    # per-device counted quantities
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_stats: Any | None
    # model-level useful FLOPs (global): 6·N·D dense / 6·N_active·D MoE
    model_flops_global: float
    hw: HardwareSpec = H100_SXM
    # peak device memory, bytes per device
    peak_device_bytes: float = 0.0

    # -- the three terms, in seconds ----------------------------------------

    @property
    def compute_seconds(self) -> float:
        return self.hlo_flops / self.hw.peak_flops

    @property
    def memory_seconds(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bandwidth

    @property
    def collective_seconds(self) -> float:
        return self.coll_bytes / self.hw.link_bandwidth

    @property
    def step_seconds(self) -> float:
        """BSPS-style step estimate: max of the three overlapped resources."""
        return max(self.compute_seconds, self.memory_seconds, self.collective_seconds)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_seconds,
            "memory": self.memory_seconds,
            "collective": self.collective_seconds,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global) — catches remat/redundant compute."""
        total = self.hlo_flops * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU if the step ran exactly at the dominant-term bound."""
        denom = self.step_seconds * self.chips * self.hw.peak_flops
        return self.model_flops_global / denom if denom else 0.0

    def row(self) -> dict[str, Any]:
        return {
            "cell": self.name,
            "chips": self.chips,
            "compute_s": self.compute_seconds,
            "memory_s": self.memory_seconds,
            "collective_s": self.collective_seconds,
            "dominant": self.dominant,
            "model_gflops": self.model_flops_global / 1e9,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_frac": self.roofline_fraction,
            "peak_device_gb": self.peak_device_bytes / 1e9,
        }

    def __str__(self) -> str:
        return (
            f"{self.name}: compute {self.compute_seconds * 1e3:.3f} ms | "
            f"memory {self.memory_seconds * 1e3:.3f} ms | "
            f"collective {self.collective_seconds * 1e3:.3f} ms  "
            f"=> {self.dominant}-bound, useful {self.useful_flops_ratio:.3f}, "
            f"roofline {self.roofline_fraction:.3f}, "
            f"{self.peak_device_bytes / 1e9:.2f} GB/device"
        )


def model_flops(
    *,
    params: float,
    active_params: float | None,
    tokens: float,
    training: bool,
) -> float:
    """Useful model FLOPs: 6·N·D training / 2·N·D inference (N_active for MoE)."""
    n = active_params if active_params is not None else params
    factor = 6.0 if training else 2.0
    return factor * n * tokens


# -- the kernels' own work ------------------------------------------------------------


class KernelCost(NamedTuple):
    """The work a kernel's function needs: its operations, the bytes of its
    inputs read once and its outputs written once, and the operations' type
    ("bf16" on the tensor cores, "fp32" on the FMA pipes)."""

    flops: float
    bytes: float
    kind: str


def kernel_bound(cost: KernelCost, hw: HardwareSpec = H100_SXM) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for ``cost`` — the larger of its bytes over the memory rate and its
    operations over the peak rate of their type."""
    t_bytes = cost.bytes / hw.hbm_bandwidth
    t_ops = cost.flops / hw.peak(cost.kind)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the counter ------------------------------------------------------------------------


@dataclasses.dataclass
class Count:
    """What the work run inside :func:`count` needs: FLOPs and bytes (the
    torch ops' and the kernels'), kernel calls, and the device's peak
    memory. ``kernels`` splits the kernels' part by wrapper (calls, FLOPs,
    bytes), ``ops`` the torch ops' by aten op (calls, FLOPs, bytes)."""

    flops: float = 0.0
    bytes: float = 0.0
    launches: int = 0
    kernels: dict[str, list] = dataclasses.field(default_factory=dict)
    ops: dict[str, list] = dataclasses.field(default_factory=dict)
    peak_device_bytes: float = 0.0

    def _add(self, table: dict, key: str, flops: float, nbytes: float) -> None:
        row = table.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes


# the counts open now, and the depth of kernel calls (and uncounted blocks)
# the current work is inside: the torch ops there are not counted
_OPEN: list[Count] = []
_DEPTH = [0]

_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
                "_unsafe_view", "resize_", "lift_fresh"}
# ops that read their first tensor only where the indices point (as many
# elements as they write), and in-place ops that write their first tensor
# only there (as many elements as the values they are given)
_GATHERS = {"embedding", "index_select", "gather", "index", "take"}
_SCATTERS = {"index_put_", "index_copy_", "index_add_", "scatter_", "scatter_add_"}


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _nbytes(t: torch.Tensor) -> int:
    """Bytes ``t`` spans once: broadcast (stride-0) dims read their element
    once, so an expanded view counts its storage, not its logical size."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


def _op_cost(func, args, kwargs, out) -> tuple[float, float]:
    """(FLOPs, bytes) of one aten op: FLOPs from ``torch.utils.flop_counter``'s
    formulas for the products (0 for elementwise work), bytes each distinct
    input read once and each output written once (an in-place op's output is
    its input, counted once); views and allocations move nothing, gathers
    and in-place scatters only the elements they touch of the indexed
    tensor."""
    name = func.__name__.split(".")[0]
    if getattr(func, "is_view", False) or torch.Tag.inplace_view in func.tags \
            or name in _ALLOCATIONS:
        return 0.0, 0.0
    inputs = list(_tensors((args, kwargs)))
    seen: dict[tuple, int] = {}
    if name in _GATHERS | _SCATTERS and inputs:
        first, rest = inputs[0], inputs[1:]
        outs = [t for t in _tensors(out) if _key(t) != _key(first)]
        if name in _GATHERS:
            touched = sum(_nbytes(t) for t in outs)
        else:
            values = [t for t in rest if t.dtype == first.dtype]
            touched = _nbytes(values[-1]) if values else 0
        seen[_key(first)] = min(_nbytes(first), touched)
        inputs = rest
    for t in inputs:
        seen.setdefault(_key(t), _nbytes(t))
    for t in _tensors(out):
        seen.setdefault(_key(t), _nbytes(t))
    formula = flop_registry.get(func._overloadpacket)
    flops = float(formula(*args, **kwargs, out_val=out)) if formula is not None else 0.0
    return flops, float(sum(seen.values()))


class _OpCounter(TorchDispatchMode):
    def __init__(self, into: Count):
        super().__init__()
        self.into = into

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _DEPTH[0]:
            flops, nbytes = _op_cost(func, args, kwargs, out)
            self.into._add(self.into.ops, str(func), flops, nbytes)
        return out


@contextlib.contextmanager
def count(device: Any = None) -> Iterator[Count]:
    """Count the work run inside the block: ``with count() as c: step(...)``.

    Torch ops are counted through a ``TorchDispatchMode``; each kernel
    wrapper decorated with :func:`counted` records its ``cost`` once a call
    and hides the torch ops it runs (on CPU tensors its plain version, on
    CUDA tensors its allocations), so a call counts the same on both
    devices. Counting never changes which path runs. The mode is the
    calling thread's (autograd's backward carries it); ops other threads run
    (the hyperstep runner's staging lanes) are not counted. ``device`` (a CUDA
    device) gives ``peak_device_bytes`` from ``torch.cuda.max_memory_allocated``
    over the block; the peak statistics are reset at its start.
    """
    c = Count()
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _OPEN.append(c)
    try:
        with _OpCounter(c):
            yield c
    finally:
        _OPEN.remove(c)
        if cuda:
            c.peak_device_bytes = float(torch.cuda.max_memory_allocated(device))


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Leave the torch ops run inside the block out of every open count:
    work a kernel's launch needs that is not the function's own (staging an
    operand for TMA)."""
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def counted(name: str, cost: Callable[..., KernelCost]):
    """Decorate kernel wrapper ``name``: inside a :func:`count`, a call adds
    ``cost(*args, **kwargs)`` to every open count, once, and the torch ops it
    runs are not counted. A kernel call made inside another (the scan's
    backward launching its forward for the tape) belongs to the outer one."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _OPEN:
                return fn(*args, **kwargs)
            _DEPTH[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
            if not _DEPTH[0]:
                c = cost(*args, **kwargs)
                for open_count in _OPEN:
                    open_count._add(open_count.kernels, name, c.flops, c.bytes)
                    open_count.launches += 1
            return out

        return wrapper

    return deco


def analyze(name: str, c: Count, *, model_flops_global: float,
            hw: HardwareSpec = H100_SXM) -> RooflineReport:
    """Build a :class:`RooflineReport` for one card from a :class:`Count`."""
    return RooflineReport(
        name=name,
        chips=1,
        hlo_flops=c.flops,
        hlo_bytes=c.bytes,
        coll_bytes=0.0,
        coll_stats=None,
        model_flops_global=model_flops_global,
        hw=hw,
        peak_device_bytes=c.peak_device_bytes,
    )

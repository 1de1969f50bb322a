"""Lower a chip-level StreamPlan to a CUDA launch — the port's one launch site.

This is the only module of the port that touches the compiled kernel
library. Every kernel in ``kernels/`` declares its streaming structure as a
:class:`repro_torch.core.plan.StreamPlan` and hands it here with the name of
its C entry point; the mapping (the counterpart of the JAX package's
``pl.pallas_call`` lowering) is mechanical:

  =============================  ==========================================
  StreamPlan                     CUDA launch
  =============================  ==========================================
  "parallel" grid axes           the CUDA grid, last such axis in x
  "arbitrary" grid axes          the loop count each block runs in order
                                 (a CUDA grid has no order to carry state)
  ScratchSpec                    the block's persistent state: checked
                                 against the device's per-block opt-in
                                 limit; dynamic shared memory, or registers
                                 where the kernel keeps it there (flash,
                                 the matmul's wgmma variant)
  TokenSpec block_shape          the tile the kernel stages per hyperstep
  =============================  ==========================================

Launches are cached by plan fingerprint, so a kernel that rebuilds its plan
for a shape it has seen does not lower it again.

The kernel library is built on first use: one ``nvcc`` per source under
``csrc/``, all started together, for ``sm_90a``, linked into one shared
library with a plain C interface under ``build/kernels/`` of the checkout
and loaded with ``ctypes``. Its name carries a hash of the sources and
flags, so an edited source is rebuilt. Every C entry point takes the launch
prefix ``(device, gx, gy, gz, loop, scratch_bytes, stream)`` and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Any

import torch

from repro_torch.core.plan import StreamPlan

__all__ = ["Launch", "geometry", "lower", "launch", "library", "build_library", "sm_count",
           "sweep_kernels", "kernel_attrs", "BUILD_DIR", "CSRC"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("device.cu", "streamed_dot.cu", "streamed_matmul.cu", "flash_attention.cu",
           "ssm_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PREFIX = [_I, _I, _I, _I, _I, _I, _P]   # device, gx, gy, gz, loop, scratch, stream
# argument types after the launch prefix, per C entry point
ENTRIES: dict[str, list[Any]] = {
    "bsps_dot": [_P, _P, _LL, _I, _I, _P, _P],
    "bsps_matmul": [_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _I, _I, _I],
    "bsps_flash": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P],
    "bsps_ssm_scan": [_P] * 8 + [_I] * 7,
    "bsps_ssm_scan_bwd": [_P] * 17 + [_I] * 8,
}
#: queries of a kernel's compiled attributes: the device, the query's ints,
#: then an int[4] the entry fills (:func:`kernel_attrs`)
QUERIES: dict[str, list[Any]] = {"bsps_ssm_scan_bwd_attrs": [_I, _I, _I, _P],
                                 "bsps_flash_attrs": [_I, _I, _I, _P],
                                 "bsps_matmul_attrs": [_I, _I, _I, _I, _P]}
_LIBRARY_ENTRIES = {"bsps_smem_optin": [_I], **QUERIES,
                    **{name: _PREFIX + args for name, args in ENTRIES.items()}}
#: the fp32 matmul's tile sweep (``launch/sweep_simt_f32``), a library of its
#: own: its source and its entry points' full argument types
SWEEP_SOURCES = ("sweep/simt_f32_sweep.cu",)
SWEEP_ENTRIES: dict[str, list[Any]] = {
    "bsps_sweep_f32": [_I, _P, _P, _P, _P, _P, _I, _I, _I],
    "bsps_sweep_f32_count": [],
}


@dataclasses.dataclass(frozen=True)
class Launch:
    """A plan lowered to launch geometry for one C entry point."""

    entry: str
    grid: tuple[int, int, int]
    loop: int
    scratch_bytes: int


_LOWER_CACHE: dict[tuple, Launch] = {}
_LIB: dict[str, Any] = {}
_LIB_LOCK = threading.Lock()
_SMEM_LIMIT: dict[int, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _source_hash(sources: tuple[str, ...]) -> str:
    h = hashlib.sha1(repr(NVCC_FLAGS).encode())
    names = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    for name in (*names, *sources):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:12]


def build_library(sources: tuple[str, ...] = SOURCES,
                  name: str = "libbsps_kernels") -> pathlib.Path:
    """Compile ``sources`` (paths under ``csrc/``, by default the kernel
    library's) into the shared library ``name`` if not built yet.

    One ``nvcc -c`` per source, all running at once; then one link. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept in ``<source file name>.log`` beside the library. Returns the
    library path.
    """
    out_dir = BUILD_DIR / _source_hash(sources)
    lib_path = out_dir / f"{name}.so"
    if lib_path.exists():
        return lib_path
    # objects go to a directory of this process, so builds racing from
    # several processes never link each other's half-written objects
    work = out_dir / f"build-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    files = [pathlib.Path(src).name for src in sources]
    procs = []
    for src, file in zip(sources, files):
        log = open(work / (file + ".log"), "w")  # noqa: SIM115 — closed below
        procs.append((file, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(work / (file + ".o"))],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for file, log, proc in procs:
        if proc.wait() != 0:
            failed.append(file)
        log.close()
    if failed:
        msgs = "\n".join((work / (f + ".log")).read_text() for f in failed)
        raise RuntimeError(f"nvcc failed on {failed}:\n{msgs}")
    subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / "lib.so"),
                    *(str(work / (f + ".o")) for f in files)], check=True)
    for file in files:
        os.replace(work / (file + ".log"), out_dir / (file + ".log"))
    os.replace(work / "lib.so", lib_path)
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _load(key: str, build: Any, entries: dict[str, list[Any]]) -> Any:
    """Library ``key``, built by ``build()`` and loaded on first use, with
    each entry's argument types declared and an int result."""
    with _LIB_LOCK:
        lib = _LIB.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _I
            _LIB[key] = lib
        return lib


def library() -> Any:
    """The loaded kernel library (built on first use)."""
    lib = _LIB.get("lib")
    return lib if lib is not None else _load("lib", build_library, _LIBRARY_ENTRIES)


def sweep_kernels() -> Any:
    """The fp32 matmul's tile sweep library (built on first use), whose
    entries are :data:`SWEEP_ENTRIES`: a measurement tool's, not the
    port's."""
    return _load("sweep", lambda: build_library(SWEEP_SOURCES, "libbsps_sweep"), SWEEP_ENTRIES)


def _smem_limit(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    limit = _SMEM_LIMIT.get(idx)
    if limit is None:
        limit = library().bsps_smem_optin(idx)
        if limit < 0:
            raise RuntimeError(f"cannot query shared memory of cuda:{idx}")
        _SMEM_LIMIT[idx] = limit
    return limit


def geometry(plan: StreamPlan) -> tuple[tuple[int, int, int], int]:
    """``(grid, loop)`` of ``plan``: its "parallel" axes as the CUDA grid (the
    last one in x, at most three) and the product of its "arbitrary" axes as
    the per-block loop count."""
    sem = plan.dimension_semantics or ("arbitrary",) * len(plan.grid)
    parallel = [g for g, s in zip(plan.grid, sem) if s == "parallel"]
    loop = 1
    for g, s in zip(plan.grid, sem):
        if s != "parallel":
            loop *= g
    if len(parallel) > 3:
        raise ValueError(f"{plan.name}: {len(parallel)} parallel axes; a CUDA grid has 3")
    grid = tuple(reversed(parallel)) + (1,) * (3 - len(parallel))
    if grid[1] > 65535 or grid[2] > 65535 or grid[0] > 2**31 - 1:
        raise ValueError(f"{plan.name}: grid {grid} exceeds the CUDA grid limits")
    return grid, loop


def lower(plan: StreamPlan, entry: str, device: torch.device) -> Launch:
    """Map ``plan`` to the launch of C entry point ``entry`` on ``device``.

    The geometry comes from :func:`geometry`; the plan's scratch becomes the
    dynamic shared-memory request, refused when it exceeds what one block
    may have on ``device``.
    """
    if entry not in ENTRIES:
        raise ValueError(f"unknown kernel entry {entry!r}")
    key = (plan.fingerprint(), entry, device.index)
    hit = _LOWER_CACHE.get(key)
    if hit is not None:
        return hit
    grid, loop = geometry(plan)
    limit = _smem_limit(device)
    if plan.scratch_bytes > limit:
        raise ValueError(
            f"{plan.name}: scratch of {plan.scratch_bytes} bytes exceeds the "
            f"{limit} bytes of shared memory a block may use")
    out = Launch(entry, grid, loop, plan.scratch_bytes)
    _LOWER_CACHE[key] = out
    return out


def launch(plan_launch: Launch, device: torch.device, *args: Any) -> None:
    """Run ``plan_launch`` on PyTorch's current stream of ``device``.

    ``args`` follow the entry's launch prefix (pointers as ints from
    ``tensor.data_ptr()``). Raises ``RuntimeError`` when the C side reports
    a CUDA error — a refused launch never runs, and nothing falls back.
    """
    fn = getattr(library(), plan_launch.entry)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    gx, gy, gz = plan_launch.grid
    err = fn(idx, gx, gy, gz, plan_launch.loop, plan_launch.scratch_bytes, stream, *args)
    if err != 0:
        raise RuntimeError(
            f"{plan_launch.entry} failed with CUDA error {err} "
            f"(grid {plan_launch.grid}, loop {plan_launch.loop}, "
            f"scratch {plan_launch.scratch_bytes} B)")


def kernel_attrs(query: str, device: torch.device, *args: int) -> tuple[int, int, int, int]:
    """The four ints that the library's ``query`` entry reports for a
    kernel on ``device`` (what each means is the entry's: for
    ``bsps_ssm_scan_bwd_attrs``, ``bsps_flash_attrs`` and
    ``bsps_matmul_attrs`` registers and spilled bytes a thread, shared
    memory a block, resident blocks an SM).
    Raises on a CUDA error."""
    if query not in QUERIES:
        raise ValueError(f"unknown kernel query {query!r}")
    idx = device.index if device.index is not None else torch.cuda.current_device()
    out = (_I * 4)()
    err = getattr(library(), query)(idx, *args, out)
    if err != 0:
        raise RuntimeError(f"{query}{args} failed with CUDA error {err}")
    return tuple(out)


_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` — what a launch must fill."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]

"""The rank's process group: one process per rank, as ``torch.distributed``
runs a mesh (the JAX package has no counterpart: JAX's runtime owns its
devices).

* :func:`start` / :func:`end` open and close the rank's default group. The
  backend follows the device — ``nccl`` for the card, ``gloo`` for the CPU —
  and never swaps: a CUDA rank without ``nccl`` fails. The rendezvous is a
  file in a directory the caller names (``file://``), never a TCP port, so
  that concurrent runs on one host cannot collide.
* :func:`spawn` starts N CPU ranks on ``gloo`` (one thread each), runs
  ``fn(rank, world, *args)`` in each and returns their results in rank
  order. It raises with the tracebacks of the ranks that failed, and kills
  every rank when one fails or the timeout passes: it never hangs.
* :func:`device_mesh` is the ``DeviceMesh`` of a port
  :class:`~repro_torch.launch.mesh.Mesh`'s shape over the group's ranks
  (row-major: rank r sits at ``np.unravel_index(r, shape)``).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["backend_for", "start", "end", "rank_device", "spawn", "device_mesh"]


def backend_for(device: Any) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def start(rank: int, world: int, *, rendezvous_dir: str, device: Any = None) -> torch.device:
    """Open this rank's default process group through a ``file://``
    rendezvous in ``rendezvous_dir`` (shared by the group's ranks, empty
    before the first rank starts); returns the rank's device: the card
    ``rank % device_count`` unless ``device`` names the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device), init_method="file://" + os.path.join(rendezvous_dir, "rendezvous"),
        rank=rank, world_size=world, device_id=device if device.type == "cuda" else None)
    return device


def end() -> None:
    """Close this rank's default group (no-op when none is open)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device() -> torch.device:
    """The device this rank computes on: the current card under ``nccl``,
    the CPU under ``gloo``."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_mesh(shape: Mapping[str, int]) -> Any:
    """A ``DeviceMesh`` of ``shape`` (axis -> size, in order) over the
    group's ranks; the sizes' product must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tuple(shape.values())
    n = 1
    for s in sizes:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {dict(shape)} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(rank_device().type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(shape))


def _rank_main(fn: Callable, rank: int, world: int, root: str, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        start(rank, world, rendezvous_dir=root, device="cpu")
        result = fn(rank, world, *args)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        end()


def spawn(fn: Callable, world: int, *args: Any, timeout: float = 120.0) -> list[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` CPU ranks over ``gloo``;
    returns the ranks' results in rank order.

    ``fn`` and ``args`` travel to fresh interpreters (the ``spawn`` start
    method), so ``fn`` must be importable by name. A rank that raises fails
    the call with the tracebacks of every rank that failed; ``timeout``
    seconds after the start every rank still running is killed and the call
    raises ``TimeoutError``."""
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="bsps_ranks_")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, root, args),
                         name=f"bsps-rank{r}", daemon=True) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks: still running after "
                                   f"{timeout:.0f} s")
            time.sleep(0.02)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed:
            # a rank a peer's failure took down failed after that peer,
            # which had written its traceback first
            msgs = []
            for r, p in enumerate(procs):
                err = os.path.join(root, f"rank{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        msgs.append(f"rank {r} of {world} failed:\n{f.read()}")
                elif p.exitcode not in (None, 0):
                    msgs.append(f"rank {r} of {world} failed: exit code {p.exitcode}")
            raise RuntimeError(f"{fn.__name__}: " + "\n".join(msgs))
        results = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)

"""Atomic, async checkpointing with verified restore.

The JAX package's ``train/checkpoint.py`` with its on-disk format: a
checkpoint ``step_%08d/`` holds one ``npz`` per state group and a
``manifest.json`` (step, time, data_state, and per array its crc32, shape
and dtype), keyed by tree paths joined with ``/`` — dict keys in sorted
order, list indices as numbers, as ``jax.tree_util`` names them. The port's
parameters keep the JAX package's per-layer layout (``stack/<period>/<block>``),
so its paths are the reference's for ``scan_layers=False``. npz has no
bfloat16: a bf16 leaf is written as float32 and restored to the template's
dtype, as the reference does. Either package reads the other's files;
:func:`restore_reference` carries a JAX-written training state (either stack
layout) into the port's trees.

Fault-tolerance contract (DESIGN.md §5):

* **atomic** — a checkpoint is written to ``step_XXXX.tmp/`` and committed
  with a single ``os.rename``; a crash mid-write never corrupts the latest
  good checkpoint, and ``restore_latest`` skips torn directories.
* **async** — ``save`` copies the state to host numpy (the only blocking
  part) and writes files on a background thread, overlapping the next
  steps (hyperstep logic applied to checkpoint I/O).
* **data state included** — the data-stream cursor rides in the manifest,
  so restart resumes the exact stream position (the paper's ``seek``).
* **verified** — the manifest carries per-array checksums (crc32) checked on
  restore.

The port's AdamW updates parameters and moments in place, so a snapshot
*copies* every tensor (on the CPU ``Tensor.numpy()`` would alias it, and
the next step would rewrite a snapshot not yet flushed). ``restore`` puts
each array on its template tensor's device and dtype, or with
``copy_into=True`` copies it into the template's tensors, or hands each
group's tree to a ``sharder`` that places it on the current mesh (elastic
restore: the files hold full arrays, whatever mesh wrote them).

Inside a rank group a state of DTensors saves as an unsharded one would:
every rank gathers each leaf (``full_tensor()``), rank 0 alone writes the
same files, and the other ranks wait at a barrier for its commit, so a
sharded save is always blocking. Only rank 0 writes a snapshot that comes
down a :class:`CheckpointStream`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.stream import StreamOwnership

__all__ = ["save", "restore", "restore_latest", "restore_reference",
           "latest_step", "committed_steps", "snapshot", "CheckpointManager",
           "CheckpointStream"]


def _items(tree: Any, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(tree path, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    list and tuple entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (i,))
    else:
        yield "/".join(str(p) for p in path), tree


def _writer() -> bool:
    """False on every rank of a rank group but rank 0, which writes the
    group's checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _sharded(tree: Any) -> bool:
    return any(hasattr(leaf, "full_tensor") for _, leaf in _items(tree))


def _host_copy(leaf: Any) -> np.ndarray:
    """A host numpy copy of one leaf (a DTensor gathered whole first: every
    rank must take part); bf16 becomes float32 (npz has none)."""
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(leaf)


def _flat(tree: Any) -> dict[str, np.ndarray]:
    return {key: _host_copy(leaf) for key, leaf in _items(tree)}


def _is_snapshot(v: Any) -> bool:
    """True for the flat {path: ndarray} dicts produced by :func:`snapshot`."""
    return (isinstance(v, dict) and bool(v)
            and all(isinstance(a, np.ndarray) for a in v.values()))


def _unflat(like: Any, arrays: dict[str, np.ndarray], copy_into: bool,
            path: tuple = ()) -> Any:
    """``arrays`` in the structure of ``like``, each leaf on its template's
    device and dtype (or copied into the template's tensor)."""
    if isinstance(like, dict):
        return {k: _unflat(v, arrays, copy_into, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflat(v, arrays, copy_into, path + (i,))
                          for i, v in enumerate(like))
    arr = arrays["/".join(str(p) for p in path)]
    if isinstance(like, torch.Tensor):
        src = torch.from_numpy(arr)
        if copy_into:
            with torch.no_grad():
                like.copy_(src)
            return like
        return src.to(like.device, like.dtype)
    if hasattr(like, "dtype"):
        return arr.astype(like.dtype)
    return arr


def snapshot(state: dict[str, Any]) -> dict[str, dict[str, np.ndarray]]:
    """Copy the state to host numpy (the blocking half of a save).

    Every leaf is copied, so the flat host dict can travel down a write-back
    stream and be flushed to disk off the critical path
    (:class:`CheckpointStream`) while the next step updates the parameters
    and moments in place.
    """
    return {k: _flat(v) for k, v in state.items()}


def save(
    directory: str,
    step: int,
    state: dict[str, Any],
    *,
    data_state: dict[str, Any] | None = None,
    blocking: bool = False,
) -> threading.Thread | None:
    """Write checkpoint ``step`` under ``directory`` (atomically committed).

    ``state`` maps group names to trees of tensors, or is already a host
    :func:`snapshot` (its flat dicts pass through). The host copy is taken
    before this returns; with ``blocking=False`` the files are written on a
    ``ckpt-writer`` thread, which is returned. A state holding DTensors is
    saved by every rank of the group together (see the module docstring).
    """
    sharded = any(not _is_snapshot(v) and _sharded(v) for v in state.values())
    # host copy — after this, training may update the tensors freely
    host = {k: v if _is_snapshot(v) else _flat(v) for k, v in state.items()}
    if not _writer():
        if sharded:
            dist.barrier()       # rank 0's commit
        return None
    os.makedirs(directory, exist_ok=True)

    def _write() -> None:
        tmp = os.path.join(directory, f"step_{step:08d}.tmp")
        final = os.path.join(directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest: dict[str, Any] = {
            "step": step, "time": time.time(), "data_state": data_state or {},
            "arrays": {},
        }
        for group, arrays in host.items():
            _write_fsync(os.path.join(tmp, f"{group}.npz"),
                         lambda f, arrays=arrays: np.savez(f, **dict(arrays)))
            for k, v in arrays.items():
                manifest["arrays"][f"{group}/{k}"] = {
                    "crc": zlib.crc32(np.ascontiguousarray(v).tobytes()),
                    "shape": list(v.shape), "dtype": str(v.dtype),
                }
        _write_fsync(os.path.join(tmp, "manifest.json"),
                     lambda f: f.write(json.dumps(manifest).encode()))
        _fsync_dir(tmp)
        if os.path.isdir(final):  # re-save of the same step: replace
            shutil.rmtree(final)
        os.rename(tmp, final)  # the commit point
        _fsync_dir(directory)   # make the rename itself durable

    if blocking or sharded:
        _write()
        if sharded:
            dist.barrier()
        return None
    t = threading.Thread(target=_write, daemon=False, name="ckpt-writer")
    t.start()
    return t


def _write_fsync(path: str, writer: Callable[[Any], None]) -> None:
    """Write a file and fsync it before returning (durable pre-commit).

    The atomic-rename commit is only honest if the renamed files are already
    on disk: rename-then-crash must never leave a committed directory with
    torn contents.
    """
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """fsync a directory entry (no-op on platforms that refuse dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _retention_gc(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for s in steps[:-keep] if len(steps) > keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def committed_steps(directory: str) -> list[int]:
    """Committed (renamed, manifest-bearing) checkpoint steps, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _load(directory: str, step: int, groups: Any,
          verify: bool) -> tuple[dict[str, dict[str, np.ndarray]], dict[str, Any]]:
    """Checkpoint ``step``'s flat arrays of ``groups`` (crc-checked when
    ``verify``) and its data state."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for group in groups:
        with np.load(os.path.join(path, f"{group}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if verify:
            for k, v in arrays.items():
                want = manifest["arrays"][f"{group}/{k}"]["crc"]
                got = zlib.crc32(np.ascontiguousarray(v).tobytes())
                if want != got:
                    raise IOError(f"checkpoint corruption in {group}/{k}")
        out[group] = arrays
    return out, manifest.get("data_state", {})


def restore(
    directory: str,
    step: int,
    state_like: dict[str, Any],
    *,
    sharder: Callable[[str, Any], Any] | None = None,
    verify: bool = True,
    copy_into: bool = False,
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Load checkpoint ``step``; returns (state, data_state).

    ``state_like`` gives the tree structure and, per leaf, the device and
    dtype (a numpy leaf gives its dtype). ``copy_into=True`` copies each
    array into the template's tensor instead of making a new one, so a
    restore needs no second copy of the state in device memory.
    ``sharder(group, tree) -> placed_tree`` is called with each group's
    tree of full tensors and places it on the current mesh (elastic
    restore: any mesh shape, whatever mesh wrote the files).
    """
    if sharder is not None and copy_into:
        raise ValueError("restore: a sharder places new tensors; copy_into writes the "
                         "template's, give one or the other")
    flat, data_state = _load(directory, step, state_like, verify)
    out = {}
    for group, like in state_like.items():
        tree = _unflat(like, flat[group], copy_into)
        out[group] = sharder(group, tree) if sharder else tree
    return out, data_state


def restore_latest(directory: str, state_like: dict[str, Any], *,
                   on_corrupt: Callable[[int, Exception], None] | None = None,
                   **kw):
    """Restore the newest *valid* checkpoint, falling back past bad ones.

    A corrupted or truncated latest checkpoint (crc mismatch, torn npz,
    unparsable or missing files) must not brick auto-resume: each failing
    step is reported through ``on_corrupt(step, error)`` and the next-newest
    one is tried. Returns ``(step, state, data_state)`` or None when no
    checkpoint restores cleanly.
    """
    for step in reversed(committed_steps(directory)):
        try:
            state, data_state = restore(directory, step, state_like, **kw)
        except Exception as e:  # noqa: BLE001 — any torn artifact falls back
            if on_corrupt is not None:
                on_corrupt(step, e)
            continue
        return step, state, data_state
    return None


def _nest(flat: dict[str, np.ndarray]) -> Any:
    """A flat {tree path: array} dict as nested dicts, with lists where a
    level's keys are list indices."""
    root: dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr

    def lists(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def restore_reference(directory: str, step: int, cfg: Any, *, device: Any = None,
                      verify: bool = True) -> tuple[dict[str, Any], dict[str, Any]]:
    """A training checkpoint the JAX package wrote, as the port's state.

    Reads the ``params`` and ``opt_state`` groups that the reference's
    ``train`` saves (its ``jax.tree_util`` key paths, either stack layout:
    ``scan_layers`` stacks periods on a leading axis) and carries them over
    with :func:`repro_torch.models.model.params_from_numpy` and
    ``opt_state_from_numpy`` onto ``device`` (the card unless named).
    Returns ``({"params", "opt_state"}, data_state)``, the data state as
    written.
    """
    from repro_torch.models import model as M

    flat, data_state = _load(directory, step, ("params", "opt_state"), verify)
    params = M.params_from_numpy(cfg, _nest(flat["params"]), device=device)
    opt_state = M.opt_state_from_numpy(cfg, _nest(flat["opt_state"]), device=device)
    return {"params": params, "opt_state": opt_state}, data_state


class CheckpointManager:
    """Periodic async saves + retention, with crash-safe handoff."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, state: dict[str, Any],
                   data_state: dict[str, Any] | None = None) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        self._pending = save(self.directory, step, state, data_state=data_state)
        self._gc()
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        _retention_gc(self.directory, self.keep)


class CheckpointStream(StreamOwnership):
    """Checkpoint write-back as a paper-§4 *up*-stream.

    One ``move_up`` per hyperstep: the token is either ``None`` (no snapshot
    due — 0 words move on the link) or ``(step, host_snapshot, data_state)``
    from :func:`snapshot`, which this flushes to disk *synchronously on the
    caller's thread*. Handed to
    :class:`repro_torch.core.hyperstep.HyperstepRunner` as an out-stream,
    that caller is the runner's DMA lane, so the file write overlaps the
    next hyperstep's compute and is joined at the bulk synchronisation —
    checkpoint I/O priced and scheduled exactly like any other output token.

    In :func:`repro_torch.core.plan.host_plan`, pass ``out_every=[every]`` so
    Eq. 1 charges the snapshot only on hypersteps whose output block index
    changes (one flush per checkpoint interval).
    """

    token_size = 1

    def __init__(self, directory: str, *, every: int, num_tokens: int,
                 state_words: int, keep: int = 3, name: str = "checkpoint"):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.name = name
        self.stream_id = 0
        self._num = int(num_tokens)
        self._words = int(state_words)
        self._cursor = 0
        self._owner: int | None = None

    # -- stream protocol (open/close/exclusivity from StreamOwnership) -------

    def _rewind(self) -> None:
        self._cursor = 0

    def move_up(self, core: int, token: Any) -> int:
        self._check_owner(core)
        self._cursor += 1
        if token is None:
            return 0
        step, host_state, data_state = token
        if _writer():
            save(self.directory, step, host_state, data_state=data_state,
                 blocking=True)
            _retention_gc(self.directory, self.keep)
        return self._words

    # -- plan protocol (host_plan pricing) -----------------------------------

    @property
    def cursor(self) -> int:
        return self._cursor

    @property
    def num_tokens(self) -> int:
        return self._num

    @property
    def token_shape(self) -> tuple[int, ...]:
        return (1, self._words)

    @property
    def dtype(self):
        return np.float32

    @property
    def token_words(self) -> int:
        return self._words

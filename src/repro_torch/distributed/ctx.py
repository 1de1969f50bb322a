"""Mesh context for in-model sharding constraints.

The JAX package's ``distributed/ctx.py``. Model code is mesh-agnostic; the
launcher (the training loop under ``mesh=``) registers the active mesh axis
names and sizes here, and code asks :func:`dp_size` how many data-parallel
groups the batch splits into (the MoE dispatch groups) or calls
:func:`constrain` with *logical* specs — axis names not on the current
mesh, or axes that do not divide the dimension, are dropped; with no mesh
registered the call is a no-op.

The port computes on local tensors, one process per rank: a plain tensor
passes :func:`constrain` unchanged (its placement is the caller's), and a
DTensor is redistributed to the filtered placements. Inside an explicit
data-parallel step each rank holds one DP shard of the batch:
:func:`shard_local` registers the same axes with every DP axis counted once,
so the rank's shard is one dispatch group.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping

__all__ = ["DP", "TP", "set_mesh", "mesh_axes", "shard_local", "constrain", "dp_size"]

_AXES: dict[str, int] = {}

DP = ("pod", "host", "data")   # logical data-parallel axes
TP = "model"           # tensor/sequence-parallel axis


def set_mesh(axes: Mapping[str, int]) -> None:
    global _AXES
    _AXES = dict(axes)


@contextlib.contextmanager
def mesh_axes(axes: Mapping[str, int]) -> Iterator[None]:
    global _AXES
    prev = _AXES
    _AXES = dict(axes)
    try:
        yield
    finally:
        _AXES = prev


@contextlib.contextmanager
def shard_local() -> Iterator[None]:
    """Within the block, the registered axes with each DP axis of size 1:
    the rank's own batch shard is the whole batch model code sees."""
    with mesh_axes({a: (1 if a in DP else n) for a, n in _AXES.items()}):
        yield


def _filter(entry, dim: int):
    """Keep only registered axes whose product divides ``dim``."""
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    kept: list[str] = []
    prod = 1
    for a in names:
        if a in _AXES and dim % (prod * _AXES[a]) == 0:
            kept.append(a)
            prod *= _AXES[a]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def constrain(x: Any, *spec) -> Any:
    """The sharding constraint with logical axis names; no-op without a mesh.

    A plain tensor comes back as it is. A DTensor is redistributed to the
    filtered spec's placements over its own device mesh (the dims the spec
    does not name are replicated)."""
    if not _AXES:
        return x
    clean = tuple(_filter(s, d) for s, d in zip(spec, x.shape))
    if all(s is None for s in clean):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import spec_placements
    from repro_torch.distributed.shardspec import P

    dmesh = x.device_mesh
    return x.redistribute(dmesh, spec_placements(P(*clean), dmesh.mesh_dim_names))


def dp_size() -> int:
    """Product of registered data-parallel axis sizes (1 without a mesh)."""
    n = 1
    for a in DP:
        n *= _AXES.get(a, 1)
    return n

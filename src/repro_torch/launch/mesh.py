"""Mesh construction, shape first: the port's stand-in for JAX's ``Mesh``.

A :class:`Mesh` holds its axes' sizes (``shape``, axis → size, in order),
``axis_names`` and ``size``: what the sharding rules
(:mod:`repro_torch.distributed.shardspec`) resolve against. The production
mesh is shape-only — single pod ``(data=16, model=16)``, multi-pod ``(pod=2,
data=16, model=16)`` — so specs for it resolve on any machine. The host
meshes lay out the CUDA devices that exist (``devices``, a numpy array of
``torch.device`` in the mesh's shape), and validate as the JAX package's
do: every factor must divide the device count, so no device is dropped.

Inside a rank group (:mod:`repro_torch.distributed.group`: one process per
rank) the host meshes lay out the group's ranks instead, one device per
rank, with the same divisibility errors; such a mesh carries the group's
``device_mesh`` (a ``torch.distributed`` ``DeviceMesh`` of the same shape),
which tensors are placed on.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh", "make_host_core_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes; ``devices`` None for a shape-only mesh."""

    shape: dict[str, int]
    devices: Any = None
    #: the ``DeviceMesh`` over the group's ranks; None outside a rank group
    device_mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))


def _mesh(sizes: tuple[int, ...], axes: tuple[str, ...], devices: list | None = None,
          ranks: bool = False) -> Mesh:
    grid = None
    if devices is not None:
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        grid = grid.reshape(sizes)
    shape = dict(zip(axes, sizes))
    dmesh = None
    if ranks:
        from repro_torch.distributed.group import device_mesh

        dmesh = device_mesh(shape)
    return Mesh(shape, grid, dmesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The pod mesh the sharding rules are written for, shape only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def _devices(device: Any) -> tuple[list[torch.device], bool]:
    """The devices a host mesh spans and whether they are a rank group's:
    one per rank inside a group (on the group's device type: asking for
    another raises), else every CUDA device, or the one CPU."""
    if dist.is_initialized():
        from repro_torch.distributed.group import rank_device

        kind = rank_device().type
        if device is not None and torch.device(device).type != kind:
            raise ValueError(f"the rank group computes on {kind}, not {torch.device(device)}")
        n = dist.get_world_size()
        if kind == "cuda":
            return [torch.device("cuda", r % torch.cuda.device_count()) for r in range(n)], True
        return [torch.device("cpu")] * n, True
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())], False
    return [device], False


def make_host_mesh(model: int | None = None, *, device: Any = None) -> Mesh:
    """A small ``(data, model)`` mesh over whatever devices exist.

    ``model`` must divide the device count exactly: silently flooring
    ``n // model`` would drop devices from the mesh.
    """
    devs, ranks = _devices(device)
    n = len(devs)
    model = model or 1
    if model > n:
        raise ValueError(f"model={model} exceeds the {n} available device(s)")
    if n % model != 0:
        raise ValueError(
            f"model={model} does not divide the {n} available device(s); "
            f"a ({n // model}, {model}) mesh would drop {n % model} of them")
    return _mesh((n // model, model), ("data", "model"), devs, ranks)


def make_host_core_mesh(hosts: int, *, model: int | None = None, device: Any = None) -> Mesh:
    """The third-level ``(host, data, model)`` mesh: ``hosts`` leading
    groups, each a ``(data, model)`` grid over the remaining devices. The
    ``host`` axis joins the DP axes (``shardspec.dp_axes``), so the traffic
    crossing it is what ``host_h_relation`` charges. Every factor must
    divide, as in :func:`make_host_mesh`."""
    devs, ranks = _devices(device)
    n = len(devs)
    if hosts <= 0:
        raise ValueError(f"hosts must be positive, got {hosts}")
    if hosts > n:
        raise ValueError(f"hosts={hosts} exceeds the {n} available device(s)")
    if n % hosts != 0:
        raise ValueError(
            f"hosts={hosts} does not divide the {n} available device(s); "
            f"would drop {n % hosts} of them")
    per_host = n // hosts
    model = model or per_host
    if per_host % model != 0:
        raise ValueError(
            f"model={model} does not divide the {per_host} device(s) per host; "
            f"would drop {per_host % model} of them")
    return _mesh((hosts, per_host // model, model), ("host", "data", "model"), devs, ranks)

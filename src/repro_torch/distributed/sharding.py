"""Sharding rules: FSDP + TP + EP (+ SP for long-context) over the pod mesh.

Mesh axes (:mod:`repro_torch.launch.mesh`): single-pod ``(data=16,
model=16)``, multi-pod ``(pod=2, data=16, model=16)``, host×core ``(host,
data, model)``. The combined DP axes (``pod``/``host``/``data``) carry both
batch parallelism and the FSDP dimension of 2-D weight sharding (every 2-D
weight sharded over the model axis — tensor parallel — and the DP axes);
the ``model`` axis carries TP (attention heads / ffn), EP (experts) and
vocab sharding.

The rules are data, not code: the declarative tables in
:mod:`repro_torch.distributed.shardspec` resolved here against a mesh, over
the port's parameter and cache trees (shapes from
:func:`repro_torch.models.model.abstract_params` and ``abstract_cache``).
The port keeps its stack per layer (``stack[period][block]``), so no leaf
carries a scanned period axis and no spec gets the JAX package's leading
``None`` for one. Every rule degrades gracefully: a dim is only sharded if
divisible by the axis size, falling back to the next alternative axis or
replication — e.g. minicpm's vocab 122753 stays unsharded.

:func:`named` maps a resolved spec to DTensor placements, one per mesh
dim — the counterpart of JAX's ``NamedSharding`` — and
:func:`logical_to_sharding` places a tree on a rank group's mesh
(:attr:`repro_torch.launch.mesh.Mesh.device_mesh`) as DTensors, each rank
slicing its own shard from the full tensor it holds, with no communication.
An entry naming several axes on one dim shards in the entry's order; DTensor
shards a dim over several mesh dims in mesh order, so an entry whose order
is not the mesh's is refused.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.shardspec import (
    CACHE_RULES,
    PARAM_RULES,
    P,
    build_context,
    dp_axes,
    leaf_shape,
    resolve_leaf,
)

__all__ = ["dp_axes", "axis_size", "param_specs", "batch_spec", "cache_specs",
           "opt_state_specs", "spec_placements", "named", "logical_to_sharding"]


def axis_size(mesh: Any, axes: str | tuple[str, ...] | None) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _tree_map_with_path(fn, tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` over a tree of dicts and lists, the same
    structure back; ``names`` are the keys and indices down to the leaf, as
    strings."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def param_specs(cfg: ModelConfig, mesh: Any, params_shape: Any) -> Any:
    """Partition-spec tree matching ``params_shape`` (the port's parameter
    tree, real or abstract), resolved from
    :data:`repro_torch.distributed.shardspec.PARAM_RULES`."""
    ctx = build_context(mesh)

    def rule(names, leaf) -> P:
        return resolve_leaf(PARAM_RULES, names, leaf_shape(leaf), ctx, mesh,
                            scanned=False, kind="sharding")

    return _tree_map_with_path(rule, params_shape)


def batch_spec(cfg: ModelConfig, mesh: Any, shape: ShapeSpec) -> P:
    """Input token batch (B, S): batch over DP axes when divisible."""
    dp = dp_axes(mesh)
    if shape.global_batch % axis_size(mesh, dp) == 0:
        return P(dp, None)
    if shape.global_batch == 1 and shape.seq_len % axis_size(mesh, "data") == 0:
        return P(None, "data")   # SP: long-context single-stream
    return P(None, None)


def cache_specs(cfg: ModelConfig, mesh: Any, shape: ShapeSpec, cache_shape: Any) -> Any:
    """Decode-cache shardings: batch over DP if divisible, else sequence over
    ``data`` (long_500k), state feature dims over ``model`` — resolved from
    :data:`repro_torch.distributed.shardspec.CACHE_RULES`. The cache's
    ``len`` (a Python int in the port) resolves as a 0-d leaf."""
    dp = dp_axes(mesh)
    batch_ok = shape.global_batch % axis_size(mesh, dp) == 0
    ctx = build_context(mesh, batch_ok=batch_ok)

    def rule(names, leaf) -> P:
        return resolve_leaf(CACHE_RULES, names, leaf_shape(leaf), ctx, mesh,
                            scanned=False, kind="cache")

    return _tree_map_with_path(rule, cache_shape)


def opt_state_specs(param_spec_tree: Any) -> Any:
    """Adam moments share their parameter's spec (2-D sharded ⇒ ZeRO-ish)."""
    return param_spec_tree


def spec_placements(spec: P, axis_names: Sequence[str]) -> tuple:
    """The DTensor placements of ``spec`` over a mesh whose dims are
    ``axis_names``: ``Shard(d)`` on each mesh dim an entry of dim ``d``
    names, ``Replicate()`` on the others.

    Raises ``ValueError`` for an axis not on the mesh, an axis named twice,
    or an entry whose axes are not in mesh order (DTensor would shard that
    dim in another order than the spec says)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axis_names)
    out: list[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names {missing}, not on the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec} shards dim {d} over {axes}, not in the mesh's order {names}: "
                "DTensor shards a dim over several mesh dims in mesh order")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def _map_specs(fn, specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree (a :class:`P` is a leaf) and
    trees of the same structure."""
    if isinstance(specs, P):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def named(mesh: Any, spec_tree: Any) -> Any:
    """Each spec of ``spec_tree`` as its DTensor placements on ``mesh``."""
    return _map_specs(lambda s: spec_placements(s, mesh.axis_names), spec_tree)


def logical_to_sharding(mesh: Any, tree: Any, specs: Any) -> Any:
    """``tree`` placed on ``mesh``'s ranks by ``specs``: each leaf (the full
    tensor, the same on every rank) becomes a DTensor holding this rank's
    shard."""
    from torch.distributed.tensor import distribute_tensor

    if mesh.device_mesh is None:
        raise ValueError("placing tensors needs a mesh over a rank group "
                         "(repro_torch.distributed.group.start, then make_host_mesh)")
    dmesh = mesh.device_mesh
    return _map_specs(
        lambda s, leaf: distribute_tensor(leaf, dmesh, spec_placements(s, mesh.axis_names),
                                          src_data_rank=None),
        specs, tree)

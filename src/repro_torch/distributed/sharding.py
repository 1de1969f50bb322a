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

Placing tensors on a real mesh (the JAX package's ``named`` and
``logical_to_sharding``) is not ported yet.
"""

from __future__ import annotations

from typing import Any

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
           "opt_state_specs"]


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

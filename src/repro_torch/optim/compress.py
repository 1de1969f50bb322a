"""Gradient compression for data parallelism across pods.

Copies of the JAX package's ``optim/compress.py``:

* :func:`bf16_grads` — cast float32 gradients to bf16 before the
  data-parallel all-reduce (half its volume; the fp32 master copy lives in
  the Adam moments);
* :class:`TopKCompressor` — magnitude top-k sparsification with error
  feedback: only the k largest |g| entries are kept, the residual is
  carried to the next step (Stich et al., 2018).

Gradients are trees of dicts and lists of tensors, as the parameters are.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["bf16_grads", "TopKCompressor", "tree_map"]

Params = Any


def tree_map(fn, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (dicts and lists)."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def bf16_grads(grads: Params) -> Params:
    return tree_map(lambda g: g.to(torch.bfloat16) if g.dtype == torch.float32 else g, grads)


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Error-feedback top-k on flattened per-leaf gradients."""

    ratio: float = 0.01  # fraction of entries kept

    def init(self, params: Params) -> Params:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    def compress(self, grads: Params, error: Params) -> tuple[Params, Params]:
        """Returns (sparse grads in the dense layout, new error): zeros off
        the support, so the result drops into the same all-reduce."""

        def one(g, e):
            gf = g.float() + e
            flat = gf.reshape(-1)
            k = max(1, int(flat.shape[0] * self.ratio))
            thresh = torch.topk(flat.abs(), k).values[-1]
            kept = torch.where(gf.abs() >= thresh, gf, torch.zeros_like(gf))
            return kept.to(g.dtype), gf - kept

        pairs = tree_map(one, grads, error)
        is_pair = lambda x: isinstance(x, tuple)
        return _split(pairs, 0, is_pair), _split(pairs, 1, is_pair)

    def words_exchanged(self, n_params: int) -> int:
        """Cost-model hook: index+value words for the BSPS collective term."""
        return 2 * max(1, int(n_params * self.ratio))


def _split(tree: Any, i: int, is_pair) -> Any:
    if is_pair(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _split(v, i, is_pair) for k, v in tree.items()}
    return [_split(v, i, is_pair) for v in tree]

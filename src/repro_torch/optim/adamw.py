"""AdamW with fp32 moments over (bf16 or fp32) parameters.

The JAX package's ``optim/adamw.py`` with its defaults and its arithmetic
order: the gradients are clipped by their global norm, the moments updated
in fp32, the bias corrections taken at the new step, the decayed update
applied in fp32 and cast to each parameter's dtype once.

The JAX optimizer is functional (new parameter and moment trees). This one
updates the parameter and moment tensors in place, leaf by leaf, under
``torch.no_grad()``: full minicpm-2b holds 21.8 GB of moments, which a
functional update would briefly hold twice. It returns the same trees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.trace import traced
from repro_torch.optim.compress import tree_map

__all__ = ["AdamW", "global_norm", "leaves"]

Params = Any
Schedule = Callable[[Any], torch.Tensor]


def leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (the order of ``jax.tree_util.tree_leaves``, so sums over leaves add in
    the reference's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32."""
    total = None
    for x in leaves(tree):
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Params) -> dict[str, Any]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    @traced("repro_torch.optim.update")
    def update(self, grads: Params, state: dict[str, Any], params: Params, *,
               gnorm: torch.Tensor | None = None,
               ) -> tuple[Params, dict[str, Any], dict[str, torch.Tensor]]:
        """Returns (params, state, {"grad_norm", "lr"}); ``params`` and the
        state's moments are updated in place. ``gnorm`` is the norm the
        gradients are clipped by, where ``grads`` are one rank's shards of
        the gradient (default: ``global_norm(grads)``). Under a profiler
        the call is a ``repro_torch.optim.update`` span."""
        step = state["step"] + 1
        lr = self.schedule(step).to(torch.float32)
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = None
        if self.grad_clip > 0:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                              leaves(state["v"])):
            gf = g.float()
            if scale is not None:
                gf = gf * scale
            m.mul_(b1).add_(gf * (1 - b1))
            v.mul_(b2).add_(gf * (1 - b2) * gf)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            pf = p.float()
            u = u + self.weight_decay * pf
            p.copy_(pf - lr * u)
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}

"""The training reference: the loss, the gradients and AdamW in plain fp32
PyTorch, for the first steps of a train cell.

Parameters stay in the configuration's dtype between steps, as the
configuration states (bf16 weights, fp32 moments): each step reads them as
fp32, and the update is computed in fp32 and rounded to the dtype once.
The loss is the mean cross entropy over the batch's labelled positions,
taken a row at a time with each layer recomputed in the backward pass
(``torch.utils.checkpoint``), so that a 16k-token batch fits beside the
moments. AdamW: gradients clipped by their global norm, moments updated in
fp32, the bias corrections at the new step, decoupled weight decay.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from portbench.reference.model import Ref

__all__ = ["leaves", "learning_rate", "follow"]


def leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _like(tree: Any, flat: list) -> Any:
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def learning_rate(sched: dict, step: int) -> float:
    """The schedule's rate at ``step`` (1-based): "wsd" is MiniCPM's
    warmup-stable-decay, "constant" a fixed rate."""
    if sched["name"] == "constant":
        return float(sched["lr"])
    if sched["name"] != "wsd":
        raise ValueError(f"unknown schedule {sched['name']!r}")
    peak, warmup, total = sched["peak_lr"], sched["warmup"], sched["total"]
    decay_start = int(total * (1 - sched.get("decay_frac", 0.1)))
    if step < warmup:
        return peak * step / max(warmup, 1)
    if step < decay_start:
        return float(peak)
    t = min(max((step - decay_start) / max(total - decay_start, 1), 0.0), 1.0)
    return peak * sched.get("floor", 0.01) ** t


def _loss_and_grads(cfg: dict, p32: dict, tokens: torch.Tensor, labels: torch.Tensor,
                    quant: bool) -> tuple[float, list[torch.Tensor]]:
    flat = leaves(p32)
    for p in flat:
        p.grad = None
    ref = Ref(cfg, p32, quant=quant)
    count = int((labels >= 0).sum())
    total = 0.0
    for r in range(tokens.shape[0]):
        h = ref.hidden(tokens[r:r + 1], checkpoint=True)
        logits = ref.head(h)[0]
        loss = F.cross_entropy(logits, labels[r].long(), ignore_index=-1, reduction="sum") / count
        loss.backward()
        total += float(loss.detach())
        del h, logits, loss
    return total, [p.grad for p in flat]


def follow(cfg: dict, params: dict, batches: list[tuple[torch.Tensor, torch.Tensor]],
           sched: dict, adamw: dict, *, quant: bool = False) -> dict:
    """Run ``len(batches)`` AdamW steps from ``params`` (the initial
    weights, left as they are) and read each step's loss, the first step's
    clipped gradient norm of each leaf (what the optimizer takes) and each
    leaf's change over all the steps: {"loss": [a step], "grad1": [a leaf],
    "delta": [a leaf]}, leaves in sorted-key order."""
    init = leaves(params)
    p32 = _like(params, [p.detach().to(torch.float32, copy=True).requires_grad_(True)
                         for p in init])
    flat = leaves(p32)
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    b1, b2, eps = adamw["b1"], adamw["b2"], adamw["eps"]
    out: dict = {"loss": [], "grad1": [], "delta": []}
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss, grads = _loss_and_grads(cfg, p32, tokens, labels, quant)
        out["loss"].append(loss)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
            scale = min(1.0, adamw["grad_clip"] / (gnorm + 1e-9)) if adamw["grad_clip"] > 0 else 1.0
            if step == 1:
                out["grad1"] = [float(g.double().norm()) * scale for g in grads]
            lr = learning_rate(sched, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for p, p0, g, mi, vi in zip(flat, init, grads, m, v):
                g = g * scale
                mi.mul_(b1).add_(g * (1 - b1))
                vi.mul_(b2).add_(g * g * (1 - b2))
                u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps) + adamw["weight_decay"] * p
                p.copy_((p - lr * u).to(p0.dtype).float())
                p.grad = None
    with torch.no_grad():
        out["delta"] = [float((p - p0.float()).double().norm()) for p, p0 in zip(flat, init)]
    return out

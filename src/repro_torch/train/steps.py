"""Train, serve and prefill steps of the port.

``make_train_step`` closes over (cfg, optimizer) and returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``, the
gradients of ``make_grad_fn`` followed by the optimizer's update;
``make_serve_step`` returns ``step(params, cache, batch) -> (logits, cache)``;
``make_prefill_step`` returns ``step(params, batch) -> logits``, the
prompt-scoring forward that runs attention through the flash kernel. Each
resolves its device once, when it is made.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, leaves
from repro_torch.optim.compress import bf16_grads, tree_map

Params = Any

__all__ = ["make_grad_fn", "make_train_step", "make_serve_step", "make_prefill_step",
           "abstract_opt_state", "TRAIN_METRICS"]

#: the keys of :func:`make_train_step`'s metrics, each a 0-d tensor, sorted
#: (the layout of the training loop's compiled metric stream)
TRAIN_METRICS = ("ce", "grad_norm", "loss", "lr", "moe_aux")


def make_grad_fn(cfg: ModelConfig, *, aux_weight: float = 0.01, compress_bf16: bool = True,
                 device: Any = None):
    """``grads(params, batch) -> (grads, metrics)``: the gradient half of
    :func:`make_train_step`.

    The loss is :func:`repro_torch.models.model.loss_fn` on ``batch =
    {"tokens" or "embeds", "labels"[, "positions"]}``; the gradients of
    every parameter leaf come from ``torch.autograd.grad`` (through the
    kernels' backward passes on the card), in the structure of ``params``,
    cast to bf16 when
    ``compress_bf16`` (the JAX package's ``bf16_grads``). The metrics hold
    the loss, ce and moe_aux as 0-d tensors.
    """
    device = resolve_device(device)

    def grads_of(params: Params, batch: dict[str, torch.Tensor]):
        # leaves that share the parameters' storage and take gradients
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        _, metrics = M.loss_fn(cfg, live, batch.get("tokens"), batch["labels"],
                               embeds=batch.get("embeds"), positions=batch.get("positions"),
                               aux_weight=aux_weight, device=device)
        flat = leaves(live)
        grads = torch.autograd.grad(metrics["loss"], flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        grads = _unflatten(live, grads)
        if compress_bf16:
            # halves the data-parallel all-reduce; the moments keep fp32
            grads = bf16_grads(grads)
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grads_of


def make_train_step(cfg: ModelConfig, opt: AdamW, *, aux_weight: float = 0.01,
                    compress_bf16: bool = True, device: Any = None):
    """One optimizer step on ``batch = {"tokens" or "embeds", "labels"[,
    "positions"]}``:
    the gradients of :func:`make_grad_fn`, then ``opt`` updates the
    parameters and moments in place. The metrics hold the loss, ce,
    moe_aux, grad_norm and lr as 0-d tensors (:data:`TRAIN_METRICS`).
    """
    grads_of = make_grad_fn(cfg, aux_weight=aux_weight, compress_bf16=compress_bf16,
                            device=device)

    def train_step(params: Params, opt_state: Params, batch: dict[str, torch.Tensor]):
        grads, metrics = grads_of(params, batch)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def _unflatten(tree: Any, flat: list[torch.Tensor]) -> Any:
    """``flat`` (in :func:`leaves` order) in the structure of ``tree``."""
    it = iter(flat)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def make_serve_step(cfg: ModelConfig, *, device: Any = None):
    device = resolve_device(device)

    def serve_step(params: Params, cache: Params, batch: dict[str, torch.Tensor]):
        return M.decode_step(cfg, params, cache, batch.get("tokens"),
                             embeds=batch.get("embeds"), device=device)

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, device: Any = None):
    """Inference prefill: forward only, returns logits (no optimizer)."""
    device = resolve_device(device)

    def prefill_step(params: Params, batch: dict[str, torch.Tensor]):
        logits, _ = M.forward(cfg, params, batch.get("tokens"), embeds=batch.get("embeds"),
                              positions=batch.get("positions"), device=device)
        return logits

    return prefill_step


def abstract_opt_state(opt: AdamW, params_shape: Params) -> Params:
    """``opt.init``'s tree with every tensor on the ``meta`` device: shapes
    and dtypes, no memory."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params_shape)
    return opt.init(meta)

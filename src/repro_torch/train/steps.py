"""Train, serve and prefill steps of the port.

``make_train_step`` closes over (cfg, optimizer) and returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``, the
gradients of ``make_grad_fn`` followed by the optimizer's update;
``make_serve_step`` returns ``step(params, cache, batch) -> (logits, cache)``;
``make_prefill_step`` returns ``step(params, batch) -> logits``, the
prompt-scoring forward that runs attention through the flash kernel. Each
resolves its device once, when it is made. ``make_sharded_train_step`` is
the train step over a mesh of ranks: explicit ZeRO-3, computing what the
JAX package's GSPMD step computes.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import span
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, leaves
from repro_torch.optim.compress import bf16_grads, tree_map

Params = Any

__all__ = ["make_grad_fn", "make_train_step", "make_sharded_train_step", "make_serve_step",
           "make_prefill_step", "abstract_opt_state", "TRAIN_METRICS"]

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
    the loss, ce and moe_aux as 0-d tensors. ``grads(params, batch,
    denom)`` divides the CE sum by ``denom`` instead of the batch's own
    count of labelled positions. Under a profiler the loss is a
    ``repro_torch.train.forward`` span and the gradients and their cast a
    ``repro_torch.train.backward`` span.
    """
    device = resolve_device(device)

    def grads_of(params: Params, batch: dict[str, torch.Tensor],
                 denom: torch.Tensor | None = None):
        # leaves that share the parameters' storage and take gradients
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with span("repro_torch.train.forward"):
            _, metrics = M.loss_fn(cfg, live, batch.get("tokens"), batch["labels"],
                                   embeds=batch.get("embeds"),
                                   positions=batch.get("positions"),
                                   aux_weight=aux_weight, denom=denom, device=device)
        with span("repro_torch.train.backward"):
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


def make_sharded_train_step(cfg: ModelConfig, opt: AdamW, mesh: Any, specs: Any, *,
                            aux_weight: float = 0.01, compress_bf16: bool = True,
                            device: Any = None):
    """:func:`make_train_step` over ``mesh``'s ranks (a mesh over a rank
    group), for parameters and moments placed as DTensors by ``specs``
    (:func:`repro_torch.distributed.sharding.param_specs`; the moments by
    the same specs, the step replicated).

    Explicit ZeRO-3, what the JAX package's GSPMD step computes:

    * each DP rank (a coordinate of the mesh's DP axes, ``ctx.DP``) takes
      its block of the batch's rows, and every rank gathers the parameters
      whole (``full_tensor()``: the token fetch);
    * the gradients of :func:`make_grad_fn` on the local rows, model code
      seeing the rank's shard as the whole batch (``ctx.shard_local``: one
      MoE dispatch group a rank). The CE sum is divided by the count of
      labelled positions over all DP ranks and the MoE aux weighted by
      1/D, so the gradients summed over the D DP ranks are the gradient of
      the global loss (sum of CE over the global count, plus the aux
      averaged over the groups);
    * the gradients summed over the DP mesh dims only (``Partial`` there,
      ``Replicate`` on ``model``, whose ranks hold equal gradients) into the
      parameter placement, in the gradients' dtype (bf16 under
      ``compress_bf16``);
    * :meth:`AdamW.update` on the local shards, clipped by the norm of the
      whole gradient (each shard's sum of squares once, a replicated shard
      divided by its copies, summed over the ranks).

    The metrics are the global ones. At one rank every gather, reduction
    and placement is an identity, and the step gives :func:`make_train_step`'s
    bits.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.sharding import spec_placements
    from repro_torch.distributed.shardspec import tree_leaves

    dmesh = mesh.device_mesh
    if dmesh is None:
        raise ValueError("a sharded train step needs a mesh over a rank group")
    names = mesh.axis_names
    dp_dims = [i for i, a in enumerate(names) if a in ctx.DP]
    n_dp = 1
    for i in dp_dims:
        n_dp *= mesh.shape[names[i]]
    coord = dmesh.get_coordinate()
    dp_index = 0
    for i in dp_dims:
        dp_index = dp_index * mesh.shape[names[i]] + int(coord[i])
    over_dp = tuple(Partial() if i in dp_dims else Replicate() for i in range(len(names)))
    replicated = tuple(Replicate() for _ in names)
    placements = [spec_placements(sp, names) for sp in tree_leaves(specs)]
    copies = []
    for pl in placements:
        c = 1
        for i, p in enumerate(pl):
            if isinstance(p, Replicate):
                c *= mesh.shape[names[i]]
        copies.append(c)
    grads_of = make_grad_fn(cfg, aux_weight=aux_weight / n_dp, compress_bf16=compress_bf16,
                            device=device)

    def reduce(x: torch.Tensor, over: tuple) -> torch.Tensor:
        return DTensor.from_local(x, dmesh, over, run_check=False).full_tensor()

    def to_local(t):
        return t.to_local()

    def train_step(params: Params, opt_state: Params, batch: dict[str, torch.Tensor]):
        rows = batch["labels"].shape[0]
        if rows % n_dp:
            raise ValueError(f"a batch of {rows} rows does not split over {n_dp} DP ranks")
        per = rows // n_dp
        local = {k: v[dp_index * per:(dp_index + 1) * per] for k, v in batch.items()}
        count = reduce((torch.as_tensor(local["labels"]) >= 0).sum(), over_dp)
        with ctx.shard_local():
            grads, metrics = grads_of(tree_map(lambda p: p.full_tensor(), params), local,
                                      denom=count)
        shards = [DTensor.from_local(g, dmesh, over_dp, run_check=False)
                  .redistribute(dmesh, pl).to_local()
                  for g, pl in zip(leaves(grads), placements)]
        del grads
        total = None
        for g, c in zip(shards, copies):
            part = torch.sum(torch.square(g.float()))
            if c != 1:
                part = part / c
            total = part if total is None else total + part
        dist.all_reduce(total)
        gnorm = torch.sqrt(total)
        local_state = {"m": tree_map(to_local, opt_state["m"]),
                       "v": tree_map(to_local, opt_state["v"]),
                       "step": opt_state["step"].to_local()}
        _, new_state, opt_metrics = opt.update(
            _unflatten(params, shards), local_state, tree_map(to_local, params), gnorm=gnorm)
        opt_state = {"m": opt_state["m"], "v": opt_state["v"],
                     "step": DTensor.from_local(new_state["step"], dmesh, replicated,
                                                run_check=False)}
        metrics = {"loss": reduce(metrics["loss"], over_dp),
                   "ce": reduce(metrics["ce"], over_dp),
                   "moe_aux": reduce(metrics["moe_aux"], over_dp) / n_dp}
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
    """One decode step over a prefill chunk or one token: under a profiler a
    ``repro_torch.serve.step`` span."""
    device = resolve_device(device)

    def serve_step(params: Params, cache: Params, batch: dict[str, torch.Tensor]):
        with span("repro_torch.serve.step"):
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

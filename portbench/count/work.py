"""The work a unit of a cell needs, from the configuration and the traffic's
shapes: each product, attention, scan and optimizer pass as a ``Cost``
(``costs``), tagged with its kernel class. What the inputs need is
counted, not what an implementation does beyond it: a prefill's head only
where its logits are used, an expert's rows only for the tokens routed to
it, the attention pairs a causal mask keeps. ``route`` says whether the
program runs a product on its own matmul kernel ("port") or hands it to
the library ("library"); it does not change the work.
"""

from __future__ import annotations

import dataclasses
import math

from portbench.count import costs
from portbench.count.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

__all__ = ["Item", "forward", "train_step", "decode_step", "unit", "totals", "bound_seconds",
           "model_flops"]


@dataclasses.dataclass(frozen=True)
class Item:
    cls: str            # matmul | attention | scan | optimizer | cache
    route: str          # port | library | -
    cost: costs.Cost
    phase: str = "fwd"  # fwd | remat | bwd | opt


def _dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    return {"d": d, "h": cfg["num_heads"], "hkv": cfg["num_kv_heads"],
            "hd": cfg.get("head_dim") or d // cfg["num_heads"], "ff": cfg["d_ff"],
            "v": cfg["vocab_size"], "e": cfg.get("moe_experts", 0),
            "k": cfg.get("moe_top_k", 0), "eff": cfg.get("moe_d_ff", 0),
            "di": cfg.get("ssm_expand", 2) * d, "ds": cfg.get("ssm_d_state", 16),
            "dtr": cfg.get("ssm_dt_rank") or math.ceil(d / 16)}


def _layers(cfg: dict):
    pattern = [tuple(b) for b in cfg["pattern"]]
    for i in range(cfg["num_layers"]):
        yield pattern[i % len(pattern)]


def _products(cfg: dict, t: float) -> list[tuple[str, float, float, float, int]]:
    """(route, m, k, n, itemsize) of every product of ``t`` tokens through
    the stack, without the head."""
    z = _dims(cfg)
    d = z["d"]
    out = []
    for mixer, mlp in _layers(cfg):
        if mixer == "attn":
            qd, kvd = z["h"] * z["hd"], z["hkv"] * z["hd"]
            out += [("port", t, d, qd, 2), ("port", t, d, kvd, 2), ("port", t, d, kvd, 2),
                    ("port", t, qd, d, 2)]
        elif mixer == "mamba":
            di = z["di"]
            out += [("library", t, d, 2 * di, 2), ("library", t, di, z["dtr"] + 2 * z["ds"], 2),
                    ("library", t, z["dtr"], di, 2), ("library", t, di, d, 2)]
        if mlp == "dense":
            out += [("port", t, d, z["ff"], 2)] * 2 + [("port", t, z["ff"], d, 2)]
        elif mlp == "moe":
            e, k, eff = z["e"], z["k"], z["eff"]
            out.append(("library", t, d, e, 4))                       # the fp32 router
            touched = min(e, t * k)
            rows = t * k / touched                                    # routed rows an expert
            out += [("library", rows, d, eff, 2)] * (2 * touched)
            out += [("library", rows, eff, d, 2)] * touched
    return out


def _head(cfg: dict, rows: float) -> tuple:
    z = _dims(cfg)
    return ("port", rows, z["d"], z["v"], 2)


def _attn_layers(cfg: dict) -> int:
    return sum(1 for mixer, _ in _layers(cfg) if mixer == "attn")


def _mamba_layers(cfg: dict) -> int:
    return sum(1 for mixer, _ in _layers(cfg) if mixer == "mamba")


def _mm(route, m, k, n, itemsize, phase="fwd") -> Item:
    return Item("matmul", route, costs.matmul(m, k, n, itemsize), phase)


def forward(cfg: dict, batch: int, seq: int, *, head_rows: float | None = None) -> list[Item]:
    """A full-sequence forward of ``batch`` rows of ``seq`` tokens; the head
    over ``head_rows`` rows (default every position)."""
    z = _dims(cfg)
    t = batch * seq
    items = [_mm(*p) for p in _products(cfg, t)]
    items.append(_mm(*_head(cfg, t if head_rows is None else head_rows)))
    fl = costs.flash(batch, z["h"], z["hkv"], seq, seq, z["hd"], 2)
    items += [Item("attention", "port", fl)] * _attn_layers(cfg)
    sc = costs.scan(batch, seq, z["di"], z["ds"], 2)
    items += [Item("scan", "port", sc)] * _mamba_layers(cfg)
    return items


def train_step(cfg: dict, batch: int, seq: int, remat: str) -> list[Item]:
    """One AdamW step: the forward (each layer's products and attention run
    again in the backward under remat "full"), both gradients of every
    product, attention's backward, the scan's backward and the optimizer
    reading p, g, m, v and writing p, m, v once (22 bytes a parameter)."""
    z = _dims(cfg)
    t = batch * seq
    layer = _products(cfg, t)
    head = _head(cfg, t)
    items = [_mm(*p) for p in layer] + [_mm(*head)]
    if remat == "full":
        items += [_mm(*p, phase="remat") for p in layer]
    for route, m, k, n, s in layer + [head]:
        items += [Item("matmul", route, costs.matmul(m, n, k, s), "bwd"),
                  Item("matmul", route, costs.matmul(k, m, n, s), "bwd")]
    a = _attn_layers(cfg)
    fl = costs.flash(batch, z["h"], z["hkv"], seq, seq, z["hd"], 2, lse=True)
    items += [Item("attention", "port", fl)] * a
    if remat == "full":
        items += [Item("attention", "port", fl, "remat")] * a
    items += [Item("attention", "port",
                   costs.flash_bwd(batch, z["h"], z["hkv"], seq, seq, z["hd"], 2), "bwd")] * a
    m_l = _mamba_layers(cfg)
    items += [Item("scan", "port", costs.scan(batch, seq, z["di"], z["ds"], 2))] * m_l
    items += [Item("scan", "port", costs.scan_bwd(batch, seq, z["di"], z["ds"], 2), "bwd")] * m_l
    n = param_count(cfg)
    items.append(Item("optimizer", "-", costs.Cost(15.0 * n, 22.0 * n, "fp32"), "opt"))
    return items


def decode_step(cfg: dict, batch: int, ctx: int, *, head: bool = True) -> list[Item]:
    """One token a row through the stack at cache length ``ctx`` (the new
    token included): the products, attention over the cache (K and V read
    once), and each Mamba layer's recurrent step (its fp32 state read and
    written, the conv window read)."""
    z = _dims(cfg)
    items = [_mm(*p) for p in _products(cfg, batch)]
    if head:
        items.append(_mm(*_head(cfg, batch)))
    at = costs.flash(batch, z["h"], z["hkv"], 1, ctx, z["hd"], 2, causal=False)
    items += [Item("attention", "-", at)] * _attn_layers(cfg)
    di, ds = z["di"], z["ds"]
    step = costs.Cost(costs.SSM_FLOPS * batch * di * ds,
                      float(2 * batch * di * ds * 4 + 3 * batch * di * 2 + 2 * batch * ds * 2
                            + batch * (cfg.get("ssm_d_conv", 4) - 1) * di * 2), "fp32")
    items += [Item("scan", "-", step)] * _mamba_layers(cfg)
    return items


def param_count(cfg: dict) -> int:
    """Parameters of the configuration (the weights' leaves)."""
    from portbench.weights import leaf_specs

    return sum(math.prod(shape) for _, shape, _ in leaf_specs(cfg))


def unit(cfg: dict, traffic: dict, **shape) -> list[Item]:
    """The work of one unit of the traffic's kind: a train step, a generate
    call (``decode``: the prompt fed a token a step, the head where its
    logits pick a token), a request of ``prompt_len`` tokens (``ttft``: the
    prompt's forward, the head at its last position, and the one decode
    step ``generate(steps=1)`` runs), or a scoring forward (``score``)."""
    kind = traffic["kind"]
    if kind == "train":
        return train_step(cfg, traffic["batch"], traffic["seq_len"], traffic["remat"])
    if kind == "score":
        return forward(cfg, traffic["batch"], traffic["seq_len"])
    if kind == "ttft":
        n = shape["prompt_len"]
        return forward(cfg, 1, n, head_rows=1) + decode_step(cfg, 1, n + 1)
    if kind == "decode":
        b, p, g = traffic["batch"], traffic["prompt_len"], traffic["new_tokens"]
        items = []
        for pos in range(p + g):
            # the logits of the last prompt token and of the generated ones
            # but the last pick the tokens
            items += decode_step(cfg, b, pos + 1, head=p - 1 <= pos < p + g - 1)
        return items
    raise ValueError(f"no work model for traffic kind {kind!r}")


def totals(items: list[Item]) -> dict:
    """{"flops": {kind: ...}, "bytes": ..., "class": {cls: (flops, bytes,
    bound seconds)}} summed over ``items``."""
    flops: dict[str, float] = {}
    nbytes = 0.0
    per: dict[str, list[float]] = {}
    for it in items:
        c = it.cost
        flops[c.kind] = flops.get(c.kind, 0.0) + c.flops
        nbytes += c.bytes
        row = per.setdefault(it.cls, [0.0, 0.0, 0.0])
        row[0] += c.flops
        row[1] += c.bytes
        row[2] += bound_seconds(c)
    return {"flops": flops, "bytes": nbytes, "class": {k: tuple(v) for k, v in per.items()}}


def bound_seconds(c: costs.Cost) -> float:
    """The least time the card takes for one call: its bytes at the memory
    rate or its operations at the peak of their type, whichever is longer."""
    return max(c.bytes / HBM_BYTES_PER_S, c.flops / PEAK_FLOPS[c.kind])


def model_flops(cfg: dict, traffic: dict, **shape) -> float:
    """The model's operations in a unit: every product and attention pair of
    the forward (no recompute), three times over for a train step (the
    forward and both gradients: 6·N·D plus attention)."""
    items = unit(cfg, traffic, **shape)
    fwd = sum(it.cost.flops for it in items
              if it.phase == "fwd" and it.cls in ("matmul", "attention"))
    return 3.0 * fwd if traffic["kind"] == "train" else fwd

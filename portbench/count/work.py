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

from portbench import archs
from portbench.count import costs
from portbench.count.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from portbench.weights import dims, leaf_specs

__all__ = ["Item", "Work", "param_count", "unit", "totals", "bound_seconds", "model_flops"]


@dataclasses.dataclass(frozen=True)
class Item:
    cls: str            # matmul | attention | scan | optimizer | cache
    route: str          # port | library | -
    cost: costs.Cost
    phase: str = "fwd"  # fwd | remat | bwd | opt


def _mm(route, m, k, n, itemsize, phase="fwd") -> Item:
    return Item("matmul", route, costs.matmul(m, k, n, itemsize), phase)


#: the order of the mixers' items after the products: by class, then by
#: phase, each in layer order
_CLASSES = ("attention", "scan")
_PHASES = ("fwd", "remat", "bwd", "opt")


def _by_class(items: list[Item]) -> list[Item]:
    return sorted(items, key=lambda it: (_CLASSES.index(it.cls) if it.cls in _CLASSES
                                         else len(_CLASSES), _PHASES.index(it.phase)))


class Work:
    """The work model of a configuration. A layer's products come from
    ``mixer_products`` and ``mlp_products`` by kind, and its mixer's
    attention-like items (attention, the scan) from ``mixer_forward``,
    ``mixer_train`` and ``mixer_decode``; ``forward``, ``train_step`` and
    ``decode_step`` compose them. A kind the built-ins lack counts by
    ``archs/<kind>.py``'s ``products``, ``forward_items``, ``train_items``
    and ``decode_items``, and raises where there is none."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.z = dims(cfg)

    def layers(self):
        pattern = [tuple(b) for b in self.cfg["pattern"]]
        for i in range(self.cfg["num_layers"]):
            yield pattern[i % len(pattern)]

    # -- a layer's products: (route, m, k, n, itemsize) of t tokens ------------------

    def mixer_products(self, kind: str, t: float) -> list[tuple]:
        z = self.z
        d = z["d"]
        if kind == "attn":
            qd, kvd = z["h"] * z["hd"], z["hkv"] * z["hd"]
            return [("port", t, d, qd, 2), ("port", t, d, kvd, 2), ("port", t, d, kvd, 2),
                    ("port", t, qd, d, 2)]
        if kind == "mamba":
            di = z["di"]
            return [("library", t, d, 2 * di, 2), ("library", t, di, z["dtr"] + 2 * z["ds"], 2),
                    ("library", t, z["dtr"], di, 2), ("library", t, di, d, 2)]
        return archs.find(kind, "products", "work model for mixer")(self, t)

    def mlp_products(self, kind: str, t: float) -> list[tuple]:
        z = self.z
        d = z["d"]
        if kind == "none":
            return []
        if kind == "dense":
            return [("port", t, d, z["ff"], 2)] * 2 + [("port", t, z["ff"], d, 2)]
        if kind == "moe":
            e, k, eff, sff = z["e"], z["top_k"], z["eff"], z["shared"] * z["eff"]
            out = [("library", t, d, e, 4)]                            # the fp32 router
            touched = min(e, t * k)
            rows = t * k / touched                                     # routed rows an expert
            out += [("library", rows, d, eff, 2)] * (2 * touched)
            out += [("library", rows, eff, d, 2)] * touched
            if sff:                                                    # shared experts, all t
                out += [("library", t, d, sff, 2)] * 2 + [("library", t, sff, d, 2)]
            return out
        return archs.find(kind, "products", "work model for mlp")(self, t)

    def products(self, t: float) -> list[tuple]:
        """Every product of ``t`` tokens through the stack, without the head."""
        out = []
        for mixer, mlp in self.layers():
            out += self.mixer_products(mixer, t) + self.mlp_products(mlp, t)
        return out

    def head(self, rows: float) -> tuple:
        return ("port", rows, self.z["d"], self.z["v"], 2)

    # -- a layer's mixer beside its products -------------------------------------------

    def mixer_forward(self, kind: str, batch: int, seq: int) -> list[Item]:
        z = self.z
        if kind == "attn":
            return [Item("attention", "port",
                         costs.flash(batch, z["h"], z["hkv"], seq, seq, z["hd"], 2))]
        if kind == "mamba":
            return [Item("scan", "port", costs.scan(batch, seq, z["di"], z["ds"], 2))]
        return archs.find(kind, "forward_items", "work model for mixer")(self, batch, seq)

    def mixer_train(self, kind: str, batch: int, seq: int, remat: str) -> list[Item]:
        """The forward (again in the backward under remat "full" for
        attention) and the backward."""
        z = self.z
        if kind == "attn":
            fl = costs.flash(batch, z["h"], z["hkv"], seq, seq, z["hd"], 2, lse=True)
            return ([Item("attention", "port", fl)]
                    + ([Item("attention", "port", fl, "remat")] if remat == "full" else [])
                    + [Item("attention", "port",
                            costs.flash_bwd(batch, z["h"], z["hkv"], seq, seq, z["hd"], 2),
                            "bwd")])
        if kind == "mamba":
            return [Item("scan", "port", costs.scan(batch, seq, z["di"], z["ds"], 2)),
                    Item("scan", "port", costs.scan_bwd(batch, seq, z["di"], z["ds"], 2), "bwd")]
        return archs.find(kind, "train_items", "work model for mixer")(self, batch, seq, remat)

    def mixer_decode(self, kind: str, batch: int, ctx: int) -> list[Item]:
        """Attention over the cache (K and V read once); a Mamba layer's
        recurrent step (its fp32 state read and written, the conv window
        read)."""
        z = self.z
        if kind == "attn":
            return [Item("attention", "-",
                         costs.flash(batch, z["h"], z["hkv"], 1, ctx, z["hd"], 2, causal=False))]
        if kind == "mamba":
            di, ds = z["di"], z["ds"]
            return [Item("scan", "-", costs.Cost(
                costs.SSM_FLOPS * batch * di * ds,
                float(2 * batch * di * ds * 4 + 3 * batch * di * 2 + 2 * batch * ds * 2
                      + batch * (z["d_conv"] - 1) * di * 2), "fp32"))]
        return archs.find(kind, "decode_items", "work model for mixer")(self, batch, ctx)

    def _mixers(self, items_of) -> list[Item]:
        return _by_class([it for mixer, _ in self.layers() for it in items_of(mixer)])

    # -- a unit's parts ------------------------------------------------------------------

    def forward(self, batch: int, seq: int, *, head_rows: float | None = None) -> list[Item]:
        """A full-sequence forward of ``batch`` rows of ``seq`` tokens; the
        head over ``head_rows`` rows (default every position)."""
        t = batch * seq
        items = [_mm(*p) for p in self.products(t)]
        items.append(_mm(*self.head(t if head_rows is None else head_rows)))
        return items + self._mixers(lambda kind: self.mixer_forward(kind, batch, seq))

    def train_step(self, batch: int, seq: int, remat: str) -> list[Item]:
        """One AdamW step: the forward (each layer's products run again in
        the backward under remat "full"), both gradients of every product,
        the mixers' items and the optimizer reading p, g, m, v and writing
        p, m, v once (22 bytes a parameter)."""
        t = batch * seq
        layer = self.products(t)
        head = self.head(t)
        items = [_mm(*p) for p in layer] + [_mm(*head)]
        if remat == "full":
            items += [_mm(*p, phase="remat") for p in layer]
        for route, m, k, n, s in layer + [head]:
            items += [Item("matmul", route, costs.matmul(m, n, k, s), "bwd"),
                      Item("matmul", route, costs.matmul(k, m, n, s), "bwd")]
        items += self._mixers(lambda kind: self.mixer_train(kind, batch, seq, remat))
        n = param_count(self.cfg)
        items.append(Item("optimizer", "-", costs.Cost(15.0 * n, 22.0 * n, "fp32"), "opt"))
        return items

    def decode_step(self, batch: int, ctx: int, *, head: bool = True) -> list[Item]:
        """One token a row through the stack at cache length ``ctx`` (the new
        token included): the products and the mixers' steps."""
        items = [_mm(*p) for p in self.products(batch)]
        if head:
            items.append(_mm(*self.head(batch)))
        return items + self._mixers(lambda kind: self.mixer_decode(kind, batch, ctx))


def param_count(cfg: dict) -> int:
    """Parameters of the configuration (the weights' leaves)."""
    return sum(math.prod(shape) for _, shape, _ in leaf_specs(cfg))


def unit(cfg: dict, traffic: dict, **shape) -> list[Item]:
    """The work of one unit of the traffic's kind: a train step, a generate
    call (``decode``: the prompt fed a token a step, the head where its
    logits pick a token), a request of ``prompt_len`` tokens (``ttft``: the
    prompt's forward, the head at its last position, and the one decode
    step ``generate(steps=1)`` runs), or a scoring forward (``score``)."""
    kind = traffic["kind"]
    w = Work(cfg)
    if kind == "train":
        return w.train_step(traffic["batch"], traffic["seq_len"], traffic["remat"])
    if kind == "score":
        return w.forward(traffic["batch"], traffic["seq_len"])
    if kind == "ttft":
        n = shape["prompt_len"]
        return w.forward(1, n, head_rows=1) + w.decode_step(1, n + 1)
    if kind == "decode":
        b, p, g = traffic["batch"], traffic["prompt_len"], traffic["new_tokens"]
        items = []
        for pos in range(p + g):
            # the logits of the last prompt token and of the generated ones
            # but the last pick the tokens
            items += w.decode_step(b, pos + 1, head=p - 1 <= pos < p + g - 1)
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

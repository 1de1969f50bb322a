"""Weights made from the seed, on the device, in the program's parameter tree.

Both sides are handed these tensors: the program as its parameters, the
reference (which makes them again from the same seed after the window) as
the inputs it computes from. Every random leaf of the config's dtype is a
view into one buffer filled by one ``torch.randn`` call on the device, then
scaled in place by 1/sqrt(fan-in) (the embedding by 0.02); the fp32 MoE
routers come from a second call, and the fp32 selection biases of a
sigmoid-scored MoE (``router_bias``, scaled by ``BIAS_SCALE``: never zero,
since a zero bias would hide a program that ignores it) from a third. The
constants are the usual initial values (norm scales 1, Mamba's A =
-(1..d_state) stored as its log, dt's bias softplus^-1(0.01), the skip 1).
The same seed gives the same bits.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from portbench import archs

__all__ = ["Leaves", "dims", "make_params", "leaf_specs", "torch_dtype"]

_ALIGN = 128          # elements: every view starts 256-byte aligned in bf16
#: the leaves drawn in fp32, by the last name of their path: one call for
#: every router, then one for every selection bias, so a bias moves no
#: other leaf's bits
_FP32 = ("router", "router_bias")
#: the scale of a sigmoid-scored MoE's selection bias: beside the sigmoids of
#: router logits of unit scale it changes a choice of 17% of tokens at 4
#: experts top-2 and of 99% at 64 experts top-6
BIAS_SCALE = 0.1


def torch_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def dims(cfg: dict) -> dict[str, int]:
    """The configuration's widths under short names, as the weights and the
    work model read them."""
    d = cfg["d_model"]
    return {"d": d, "h": cfg["num_heads"], "hkv": cfg["num_kv_heads"],
            "hd": cfg.get("head_dim") or d // cfg["num_heads"], "ff": cfg["d_ff"],
            "v": cfg["vocab_size"], "e": cfg.get("moe_experts", 0),
            "top_k": cfg.get("moe_top_k", 0), "eff": cfg.get("moe_d_ff", 0),
            "shared": cfg.get("moe_shared_experts", 0),
            "di": cfg.get("ssm_expand", 2) * d, "ds": cfg.get("ssm_d_state", 16),
            "d_conv": cfg.get("ssm_d_conv", 4),
            "dtr": cfg.get("ssm_dt_rank") or math.ceil(d / 16)}


class Leaves:
    """The leaf list of a configuration: (path, shape, init) of every leaf,
    in a fixed order. ``init`` is a scale for a random leaf (drawn in the
    config's dtype, or in fp32 for a path ending in "router" or
    "router_bias"), or ("fill",
    value) / ("a_log",) for a constant. A block's leaves come from ``mixer``
    and ``mlp`` by kind; a kind the built-ins lack, from
    ``archs/<kind>.py``'s ``leaves``."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.z = dims(cfg)

    def specs(self) -> list[tuple[tuple, tuple[int, ...], Any]]:
        pattern = self.cfg["pattern"]
        out = self.embed()
        for i in range(self.cfg["num_layers"] // len(pattern)):
            for j, (mixer, mlp) in enumerate(pattern):
                out += self.block(("stack", i, j), mixer, mlp)
        return out + self.final()

    def embed(self) -> list:
        d, v = self.z["d"], self.z["v"]
        out: list = [(("embed", "tokens"), (v, d), 0.02)]
        if not self.cfg.get("tie_embeddings", False):
            out.append((("embed", "head"), (d, v), 1 / math.sqrt(d)))
        return out

    def block(self, at: tuple, mixer: str, mlp: str) -> list:
        d = self.z["d"]
        out = [(at + ("ln1", "scale"), (d,), ("fill", 1.0))] + self.mixer(at + ("mixer",), mixer)
        if mlp == "none":
            return out
        return out + [(at + ("ln2", "scale"), (d,), ("fill", 1.0))] + self.mlp(at + ("mlp",), mlp)

    def mixer(self, at: tuple, kind: str) -> list:
        z = self.z
        d = z["d"]
        if kind == "attn":
            h, hkv, hd = z["h"], z["hkv"], z["hd"]
            return [(at + ("wq",), (d, h * hd), 1 / math.sqrt(d)),
                    (at + ("wk",), (d, hkv * hd), 1 / math.sqrt(d)),
                    (at + ("wv",), (d, hkv * hd), 1 / math.sqrt(d)),
                    (at + ("wo",), (h * hd, d), 1 / math.sqrt(h * hd))]
        if kind == "mamba":
            di, ds, dtr = z["di"], z["ds"], z["dtr"]
            return [(at + ("w_in",), (d, 2 * di), 1 / math.sqrt(d)),
                    (at + ("conv_w",), (z["d_conv"], di), 0.1),
                    (at + ("conv_b",), (di,), ("fill", 0.0)),
                    (at + ("w_x",), (di, dtr + 2 * ds), 1 / math.sqrt(di)),
                    (at + ("w_dt",), (dtr, di), 1 / math.sqrt(dtr)),
                    (at + ("dt_bias",), (di,), ("fill", -4.6)),
                    (at + ("a_log",), (di, ds), ("a_log",)),
                    (at + ("d_skip",), (di,), ("fill", 1.0)),
                    (at + ("w_out",), (di, d), 1 / math.sqrt(di))]
        return archs.find(kind, "leaves", "weights for mixer")(self, at)

    def mlp(self, at: tuple, kind: str) -> list:
        z = self.z
        d = z["d"]
        if kind == "dense":
            ff = z["ff"]
            return [(at + ("w_up",), (d, ff), 1 / math.sqrt(d)),
                    (at + ("w_down",), (ff, d), 1 / math.sqrt(ff)),
                    (at + ("w_gate",), (d, ff), 1 / math.sqrt(d))]
        if kind == "moe":
            e, ff, sff = z["e"], z["eff"], z["shared"] * z["eff"]
            out = [(at + ("router",), (d, e), 1 / math.sqrt(d)),
                   (at + ("w_up",), (e, d, ff), 1 / math.sqrt(d)),
                   (at + ("w_down",), (e, ff, d), 1 / math.sqrt(ff)),
                   (at + ("w_gate",), (e, d, ff), 1 / math.sqrt(d))]
            if sff:
                out += [(at + ("shared_up",), (d, sff), 1 / math.sqrt(d)),
                        (at + ("shared_down",), (sff, d), 1 / math.sqrt(sff)),
                        (at + ("shared_gate",), (d, sff), 1 / math.sqrt(d))]
            if self.cfg.get("moe_scoring", "softmax") == "sigmoid":
                out.append((at + ("router_bias",), (e,), BIAS_SCALE))
            return out
        return archs.find(kind, "leaves", "weights for mlp")(self, at)

    def final(self) -> list:
        return [(("final_norm", "scale"), (self.z["d"],), ("fill", 1.0))]


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple[int, ...], Any]]:
    """(path, shape, init) of every leaf of ``cfg``, in a fixed order
    (``Leaves``)."""
    return Leaves(cfg).specs()


def _put(tree: dict, path: tuple, leaf: torch.Tensor) -> None:
    node: Any = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, dict):
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        else:
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
    node[path[-1]] = leaf


def make_params(cfg: dict, seed: int, device: Any) -> dict:
    """The parameter tree of ``cfg`` (``embed``, ``stack[period][slot]``,
    ``final_norm``) drawn from ``seed`` on ``device``."""
    dtype = torch_dtype(cfg)
    specs = leaf_specs(cfg)
    rand = [(p, s, init) for p, s, init in specs
            if not isinstance(init, tuple) and p[-1] not in _FP32]
    offsets, total = [], 0
    for _, shape, _ in rand:
        offsets.append(total)
        total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    where = {p: off for (p, _, _), off in zip(rand, offsets)}
    fp32: dict[tuple, torch.Tensor] = {}
    for name in _FP32:
        group = [(p, shape) for p, shape, _ in specs if p[-1] == name]
        if not group:
            continue
        buf = torch.randn(sum(math.prod(shape) for _, shape in group), generator=gen,
                          dtype=torch.float32, device=device)
        off = 0
        for path, shape in group:
            fp32[path] = buf[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
    tree: dict = {}
    for path, shape, init in specs:
        n = math.prod(shape)
        if path in where:
            leaf = flat[where[path]:where[path] + n].view(shape).mul_(init)
        elif path in fp32:
            leaf = fp32[path].mul_(init)
        elif init[0] == "fill":
            leaf = torch.full(shape, init[1], dtype=dtype, device=device)
        else:
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device)
            leaf = torch.log(a).expand(shape).to(dtype).contiguous()
        _put(tree, path, leaf)
    return tree

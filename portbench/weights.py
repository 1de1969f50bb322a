"""Weights made from the seed, on the device, in the program's parameter tree.

Both sides are handed these tensors: the program as its parameters, the
reference (which makes them again from the same seed after the window) as
the inputs it computes from. Every random leaf of the config's dtype is a
view into one buffer filled by one ``torch.randn`` call on the device, then
scaled in place by 1/sqrt(fan-in) (the embedding by 0.02); the fp32 MoE
routers come from a second call. The constants are the usual initial values
(norm scales 1, Mamba's A = -(1..d_state) stored as its log, dt's bias
softplus^-1(0.01), the skip 1). The same seed gives the same bits.
"""

from __future__ import annotations

import math
from typing import Any

import torch

__all__ = ["make_params", "leaf_specs", "torch_dtype"]

_ALIGN = 128          # elements: every view starts 256-byte aligned in bf16


def torch_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def _dims(cfg: dict) -> dict[str, int]:
    d = cfg["d_model"]
    di = cfg.get("ssm_expand", 2) * d
    return {"d": d, "h": cfg["num_heads"], "hkv": cfg["num_kv_heads"],
            "hd": cfg.get("head_dim") or d // cfg["num_heads"], "ff": cfg["d_ff"],
            "v": cfg["vocab_size"], "e": cfg.get("moe_experts", 0),
            "eff": cfg.get("moe_d_ff", 0), "di": di, "ds": cfg.get("ssm_d_state", 16),
            "k": cfg.get("ssm_d_conv", 4),
            "dtr": cfg.get("ssm_dt_rank") or math.ceil(d / 16)}


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple[int, ...], Any]]:
    """(path, shape, init) of every leaf, in a fixed order. ``init`` is a
    scale for a random leaf (drawn in the config's dtype, or in fp32 for a
    path ending in "router"), or ("fill", value) / ("a_log",) for a
    constant."""
    z = _dims(cfg)
    d, v = z["d"], z["v"]
    out: list = [(("embed", "tokens"), (v, d), 0.02)]
    if not cfg.get("tie_embeddings", False):
        out.append((("embed", "head"), (d, v), 1 / math.sqrt(d)))
    pattern = cfg["pattern"]
    periods = cfg["num_layers"] // len(pattern)
    for i in range(periods):
        for j, (mixer, mlp) in enumerate(pattern):
            at = ("stack", i, j)
            out.append((at + ("ln1", "scale"), (d,), ("fill", 1.0)))
            if mixer == "attn":
                h, hkv, hd = z["h"], z["hkv"], z["hd"]
                out += [(at + ("mixer", "wq"), (d, h * hd), 1 / math.sqrt(d)),
                        (at + ("mixer", "wk"), (d, hkv * hd), 1 / math.sqrt(d)),
                        (at + ("mixer", "wv"), (d, hkv * hd), 1 / math.sqrt(d)),
                        (at + ("mixer", "wo"), (h * hd, d), 1 / math.sqrt(h * hd))]
            elif mixer == "mamba":
                di, ds, dtr = z["di"], z["ds"], z["dtr"]
                out += [(at + ("mixer", "w_in"), (d, 2 * di), 1 / math.sqrt(d)),
                        (at + ("mixer", "conv_w"), (z["k"], di), 0.1),
                        (at + ("mixer", "conv_b"), (di,), ("fill", 0.0)),
                        (at + ("mixer", "w_x"), (di, dtr + 2 * ds), 1 / math.sqrt(di)),
                        (at + ("mixer", "w_dt"), (dtr, di), 1 / math.sqrt(dtr)),
                        (at + ("mixer", "dt_bias"), (di,), ("fill", -4.6)),
                        (at + ("mixer", "a_log"), (di, ds), ("a_log",)),
                        (at + ("mixer", "d_skip"), (di,), ("fill", 1.0)),
                        (at + ("mixer", "w_out"), (di, d), 1 / math.sqrt(di))]
            else:
                raise ValueError(f"no weights for mixer {mixer!r}")
            if mlp == "none":
                continue
            out.append((at + ("ln2", "scale"), (d,), ("fill", 1.0)))
            if mlp == "dense":
                ff = z["ff"]
                out += [(at + ("mlp", "w_up"), (d, ff), 1 / math.sqrt(d)),
                        (at + ("mlp", "w_down"), (ff, d), 1 / math.sqrt(ff)),
                        (at + ("mlp", "w_gate"), (d, ff), 1 / math.sqrt(d))]
            elif mlp == "moe":
                e, ff = z["e"], z["eff"]
                out += [(at + ("mlp", "router"), (d, e), 1 / math.sqrt(d)),
                        (at + ("mlp", "w_up"), (e, d, ff), 1 / math.sqrt(d)),
                        (at + ("mlp", "w_down"), (e, ff, d), 1 / math.sqrt(ff)),
                        (at + ("mlp", "w_gate"), (e, d, ff), 1 / math.sqrt(d))]
            else:
                raise ValueError(f"no weights for mlp {mlp!r}")
    out.append((("final_norm", "scale"), (d,), ("fill", 1.0)))
    return out


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
            if not isinstance(init, tuple) and p[-1] != "router"]
    routers = [(p, s, init) for p, s, init in specs if p[-1] == "router"]
    offsets, total = [], 0
    for _, shape, _ in rand:
        offsets.append(total)
        total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    rtotal = sum(math.prod(s) for _, s, _ in routers)
    rflat = torch.randn(rtotal, generator=gen, dtype=torch.float32, device=device) \
        if routers else None
    where = {p: off for (p, _, _), off in zip(rand, offsets)}
    rwhere, roff = {}, 0
    for path, shape, _ in routers:
        rwhere[path] = roff
        roff += math.prod(shape)
    tree: dict = {}
    for path, shape, init in specs:
        n = math.prod(shape)
        if path in where:
            leaf = flat[where[path]:where[path] + n].view(shape).mul_(init)
        elif path in rwhere:
            leaf = rflat[rwhere[path]:rwhere[path] + n].view(shape).mul_(init)
        elif init[0] == "fill":
            leaf = torch.full(shape, init[1], dtype=dtype, device=device)
        else:
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device)
            leaf = torch.log(a).expand(shape).to(dtype).contiguous()
        _put(tree, path, leaf)
    return tree

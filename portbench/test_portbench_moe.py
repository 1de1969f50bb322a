"""The built-in ``moe``'s DeepSeek variant, from configuration fields:
shared experts (``moe_shared_experts``) whose leaves are the program's (its
``moe_forward`` on them equals the reference), sigmoid scoring with a drawn
selection bias (``moe_scoring``) and a routed scale (``moe_routed_scale``)
against an oracle of every expert on every token, the work model's three
shared products, and the fp8 control through them."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from portbench import run, weights
from portbench.count import work
from portbench.reference.model import Ref, fp8_round


def cut(smoke, **fields) -> dict:
    """jamba's smoke cut (4 experts, top-2) to one attention and MoE layer,
    dropless (capacity factor E/k), with ``fields``."""
    cfg = smoke[0]("jamba-v0.1-52b")
    cfg.update(pattern=[["attn", "moe"]], num_layers=1,
               moe_capacity_factor=cfg["moe_experts"] / cfg["moe_top_k"], **fields)
    return cfg


def tokens(cfg: dict, t: int = 32, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(t, cfg["d_model"], generator=g)


def mlp_of(cfg: dict, seed: int = 3) -> dict:
    return weights.make_params(cfg, seed, "cpu")["stack"][0][0]["mlp"]


def test_shared_experts_are_the_programs(smoke):
    """The program's tree, drawn by its own ``init_moe``, has the leaves and
    shapes of the harness's; the program's ``moe_forward`` on the harness's
    leaves equals the reference."""
    from repro_torch.models import moe

    cfg = cut(smoke, moe_shared_experts=2)
    pcfg = run.Context("moe", cfg, {}, 0, 0.0, torch.device("cpu")).program_config()
    p = mlp_of(cfg)
    theirs = moe.init_moe(pcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    assert p["shared_up"].shape == (cfg["d_model"], 2 * cfg["moe_d_ff"])
    x = tokens(cfg)
    with torch.no_grad():
        got, _ = moe.moe_forward(pcfg, p, x[None])
        want = Ref(cfg, {}).ffn("moe", p, x[None])
        without = Ref(dict(cfg, moe_shared_experts=0), {}).ffn("moe", p, x[None])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((without - want).abs().max()) > 0.1 * scale


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def oracle(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert on every token and a masked combine: the bias only in
    the choice, the scale only on the routed sum."""
    e, k = cfg["moe_experts"], cfg["moe_top_k"]
    scores = torch.sigmoid(x @ p["router"])
    chosen = torch.topk(scores + p["router_bias"], k, dim=-1).indices
    mask = torch.zeros_like(scores).scatter(1, chosen, 1.0)
    w = scores * mask
    w = w / w.sum(-1, keepdim=True)
    every = torch.stack([_swiglu(x, p["w_gate"][j], p["w_up"][j], p["w_down"][j])
                         for j in range(e)], dim=1)                  # (T, E, d)
    y = cfg.get("moe_routed_scale", 1.0) * torch.einsum("te,ted->td", w, every)
    if cfg.get("moe_shared_experts", 0):
        y = y + _swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y


@pytest.mark.parametrize("shared,scale", [(0, 1.0), (2, 2.446)])
def test_sigmoid_routing_against_every_expert_on_every_token(smoke, shared, scale):
    cfg = cut(smoke, moe_shared_experts=shared, moe_scoring="sigmoid", moe_routed_scale=scale)
    p = mlp_of(cfg)
    assert p["router_bias"].dtype == torch.float32 and p["router_bias"].shape == (4,)
    x = tokens(cfg)
    with torch.no_grad():
        got = Ref(cfg, {}).moe(p, x)
        want = oracle(cfg, p, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_drawn_bias_changes_a_choice(smoke):
    cfg = cut(smoke, moe_scoring="sigmoid")
    p = mlp_of(cfg)
    assert float(p["router_bias"].abs().min()) > 0
    scores = torch.sigmoid(tokens(cfg) @ p["router"])
    k = cfg["moe_top_k"]

    def chosen(bias):
        return torch.topk(scores + bias, k, dim=-1).indices.sort(-1).values

    changed = (chosen(p["router_bias"]) != chosen(torch.zeros_like(p["router_bias"]))).any(-1)
    assert bool(changed.any()) and not bool(changed.all())


def test_the_bias_is_drawn_after_the_routers_and_moves_no_other_bits(smoke):
    """The softmax configuration's leaves keep their bits where the sigmoid
    one adds its bias: the bias is the fp32 call's last draw."""
    soft, sig = cut(smoke), cut(smoke, moe_scoring="sigmoid")
    a, b = weights.make_params(soft, 5, "cpu"), weights.make_params(sig, 5, "cpu")
    for path, _, _ in weights.leaf_specs(soft):
        x, y = a, b
        for key in path:
            x, y = x[key], y[key]
        assert torch.equal(x, y), path
    assert [p for p, _, _ in weights.leaf_specs(sig)][-2] == ("stack", 0, 0, "mlp", "router_bias")


def test_a_shared_expert_layer_counts_three_more_products(smoke):
    plain, shared = cut(smoke), cut(smoke, moe_shared_experts=2)
    d, sff = plain["d_model"], 2 * plain["moe_d_ff"]
    more = work.Work(shared).mlp_products("moe", 24)
    assert more[:len(work.Work(plain).mlp_products("moe", 24))] == \
        work.Work(plain).mlp_products("moe", 24)
    assert more[-3:] == [("library", 24, d, sff, 2)] * 2 + [("library", 24, sff, d, 2)]
    assert len(more) - len(work.Work(plain).mlp_products("moe", 24)) == 3
    assert work.param_count(shared) - work.param_count(plain) == 3 * d * sff
    sig = cut(smoke, moe_scoring="sigmoid")
    assert work.param_count(sig) - work.param_count(plain) == plain["moe_experts"]


def test_the_fp8_control_passes_through_the_shared_products(smoke):
    """With the routed experts' outputs zeroed, the control's MoE is the
    shared experts' SwiGLU with each product's operands rounded to fp8."""
    cfg = cut(smoke, moe_shared_experts=2, moe_scoring="sigmoid", moe_routed_scale=2.446)
    p = dict(mlp_of(cfg))
    p["w_down"] = torch.zeros_like(p["w_down"])
    x = tokens(cfg)

    def mm8(a, w):
        return fp8_round(a) @ fp8_round(w)

    with torch.no_grad():
        got = Ref(cfg, {}, quant=True).moe(p, x)
        want = mm8(F.silu(mm8(x, p["shared_gate"])) * mm8(x, p["shared_up"]), p["shared_down"])
        exact = Ref(cfg, {}).moe(p, x)
    assert torch.equal(got, want)
    assert float((got - exact).abs().max()) > 1e-3 * float(exact.abs().max())


def test_a_capacity_factor_of_e_over_k_drops_nothing(smoke):
    """Dropless is the capacity factor E/k: every choice kept, as the oracle
    keeps it; a factor below it drops some."""
    cfg = cut(smoke, moe_scoring="sigmoid")
    p = mlp_of(cfg)
    x = tokens(cfg, t=64, seed=9)
    with torch.no_grad():
        assert torch.allclose(Ref(cfg, {}).moe(p, x), oracle(cfg, p, x), atol=1e-6)
        tight = Ref(dict(cfg, moe_capacity_factor=0.5), {}).moe(p, x)
    assert not torch.allclose(tight, oracle(cfg, p, x), atol=1e-6)

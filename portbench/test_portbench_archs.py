"""The modules of kinds the built-in code lacks (``archs/<kind>.py``): two
modules written in a temporary directory add a mixer kind and an MLP kind,
and they flow through the weights, the reference (full forward and decode
steps) and the work model of every traffic kind; without a module the
built-in code raises on those kinds; a module named after a built-in kind
is never loaded, so a run is as it was."""

from __future__ import annotations

import itertools
import json
import textwrap
import types

import numpy as np
import pytest
import torch

from portbench import archs, run, weights
from portbench.count import work
from portbench.reference.model import Ref

#: a mixer "ema": an exponential moving average of a projection, then an
#: output projection
EMA = textwrap.dedent('''
    import math

    import torch

    from portbench.count import costs
    from portbench.count.work import Item


    def leaves(lv, at):
        d = lv.z["d"]
        return [(at + ("w_v",), (d, d), 1 / math.sqrt(d)),
                (at + ("decay",), (d,), ("fill", 0.75)),
                (at + ("w_o",), (d, d), 1 / math.sqrt(d))]


    def forward(ref, p, x, pos):
        v, a = ref.mm(x, p["w_v"]), p["decay"].float()
        h, ys = torch.zeros_like(v[:, 0]), []
        for t in range(v.shape[1]):
            h = a * h + (1 - a) * v[:, t]
            ys.append(h)
        return ref.mm(torch.stack(ys, dim=1), p["w_o"])


    def state(ref, batch, max_len, device):
        return {"h": torch.zeros(batch, ref.d, device=device)}


    def step(ref, p, x, t, state):
        a = p["decay"].float()
        state["h"] = a * state["h"] + (1 - a) * ref.mm(x, p["w_v"])[:, 0]
        return ref.mm(state["h"][:, None], p["w_o"])


    def products(w, t):
        d = w.z["d"]
        return [("port", t, d, d, 2)] * 2


    def _ema(w, batch, seq, phase="fwd"):
        n = batch * seq * w.z["d"]
        return Item("scan", "port", costs.Cost(3.0 * n, 6.0 * n, "fp32"), phase)


    def forward_items(w, batch, seq):
        return [_ema(w, batch, seq)]


    def train_items(w, batch, seq, remat):
        return [_ema(w, batch, seq), _ema(w, batch, seq, "bwd")]


    def decode_items(w, batch, ctx):
        return [_ema(w, batch, 1)]
''')

#: an MLP "relu2": squared ReLU
RELU2 = textwrap.dedent('''
    import math

    import torch


    def leaves(lv, at):
        d, ff = lv.z["d"], lv.z["ff"]
        return [(at + ("w_1",), (d, ff), 1 / math.sqrt(d)),
                (at + ("w_2",), (ff, d), 1 / math.sqrt(ff))]


    def forward(ref, p, x):
        return ref.mm(torch.relu(ref.mm(x, p["w_1"])).square(), p["w_2"])


    def products(w, t):
        d, ff = w.z["d"], w.z["ff"]
        return [("port", t, d, ff, 2), ("port", t, ff, d, 2)]
''')

#: a module of a built-in kind's name: never loaded
BUILTIN = "raise AssertionError('a built-in kind loaded its module')\n"

#: the toy's stack: one of each new kind beside the built-in attention and
#: dense MLP, two periods
PATTERN = [["ema", "relu2"], ["attn", "dense"]]


@pytest.fixture
def modules(tmp_path, monkeypatch):
    (tmp_path / "ema.py").write_text(EMA)
    (tmp_path / "relu2.py").write_text(RELU2)
    for kind in ("attn", "mamba", "dense", "moe", "none"):
        (tmp_path / f"{kind}.py").write_text(BUILTIN)
    monkeypatch.setattr(archs, "DIR", tmp_path)
    return tmp_path


def toy_config(smoke) -> dict:
    cfg = smoke[0]("minicpm-2b")
    cfg.update(pattern=PATTERN, num_layers=4)
    return cfg


def test_a_module_without_the_piece_asked_for_raises(smoke, modules):
    """A mixer module that brings its leaves and nothing else: the weights
    are made, the reference and the work model raise."""
    (modules / "bare.py").write_text(EMA.split("def forward")[0])
    cfg = dict(toy_config(smoke), pattern=[["bare", "dense"]], num_layers=2)
    params = weights.make_params(cfg, 0, "cpu")
    assert set(params["stack"][0][0]["mixer"]) == {"w_v", "decay", "w_o"}
    with pytest.raises(ValueError, match="no reference for mixer 'bare'"):
        Ref(cfg, params).logits(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="no work model for mixer 'bare'"):
        work.Work(cfg).products(8)


def test_the_toy_kinds_get_their_weights(smoke, modules):
    cfg = toy_config(smoke)
    params = weights.make_params(cfg, 3, "cpu")
    d, ff = cfg["d_model"], cfg["d_ff"]
    for i in range(2):
        ema, attn = params["stack"][i]
        assert set(ema["mixer"]) == {"w_v", "decay", "w_o"} and set(ema["mlp"]) == {"w_1", "w_2"}
        assert ema["mlp"]["w_1"].shape == (d, ff)
        assert float(ema["mixer"]["decay"].min()) == float(ema["mixer"]["decay"].max()) == 0.75
        assert set(attn["mixer"]) == {"wq", "wk", "wv", "wo"}
    specs = weights.leaf_specs(cfg)
    assert work.param_count(cfg) == sum(int(np.prod(s)) for _, s, _ in specs)
    assert [p for p, _, _ in specs].index(("stack", 0, 0, "mixer", "w_v")) == 2


def test_the_toy_reference_decodes_as_it_runs_a_whole_sequence(smoke, modules):
    cfg = toy_config(smoke)
    params = weights.make_params(cfg, 4, "cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg["vocab_size"], (3, 10)))
    ref = Ref(cfg, params)
    with torch.no_grad():
        whole = ref.logits(toks)
        st = ref.decode_state(3, 10, "cpu")
        steps = torch.stack([ref.step(toks[:, t], st) for t in range(10)], dim=1)
    assert st["len"] == 10 and set(st[(0, 0)]) == {"h"} and set(st[(0, 1)]) == {"k", "v"}
    assert float((whole - steps).abs().max()) <= 1e-5 * float(whole.abs().max())
    # the built-in reference of the same weights, where the toy's layers are
    # left out, reads otherwise
    plain = dict(cfg, pattern=[["attn", "dense"]], num_layers=2)
    params["stack"] = [[params["stack"][i][1]] for i in range(2)]
    with torch.no_grad():
        assert not torch.allclose(Ref(plain, params).logits(toks), whole)


@pytest.mark.parametrize("kind", ["train", "decode", "ttft", "score"])
def test_the_toy_work_counts_in_every_traffic_kind(smoke, modules, kind):
    cfg = toy_config(smoke)
    name = {"train": "train-s2048", "decode": "decode-b64", "ttft": "ttft-1k-4k",
            "score": "score-s4096"}[kind]
    tr = smoke[1](name)
    shape = {"prompt_len": 16} if kind == "ttft" else {}
    items = work.unit(cfg, tr, **shape)
    d = cfg["d_model"]
    # tokens through each toy layer, and its passes (train: forward and
    # backward)
    if kind == "ttft":
        tokens = 16 + 1
    elif kind == "decode":
        tokens = tr["batch"] * (tr["prompt_len"] + tr["new_tokens"])
    else:
        tokens = tr["batch"] * tr["seq_len"]
    passes = 2 if kind == "train" else 1
    scan = [it for it in items if it.cls == "scan"]
    assert sum(it.cost.flops for it in scan) == 2 * passes * 3.0 * tokens * d
    assert {it.phase for it in scan} == ({"fwd", "bwd"} if kind == "train" else {"fwd"})
    # the toy's products: beside a stack of its attention layers alone, two
    # of d x d and relu2's two a toy layer, each token
    ff = cfg["d_ff"]
    plain = dict(cfg, pattern=[["attn", "dense"]], num_layers=2)

    def fwd(its):
        return sum(it.cost.flops for it in its if it.cls == "matmul" and it.phase == "fwd")

    assert fwd(items) - fwd(work.unit(plain, tr, **shape)) == 2 * (4.0 * d * d + 4.0 * d * ff) \
        * tokens
    assert work.totals(items)["class"]["scan"][0] == sum(it.cost.flops for it in scan)
    assert work.model_flops(cfg, tr, **shape) > work.model_flops(plain, tr, **shape)


def test_the_toy_products_are_those_of_its_layers(smoke, modules):
    cfg = toy_config(smoke)
    w = work.Work(cfg)
    d, ff = cfg["d_model"], cfg["d_ff"]
    toy = [("port", 5, d, d, 2)] * 2 + [("port", 5, d, ff, 2), ("port", 5, ff, d, 2)]
    attn = w.mixer_products("attn", 5) + w.mlp_products("dense", 5)
    assert w.products(5) == (toy + attn) * 2


#: kinds no built-in code knows, in the mixer's and in the MLP's place
UNKNOWN = [["ema", "dense"], ["attn", "relu2"]]


@pytest.mark.parametrize("pattern", UNKNOWN, ids=lambda p: "-".join(p))
def test_the_builtin_weights_raise_on_an_unknown_kind(smoke, pattern):
    cfg = dict(smoke[0]("minicpm-2b"), pattern=[pattern])
    with pytest.raises(ValueError, match="no weights for"):
        weights.make_params(cfg, 0, "cpu")


@pytest.mark.parametrize("pattern", UNKNOWN, ids=lambda p: "-".join(p))
def test_the_builtin_reference_raises_on_an_unknown_kind(smoke, modules, monkeypatch,
                                                        tmp_path_factory, pattern):
    cfg = dict(toy_config(smoke), pattern=[pattern], num_layers=2)
    params = weights.make_params(cfg, 0, "cpu")
    monkeypatch.setattr(archs, "DIR", tmp_path_factory.mktemp("no_modules"))
    ref = Ref(cfg, params)
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="no reference for"):
        ref.logits(toks)
    with pytest.raises(ValueError, match="no reference for"):
        ref.step(toks[:, 0], ref.decode_state(1, 4, "cpu"))


@pytest.mark.parametrize("kind", ["train", "decode", "ttft", "score"])
@pytest.mark.parametrize("pattern", UNKNOWN, ids=lambda p: "-".join(p))
def test_the_builtin_work_model_raises_on_an_unknown_kind(smoke, pattern, kind):
    cfg = dict(smoke[0]("minicpm-2b"), pattern=[pattern])
    name = {"train": "train-s2048", "decode": "decode-b64", "ttft": "ttft-1k-4k",
            "score": "score-s4096"}[kind]
    with pytest.raises(ValueError, match="no work model for"):
        work.unit(cfg, smoke[1](name), **({"prompt_len": 8} if kind == "ttft" else {}))


@pytest.mark.parametrize("kind", ["absent", "../weights", "a.b"])
def test_a_kind_that_names_no_module_raises(smoke, modules, kind):
    cfg = dict(smoke[0]("minicpm-2b"), pattern=[[kind, "dense"]])
    with pytest.raises(ValueError, match="no weights for mixer"):
        weights.leaf_specs(cfg)


def _limits(cell: str) -> dict:
    return json.loads((run.HERE / "limits" / f"{cell}.json").read_text())


def test_modules_of_builtin_names_leave_a_run_as_it_was(smoke, modules, monkeypatch,
                                                        tmp_path_factory):
    """``run_cell`` on the CPU at a minicpm cut, the run's own clock made a
    counter so that its metrics repeat: the same result object where the
    kinds' directory holds a module, raising if loaded, for each built-in
    kind, and where it holds none."""
    cell = "minicpm-2b.train-s2048"

    def result(cfg):
        clock = itertools.count(1000)
        monkeypatch.setattr(run, "time", types.SimpleNamespace(
            perf_counter=lambda: float(next(clock))))
        return run.run_cell(cell, 20240612, 0.0, False, device="cpu", cfg=cfg,
                            traffic=smoke[1]("train-s2048"), limits=_limits(cell))

    moduled = result(smoke[0]("minicpm-2b"))
    monkeypatch.setattr(archs, "DIR", tmp_path_factory.mktemp("no_modules"))
    plain = result(smoke[0]("minicpm-2b"))
    assert plain["correct"] and moduled == plain


def test_attention_takes_a_value_width_of_its_own(smoke):
    """Latent attention's shape: queries and keys of 24, values of 16, two
    query heads a key head; causal, scaled by 24^-1/2."""
    cfg = dict(smoke[0]("jamba-v0.1-52b"), num_heads=4, num_kv_heads=2)
    ref = Ref(cfg, {})
    g = torch.Generator().manual_seed(5)
    q, k = torch.randn(2, 7, 4, 24, generator=g), torch.randn(2, 7, 2, 24, generator=g)
    v = torch.randn(2, 7, 2, 16, generator=g)
    got = ref.attend(q, k, v, 0, block=3)
    want = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(2, 2).transpose(1, 2),
        v.repeat_interleave(2, 2).transpose(1, 2), is_causal=True)
    assert got.shape == (2, 7, 4 * 16)
    assert torch.allclose(got, want.transpose(1, 2).reshape(2, 7, 64), atol=1e-5)

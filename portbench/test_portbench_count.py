"""The benchmark's frozen counts against the program's own counter
(``core/roofline.count``, each kernel module's ``cost``) at smoke widths on
the CPU: the products that run on the program's matmul kernel, flash
attention and the scan, in a forward and in a train step under remat
"full". Checked here once: the benchmark never imports the counter."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.count import costs, work
from portbench.run import Context


def _sums(items, cls, route=None, phases=None):
    sel = [it for it in items if it.cls == cls and (route is None or it.route == route)
           and (phases is None or it.phase in phases)]
    return len(sel), sum(it.cost.flops for it in sel), sum(it.cost.bytes for it in sel)


def _program(cfg, remat="none"):
    return Context("smoke", cfg, {}, 0, 0.0, torch.device("cpu")).program_config(remat=remat)


@pytest.mark.parametrize("name", ["minicpm-2b", "jamba-v0.1-52b"])
def test_forward_counts_equal_the_programs(smoke, name):
    from repro_torch.core import roofline
    from repro_torch.models import model as M

    cfg = smoke[0](name, dtype="bfloat16")
    params = weights.make_params(cfg, 1, "cpu")
    b, s = 2, 24
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg["vocab_size"], (b, s)))
    with roofline.count() as c, torch.no_grad():
        M.forward(_program(cfg), params, tokens, device="cpu")
    items = work.Work(cfg).forward(b, s)
    assert _sums(items, "matmul", "port") == pytest.approx(tuple(c.kernels["streamed_matmul"]))
    n_attn = _sums(items, "attention")
    if n_attn[0]:
        assert n_attn == pytest.approx(tuple(c.kernels["flash_attention"]))
    n_scan = _sums(items, "scan")
    if n_scan[0]:
        assert n_scan == pytest.approx(tuple(c.kernels["ssm_scan"]))


def test_train_step_counts_equal_the_programs(smoke):
    from repro_torch.core import roofline
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.train.steps import make_train_step

    cfg = smoke[0]("minicpm-2b", dtype="bfloat16")
    params = weights.make_params(cfg, 2, "cpu")
    opt = AdamW(schedule=constant(1e-3))
    step = make_train_step(_program(cfg, remat="full"), opt, device="cpu")
    b, s = 2, 24
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg["vocab_size"], (b, s + 1)))
    state = opt.init(params)
    with roofline.count() as c:
        step(params, state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    items = work.Work(cfg).train_step(b, s, "full")
    assert _sums(items, "matmul", "port") == pytest.approx(tuple(c.kernels["streamed_matmul"]))
    assert _sums(items, "attention", phases=("fwd", "remat")) == pytest.approx(
        tuple(c.kernels["flash_attention"]))


def test_causal_pairs_and_bounds():
    assert costs.causal_pairs(4, 4) == 10 and costs.causal_pairs(1, 9) == 9
    c = costs.matmul(1024, 2304, 5760, 2)
    assert work.bound_seconds(c) == pytest.approx(2 * 1024 * 2304 * 5760 / 989e12)


def test_decode_unit_reads_every_weight_each_step():
    from portbench.run import load_json, HERE

    cfg = load_json(HERE / "configs" / "jamba-v0.1-52b.json", "configuration")
    items = work.Work(cfg).decode_step(64, 1)
    weight_bytes = sum(it.cost.bytes for it in items if it.cls == "matmul")
    # every expert is touched by 128 routed rows: the step reads all 13.3 B
    # parameters but the embedding's (bf16)
    params = work.param_count(cfg) - 65536 * 4096
    assert 2 * params * 0.99 < weight_bytes < 2 * params * 1.05

"""The plain reference against the program at smoke widths on the CPU, in
fp32: the dense decoder, Jamba's Mamba and MoE layers, step-by-step
decoding through ``generate``, and AdamW training steps."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.kinds import decode as decode_kind
from portbench.kinds import train as train_kind
from portbench.reference import train as reftrain
from portbench.reference.model import Ref, fp8_round
from portbench.run import Context

CONFIGS = ["minicpm-2b", "jamba-v0.1-52b"]


def program_config(cfg: dict):
    return Context("smoke", cfg, {}, 0, 0.0, torch.device("cpu")).program_config(remat="none")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_program(smoke, name):
    from repro_torch.models import model as M

    cfg = smoke[0](name)
    params = weights.make_params(cfg, 3, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg["vocab_size"], (2, 24)))
    prog, _ = M.forward(program_config(cfg), params, tokens, device="cpu")
    ref = Ref(cfg, params).logits(tokens)
    scale = float(ref.abs().max())
    assert float((prog - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("layer", ["mamba", "moe"])
def test_jamba_layers_match_the_program(smoke, layer):
    from repro_torch.models import mamba, moe

    cfg = smoke[0]("jamba-v0.1-52b")
    params = weights.make_params(cfg, 4, "cpu")
    pc = program_config(cfg)
    ref = Ref(cfg, params)
    x = torch.randn(2, 20, cfg["d_model"], generator=torch.Generator().manual_seed(1))
    if layer == "mamba":
        p = params["stack"][0][0]["mixer"]
        prog, want = mamba.mamba_forward(pc, p, x), ref.mamba(p, x)
    else:
        p = params["stack"][0][1]["mlp"]
        prog = moe.moe_forward(pc, p, x)[0]
        want = ref.moe(p, x.reshape(-1, x.shape[-1])).view_as(x)
    assert float((prog - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_decoding_matches_the_program(smoke):
    """Greedy tokens of ``generate`` (batch 4, MoE capacity binding) lie
    exactly at the reference's best, a position at a time."""
    from repro_torch.launch.serve import generate

    cfg = smoke[0]("jamba-v0.1-52b")
    params = weights.make_params(cfg, 5, "cpu")
    prompt = torch.from_numpy(decode_kind.prompts(cfg["vocab_size"], 4, 8, 5, 1))
    out, _ = generate(program_config(cfg), params, prompt, steps=8, device="cpu")
    gaps = decode_kind.reference_gaps(cfg, params, out, 8)
    assert gaps.shape == (4, 8)
    assert float(gaps.max()) <= 1e-5


def test_training_steps_match_the_program(smoke):
    """Three AdamW steps of the program's train step against the reference
    from the same weights and batches: each loss, each leaf's first
    gradient and each leaf's change."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.steps import make_train_step

    cfg = smoke[0]("minicpm-2b")
    tr = smoke[1]("train-s2048")
    s, a = tr["schedule"], tr["adamw"]
    opt = AdamW(schedule=wsd(s["peak_lr"], s["warmup"], s["total"]), b1=a["b1"], b2=a["b2"],
                eps=a["eps"], weight_decay=a["weight_decay"], grad_clip=a["grad_clip"])
    params = weights.make_params(cfg, 6, "cpu")
    state = opt.init(params)
    step = make_train_step(program_config(cfg), opt, compress_bf16=False, device="cpu")
    batches = [tuple(torch.as_tensor(x) for x in
                     train_kind.synthetic_batch(cfg["vocab_size"], tr["batch"], tr["seq_len"],
                                                6, i))
               for i in range(3)]
    prog = {"loss": [], "grad1": [], "delta": []}
    for i, (t, lab) in enumerate(batches):
        params, state, m = step(params, state, {"tokens": t, "labels": lab})
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad1"] = [float(x.double().norm()) / (1 - a["b1"])
                             for x in reftrain.leaves(state["m"])]
    init = weights.make_params(cfg, 6, "cpu")
    prog["delta"] = [float((p - q).double().norm())
                     for p, q in zip(reftrain.leaves(params), reftrain.leaves(init))]
    ref = reftrain.follow(cfg, init, batches, s, a)
    numbers = dict(train_kind.compare(prog, ref))
    assert numbers["loss_gap"] <= 1e-6
    assert numbers["grad_gap"] <= 1e-4
    assert numbers["update_gap"] <= 1e-3
    assert statistics.median(ref["delta"]) > 0


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, -448.0, 0.0])
    # 1.0625 lies halfway between e4m3's 1.0 and 1.125 and rounds to even
    assert fp8_round(x).tolist() == [1.0, 1.0, 1.125, -448.0, 0.0]

"""What every cell reads from its configuration, pinned: the weights' leaves
and their order, the bits ``make_params`` draws from a seed, the reference's
outputs, and the counted work and model FLOPs of every unit shape of the
four cells. The values are those the harness gave before a kind the
built-in code lacks could bring its own module (``archs/``); they set each
cell's ``correct`` numbers and its roofline denominators, so none of them
may move without a change to the benchmark that says so. The leaves, the
bits and the counts are exact by construction and pinned exactly; the
reference's fp32 outputs, whose last bits follow the CPU's product
kernels, within ``TOL``."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench import run, weights
from portbench.count import work
from portbench.reference.model import Ref, fp8_round

CONFIGS = ["minicpm-2b", "jamba-v0.1-52b"]

#: sha256 of: the full configuration's leaf list (its repr); each leaf's path
#: and bits of ``make_params(seed 0)`` at the smoke cut in bf16
DIGESTS = {
    "minicpm-2b": {
        "leaves": "536af5fe6c66b8ecc37d10ac2a47f42d610d014eddf85f27ba275e6aa875c365",
        "bits": "75a3d90333d73f5874dddbd602e8b865d2f8b314b71558cc045415a7d4d70784"},
    "jamba-v0.1-52b": {
        "leaves": "d9f782b991ae197735e820d9faffca5c2600816f9c8b68131badc4cc334053ef",
        "bits": "a6536db518a9c1e0a959c09c14a2eaa0f5f545c64b16a5922c2f1e23f453c4d0"},
}
#: the reference's fp32 logits of a (2, 12) batch at the smoke cut in fp32,
#: and its first three decode steps' (2, V): the norm, the largest magnitude
#: and the values at ``LOGIT_AT`` / ``STEP_AT``
OUTPUTS = {
    "minicpm-2b": {
        "logits": {"norm": 12.959655071172318, "amax": 0.6854390501976013,
                   "values": [0.15783844888210297, -0.03780136629939079, 0.1479589343070984,
                              -0.20741386711597443, 0.10499248653650284, -0.18702332675457]},
        "steps": [{"norm": 3.68830137971789, "amax": 0.5494203567504883,
                   "values": [0.15783846378326416, -0.15412499010562897, 0.16148552298545837,
                              -0.044393934309482574, 0.09879206120967865, -0.22988349199295044]},
                  {"norm": 3.788698278526033, "amax": 0.6015823483467102,
                   "values": [-0.18518006801605225, -0.0199055727571249, -0.056064411997795105,
                              -0.011271435767412186, 0.0068558938801288605, -0.19261810183525085]},
                  {"norm": 3.819571818121839, "amax": 0.6077349185943604,
                   "values": [-0.05541418492794037, -0.14468251168727875, 0.014010392129421234,
                              -0.12091152369976044, -0.05630806088447571, -0.027821771800518036]}]},
    "jamba-v0.1-52b": {
        "logits": {"norm": 77.42657661527528, "amax": 3.1569085121154785,
                   "values": [0.23168852925300598, -1.4207518100738525, 0.10059366375207901,
                              -1.2520291805267334, 0.5695889592170715, -0.257684588432312]},
        "steps": [{"norm": 21.870601923469888, "amax": 3.035126209259033,
                   "values": [0.23168779909610748, -1.289422869682312, 0.5483264923095703,
                              -1.3200494050979614, 1.0381834506988525, 0.7879433035850525]},
                  {"norm": 21.322286426198303, "amax": 2.8189890384674072,
                   "values": [-2.3371453285217285, -0.9848897457122803, 2.0220882892608643,
                              -0.8103980422019958, 0.33615127205848694, 0.747566819190979]},
                  {"norm": 22.783021744352, "amax": 2.6168370246887207,
                   "values": [0.14237506687641144, -1.3140232563018799, 1.7901623249053955,
                              -1.8521144390106201, 0.2717626988887787, 0.4365961253643036]}]},
}
LOGIT_AT = [(0, 0, 0), (0, 5, 17), (0, 11, 255), (1, 3, 100), (1, 11, 7), (1, 8, 200)]
STEP_AT = [(b, v) for b, _, v in LOGIT_AT]
#: how far a pinned output may move: a value by this share of the largest
#: magnitude, the norm by a tenth of it. Perturbing every weight by 1e-6
#: (relative, random), ten times a product's fp32 rounding, moves jamba's
#: values by up to 3.0e-5 of the largest and the norm by 3.8e-7, minicpm's
#: less; an error in the reference's structure moves them by far more.
TOL = 1e-4
#: sha256 of ``fp8_round``'s fp32 result on a fixed (64, 96) input, the
#: control's rounding. The control's logits are not pinned: they follow
#: every rounding of their fp8 operands, and perturbing the weights by 2e-7
#: moves them by 7-8% (minicpm) and 122-126% (jamba, routing ties) of the
#: largest.
FP8 = "ac2b12561b029a84cc6bddc9488135da34654896bad553514b6979b57c0fb23a"
PARAMS = {"minicpm-2b": 2724880896, "jamba-v0.1-52b": 13295235072}

#: (work.totals, work.model_flops) of each unit shape of the four cells, the
#: ttft cell's by prompt length
UNITS = {
    "minicpm-2b.train-s2048": (
        {"bytes": 365546906112.0,
         "class": {"attention": (27844977623040.0, 48601497600.0, 0.02815467909306377),
                   "matmul": (347863586439168.0, 256998028800.0, 0.3517326455401088),
                   "optimizer": (40873213440.0, 59947379712.0, 0.017894740212537313)},
         "flops": {"bf16": 375708564062208.0, "fp32": 40873213440.0}},
        286411664130048.0),
    "jamba-v0.1-52b.decode-b64": (
        {"bytes": 10207009701888.0,
         "class": {"attention": (77510737920.0, 19780337664.0, 0.005904578407164178),
                   "matmul": (150942330650624.0, 9989918294016.0, 2.982065162395102),
                   "scan": (225485783040.0, 197311070208.0, 0.05889882692775866)},
         "flops": {"bf16": 151006956486656.0, "fp32": 238370684928.0}},
        151019841388544.0),
    "minicpm-2b.ttft-1k-4k.1024": (
        {"bytes": 15527644676.0,
         "class": {"attention": (193840128000.0, 1133199360.0, 0.0003382684656716411),
                   "matmul": (5006967579648.0, 14394445316.0, 0.006853274724359662)},
         "flops": {"bf16": 5200807707648.0}},
        5200807707648.0),
    "minicpm-2b.ttft-1k-4k.1536": (
        {"bytes": 17839754756.0,
         "class": {"attention": (435715153920.0, 1699430400.0, 0.0006092327015631645),
                   "matmul": (7507443852288.0, 16140324356.0, 0.00938156215877806)},
         "flops": {"bf16": 7943159006208.0}},
        7943159006208.0),
    "minicpm-2b.ttft-1k-4k.2048": (
        {"bytes": 20151864836.0,
         "class": {"attention": (774226944000.0, 2265661440.0, 0.0010076600908935599),
                   "matmul": (10007920124928.0, 17886203396.0, 0.011909849593196607)},
         "flops": {"bf16": 10782147068928.0}},
        10782147068928.0),
    "minicpm-2b.ttft-1k-4k.3072": (
        {"bytes": 24776084996.0,
         "class": {"attention": (1741160816640.0, 3398123520.0, 0.0020976496445594076),
                   "matmul": (15008872670208.0, 21377961476.0, 0.016966424462034085)},
         "flops": {"bf16": 16750033486848.0}},
        16750033486848.0),
    "minicpm-2b.ttft-1k-4k.4096": (
        {"bytes": 29400305156.0,
         "class": {"attention": (3094641745920.0, 4530585600.0, 0.00357848556489866),
                   "matmul": (20009825215488.0, 24869719556.0, 0.022022999330871255)},
         "flops": {"bf16": 23104466961408.0}},
        23104466961408.0),
    "jamba-v0.1-52b.score-s4096": (
        {"bytes": 69409669120.0,
         "class": {"attention": (549890031616.0, 335544320.0, 0.000556006098701719),
                   "matmul": (103560251441152.0, 63425740800.0, 0.10516960407917858),
                   "scan": (150323855360.0, 5648384000.0, 0.0022436396322388055)},
         "flops": {"bf16": 104101551538176.0, "fp32": 158913789952.0}},
        104110141472768.0),
}


def _digest(chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _config(name: str) -> dict:
    return run.load_json(run.HERE / "configs" / f"{name}.json", "configuration")


@pytest.fixture
def one_thread():
    """CPU products summed in one fixed order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_leaves_and_their_order(name):
    cfg = _config(name)
    assert _digest([repr(weights.leaf_specs(cfg)).encode()]) == DIGESTS[name]["leaves"]
    assert work.param_count(cfg) == PARAMS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_bits_drawn_from_a_seed(smoke, name):
    cfg = smoke[0](name, dtype="bfloat16")
    params = weights.make_params(cfg, 0, "cpu")
    got = _digest([repr(path).encode() + _bytes(_leaf(params, path))
                   for path, _, _ in weights.leaf_specs(cfg)])
    assert got == DIGESTS[name]["bits"]


def _near(t: torch.Tensor, pinned: dict, at: list[tuple]) -> None:
    assert float(t.double().norm()) == pytest.approx(pinned["norm"], rel=TOL / 10)
    assert float(t.abs().max()) == pytest.approx(pinned["amax"], rel=TOL)
    got = [float(t[i]) for i in at]
    assert got == pytest.approx(pinned["values"], abs=TOL * pinned["amax"])


@pytest.mark.parametrize("name", CONFIGS)
def test_the_references_outputs(smoke, one_thread, name):
    cfg = smoke[0](name)
    params = weights.make_params(cfg, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg["vocab_size"], (2, 12)))
    with torch.no_grad():
        ref = Ref(cfg, params)
        _near(ref.logits(toks), OUTPUTS[name]["logits"], LOGIT_AT)
        st = ref.decode_state(2, 16, "cpu")
        for i, pinned in enumerate(OUTPUTS[name]["steps"]):
            _near(ref.step(toks[:, i], st), pinned, STEP_AT)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32))
    assert _digest([fp8_round(x).numpy().tobytes()]) == FP8


#: the four cells whose unit shapes are pinned
CELLS = ["minicpm-2b.train-s2048", "jamba-v0.1-52b.decode-b64", "minicpm-2b.ttft-1k-4k",
         "jamba-v0.1-52b.score-s4096"]


def _unit_shapes():
    out = []
    for cell in CELLS:
        wl = run.find(run.manifest()["workloads"], cell, "workload")
        tr = run.load_json(run.HERE / "traffic" / f"{wl['traffic']}.json", "traffic")
        if tr["kind"] == "ttft":
            out += [(f"{cell}.{n}", wl["config"], tr, {"prompt_len": n})
                    for n in tr["prompt_lens"]]
        else:
            out.append((cell, wl["config"], tr, {}))
    return out


SHAPES = _unit_shapes()


@pytest.mark.parametrize("key,config,traffic,shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_the_counted_work_of_every_unit_shape(key, config, traffic, shape):
    cfg = _config(config)
    totals, flops = UNITS[key]
    assert work.totals(work.unit(cfg, traffic, **shape)) == totals
    assert work.model_flops(cfg, traffic, **shape) == flops


def test_every_unit_shape_is_pinned():
    assert sorted(key for key, *_ in SHAPES) == sorted(UNITS)

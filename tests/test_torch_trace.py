"""The port's spans (``core/trace``) on the CPU: none while no profiler
records, and under one, the phases of ``generate``, each model layer and the
train step's phases, counted and nested as documented."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import trace
from repro_torch.core.bsp import BSPAccelerator
from repro_torch.data.pipeline import BatchStream, DataConfig, TokenStream
from repro_torch.launch import serve
from repro_torch.launch.registry import Registry
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.steps import make_train_step

# a fixed pack (the serve tests' own): no calibration in tests
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")
PROMPT_LEN, STEPS, BATCH = 5, 3, 2


def _model(name):
    cfg = dataclasses.replace(get_config(name, smoke=True), dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def jamba():
    return _model("jamba-v0.1-52b")


@pytest.fixture(scope="module")
def minicpm():
    return dataclasses.replace(get_config("minicpm-2b", smoke=True), dtype="float32")


def _generate(cfg, params):
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                           generator=torch.Generator().manual_seed(1))
    return serve.generate(cfg, params, prompt, steps=STEPS, machine=BSPAccelerator(**PACK),
                          device="cpu")[0]


def _train_step(cfg, remat="none"):
    cfg = dataclasses.replace(cfg, remat=remat)
    params = M.init_params(cfg, 0, device="cpu")       # the step updates in place
    opt = AdamW(schedule=constant(1e-3))
    batches = BatchStream(TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                 global_batch=2)), 4,
                          put_fn=lambda b: {k: torch.as_tensor(v) for k, v in b.items()})
    batches.open(0)
    try:
        step = make_train_step(cfg, opt, device="cpu")
        return step(params, opt.init(params), batches.move_down(0))[2]
    finally:
        batches.close(0)


def _spans(fn):
    """(result, [(name, start us, end us, thread)] of the program's spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end, e.thread)
                 for e in prof.events() if e.name.startswith("repro_torch.")]


def _count(spans, name):
    return sum(n == f"repro_torch.{name}" for n, *_ in spans)


def _parents(spans, name):
    """The innermost program span around each ``name`` span on its thread."""
    out = []
    for n, s, e, tid in spans:
        if n != f"repro_torch.{name}":
            continue
        around = [(s2, n2) for n2, s2, e2, t2 in spans
                  if t2 == tid and s2 <= s and e <= e2 and (s2, e2) != (s, e)]
        out.append(max(around)[1].removeprefix("repro_torch.") if around else None)
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert trace.span("repro_torch.x") is trace.span("repro_torch.y", request=1)

    @trace.traced("repro_torch.x")
    def twice(x):
        """Doubles."""
        return 2 * x

    assert twice(3) == 6 and twice.__name__ == "twice" and twice.__doc__ == "Doubles."
    _, spans = _spans(lambda: twice(3))
    assert [n for n, *_ in spans] == ["repro_torch.x"]


@pytest.mark.parametrize("entry", ["generate", "train_step"])
def test_no_profiler_means_no_record_function(entry, jamba, minicpm, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(serve, "decode_runners", Registry(capacity=8))
    if entry == "generate":
        out = _generate(*jamba)
        assert out.shape == (BATCH, PROMPT_LEN + STEPS)
    else:
        assert torch.isfinite(_train_step(minicpm)["loss"])


@pytest.fixture(scope="module")
def generate_spans(jamba):
    """Two calls of one shape under the profiler: the first builds its
    runner, the second finds it."""
    reg = serve.decode_runners
    serve.decode_runners = Registry(capacity=8)
    try:
        plain = _generate(*jamba)
        serve.decode_runners = Registry(capacity=8)
        (first, second), spans = _spans(lambda: (_generate(*jamba), _generate(*jamba)))
    finally:
        serve.decode_runners = reg
    assert torch.equal(first, plain) and torch.equal(second, plain)
    gens = sorted((s, e) for n, s, e, _ in spans if n == "repro_torch.serve.generate")
    return jamba[0], [[sp for sp in spans if a <= sp[1] and sp[2] <= b] for a, b in gens]


def _per_step(cfg):
    per = {}
    for _, blk in cfg.blocks():
        per[f"model.{blk.mixer}"] = per.get(f"model.{blk.mixer}", 0) + 1
        if blk.mlp != "none":
            per[f"model.{blk.mlp}"] = per.get(f"model.{blk.mlp}", 0) + 1
    return dict(per, **{"model.embed": 1, "model.head": 1})


@pytest.mark.parametrize("call", [0, 1])
def test_generate_counts_each_phase_step_and_layer(generate_spans, call):
    cfg, calls = generate_spans
    spans = calls[call]
    steps = PROMPT_LEN + STEPS          # block-1 prefill: a step a prompt token
    want = {"serve.generate": 1, "serve.prefill": 1, "serve.step": steps,
            "serve.sample": STEPS, "hyperstep.stage": 1, "hyperstep.replay": 1,
            "hyperstep.drain": 1,
            # the first call of a shape builds its runner; the second neither
            # builds it nor simulates its schedule again
            "serve.build_runner": 1 - call, "hyperstep.compile": 1 - call}
    want.update({k: v * steps for k, v in _per_step(cfg).items()})
    assert {"model.mamba", "model.attn", "model.moe", "model.dense"} <= set(want)
    got = {k: _count(spans, k) for k in want}
    assert got == want
    assert len(spans) == sum(want.values())


@pytest.mark.parametrize("name,parents", [
    ("serve.prefill", {"serve.generate"}),
    ("serve.build_runner", {"serve.generate"}),
    ("hyperstep.compile", {"serve.build_runner"}),
    ("hyperstep.stage", {"serve.generate"}),
    ("hyperstep.replay", {"serve.generate"}),
    ("hyperstep.drain", {"serve.generate"}),
    ("serve.step", {"serve.prefill", "hyperstep.replay"}),
    ("serve.sample", {"hyperstep.replay"}),
    ("model.embed", {"serve.step"}),
    ("model.mamba", {"serve.step"}),
    ("model.attn", {"serve.step"}),
    ("model.moe", {"serve.step"}),
    ("model.dense", {"serve.step"}),
    ("model.head", {"serve.step"}),
])
def test_generate_spans_nest(generate_spans, name, parents):
    _, calls = generate_spans
    got = [p for spans in calls for p in _parents(spans, name)]
    assert got and set(got) == parents


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_spans(minicpm, remat):
    cfg = minicpm
    _, spans = _spans(lambda: _train_step(cfg, remat=remat))
    layers = cfg.num_layers * (2 if remat == "full" else 1)     # recomputed in the backward
    assert {k: _count(spans, k) for k in
            ("data.fetch", "train.forward", "train.backward", "optim.update", "model.attn",
             "model.dense", "model.embed", "model.head")} == {
        "data.fetch": 1, "train.forward": 1, "train.backward": 1, "optim.update": 1,
        "model.attn": layers, "model.dense": layers, "model.embed": 1, "model.head": 1}
    assert set(_parents(spans, "model.embed")) == {"train.forward"}
    assert set(_parents(spans, "model.attn")) == (
        {"train.forward", "train.backward"} if remat == "full" else {"train.forward"})
    assert _parents(spans, "optim.update") == [None]

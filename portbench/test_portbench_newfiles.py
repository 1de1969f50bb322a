"""A new configuration and its cell taken as new files only. In a copy of
the harness's data directories a toy configuration is added whose stack
holds a latent-cache attention mixer (``archs/toymla.py``) and the
built-in ``moe`` with shared experts, sigmoid scoring, a routed scale and a
dropless capacity; with it its smoke widths, a ttft traffic, its limits, its
control widths and a ``kernel_scopes/attention.<x>.txt`` wrapping its
attention. The program that serves it stands in for the port's next step:
its mixer prefills in chunks with expanded keys and values, then serves the
prompt's last position by an absorbed step over the latent cache, on the
port's own norms, rotary embedding, dense MLP, embedding and head. A sound
run comes out ``correct``, the fp8 control and programs that ignore a
field of the MoE do not, and the mixer's attention kernels fall in the
attention class."""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import shutil
import textwrap
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import archs, run, spans, tracing, weights
from portbench.count import work
from portbench.test_portbench_faults import control, limits
from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope, embed_tokens, lm_head,
                                       ops_matmul)

TOY, TRAFFIC = "toy-mla-moe", "ttft-toy"
CELL = f"{TOY}.{TRAFFIC}"

#: the latent-cache mixer, harness side: leaves, the expanded reference and
#: the work model of the kinds a ttft cell counts
TOYMLA = textwrap.dedent('''
    import math

    import torch

    from portbench.count import costs
    from portbench.count.work import Item


    def widths(cfg):
        return (cfg["num_heads"], cfg["mla_kv_rank"], cfg["mla_nope_dim"], cfg["mla_rope_dim"],
                cfg["mla_v_dim"])


    def leaves(lv, at):
        d = lv.z["d"]
        h, r, dn, dr, dv = widths(lv.cfg)
        return [(at + ("wq",), (d, h * (dn + dr)), 1 / math.sqrt(d)),
                (at + ("w_dkv",), (d, r + dr), 1 / math.sqrt(d)),
                (at + ("w_uk",), (r, h * dn), 1 / math.sqrt(r)),
                (at + ("w_uv",), (r, h * dv), 1 / math.sqrt(r)),
                (at + ("wo",), (h * dv, d), 1 / math.sqrt(h * dv))]


    def forward(ref, p, x, pos):
        b, s, _ = x.shape
        h, r, dn, dr, dv = widths(ref.cfg)
        q = ref.mm(x, p["wq"]).view(b, s, h, dn + dr)
        ckr = ref.mm(x, p["w_dkv"])
        c, kr = ckr[..., :r], ref.rope(ckr[..., None, r:], pos).expand(b, s, h, dr)
        k = torch.cat([ref.mm(c, p["w_uk"]).view(b, s, h, dn), kr], dim=-1)
        q = torch.cat([q[..., :dn], ref.rope(q[..., dn:], pos)], dim=-1)
        v = ref.mm(c, p["w_uv"]).view(b, s, h, dv)
        return ref.mm(ref.attend(q, k, v, 0), p["wo"])


    def products(w, t):
        d = w.z["d"]
        h, r, dn, dr, dv = widths(w.cfg)
        return [("port", t, d, h * (dn + dr), 2), ("port", t, d, r + dr, 2),
                ("port", t, r, h * dn, 2), ("port", t, r, h * dv, 2), ("port", t, h * dv, d, 2)]


    def forward_items(w, batch, seq):
        h, _, dn, dr, _ = widths(w.cfg)
        return [Item("attention", "port", costs.flash(batch, h, h, seq, seq, dn + dr, 2))]


    def decode_items(w, batch, ctx):
        h, r, _, dr, _ = widths(w.cfg)
        return [Item("attention", "-", costs.flash(batch, h, 1, 1, ctx, r + dr, 2, causal=False))]
''')

#: the toy at its published widths (Moonlight-16B-A3B's, two layers)
CONFIG = {
    "name": TOY, "family": "moe", "num_layers": 2, "d_model": 2048, "num_heads": 16,
    "num_kv_heads": 16, "d_ff": 11264, "vocab_size": 163840,
    "pattern": [["toymla", "dense"], ["toymla", "moe"]], "norm_type": "rmsnorm",
    "norm_eps": 1e-05, "mlp_activation": "swiglu", "rope_type": "rope", "rope_theta": 50000.0,
    "tie_embeddings": False, "moe_experts": 64, "moe_top_k": 6, "moe_shared_experts": 2,
    "moe_d_ff": 1408, "moe_capacity_factor": 11.0, "moe_scoring": "sigmoid",
    "moe_routed_scale": 2.446, "mla_kv_rank": 512, "mla_nope_dim": 128, "mla_rope_dim": 64,
    "mla_v_dim": 128, "dtype": "bfloat16", "source": "a toy of the CPU tests", "reduced": []}
SMOKE = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 128,
         "vocab_size": 256, "moe_experts": 8, "moe_top_k": 2, "moe_d_ff": 32,
         "moe_capacity_factor": 4.0, "mla_kv_rank": 32, "mla_nope_dim": 16, "mla_rope_dim": 8,
         "mla_v_dim": 16}
CONTROL = {"d_model": 256, "d_ff": 512, "moe_d_ff": 128, "vocab_size": 4096}
LIMITS = {"served_gap": 0.01}
SCOPE = f"wrap: {__name__}:toy_attend\n"


@pytest.fixture
def toy_files(tmp_path, monkeypatch):
    """The harness's data directories copied, the toy's files added; the
    directory constants moved there. Returns the manifest with the toy's
    configuration and cell."""
    for sub in ("configs", "traffic", "limits", "smoke", "kernel_scopes", "archs"):
        shutil.copytree(run.HERE / sub, tmp_path / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    new = {f"configs/{TOY}.json": CONFIG, f"smoke/configs/{TOY}.json": SMOKE,
           f"traffic/{TRAFFIC}.json": {"kind": "ttft", "prompt_lens": [2048, 4096, 8064],
                                       "check_requests": 24},
           f"limits/{CELL}.json": LIMITS, f"smoke/controls/{CELL}.json": CONTROL}
    for name, obj in new.items():
        assert not (tmp_path / name).exists()
        (tmp_path / name).write_text(json.dumps(obj))
    (tmp_path / "archs" / "toymla.py").write_text(TOYMLA)
    (tmp_path / "kernel_scopes" / "attention.toymla.txt").write_text(SCOPE)
    monkeypatch.setattr(run, "HERE", tmp_path)
    monkeypatch.setattr(archs, "DIR", tmp_path / "archs")
    monkeypatch.setattr(tracing, "SCOPES", tmp_path / "kernel_scopes")
    bench = copy.deepcopy(run.manifest())
    bench["configs"].append({"name": TOY, "source": CONFIG["source"],
                             "file": f"portbench/configs/{TOY}.json", "reduced": [],
                             "why": "a toy"})
    bench["workloads"].append({"name": CELL, "config": TOY, "traffic": TRAFFIC, "chips": 1,
                               "why": "a toy"})
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p95_ms":
            m["workloads"].append(CELL)
    return bench


# -- the program's next step, in miniature ------------------------------------------


def next_config(base):
    """The program's ``ModelConfig`` with the fields its next step adds."""

    @dataclasses.dataclass(frozen=True)
    class NextConfig(base.ModelConfig):
        moe_scoring: str = "softmax"
        moe_routed_scale: float = 1.0
        mla_kv_rank: int = 0
        mla_nope_dim: int = 0
        mla_rope_dim: int = 0
        mla_v_dim: int = 0

    return NextConfig


def toy_attend(q, k, v, q0: int, scale: float) -> torch.Tensor:
    """Causal attention of q (B, Sq, H, D) at positions q0.. over k (B, Skv,
    Hk, D) and v (B, Skv, Hk, Dv) at positions 0.., where Hk is H or 1 (the
    latent cache, which every head reads): (B, Sq, H, Dv)."""
    h = q.shape[2]
    k, v = k.expand(-1, -1, h, -1), v.expand(-1, -1, h, -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    qpos = q0 + torch.arange(q.shape[1])
    s = s.masked_fill(torch.arange(k.shape[1])[None, :] > qpos[:, None], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


class ToyProgram:
    """Greedy ``generate(steps=1)`` of the toy: the prompt but its last
    token prefilled in chunks of ``CHUNK`` (expanded keys and values from
    the latent cache), the last token by an absorbed step (the queries taken
    into the latent space, the cache read as it is). ``fault`` leaves out
    one field of the MoE."""

    CHUNK = 16

    def __init__(self, fault: str | None = None):
        self.fault = fault

    def latent(self, cfg, p, x, t0):
        b, s, _ = x.shape
        r, dr = cfg.mla_kv_rank, cfg.mla_rope_dim
        pos = torch.arange(t0, t0 + s)[None].expand(b, s)
        rope = dataclasses.replace(cfg, head_dim=dr)
        ckr = ops_matmul(x, p["w_dkv"])
        q = ops_matmul(x, p["wq"]).view(b, s, cfg.num_heads, -1)
        q = torch.cat([q[..., :cfg.mla_nope_dim],
                       apply_rope(rope, q[..., cfg.mla_nope_dim:], pos)], dim=-1)
        return q, ckr[..., :r], apply_rope(rope, ckr[..., None, r:], pos)[:, :, 0]

    def mixer(self, cfg, p, x, cache, t0):
        b, s, _ = x.shape
        h, dn, dr, dv = cfg.num_heads, cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
        q, c, kr = self.latent(cfg, p, x, t0)
        t1 = t0 + s
        cache["c"][:, t0:t1], cache["kr"][:, t0:t1] = c, kr
        c, kr = cache["c"][:, :t1], cache["kr"][:, :t1, None]
        if s > 1:               # expanded
            k = torch.cat([ops_matmul(c, p["w_uk"]).view(b, t1, h, dn),
                           kr.expand(b, t1, h, dr)], dim=-1)
            o = toy_attend(q, k, ops_matmul(c, p["w_uv"]).view(b, t1, h, dv), t0,
                           (dn + dr) ** -0.5)
        else:                   # absorbed
            w_uk = p["w_uk"].view(-1, h, dn)
            qa = torch.cat([torch.einsum("bqhn,rhn->bqhr", q[..., :dn], w_uk), q[..., dn:]], -1)
            o_lat = toy_attend(qa, torch.cat([c, kr[:, :, 0]], -1)[:, :, None], c[:, :, None],
                               t0, (dn + dr) ** -0.5)
            o = torch.einsum("bqhr,rhv->bqhv", o_lat, p["w_uv"].view(-1, h, dv))
        return ops_matmul(o.reshape(b, s, h * dv), p["wo"])

    def moe(self, cfg, p, x):
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        scores = torch.sigmoid(xt.float() @ p["router"])
        bias = 0 if self.fault == "bias" else p["router_bias"]
        top_e = torch.topk(scores + bias, cfg.moe_top_k, dim=-1).indices
        w = torch.gather(scores, -1, top_e)
        w = w / w.sum(-1, keepdim=True)
        y = torch.zeros_like(xt)
        for j in range(cfg.moe_experts):
            rows, slot = (top_e == j).nonzero(as_tuple=True)
            if len(rows):
                expert = {"w_up": p["w_up"][j], "w_gate": p["w_gate"][j],
                          "w_down": p["w_down"][j]}
                y[rows] += w[rows, slot, None] * apply_mlp(cfg, expert, xt[rows])
        if self.fault != "scale":
            y = y * cfg.moe_routed_scale
        if self.fault != "shared":
            shared = {"w_up": p["shared_up"], "w_gate": p["shared_gate"],
                      "w_down": p["shared_down"]}
            y = y + apply_mlp(cfg, shared, xt)
        return y.view(b, s, d)

    def block(self, cfg, blk, p, x, cache, t0):
        x = x + self.mixer(cfg, p["mixer"], apply_norm(cfg, p["ln1"], x), cache, t0)
        h = apply_norm(cfg, p["ln2"], x)
        mlp = apply_mlp if blk.mlp == "dense" else self.moe
        return x + mlp(cfg, p["mlp"], h)

    def generate(self, cfg, params, prompt, *, steps, device=None, **kw):
        if steps != 1:
            raise ValueError("the toy serves first tokens only")
        b, n = prompt.shape
        layers = [(cfg.pattern[j], params["stack"][i][j])
                  for i in range(cfg.n_periods) for j in range(len(cfg.pattern))]
        caches = [{"c": torch.zeros(b, n, cfg.mla_kv_rank),
                   "kr": torch.zeros(b, n, cfg.mla_rope_dim)} for _ in layers]
        bounds = [(t0, min(t0 + self.CHUNK, n - 1)) for t0 in range(0, n - 1, self.CHUNK)]
        with torch.no_grad():
            for t0, t1 in [*bounds, (n - 1, n)]:
                x = embed_tokens(params["embed"], prompt[:, t0:t1])
                for (blk, p), cache in zip(layers, caches):
                    x = self.block(cfg, blk, p, x, cache, t0)
            logits = lm_head(cfg, params["embed"], apply_norm(cfg, params["final_norm"], x))
        return torch.cat([prompt, logits[:, -1].argmax(-1)[:, None]], dim=1), None


@pytest.fixture
def next_program(monkeypatch):
    """The toy's program in the port's place: ``generate`` and its config."""
    from repro_torch.configs import base
    from repro_torch.launch import serve

    def install(fault=None):
        monkeypatch.setattr(base, "ModelConfig", next_config(base))
        monkeypatch.setattr(serve, "generate", ToyProgram(fault).generate)

    return install


# -- the tests ---------------------------------------------------------------------------


def run_toy(smoke, bench: dict, monkeypatch, units: int = 16) -> dict:
    """A run of the toy cell on the CPU whose window serves ``units``
    requests, the run's clock made a counter; the check compares them all."""
    clock = itertools.count()
    monkeypatch.setattr(run, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock))))
    return run.run_cell(CELL, 20240612, float(units), False, device="cpu", bench=bench,
                        cfg=smoke[0](TOY), traffic=smoke[1](TRAFFIC), limits=limits(CELL))


def test_the_toy_cell_is_correct_and_its_control_is_not(smoke, toy_files, next_program,
                                                        monkeypatch):
    next_program()
    res = run_toy(smoke, toy_files, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 16 and res["checks"]["served_gap"]["limit"] == LIMITS["served_gap"]
    numbers = control(smoke, CELL, bench=toy_files)
    assert numbers["served_gap"] > limits(CELL)["served_gap"], numbers


@pytest.mark.parametrize("fault", ["bias", "scale", "shared"])
def test_a_program_that_ignores_a_field_of_the_moe_is_caught(smoke, toy_files, next_program,
                                                            monkeypatch, fault):
    next_program(fault)
    assert not run_toy(smoke, toy_files, monkeypatch)["correct"]


def test_the_toy_counts_its_work(smoke, toy_files):
    cfg = smoke[0](TOY)
    tr = smoke[1](TRAFFIC)
    items = work.unit(cfg, tr, prompt_len=24)
    tot = work.totals(items)
    assert set(tot["class"]) == {"matmul", "attention"}
    plain = dict(cfg, moe_shared_experts=0)
    d, sff = cfg["d_model"], 2 * cfg["moe_d_ff"]
    # the shared experts' three products on the prompt's 24 tokens and the
    # decode step's one
    extra = tot["flops"]["bf16"] - work.totals(work.unit(plain, tr, prompt_len=24))["flops"]["bf16"]
    assert extra == 3 * 2.0 * d * sff * (24 + 1)


class _Kernel:
    """A device kernel launched by a host op, as the profiler gives it."""

    def __init__(self, op):
        self.op = op

    def name(self):
        return "gemm_kernel"

    def start_ns(self):
        return self.op.start_ns()

    def end_ns(self):
        return self.op.end_ns()

    def device_type(self):
        return DeviceType.CUDA

    def linked_correlation_id(self):
        return self.op.correlation_id()


def _classes(smoke, scopes):
    """Device seconds by class of one toy request run under the profiler
    with the harness's wraps of ``scopes``, every product op given a
    kernel; and the seconds of those launched inside the toy's attention."""
    cfg = smoke[0](TOY)
    ctx = run.Context(CELL, cfg, smoke[1](TRAFFIC), 0, 0.0, torch.device("cpu"))
    pcfg, params = ctx.program_config(), weights.make_params(cfg, 0, "cpu")
    prompt = torch.arange(40)[None] % cfg["vocab_size"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW), spans.wrapped(scopes):
            ToyProgram().generate(pcfg, params, prompt, steps=1)
    events = list(prof.profiler.kineto_results.events())
    kernels = [_Kernel(ev) for ev in events if ev.name() in ("aten::mm", "aten::bmm")]
    attn = [(ev.start_ns(), ev.end_ns()) for ev in events if ev.name() == "portbench.attention"]
    # in seconds since the epoch, as the reduction reads them
    inside = sum(k.end_ns() * 1e-9 - k.start_ns() * 1e-9 for k in kernels
                 if any(s <= k.start_ns() <= e for s, e in attn))
    return tracing.reduce_profile(events + kernels).class_s, inside, len(attn)


def test_the_toy_attention_kernels_fall_in_the_attention_class(smoke, toy_files, next_program,
                                                              tmp_path_factory):
    next_program()
    assert ("attention", __name__, "toy_attend") in spans.wraps()
    assert [c for c, _ in tracing.kernel_scopes()] == ["attention", "optimizer"]
    classes, inside, calls = _classes(smoke, tracing.SCOPES)
    # two layers, three prefill chunks and the absorbed step each
    assert calls == 2 * 4 and inside > 0
    assert classes["attention"] == pytest.approx(inside)
    # without the new file the same kernels are matmul's
    bare = tmp_path_factory.mktemp("scopes")
    for f in tracing.SCOPES.glob("*.txt"):
        if f.name != "attention.toymla.txt":
            shutil.copy(f, bare / f.name)
    classes, inside, calls = _classes(smoke, bare)
    assert calls == 0 and inside == 0 and "attention" not in classes and classes["matmul"] > 0

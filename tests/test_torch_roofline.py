"""The port's roofline and dry-run report against the JAX package's, and the
port's work counter, on the CPU.

``RooflineReport``, ``model_flops`` and ``analytic_extra_flops`` are the
reference's arithmetic, held exactly on the same numbers. ``stream_plan_report``
is held to the reference's choice of blocks and predicted seconds with the
port's candidates patched to the reference's grid and a pack carried across
from the reference's ``TPU_V5E_CHIP`` fields (in this test only; the port's
report prices the card's tiles on the card's calibrated pack).

The counter (:func:`repro_torch.core.roofline.count`) is held to each
kernel's formula, to XLA's ``cost_analysis()`` for a plain product, and to
itself: the same step counts the same twice, and counting changes no result.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES
from repro.configs import get_config as jget
from repro.core import roofline as jrf
from repro.core.bsp import TPU_V5E_CHIP
from repro.kernels.streamed_matmul import plan_candidates
from repro.models import model as JM
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget
from repro_torch.core import roofline as rf
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.kernels import streamed_dot as tdot
from repro_torch.kernels import streamed_matmul as tmm
from repro_torch.launch import dryrun as tdry
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.steps import make_prefill_step, make_train_step


@functools.lru_cache(maxsize=None)
def _jax_dryrun():
    """The reference's dry-run module. Importing it sets ``XLA_FLAGS`` to
    512 fake devices for its own process; that is undone here, so no later
    backend start in this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jdry

    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdry


# -- the report's arithmetic -------------------------------------------------------------

HW = dict(name="test-hw", peak_flops=123e12, hbm_bandwidth=1.5e12, ici_bandwidth=40e9,
          ici_links=4, hbm_bytes=24e9)
REPORTS = [
    dict(name="a", chips=1, hlo_flops=3e12, hlo_bytes=2e10, coll_bytes=0.0,
         model_flops_global=2.5e12, peak_device_bytes=7.5e9),       # memory-bound
    dict(name="b", chips=4, hlo_flops=9e14, hlo_bytes=1e11, coll_bytes=3e9,
         model_flops_global=3.3e15, peak_device_bytes=6e10),         # compute-bound
    dict(name="c", chips=256, hlo_flops=1e12, hlo_bytes=1e9, coll_bytes=9e10,
         model_flops_global=1e14),                                   # collective-bound
    dict(name="d", chips=1, hlo_flops=0.0, hlo_bytes=0.0, coll_bytes=0.0,
         model_flops_global=0.0),                                    # empty
]


@pytest.mark.parametrize("case", range(len(REPORTS)))
def test_report_equals_reference(case):
    kw = REPORTS[case]
    got = rf.RooflineReport(**kw, coll_stats=None, hw=rf.HardwareSpec(**HW))
    want = jrf.RooflineReport(**kw, coll_stats=None, hw=jrf.HardwareSpec(**HW))
    for prop in ("compute_seconds", "memory_seconds", "collective_seconds", "step_seconds",
                 "dominant", "useful_flops_ratio", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.row() == want.row()
    assert str(got) == str(want)
    assert got.hw.link_bandwidth == want.hw.link_bandwidth


@pytest.mark.parametrize("training", [True, False])
def test_model_flops_equals_reference(training):
    for params, active, tokens in [(2.7e9, None, 1024), (5.2e10, 1.2e10, 4), (1, 1, 1)]:
        kw = dict(params=params, active_params=active, tokens=tokens, training=training)
        assert rf.model_flops(**kw) == jrf.model_flops(**kw)


def test_h100_spec_and_analyze():
    hw = rf.H100_SXM
    assert (hw.peak_flops, hw.peak_flops_fp32, hw.hbm_bandwidth, hw.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 80e9)
    assert hw.link_bandwidth == 450e9 and hw.peak("fp32") == 67e12
    c = rf.Count(flops=989e9, bytes=3.35e9 / 2, peak_device_bytes=4e9)
    rep = rf.analyze("x", c, model_flops_global=494.5e9)
    assert (rep.chips, rep.coll_bytes, rep.peak_device_bytes) == (1, 0.0, 4e9)
    assert rep.compute_seconds == pytest.approx(1e-3) and rep.dominant == "compute"
    assert rep.useful_flops_ratio == pytest.approx(0.5)


@pytest.mark.parametrize("sname", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_extra_flops_equal_reference(arch, sname):
    assert tdry.analytic_extra_flops(tget(arch), TSHAPES[sname]) == \
        _jax_dryrun().analytic_extra_flops(jget(arch), SHAPES[sname])


def _reference_attention_grid(sq, skv):
    q = sorted({min(b, sq) for b in (128, 256, 512)})
    kv = sorted({min(b, skv) for b in (128, 256, 512)})
    return [{"block_q": a, "block_kv": b} for a in q for b in kv]


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_plan_report_picks_the_reference_blocks(arch, monkeypatch):
    monkeypatch.setattr(tdry, "matmul_candidates", plan_candidates)
    monkeypatch.setattr(tdry, "attention_candidates", _reference_attention_grid)
    pack = TPack(**dataclasses.asdict(TPU_V5E_CHIP))
    for sname in SHAPES:
        for chips in (1, 256):
            want = _jax_dryrun().stream_plan_report(jget(arch), SHAPES[sname], chips=chips)
            got = tdry.stream_plan_report(tget(arch), TSHAPES[sname], pack, chips=chips)
            assert got == want, (sname, chips)


def test_stream_plan_report_prices_the_card_tiles():
    rec = tdry.plan_record("minicpm-2b", "decode_32k", device="cpu")
    mm, attn = rec["stream_plans"]["ffn_matmul"], rec["stream_plans"]["attention"]
    assert (mm["block_m"], mm["block_n"], mm["block_k"]) in tmm.VARIANTS.values()
    assert (attn["block_q"], attn["block_kv"]) == (tflash.BLOCK_Q, tflash.BLOCK_KV)
    assert rec["machine"] == "cpu-host" and rec["plan_diagnostics"] == []
    assert rec["model_flops"] == 2.0 * tget("minicpm-2b").param_counts()[1] * 128
    assert tdry.main(["--arch", "minicpm-2b", "--shape", "train_4k", "--device", "cpu"]) == 0


# -- the counter -----------------------------------------------------------------------


def _g(seed):
    return torch.Generator().manual_seed(seed)


def test_matmul_counts_its_formula():
    for (m, k, n), dtype, (al, bl) in [((64, 32, 48), torch.float32, ("mk", "kn")),
                                       ((5, 40, 24), torch.bfloat16, ("mk", "nk")),
                                       ((33, 17, 9), torch.bfloat16, ("km", "kn"))]:
        a = torch.randn((m, k) if al == "mk" else (k, m), generator=_g(0)).to(dtype)
        b = torch.randn((k, n) if bl == "kn" else (n, k), generator=_g(1)).to(dtype)
        with rf.count() as c:
            ops.matmul(a, b, a_layout=al, b_layout=bl)
        size = a.element_size()
        assert (c.flops, c.bytes, c.launches) == (2 * m * k * n, (m * k + k * n + m * n) * size, 1)
        assert c.ops == {} and c.kernels == {"streamed_matmul": [1, c.flops, c.bytes]}


def test_dot_flash_and_scan_count_their_formulas():
    v, u = torch.randn(1000, generator=_g(0)), torch.randn(1000, generator=_g(1))
    with rf.count() as c:
        ops.dot(v, u)
    assert (c.flops, c.bytes) == (2000, 8 * 1000 + 4)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 5, 9, 16
    q = torch.randn(b, hq, sq, d, generator=_g(2)).bfloat16()
    k = torch.randn(b, hkv, skv, d, generator=_g(3)).bfloat16()
    with rf.count() as c:
        ops.attention(q, k, k)
    pairs = sum(min(skv, skv - sq + i + 1) for i in range(sq))
    assert (c.flops, c.bytes) == (4 * b * hq * d * pairs,
                                  (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * 2)
    with rf.count() as c:
        ops.attention(q, k, k, return_lse=True, causal=False)
    assert c.flops == 4 * b * hq * d * sq * skv and c.bytes == (
        2 * b * hq * sq * d + 2 * b * hkv * skv * d) * 2 + 4 * b * hq * sq
    bsz, seq, di, ds = 2, 20, 12, 8
    x = torch.randn(bsz, seq, di, generator=_g(4))
    dt = torch.rand(bsz, seq, di, generator=_g(5)) * 0.05
    bb, cc = torch.randn(bsz, seq, ds, generator=_g(6)), torch.randn(bsz, seq, ds, generator=_g(7))
    a = -torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds).contiguous()
    dd = torch.randn(di, generator=_g(8))
    with rf.count() as c:
        y = ops.selective_scan(x, dt, bb, cc, a, dd)
    assert (c.flops, c.bytes) == (10 * bsz * seq * di * ds,
                                  (3 * bsz * seq * di + 2 * bsz * seq * ds) * 4 + (di * ds + di) * 4)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bb, cc, a, dd)]
    with rf.count() as c:
        ops.selective_scan(*leaves).backward(torch.ones_like(y))
    fwd, bwd = c.kernels["ssm_scan"], c.kernels["ssm_scan_bwd"]
    assert fwd == [1, 10 * bsz * seq * di * ds,
                   (3 * bsz * seq * di + 2 * bsz * seq * ds) * 4 + (di * ds + di) * 4]
    assert bwd == [1, 18 * bsz * seq * di * ds,
                   (5 * bsz * seq * di + 4 * bsz * seq * ds) * 4 + 2 * (di * ds + di) * 4]


def test_torch_mm_counts_what_xla_counts():
    for m, k, n in [(64, 32, 48), (7, 300, 5), (128, 128, 1)]:
        a, b = torch.randn(m, k, generator=_g(0)), torch.randn(k, n, generator=_g(1))
        with rf.count() as c:
            torch.mm(a, b)
        ca = jax.jit(jnp.dot).lower(jnp.ones((m, k)), jnp.ones((k, n))).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        assert c.flops == ca["flops"] == 2 * m * k * n
        assert c.bytes == ca["bytes accessed"]


def test_views_and_allocations_move_nothing():
    x = torch.randn(8, 16, generator=_g(0))
    with rf.count() as c:
        x.view(16, 8).t().transpose(0, 1).unsqueeze(0).expand(3, 16, 8)
        x[2:5]
        torch.empty(100, 100)
    assert (c.flops, c.bytes) == (0.0, 0.0) and c.ops
    with rf.count() as c:
        x.add_(1.0)                       # in place: its output counted once
        x.unsqueeze(0).expand(4, 8, 16) * 2.0   # a broadcast input counts its storage
    assert c.bytes == 8 * 16 * 4 + (8 * 16 + 4 * 8 * 16) * 4


def _smoke_cut(pkg_get):
    return dataclasses.replace(pkg_get("minicpm-2b", smoke=True), num_layers=2)


def test_smoke_forward_and_train_step_count_the_same_twice():
    cfg = _smoke_cut(tget)
    jcfg = _smoke_cut(jget)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = TM.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                                  device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    fwd = make_prefill_step(cfg, device="cpu")
    counts, outs = [], []
    for _ in range(2):
        with rf.count() as c:
            outs.append(fwd(params, {"tokens": torch.as_tensor(toks[:, :-1])}))
        counts.append(c)
    assert counts[0].flops == counts[1].flops > 0 and counts[0].bytes == counts[1].bytes
    assert counts[0].kernels == {"streamed_matmul": [15, pytest.approx(12582912.0), 516096.0],
                                 "flash_attention": [2, 540672.0, 65536.0]}
    # counting changes no result
    assert torch.equal(outs[0], fwd(params, {"tokens": torch.as_tensor(toks[:, :-1])}))
    # XLA counts the same forward's elementwise work too (norms, softmax,
    # SwiGLU, RoPE; MFU's convention counts it 0) and every causal block of
    # the reference's blockwise attention, so the port's count is below
    # XLA's, by about a tenth at these narrow widths
    xla = jax.jit(lambda p, t: JM.forward(jcfg, p, t)[0]).lower(
        jparams, toks[:, :-1]).compile().cost_analysis()
    xla = xla[0] if isinstance(xla, (list, tuple)) else xla
    ratio = counts[0].flops / xla["flops"]
    print(f"port / XLA forward FLOPs: {ratio:.4f}")
    assert 0.8 <= ratio <= 1.0

    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:].astype(np.int64))}
    train = []
    for _ in range(2):
        # AdamW steps in place: each count steps a fresh copy
        opt = AdamW(schedule=constant(1e-3))
        p = TM.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        step = make_train_step(cfg, opt, device="cpu")
        st = opt.init(p)
        with rf.count() as c:
            step(p, st, batch)
        train.append(c)
    assert train[0].flops == train[1].flops and train[0].bytes == train[1].bytes
    assert train[0].kernels == train[1].kernels
    # the backward's products: dX and dW of each forward product
    assert train[0].kernels["streamed_matmul"][0] == 3 * 15


def test_kernel_costs_keep_the_kernel_table_bounds():
    """Each kernel's ``cost`` gives the bound the kernel table printed
    before the formulas moved into the kernel modules (``PERF.md`` §6, ms on
    the H100 SXM's peaks)."""
    def ms(cost):
        t, by = rf.kernel_bound(cost)
        return round(t * 1e3, 4), by

    assert ms(tdot.cost(1 << 22, 4)) == (0.0100, "bytes")
    assert ms(tmm.cost(4, 2304, 5760, 2)) == (0.0079, "bytes")
    assert ms(tmm.cost(1024, 2304, 5760, 2)) == (0.0275, "operations")
    assert ms(tmm.cost(1024, 4096, 65536, 2)) == (0.5559, "operations")
    assert ms(tmm.cost(4096, 4096, 4096, 4)) == (2.0513, "operations")
    assert ms(tflash.cost(4, 36, 36, 256, 256, 64, 2)) == (0.0056, "bytes")
    assert ms(tflash.cost(4, 96, 8, 256, 256, 192, 2)) == (0.0244, "bytes")
    assert ms(tssm.cost(4, 256, 8192, 16, 2)) == (0.0200, "operations")
    assert ms(tssm.cost(4, 256, 8192, 16, 4)) == (0.0303, "bytes")
    assert ms(tssm.bwd_cost(4, 256, 8192, 16, 2)) == (0.0361, "operations")
    assert ms(tssm.bwd_cost(4, 256, 8192, 16, 4)) == (0.0505, "bytes")


def test_gathers_and_scatters_count_the_elements_they_touch():
    table = torch.randn(1000, 16, generator=_g(0))
    idx = torch.tensor([3, 7, 7, 900])
    with rf.count() as c:
        torch.nn.functional.embedding(idx, table)
    # the 4 rows read and written, and the indices
    assert c.bytes == 2 * 4 * 16 * 4 + 4 * 8
    rows, values = idx[:2].clone(), torch.ones(2, 16)
    with rf.count() as c:
        table.index_put_((rows,), values)
    # the 2 rows written, the values and the indices read
    assert c.bytes == 2 * 2 * 16 * 4 + 2 * 8

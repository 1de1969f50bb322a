"""Parity of the port's pure-Python layers with the JAX package.

The cost model, the StreamPlan layer and the hyperstep runner's cursor walk
are arithmetic on Python numbers: the port must give the same floats, the
same schedules and the same fingerprints as the reference, exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsp as jbsp
from repro.core import cost as jcost
from repro.core import plan as jplan
from repro.core.hyperstep import HyperstepRunner as JRunner
from repro.core.stream import StreamSet as JStreamSet
from repro.kernels.flash_attention import attention_plan as j_attention_plan
from repro.kernels.streamed_dot import dot_plan as j_dot_plan
from repro.kernels.streamed_matmul import matmul_plan as j_matmul_plan
from repro.kernels.streamed_matmul import plan_candidates as j_matmul_candidates
from repro_torch.core import bsp as tbsp
from repro_torch.core import cost as tcost
from repro_torch.core import plan as tplan
from repro_torch.core.hyperstep import HyperstepRunner as TRunner
from repro_torch.core.stream import StreamSet as TStreamSet
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_plan as t_attention_plan
from repro_torch.kernels.streamed_dot import dot_plan as t_dot_plan
from repro_torch.kernels.streamed_matmul import matmul_plan as t_matmul_plan


def _pack(acc) -> tbsp.BSPAccelerator:
    """The port's pack with the numbers of one of the JAX package's packs."""
    return tbsp.BSPAccelerator(**dataclasses.asdict(acc))


JPACKS = [jbsp.EPIPHANY_III, dataclasses.replace(jbsp.EPIPHANY_III, g=1.0),
          jbsp.TPU_V5E_CHIP, jbsp.TPU_V5E_POD]
PACK_IDS = ["epiphany", "epiphany-g1", "v5e-chip", "v5e-pod"]


def test_epiphany_preset_is_carried_over():
    assert dataclasses.asdict(tbsp.EPIPHANY_III) == dataclasses.asdict(jbsp.EPIPHANY_III)
    assert not hasattr(tbsp, "TPU_V5E_CHIP") and not hasattr(tbsp, "TPU_V5E_POD")


@pytest.mark.parametrize("jacc", JPACKS, ids=PACK_IDS)
def test_closed_forms_give_equal_floats(jacc):
    tacc = _pack(jacc)
    for n, c in [(1 << 20, 256), (1000, 7), (64, 64)]:
        assert tcost.inner_product_cost(tacc, n, c) == jcost.inner_product_cost(jacc, n, c)
    for k in (1, 4, 16):
        assert tcost.cannon_bsp_cost(tacc, 4, k) == jcost.cannon_bsp_cost(jacc, 4, k)
        th, jh = tcost.cannon_hyperstep(tacc, k, 4), jcost.cannon_hyperstep(jacc, k, 4)
        assert th.cost(tacc) == jh.cost(jacc)
        assert th.bandwidth_heavy(tacc) == jh.bandwidth_heavy(jacc)
    if jacc.p == 16:
        for n, m in [(256, 4), (512, 8)]:
            assert tcost.cannon_bsps_cost(tacc, n, m) == jcost.cannon_bsps_cost(jacc, n, m)
        assert tcost.cannon_k_equal(tacc) == jcost.cannon_k_equal(jacc)


@pytest.mark.parametrize("jacc", JPACKS, ids=PACK_IDS)
def test_bsps_cost_of_hypersteps_gives_equal_floats(jacc):
    tacc = _pack(jacc)
    rng = np.random.default_rng(0)
    spec = [dict(bsp_flops=float(f), fetch_words=[float(w), float(w) / 2],
                 writeback_words=[float(u)], comm_words=float(c), supersteps=2.0)
            for f, w, u, c in rng.integers(1, 10_000, (6, 4))]
    t = [tcost.HyperstepCost(**s) for s in spec]
    j = [jcost.HyperstepCost(**s) for s in spec]
    assert tcost.bsps_cost(t, tacc) == jcost.bsps_cost(j, jacc)
    steps = [dict(work=[1.0, 5.0], transmitted=[3.0], received=[2.0, 7.0])] * 3
    assert (tcost.bsp_cost([tcost.SuperstepCost(**s) for s in steps], tacc)
            == jcost.bsp_cost([jcost.SuperstepCost(**s) for s in steps], jacc))


def _same_plan(tp, jp, jacc):
    tacc = _pack(jacc)
    assert tp.grid == jp.grid and tp.dimension_semantics == jp.dimension_semantics
    assert tp.fetch_schedule() == jp.fetch_schedule()
    assert tp.writeback_schedule() == jp.writeback_schedule()
    assert tp.vmem_bytes == jp.vmem_bytes
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.cost(tacc) == jp.cost(jacc)
    assert tp.cost(tacc, exact=False) == jp.cost(jacc, exact=False)
    assert tp.bandwidth_heavy(tacc) == jp.bandwidth_heavy(jacc)
    assert tp.fits(tacc) == jp.fits(jacc)


MATMUL_CASES = [
    dict(m=256, k=512, n=128, block_m=128, block_n=128, block_k=128),
    dict(m=300, k=200, n=130, block_m=128, block_n=64, block_k=32),
    dict(m=4, k=2304, n=5760, block_m=16, block_n=64, block_k=64),
]


@pytest.mark.parametrize("case", MATMUL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plan_parity(case, dtype):
    tp = t_matmul_plan(**case, dtype=getattr(torch, dtype))
    jp = j_matmul_plan(**case, dtype=getattr(jnp, dtype))
    for jacc in JPACKS:
        _same_plan(tp, jp, jacc)


@pytest.mark.parametrize("n_tok,c", [(16, 8192), (5, 128)])
def test_dot_plan_parity(n_tok, c):
    tp, jp = t_dot_plan(n_tok, c), j_dot_plan(n_tok, c)
    for jacc in JPACKS:
        _same_plan(tp, jp, jacc)


def test_split_and_multicore_plans_keep_the_streamed_words():
    """The port's extra parallel axes move the same tokens: split-K and the
    p-core dot stream exactly the words of the JAX plans."""
    one = t_matmul_plan(4, 2304, 5760, block_m=16, block_n=64, block_k=64)
    split = t_matmul_plan(4, 2304, 5760, block_m=16, block_n=64, block_k=64, split_k=6)
    assert split.total_flops == one.total_flops
    # A and B tiles are each fetched once per (i, j, k) visit in both walks
    assert split.num_hypersteps == one.num_hypersteps
    with pytest.raises(ValueError):
        t_matmul_plan(4, 2304, 5760, block_m=16, block_n=64, block_k=64, split_k=5)
    dot1, dotp = t_dot_plan(512, 8192), t_dot_plan(512, 8192, cores=128)
    assert dotp.total_fetch_words() == dot1.total_fetch_words()
    assert dotp.total_flops == dot1.total_flops


ATTN_CASES = [
    dict(b=2, hq=4, hkv=4, sq=128, skv=128, d=32, block_q=32, block_kv=32),
    dict(b=2, hq=8, hkv=2, sq=96, skv=96, d=32, block_q=32, block_kv=32),
    dict(b=1, hq=4, hkv=1, sq=32, skv=128, d=32, block_q=32, block_kv=32, q_offset=96),
    dict(b=1, hq=4, hkv=2, sq=64, skv=128, d=64, block_q=64, block_kv=64, causal=False),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plan_parity(case):
    tp = t_attention_plan(**case, dtype=torch.bfloat16)
    jp = j_attention_plan(**case, dtype=jnp.bfloat16)
    assert tp.total_flops == jp.total_flops and tp.mean_flops == jp.mean_flops
    for jacc in JPACKS:
        _same_plan(tp, jp, jacc)


@pytest.mark.parametrize("jacc", [jbsp.TPU_V5E_CHIP, jbsp.EPIPHANY_III],
                         ids=["v5e-chip", "epiphany"])
def test_autotune_makes_the_same_choice(jacc):
    tacc = _pack(jacc)
    m, k, n = 512, 1024, 256
    cands = j_matmul_candidates(m, k, n) + [
        {"block_m": 16, "block_n": 64, "block_k": 64},
        {"block_m": 64, "block_n": 64, "block_k": 32}]
    try:
        jbest, jall = jplan.autotune(lambda **p: j_matmul_plan(m, k, n, **p), cands, jacc)
    except ValueError:
        with pytest.raises(ValueError):
            tplan.autotune(lambda **p: t_matmul_plan(m, k, n, **p), cands, tacc)
        return
    tbest, tall = tplan.autotune(lambda **p: t_matmul_plan(m, k, n, **p), cands, tacc)
    assert tbest.params == jbest.params
    assert [c.params for c in tall] == [c.params for c in jall]
    assert [c.predicted_seconds for c in tall] == [c.predicted_seconds for c in jall]


def test_host_plan_parity():
    rng = np.random.default_rng(0)
    data = rng.standard_normal(64).astype(np.float32)
    jss, tss = JStreamSet(), TStreamSet()
    js = [jss.create(data, 8), jss.create(data[:8], 8), jss.create(data, 4)]
    ts = [tss.create(data, 8), tss.create(data[:8], 8), tss.create(data, 4)]
    jo = jss.create(np.zeros(4, np.float32), 1)
    to = tss.create(np.zeros(4, np.float32), 1)
    kw = dict(flops_per_hyperstep=100.0, rates=[1, 0, 2], out_every=[2],
              comm_words_per_hyperstep=3.0, supersteps_per_hyperstep=1.0)
    jp = jplan.host_plan(js, out_streams=[jo], **kw)
    tp = tplan.host_plan(ts, out_streams=[to], **kw)
    for jacc in JPACKS:
        _same_plan(tp, jp, jacc)
    op = tplan.streamed_operand("kv", 1000, dtype=torch.bfloat16)
    assert op.nbytes == jplan.streamed_operand("kv", 1000, dtype=jnp.bfloat16).nbytes


def _rate_program(stream_set, device=None):
    """A program with an advancing, a resident and a rate-2 stream, a sparse
    up-stream and a MOVE-style seek in on_hyperstep_end."""
    data = np.arange(96, dtype=np.float32)
    ss = stream_set()
    s0, s1, s2 = ss.create(data, 8), ss.create(data[:8], 8), ss.create(data, 4)
    out = ss.create(np.zeros(3, np.float32), 1)

    def on_end(h, streams):
        if h == 2:
            streams[0].seek(0, -1)

    kw = dict(rates=[1, 0, 2], out_streams=[out], out_every=[2], on_hyperstep_end=on_end)
    if device is not None:
        kw["device"] = device
    return ss, out, kw


def test_runner_cursor_walk_matches_reference():
    jss, _, jkw = _rate_program(JStreamSet)
    tss, _, tkw = _rate_program(TStreamSet, device="cpu")
    step = lambda acc, t: (acc, [acc])
    jr = JRunner(step, list(jss.all())[:3], verify=False, **jkw)
    tr = TRunner(step, list(tss.all())[:3], **tkw)
    js, ts = jr.compile(6).schedule, tr.compile(6).schedule
    for name in ("gather_indices", "resident_indices", "scatter_indices", "flush_mask"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    for name in ("step_words", "initial_words", "writeback_words",
                 "final_in_cursors", "final_out_cursors"):
        assert getattr(ts, name) == getattr(js, name)


@pytest.mark.parametrize("compiled", [False, True])
def test_runner_modes_give_the_reference_result(compiled):
    """Same program, same tokens: the port's runner in either mode computes
    what the JAX runner's host loop computes, and records the same words."""

    def jstep(acc, t):
        acc = acc + float(np.sum(np.asarray(t[0]))) + float(np.sum(np.asarray(t[1]))) \
            + 0.5 * float(np.sum(np.asarray(t[2])))
        return acc, [np.full((1,), acc, np.float32)]

    def tstep(acc, t):
        acc = acc + t[0].sum() + t[1].sum() + 0.5 * t[2].sum()
        return acc, [acc.reshape(1)]

    jss, jout, jkw = _rate_program(JStreamSet)
    tss, tout, tkw = _rate_program(TStreamSet, device="cpu")
    jr = JRunner(jstep, list(jss.all())[:3], verify=False, **jkw)
    want = jr.run(0.0, 6)
    tr = TRunner(tstep, list(tss.all())[:3], **tkw)
    got = tr.run(torch.zeros((), dtype=torch.float64), 6, compiled=compiled)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(tout.data, jout.data, rtol=1e-6)
    assert tr.total_fetch_words == jr.total_fetch_words
    assert (sum(r.writeback_words for r in tr.records)
            == sum(r.writeback_words for r in jr.records))


def _multicore_program(stream_set, p=2, steps=4):
    """p cores, each with one down-stream and one up-stream that the runner
    flushes on every second hyperstep (``out_every=[2]``)."""
    ss = stream_set()
    ins = [[ss.create(np.arange(steps * 8, dtype=np.float32) * (c + 1), 8)]
           for c in range(p)]
    outs = [[ss.create(np.zeros(steps, np.float32), 1)] for _ in range(p)]
    return ins, outs


@pytest.mark.parametrize("compiled", [False, True])
def test_multicore_runner_matches_reference(compiled):
    """The runner's p-core mode: per-core lanes and records, the shared bulk
    sync, and per-core up-streams give what the JAX runner gives."""
    p = 2

    def jstep(h_acc, toks):
        h, acc = h_acc
        acc = acc + sum(float(np.sum(np.asarray(toks[0][c]))) for c in range(p))
        return (h + 1, acc), [[np.full((1,), acc + c, np.float32) for c in range(p)]]

    def tstep(h_acc, toks):
        h, acc = h_acc
        acc = acc + sum(toks[0][c].sum() for c in range(p))
        return (h + 1, acc), [[(acc + c).reshape(1) for c in range(p)]]

    jins, jouts = _multicore_program(JStreamSet, p)
    tins, touts = _multicore_program(TStreamSet, p)
    jr = JRunner(jstep, jins, cores=p, out_streams=jouts, out_every=[2], verify=False)
    _, want = jr.run((0, 0.0))
    tr = TRunner(tstep, tins, cores=p, out_streams=touts, out_every=[2], device="cpu")
    _, got = tr.run((0, torch.zeros((), dtype=torch.float64)), compiled=compiled)
    assert float(got) == pytest.approx(want, rel=1e-9)
    for jo, to in zip(jouts, touts):
        np.testing.assert_allclose(np.asarray(to[0].data), np.asarray(jo[0].data), rtol=1e-6)
    assert tr.total_fetch_words == jr.total_fetch_words
    if not compiled:
        for jrecs, trecs in zip(jr.core_records, tr.core_records):
            assert [r.fetch_words for r in trecs] == [r.fetch_words for r in jrecs]
            assert [r.writeback_words for r in trecs] == [r.writeback_words for r in jrecs]


@pytest.mark.parametrize("compiled", [False, True])
def test_inner_product_runs_through_ops_dot(compiled):
    """The §3.1 inner product as a hyperstep program with ops.dot in the step
    (its plain version on CPU tensors), priced by host_plan."""
    n, c = 4096, 512
    rng = np.random.default_rng(1)
    v = rng.standard_normal(n).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)
    ss = TStreamSet()
    sv, su = ss.create(v, c), ss.create(u, c)
    plan = tplan.host_plan([sv, su], flops_per_hyperstep=2.0 * c)
    runner = TRunner(lambda acc, t: acc + ops.dot(t[0], t[1]), [sv, su], device="cpu",
                     plan=plan, machine=tbsp.EPIPHANY_III)
    got = float(runner.run(torch.zeros(()), compiled=compiled))
    assert got == pytest.approx(float(np.dot(v.astype(np.float64), u)), rel=1e-5, abs=1e-3)
    row = runner.predicted_vs_measured()
    assert row["fetch_words_planned"] == row["fetch_words_measured"] == 2 * n


def test_run_bsps_matches_reference():
    from repro.core.hyperstep import run_bsps as j_run_bsps
    from repro_torch.core.hyperstep import run_bsps as t_run_bsps

    data = np.arange(64, dtype=np.float32)
    want, jrecs = j_run_bsps(lambda acc, t: acc + float(np.sum(t[0])),
                             [JStreamSet().create(data, 8)], 0.0, verify=False)
    got, trecs = t_run_bsps(lambda acc, t: acc + t[0].sum(),
                            [TStreamSet().create(data, 8)], torch.zeros(()), device="cpu")
    assert float(got) == float(want) and len(trecs) == len(jrecs) == 8
    assert [r.fetch_words for r in trecs] == [r.fetch_words for r in jrecs]

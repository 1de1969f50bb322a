"""Parity of the port's §3.1/§3.2 constructions with the JAX package.

The cyclic and block-grid stream layouts, the BSP helpers, Cannon's
StreamPlan (Eq. 2) and its cursor walk are pure Python: the port must give
the same floats, schedules, word counts and BSPS codes as the reference,
exactly. Two-level Cannon itself runs on the CPU here (the matmul's plain
version), fp32, against the JAX package's run on the same numpy operands.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsp as jbsp
from repro.core import cost as jcost
from repro.core import plan as jplan
from repro.core.hyperstep import HyperstepRunner as JRunner
from repro.core.stream import StreamSet as JStreamSet
from repro.core.verify import PlanVerificationError as JPlanVerificationError
from repro.core.verify import verify_runner as j_verify_runner
from repro.distributed import cannon as jcannon
from repro_torch.core import bsp as tbsp
from repro_torch.core import cost as tcost
from repro_torch.core import plan as tplan
from repro_torch.core.calibrate import measure_fetch_model
from repro_torch.core.hyperstep import HyperstepRunner as TRunner
from repro_torch.core.stream import StreamSet as TStreamSet
from repro_torch.core.verify import PlanVerificationError, verify_runner
from repro_torch.distributed import cannon as tcannon
from repro_torch.kernels import ops

JACC = jbsp.BSPAccelerator(p=4, g=1.0, l=2.0, r=1e9, e=1.0,
                           L=1 << 20, E=1 << 30, word_bytes=4, name="test-grid")


def _pack(acc) -> tbsp.BSPAccelerator:
    """The port's pack with the numbers of one of the JAX package's packs."""
    return tbsp.BSPAccelerator(**dataclasses.asdict(acc))


TACC = _pack(JACC)
JPACKS = [jbsp.EPIPHANY_III, JACC, jbsp.TPU_V5E_CHIP]
PACK_IDS = ["epiphany", "test-grid", "v5e-chip"]


def _operands(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


# -- core/bsp and core/cost helpers ---------------------------------------------


@pytest.mark.parametrize("jacc", [jbsp.EPIPHANY_III, JACC], ids=["epiphany", "test-grid"])
def test_bsp_helpers_give_equal_floats(jacc):
    tacc = _pack(jacc)
    for seconds in (0.0, 1e-6, 0.37):
        assert tacc.seconds_to_flops(seconds) == jacc.seconds_to_flops(seconds)
    for words in (0, 1, 4096, 1 << 26):
        assert tacc.external_read_seconds(words) == jacc.external_read_seconds(words)
    assert tacc.balance == jacc.balance == jacc.e
    for i in range(40):
        assert tbsp.cyclic_owner(i, jacc.p) == jbsp.cyclic_owner(i, jacc.p)
    for total, tok in [(24, 2), (25, 2), (1, 8), (0, 3), (1 << 26, 1 << 18)]:
        assert tbsp.tokens_for(total, tok) == jbsp.tokens_for(total, tok)
    with pytest.raises(ValueError):
        tbsp.tokens_for(8, 0)


@pytest.mark.parametrize("jacc", [jbsp.EPIPHANY_III, JACC], ids=["epiphany", "test-grid"])
def test_fetch_and_writeback_costs_give_equal_floats(jacc):
    tacc = _pack(jacc)
    for fw, ww in [([3.0, 7.0, 5.0], [2.0]), ([], []), ([1.0], [4.0, 9.0])]:
        t = tcost.HyperstepCost(bsp_flops=10.0, fetch_words=fw, writeback_words=ww)
        j = jcost.HyperstepCost(bsp_flops=10.0, fetch_words=fw, writeback_words=ww)
        assert t.fetch_cost(tacc) == j.fetch_cost(jacc)
        assert t.writeback_cost(tacc) == j.writeback_cost(jacc)
    for k in (1, 8, 64):
        th = tcost.cannon_hyperstep(tacc, k, 2)
        jh = jcost.cannon_hyperstep(jacc, k, 2)
        assert th.fetch_cost(tacc) == jh.fetch_cost(jacc)


# -- core/stream: cyclic and block-grid layouts ------------------------------------


def _backings(streams):
    return [np.asarray(s.data) for s in streams]


@pytest.mark.parametrize("shape,p,tok", [
    ((24,), 3, 2),        # the paper's Fig. 2: |Σ_0| = 4 tokens of C = 2
    ((25,), 4, 3),        # ragged: core 0 holds 7 components, padded to 9
    ((10, 3), 3, 2),      # a 2-D vector: rows dealt out, trailing dims kept
])
def test_create_cyclic_matches_reference(shape, p, tok):
    v = np.arange(math.prod(shape), dtype=np.float32).reshape(shape)
    js = JStreamSet().create_cyclic(v, p, tok, name="v")
    ts = TStreamSet().create_cyclic(v, p, tok, name="v")
    assert [s.name for s in ts] == [s.name for s in js]
    assert [s.num_tokens for s in ts] == [s.num_tokens for s in js]
    assert [s.token_words for s in ts] == [s.token_words for s in js]
    for t, j in zip(_backings(ts), _backings(js)):
        assert isinstance(t, np.ndarray) and t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    if shape == (24,):
        np.testing.assert_array_equal(ts[0].data, v[0::3])
        assert ts[0].num_tokens == 4
    # a tensor gives tensor backings on its device, the same numbers
    tt = TStreamSet().create_cyclic(torch.from_numpy(v), p, tok, name="v")
    for t, j in zip(tt, _backings(js)):
        assert isinstance(t.data, torch.Tensor) and t.data.device.type == "cpu"
        np.testing.assert_array_equal(t.data.numpy(), j)


@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("m_blocks,n_grid", [(2, 1), (4, 1), (2, 2), (1, 2)])
def test_create_block_grid_matches_reference(order, m_blocks, n_grid):
    a, _ = _operands(16, 5)
    js = JStreamSet().create_block_grid(a, m_blocks, n_grid, order=order, name="A")
    ts = TStreamSet().create_block_grid(a, m_blocks, n_grid, order=order, name="A")
    assert len(ts) == n_grid * n_grid
    assert [s.name for s in ts] == [s.name for s in js]
    assert [(s.num_tokens, s.token_words) for s in ts] == [
        (s.num_tokens, s.token_words) for s in js]
    for t, j in zip(_backings(ts), _backings(js)):
        np.testing.assert_array_equal(t, j)
    tt = TStreamSet().create_block_grid(torch.from_numpy(a), m_blocks, n_grid, order=order)
    for t, j in zip(tt, _backings(js)):
        assert isinstance(t.data, torch.Tensor)
        np.testing.assert_array_equal(t.data.numpy(), j)


@pytest.mark.parametrize("matrix,m_blocks,n_grid,order", [
    (np.zeros((8, 8), np.float32), 2, 1, "diag"),    # unknown order
    (np.zeros((8, 6), np.float32), 2, 1, "row"),     # not square
    (np.zeros((8,), np.float32), 2, 1, "row"),       # not a matrix
    (np.zeros((10, 10), np.float32), 2, 2, "row"),   # n not divisible by M·N
])
def test_create_block_grid_errors_match_reference(matrix, m_blocks, n_grid, order):
    with pytest.raises(ValueError) as jerr:
        JStreamSet().create_block_grid(matrix, m_blocks, n_grid, order=order)
    with pytest.raises(ValueError) as terr:
        TStreamSet().create_block_grid(matrix, m_blocks, n_grid, order=order)
    assert str(terr.value).split(",")[0] == str(jerr.value).split(",")[0]


# -- distributed/cannon: the plan ---------------------------------------------------


@pytest.mark.parametrize("n,m_blocks,n_grid", [(64, 2, 2), (64, 4, 1), (32, 2, 1), (96, 3, 4),
                                               (16384, 4, 1), (16384, 4, 4)])
@pytest.mark.parametrize("jacc", JPACKS, ids=PACK_IDS)
def test_cannon_plan_is_the_jax_plan(n, m_blocks, n_grid, jacc):
    tp = tcannon.cannon_plan(n, m_blocks, n_grid)
    jp = jcannon.cannon_plan(n, m_blocks, n_grid)
    tacc = _pack(jacc)
    assert tp.name == jp.name and tp.grid == jp.grid
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.fetch_schedule() == jp.fetch_schedule()
    assert tp.writeback_schedule() == jp.writeback_schedule()
    ts, js = tp.compiled_schedule(), jp.compiled_schedule()
    for t, j in zip(ts.in_blocks + ts.out_blocks + ts.out_completes,
                    js.in_blocks + js.out_blocks + js.out_completes):
        np.testing.assert_array_equal(t, j)
    assert tp.cost(tacc) == jp.cost(jacc)
    assert tp.predicted_seconds(tacc) == jp.predicted_seconds(jacc)
    assert tp.bandwidth_heavy(tacc) == jp.bandwidth_heavy(jacc)
    assert tp.total_fetch_words() == jp.total_fetch_words()
    # the bf16 plan names its dtype as the reference's does
    assert (tcannon.cannon_plan(n, m_blocks, n_grid, dtype=torch.bfloat16).fingerprint()
            == jcannon.cannon_plan(n, m_blocks, n_grid, dtype=jnp.bfloat16).fingerprint())


def test_cannon_plan_prices_eq2_closed_form():
    acc = dataclasses.replace(tbsp.EPIPHANY_III, g=1.0, e=1.0)
    plan = tcannon.cannon_plan(64, 2, 2)
    assert plan.num_hypersteps == 8
    assert plan.cost(acc) == pytest.approx(tcost.cannon_bsps_cost(acc, 64, 2, 2))
    assert not plan.bandwidth_heavy(acc)


def test_cannon_dims_errors():
    with pytest.raises(ValueError):
        tcannon.cannon_plan(10, 2, 2)
    with pytest.raises(ValueError):
        tcannon.cannon_plan(16, 0, 1)


def test_autotune_selects_the_reference_m():
    """Eq. 2 prefers the largest outer block (smallest M) that fits L: the
    port's autotune picks the reference's M with the same feasibility and
    prices."""
    n = 64
    jacc = dataclasses.replace(JACC, L=8192)
    cands = [{"m_blocks": m} for m in (1, 2, 4, 8)]
    jbest, jchoices = jplan.autotune(lambda m_blocks: jcannon.cannon_plan(n, m_blocks, 1),
                                     cands, jacc)
    tbest, tchoices = tplan.autotune(lambda m_blocks: tcannon.cannon_plan(n, m_blocks, 1),
                                     cands, _pack(jacc))
    assert tbest.params["m_blocks"] == jbest.params["m_blocks"] == 2
    assert ([(c.params["m_blocks"], c.feasible, c.predicted_seconds) for c in tchoices]
            == [(c.params["m_blocks"], c.feasible, c.predicted_seconds) for c in jchoices])


# -- distributed/cannon: the runner ---------------------------------------------------


@pytest.mark.parametrize("n,m_blocks,n_grid", [(32, 2, 1), (64, 2, 2), (48, 3, 2)])
def test_compiled_gather_indices_match_reference(n, m_blocks, n_grid):
    a, b = _operands(n, 0)
    jr, _, _ = jcannon.make_cannon_runner(a, b, m_blocks, n_grid=n_grid, machine=JACC)
    tr, _, _ = tcannon.make_cannon_runner(a, b, m_blocks, n_grid=n_grid, machine=TACC,
                                          device="cpu")
    js, ts = jr.compile(m_blocks**3).schedule, tr.compile(m_blocks**3).schedule
    for field in ("gather_indices", "resident_indices", "scatter_indices", "flush_mask"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
    for field in ("step_words", "initial_words", "writeback_words", "final_in_cursors",
                  "final_out_cursors"):
        assert getattr(ts, field) == getattr(js, field)
    # A walks row-major outer blocks (i·M+s), B column-major (j·M+s)
    sched = tcannon.cannon_plan(n, m_blocks, n_grid).compiled_schedule()
    a_blocks, b_blocks = sched.in_blocks
    np.testing.assert_array_equal(ts.gather_indices[:, 0, 0],
                                  a_blocks[:, 0] * m_blocks + a_blocks[:, 1])
    np.testing.assert_array_equal(ts.gather_indices[:, 0, 1],
                                  b_blocks[:, 1] * m_blocks + b_blocks[:, 0])


def _record_words(runner):
    return [[(r.index, r.fetch_words, r.writeback_words, r.initial_fetch_words) for r in recs]
            for recs in runner.core_records]


@pytest.mark.parametrize("m_blocks,n_grid", [(4, 1), (2, 2)])
@pytest.mark.parametrize("compiled", [False, True])
def test_two_level_cannon_matches_reference(m_blocks, n_grid, compiled):
    a, b = _operands(64, 3)
    jc, jr = jcannon.two_level_cannon(a, b, m_blocks, n_grid=n_grid, machine=JACC,
                                      compiled=compiled)
    tc, tr = tcannon.two_level_cannon(a, b, m_blocks, n_grid=n_grid, machine=TACC,
                                      compiled=compiled, device="cpu")
    assert isinstance(tc, np.ndarray) and tc.dtype == np.float32
    # fp32 sums of 64 terms in other orders: within 1e-5 of the JAX C, and
    # within 1e-4 of numpy
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert float(np.abs(tc - a @ b).max()) < 1e-4
    assert _record_words(tr) == _record_words(jr)
    assert tr.hypersteps_run == jr.hypersteps_run and tr.dispatches_run == jr.dispatches_run
    assert tr.predicted_seconds() == jr.predicted_seconds()
    assert tr.total_fetch_words == jr.total_fetch_words == sum(tr.plan.fetch_schedule())
    row, jrow = tr.predicted_vs_measured(), jr.predicted_vs_measured()
    for key in ("predicted_seconds", "bandwidth_heavy_predicted", "fetch_words_planned",
                "fetch_words_measured"):
        assert row[key] == jrow[key]
    k = 64 // (m_blocks * n_grid)
    if not compiled:
        assert len(tr.core_records) == n_grid * n_grid
        for recs in tr.core_records:
            assert len(recs) == m_blocks**3
            assert all(r.fetch_words == 2 * k * k for r in recs[:-1])
            assert recs[0].initial_fetch_words == 2 * k * k
            assert sum(r.writeback_words for r in recs) == k * k * m_blocks**2


def test_two_level_cannon_grid_and_modes_agree():
    """N = 2 against N = 1 and compiled against measure mode: the same local
    products on the same assembled blocks, so within 1e-5 relative."""
    a, b = _operands(64, 2)
    runs = {(n_grid, compiled): tcannon.two_level_cannon(
        a, b, 2, n_grid=n_grid, machine=TACC, compiled=compiled, device="cpu")[0]
        for n_grid in (1, 2) for compiled in (False, True)}
    base = runs[1, False]
    for c in runs.values():
        np.testing.assert_allclose(c, base, rtol=1e-5, atol=1e-5 * np.abs(base).max())


def test_two_level_cannon_takes_tensors():
    """Tensor operands (bf16 has no numpy dtype) give stream backings and C
    as tensors; bf16 adds its M = 2 partial products in bf16, as the
    reference's accumulator does."""
    a, b = _operands(32, 4)
    c32, _ = tcannon.two_level_cannon(torch.from_numpy(a), torch.from_numpy(b), 2,
                                      machine=TACC, device="cpu")
    assert isinstance(c32, torch.Tensor) and c32.dtype == torch.float32
    np.testing.assert_allclose(c32.numpy(), a @ b, rtol=1e-5, atol=1e-4)
    ab, bb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    for compiled in (False, True):
        c16, runner = tcannon.two_level_cannon(ab, bb, 2, machine=TACC, compiled=compiled,
                                               device="cpu")
        assert c16.dtype == torch.bfloat16
        assert runner.plan.fingerprint() == jcannon.cannon_plan(
            32, 2, dtype=jnp.bfloat16).fingerprint()
        want = ab.double() @ bb.double()
        # each partial product rounded to bf16 once and each of the M - 1
        # sums once: (2M - 1) units of bf16's 2^-8 roundoff of Σ|a||b|
        bound = 3 * 2.0**-8 * (ab.double().abs() @ bb.double().abs()).max().item()
        assert (c16.double() - want).abs().max().item() <= bound


def test_cannon_runner_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error")
    a, b = _operands(16, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcannon.make_cannon_runner(a, b, 2)


# -- verification ------------------------------------------------------------------------


def test_cannon_verifies_clean():
    a = np.arange(256, dtype=np.float32).reshape(16, 16)
    runner, _, _ = tcannon.make_cannon_runner(a, a, 2, machine=_pack(jbsp.TPU_V5E_CHIP),
                                              device="cpu")
    assert verify_runner(runner, num_hypersteps=8) == []


@pytest.mark.parametrize("compiled", [False, True])
def test_cannon_corrupted_seek_schedule_raises_before_dispatch(compiled):
    a = np.arange(256, dtype=np.float32).reshape(16, 16)
    good = tcannon.cannon_move_schedule(2)
    jgood = jcannon.cannon_move_schedule(2)

    def corrupt(schedule):
        def corrupted(m, per_core):
            schedule(m, per_core)
            if m == 3:                       # one extra bogus MOVE rewind
                for core, (sa, _) in enumerate(per_core):
                    sa.seek(core, -50)
        return corrupted

    runner, _, state0 = tcannon.make_cannon_runner(
        a, a, 2, machine=_pack(jbsp.TPU_V5E_CHIP), compiled=compiled, device="cpu")
    jrunner, _, _ = jcannon.make_cannon_runner(a, a, 2, machine=jbsp.TPU_V5E_CHIP,
                                               compiled=compiled)
    runner._on_end, jrunner._on_end = corrupt(good), corrupt(jgood)
    diags, jdiags = verify_runner(runner, 8), j_verify_runner(jrunner, 8)
    assert "BSPS101" in [d.code for d in diags]
    assert ([(d.code, d.severity, d.message) for d in diags]
            == [(d.code, d.severity, d.message) for d in jdiags])
    with pytest.raises(PlanVerificationError):
        runner.run(state0, num_hypersteps=8, compiled=compiled)
    assert runner.dispatches_run == 0
    with pytest.raises(JPlanVerificationError):
        jrunner.run(None if not compiled else jcannon.cannon_compiled_state(16, 2),
                    num_hypersteps=8, compiled=compiled)


# -- §3.1: the cyclic inner product ------------------------------------------------------


def test_cyclic_inner_product_matches_the_reference_runner():
    """Algorithm 1 on p = 4 cores: cyclic streams, each core's tokens through
    ``ops.dot``, against the JAX multicore runner on the same vectors."""
    p, n, tok = 4, 256, 16
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)

    def cores(ss):
        vs, us = ss.create_cyclic(v, p, tok, name="v"), ss.create_cyclic(u, p, tok, name="u")
        return [[vs[c], us[c]] for c in range(p)]

    jout = JRunner(lambda acc, t: acc + sum(float(np.dot(t[0][c], t[1][c])) for c in range(p)),
                   cores(JStreamSet()), cores=p).run(0.0)
    per_core = cores(TStreamSet())
    plan = tplan.host_plan(per_core[0], flops_per_hyperstep=2.0 * tok, name="cyclic")
    runner = TRunner(lambda acc, t: acc + sum(ops.dot(t[0][c], t[1][c]) for c in range(p)),
                     per_core, cores=p, plan=plan, machine=TACC, device="cpu")
    got = float(runner.run(torch.zeros(())))
    assert got == pytest.approx(jout, rel=1e-5)
    assert got == pytest.approx(float(np.dot(v.astype(np.float64), u)), rel=1e-5)
    row = runner.predicted_vs_measured()
    assert row["fetch_words_planned"] == row["fetch_words_measured"] == n * 2 / p
    assert len(runner.core_records) == p


def test_measure_fetch_model_on_the_cpu():
    bw, t0 = measure_fetch_model(device="cpu")
    assert math.isfinite(bw) and bw > 0
    assert math.isfinite(t0) and t0 >= 0

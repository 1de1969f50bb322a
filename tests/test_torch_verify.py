"""The port's static verifier against the JAX package's, on the CPU.

The verifier is pure Python and numpy over the declared plan and the runner's
cursor walk, so the same plan (or the same runner) must give the same
diagnostics in the same order — codes, severities, messages, locations and
hints, compared exactly. Every BSPS1xx code fires on a minimal offending
plan or runner built the same way in both packages.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import plan as jplan
from repro.core import verify as jverify
from repro.core.bsp import TPU_V5E_CHIP as J_CHIP
from repro.core.bsp import BSPAccelerator as JPack
from repro.core.hyperstep import HyperstepRunner as JRunner
from repro.core.stream import StreamSet as JStreamSet
from repro_torch.core import plan as tplan
from repro_torch.core import verify as tverify
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.core.hyperstep import HyperstepRunner as TRunner
from repro_torch.core.stream import StreamSet as TStreamSet

# small test accelerator: L = 1024 words × 4 B = 4 KiB local-memory budget
ACC = dict(p=1, g=0.0, l=0.0, r=1e9, e=4.0, L=1024, E=1 << 30, word_bytes=4,
           name="test-acc")

JAX = types.SimpleNamespace(
    plan=jplan, verify=jverify, StreamSet=JStreamSet, acc=JPack(**ACC),
    chip=J_CHIP, runner=lambda *a, **kw: JRunner(*a, **kw))
TORCH = types.SimpleNamespace(
    plan=tplan, verify=tverify, StreamSet=TStreamSet, acc=TPack(**ACC),
    chip=TPack(**dataclasses.asdict(J_CHIP)),   # the same numbers, no preset
    runner=lambda *a, **kw: TRunner(*a, device="cpu", **kw))


def _simple_runner(k, n_tok=8, token=4, **kw):
    s = k.StreamSet().create(np.zeros(n_tok * token, np.float32), token, name="v")
    return k.runner(lambda a, t: a, [s], **kw)


def _one_token_plan(k, words, *, grid=(4,), index_map=None, out_words=4):
    return k.plan.StreamPlan(
        name="budget", grid=grid,
        inputs=(k.plan.TokenSpec(name="a", block_shape=(words,),
                                 index_map=index_map or (lambda h: (h,)),
                                 full_shape=(grid[0] * words,)),),
        outputs=(k.plan.TokenSpec(name="y", block_shape=(out_words,),
                                  index_map=lambda h: (h,),
                                  full_shape=(grid[0] * out_words,), direction="up"),),
        flops_per_hyperstep=1.0)


def _cores(k, shared: bool):
    ss = k.StreamSet()
    ins = [ss.create(np.zeros(16, np.float32), 4, name=f"in{c}") for c in range(2)]
    if shared:
        out = ss.create(np.zeros(4, np.float32), 1, name="shared-out")
        outs = [[out], [out]]
    else:
        outs = [[ss.create(np.zeros(4, np.float32), 1, name=f"out{c}")] for c in range(2)]
    return k.verify.verify_runner(
        k.runner(lambda a, t: a, [[s] for s in ins], cores=2, out_streams=outs))


def _lanes(k, aliased: bool):
    ss = k.StreamSet()
    s_in = ss.create(np.zeros(64, np.float32), 4, name="kv")
    lanes = ss.create_lanes(16, 2)
    outs = [lanes[0], lanes[0]] if aliased else lanes
    return k.verify.verify_runner(k.runner(lambda a, t: a, [s_in], out_streams=outs),
                                  num_hypersteps=4)


def _bad_hook(h, ss):
    raise RuntimeError("touches device state")


def _clamped(k):
    # a run shorter than its plan: only the closed-form budget bound is kept
    s = k.StreamSet().create(np.zeros(8 * 600, np.float32), 600, name="v")
    plan = k.plan.host_plan([s], flops_per_hyperstep=1.0, name="clamped")
    return k.verify.verify_runner(
        k.runner(lambda a, t: a, [s], plan=plan, machine=k.acc), num_hypersteps=3)


CASES = {
    # code expected (None: the case must verify clean), the function that builds the case
    "bsps101_seek": ("BSPS101", lambda k: k.verify.verify_runner(_simple_runner(
        k, n_tok=4, on_hyperstep_end=lambda h, ss: ss[0].seek(0, -3)))),
    "bsps102_exhausted": ("BSPS102", lambda k: k.verify.verify_runner(
        _simple_runner(k, n_tok=4), num_hypersteps=6)),
    "bsps103_rate": ("BSPS103", lambda k: k.verify.verify_runner(
        _simple_runner(k, n_tok=8, rates=[3]))),
    "bsps103_out_every": ("BSPS103", lambda k: k.verify.verify_runner(k.runner(
        lambda a, t: a,
        [k.StreamSet().create(np.zeros(32, np.float32), 4, name="v")],
        out_streams=[k.StreamSet().create(np.zeros(8, np.float32), 1, name="y")],
        out_every=[2]), num_hypersteps=3)),
    "bsps104_range": ("BSPS104", lambda k: k.verify.verify_plan(k.plan.StreamPlan(
        name="bad-range", grid=(4,),
        inputs=(k.plan.TokenSpec(name="a", block_shape=(4,), index_map=lambda h: (h,),
                                 full_shape=(8,)),),
        outputs=(), flops_per_hyperstep=1.0))),
    "bsps104_edge_is_legal": (None, lambda k: k.verify.verify_plan(k.plan.StreamPlan(
        name="edge", grid=(4,),
        inputs=(k.plan.TokenSpec(name="a", block_shape=(4,), index_map=lambda h: (h,),
                                 full_shape=(14,)),),
        outputs=(), flops_per_hyperstep=1.0))),
    "bsps105_opaque_hook": ("BSPS105", lambda k: k.verify.verify_runner(
        _simple_runner(k, on_hyperstep_end=_bad_hook))),
    "bsps121_race": ("BSPS121", lambda k: _cores(k, shared=True)),
    "bsps121_distinct_is_clean": (None, lambda k: _cores(k, shared=False)),
    "bsps122_revisit": ("BSPS122", lambda k: k.verify.verify_plan(k.plan.StreamPlan(
        name="revisit", grid=(4,), inputs=(),
        outputs=(k.plan.TokenSpec(name="y", block_shape=(4,),
                                  index_map=lambda h: ((0, 1, 0, 1)[h],),
                                  full_shape=(8,), direction="up"),),
        flops_per_hyperstep=1.0))),
    "bsps141_peak": ("BSPS141", lambda k: k.verify.verify_plan(
        _one_token_plan(k, 600), k.acc)),
    "bsps143_pessimistic": ("BSPS143", lambda k: k.verify.verify_plan(
        _one_token_plan(k, 600, index_map=lambda h: (0,)), k.acc)),
    "bsps141_closed_form": ("BSPS141", lambda k: k.verify.verify_plan(
        _one_token_plan(k, 600), k.acc, exact=False)),
    "bsps142_alias": ("BSPS142", lambda k: k.verify.verify_runner(k.runner(
        lambda a, t: a, [s := k.StreamSet().create(np.zeros(16, np.float32), 4,
                                                   name="shared")],
        out_streams=[s], out_every=[1]), num_hypersteps=2)),
    "bsps161_host_words": ("BSPS161", lambda k: k.verify.verify_plan(k.plan.StreamPlan(
        name="host-priced", grid=(4,),
        inputs=(k.plan.TokenSpec(name="a", block_shape=(4,), index_map=lambda h: (h,),
                                 full_shape=(16,)),),
        outputs=(), flops_per_hyperstep=1.0,
        host_comm_words_per_hyperstep=100.0, host_supersteps_per_hyperstep=3.0),
        host_h={"h_words": 250.0, "supersteps": 5.0})),
    "bsps162_verdict_flip": ("BSPS162", lambda k: k.verify.verify_plan(k.plan.StreamPlan(
        name="reuse", grid=(2, 2),
        inputs=(k.plan.TokenSpec(name="a", block_shape=(256,),
                                 index_map=lambda i, j: (i,), full_shape=(512,)),),
        outputs=(), flops_per_hyperstep=700.0), k.acc)),
    "packed_decode_is_clean": (None, lambda k: [d for d in k.verify.verify_plan(
        k.plan.packed_decode_plan(lanes=4, steps=16, flops_per_token=2e6,
                                  params_words=1 << 16, kv_words_per_lane=4096.0),
        k.chip) if d.severity == "error"]),
    "lane_aliasing": ("BSPS121", lambda k: _lanes(k, aliased=True)),
    "lanes_distinct_are_clean": (None, lambda k: _lanes(k, aliased=False)),
    "clamped_run": ("BSPS141", _clamped),
}


def _rows(diags):
    return [dataclasses.astuple(d) for d in diags]


@pytest.mark.parametrize("case", list(CASES))
def test_same_diagnostics_as_the_reference(case):
    code, build = CASES[case]
    want, got = build(JAX), build(TORCH)
    assert _rows(got) == _rows(want)
    assert all(isinstance(d, tverify.Diagnostic) for d in got)
    if code is None:
        assert not [d for d in got if d.code.startswith("BSPS12") or d.severity == "error"]
    else:
        assert code in [d.code for d in got]
    assert tverify.format_diagnostics(got) == jverify.format_diagnostics(want)


def test_code_tables_equal_the_reference():
    assert tverify.CODES == jverify.CODES
    assert tverify.SEVERITY == jverify.SEVERITY


def test_compile_and_run_raise_before_dispatch():
    want = JAX.runner(lambda a, t: a, [JStreamSet().create(np.zeros(16, np.float32), 4,
                                                             name="v")])
    with pytest.raises(jverify.PlanVerificationError) as jerr:
        want.compile(6)
    for compiled in (True, False):
        runner = _simple_runner(TORCH, n_tok=4)
        with pytest.raises(tverify.PlanVerificationError) as err:
            if compiled:
                runner.run(0.0, 6, compiled=True)
            else:
                runner.run(0.0, 6)
        assert str(err.value) == str(jerr.value)
        assert runner.dispatches_run == 0 and runner.hypersteps_run == 0
    with pytest.raises(tverify.PlanVerificationError):
        _simple_runner(TORCH, n_tok=4).compile(6)


def test_verify_false_opts_out_and_verify_is_memoized():
    # opted out, the overrun surfaces the old way: an IndexError from the
    # schedule simulation instead of a structured diagnostic
    with pytest.raises(IndexError):
        _simple_runner(TORCH, n_tok=4, verify=False).compile(6)
    runner = _simple_runner(TORCH, n_tok=4)
    runner.run(0.0, compiled=True)
    runner.run(0.0, compiled=True)
    assert len(runner._verified_keys) == 1       # one walk, one verification


def test_enumerate_plans_attaches_the_same_diagnostics():
    rows = []
    for k in (JAX, TORCH):
        choices = k.plan.enumerate_plans(lambda words, k=k: _one_token_plan(k, words),
                                         [{"words": 16}, {"words": 600}], k.acc)
        rows.append([(c.params, c.feasible, c.predicted_seconds, c.row().get("diagnostics"),
                      _rows(c.diagnostics)) for c in choices])
    assert rows[1] == rows[0]
    by_words = {r[0]["words"]: r for r in rows[1]}
    assert by_words[16][1] and not by_words[600][1]
    assert "BSPS141" in by_words[600][3]


def test_autotune_names_the_rejecting_codes():
    with pytest.raises(ValueError, match="diagnostics: BSPS141"):
        tplan.autotune(lambda words: _one_token_plan(TORCH, words), [{"words": 600}],
                       TORCH.acc)

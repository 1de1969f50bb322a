"""The port's fault injection and health monitor against the JAX package's.

A ``FaultPlan`` expands its triggers with numpy, so one ``(specs, seed)``
must give the same trigger sets and, consulted in the same order, the same
trace (``fault_signature``) in both packages. The runner's hooks — a stalled
DMA lane, a straggling compute, a corrupt flush, a failed dispatch and its
retry — give the reference's traces and results; the health monitor gives
the same BSPS2xx events for the same record series; and the serve engine
pairs each fault with the recovery the JAX engine makes, on the CPU.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import health as jhealth
from repro.core.hyperstep import HyperstepRunner as JRunner
from repro.core.stream import StreamSet as JStreamSet
from repro_torch.core import faults as tfaults
from repro_torch.core import health as thealth
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.core.hyperstep import HyperstepRunner as TRunner
from repro_torch.core.stream import StreamSet as TStreamSet

# the JAX engine tests' fixed pack: no calibration in tests
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")

SPECS = [("dma_stall", dict(rate=0.2, delay_s=0.001)),
         ("straggler", dict(rate=0.1, at=(3,), delay_s=0.002)),
         ("corrupt", dict(rate=0.1, at=(5,), slot=0, mode="bitflip")),
         ("dispatch_fail", dict(at=(2,), count=2)),
         ("page_exhaust", dict(rate=0.3)),
         ("data_error", dict(at=(1,), count=2))]


def _plans(seed, horizon=128):
    return (jfaults.FaultPlan([jfaults.FaultSpec(k, **kw) for k, kw in SPECS],
                              seed=seed, horizon=horizon),
            tfaults.FaultPlan([tfaults.FaultSpec(k, **kw) for k, kw in SPECS],
                              seed=seed, horizon=horizon))


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_plan_triggers_equal_the_reference(seed):
    jp, tp = _plans(seed)
    for kind in tfaults.FAULT_KINDS:
        assert tp.triggers(kind) == jp.triggers(kind)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


def _consult(inj, fault_signature):
    """Walk one replay through every hook in a fixed order; the trace."""
    for h in range(40):
        inj.fetch_delay(h)
        inj.compute_delay(h, core=h % 2)
        inj.corrupt_token(h, 0, np.zeros(3, np.float32))
    inj.corrupt_targets(40, 20)
    for _ in range(8):
        try:
            inj.on_dispatch()
        except Exception:                  # noqa: BLE001 — either package's FaultInjected
            pass
        inj.page_fault()
    for i in range(4):
        for _ in range(3):
            try:
                inj.data_error(i)
            except Exception:              # noqa: BLE001
                pass
    return fault_signature(inj.trace)


@pytest.mark.parametrize("seed", [0, 7])
def test_replay_traces_and_signatures_equal_the_reference(seed):
    jp, tp = _plans(seed)
    want = _consult(jp.replay(), jfaults.fault_signature)
    got = _consult(tp.replay(), tfaults.fault_signature)
    assert got == want and len(got) > 10
    assert _consult(tp.replay(), tfaults.fault_signature) == got   # replays repeat


def test_fault_spec_validation():
    for bad in (dict(kind="meteor_strike"), dict(kind="dma_stall", rate=1.5),
                dict(kind="dispatch_fail", count=0), dict(kind="corrupt", mode="gamma_ray")):
        with pytest.raises(ValueError):
            tfaults.FaultSpec(**bad)


@pytest.mark.parametrize("mode", ["nan", "bitflip"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_corrupt_array_equals_the_reference(mode, dtype):
    x = (np.arange(12).reshape(3, 4) + 1).astype(dtype)
    want = np.asarray(jfaults.corrupt_array(x, mode))
    got = tfaults.corrupt_array(x, mode)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))   # the same bits
    # a tensor in, a tensor out, bit-identical; the input is left alone
    t = torch.from_numpy(x.copy())
    out = tfaults.corrupt_array(t, mode)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy().view(np.uint8), want.view(np.uint8))
    assert torch.equal(t, torch.from_numpy(x))
    # a stacked row corrupted in place
    buf = torch.from_numpy(x.copy())
    assert tfaults.corrupt_stacked_row(buf, 1, mode) is buf
    np.testing.assert_array_equal(buf.numpy()[1].view(np.uint8),
                                  np.asarray(jfaults.corrupt_array(x[1], mode)).view(np.uint8))
    np.testing.assert_array_equal(buf.numpy()[[0, 2]], x[[0, 2]])


def test_corrupt_bf16_flips_a_mantissa_bit():
    x = torch.ones(4, dtype=torch.bfloat16)
    out = tfaults.corrupt_array(x, "bitflip")
    assert out[0] != 1 and torch.isfinite(out[0]) and torch.equal(out[1:], x[1:])
    assert torch.isnan(tfaults.corrupt_pytree({"a": x, "b": [x]}, "nan")["a"][0])


# ------------------------------------------------------------- runner hooks ----


def _streams(pkg_set, n=8):
    ss = pkg_set()
    down = ss.create(np.arange(n * 4, dtype=np.float32).reshape(n, 4), 1, name="x")
    up = ss.create(np.zeros((n, 4), np.float32), 1, name="y")
    return down, up


def _double(state, toks):
    return state + 1, [toks[0] * 2.0]


def _run(pkg, plan_specs, *, compiled=False, warmup=2, state=0):
    faults, health, runner_cls, stream_set = pkg
    inj = faults.FaultPlan([faults.FaultSpec(k, **kw) for k, kw in plan_specs]).replay()
    mon = health.HealthMonitor(warmup=warmup)
    d, u = _streams(stream_set)
    kw = {"device": "cpu"} if runner_cls is TRunner else {}
    runner = runner_cls(_double, [d], out_streams=[u], faults=inj, health=mon, **kw)
    if compiled:
        state = torch.tensor(0) if runner_cls is TRunner else np.int32(0)
    runner.run(state, compiled=compiled)
    return inj, mon, runner, u


J = (jfaults, jhealth, JRunner, JStreamSet)
# health codes computed from measured wall time
WALL_CLOCK = {"BSPS201", "BSPS202", "BSPS220", "BSPS221", "BSPS222"}
T = (tfaults, thealth, TRunner, TStreamSet)


def test_dma_stall_and_straggler_host_loop():
    specs = [("dma_stall", dict(at=(2,), delay_s=0.02)),
             ("straggler", dict(at=(3,), delay_s=0.02))]
    jinj, _, _, _ = _run(J, specs)
    inj, mon, runner, _ = _run(T, specs)
    assert tfaults.fault_signature(inj.trace) == jfaults.fault_signature(jinj.trace)
    assert ("dma_stall", 2) in {(r.kind, r.index) for r in inj.trace}
    # the stall gated the bulk sync: fetch wait dominated at least one step
    assert mon.counts_by_code().get("BSPS202", 0) >= 1
    # the straggler stretched step 3's wall time
    assert runner.records[3].step_seconds >= 0.02
    assert runner.lifetime_hypersteps == 8 and runner.lifetime_dispatches == 8


@pytest.mark.parametrize("compiled", [False, True])
def test_corrupt_trace_and_flag_equal_the_reference(compiled):
    specs = [("corrupt", dict(at=(5,), slot=0, mode="nan"))]
    jinj, jmon, _, ju = _run(J, specs, compiled=compiled)
    inj, mon, _, u = _run(T, specs, compiled=compiled)
    assert tfaults.fault_signature(inj.trace) == jfaults.fault_signature(jinj.trace)
    np.testing.assert_array_equal(np.isnan(u.data), np.isnan(np.asarray(ju.data)))
    assert np.isnan(u.data[5]).any()                  # the declared step
    # the SLO, fetch-wait and drift findings score each step's wall time, so
    # they depend on the host's load; the corruption finding does not
    codes = [(e.code, e.index, e.message) for e in mon.events if e.code not in WALL_CLOCK]
    assert codes == [(e.code, e.index, e.message) for e in jmon.events
                     if e.code not in WALL_CLOCK]
    assert codes[0][0] == "BSPS203"


def test_compiled_and_host_loop_traces_agree():
    specs = [("dma_stall", dict(at=(1, 6), delay_s=0.001)),
             ("corrupt", dict(at=(5,), slot=0, mode="nan"))]
    a, _, _, _ = _run(T, specs)
    b, _, _, _ = _run(T, specs, compiled=True)
    assert ({(r.kind, r.index) for r in a.trace} == {(r.kind, r.index) for r in b.trace})


@pytest.mark.parametrize("compiled", [False, True])
def test_dispatch_fail_raises_before_state_moves_then_retry_gives_the_reference(compiled):
    want = np.arange(32, dtype=np.float32).reshape(8, 4) * 2.0
    inj = tfaults.FaultPlan([tfaults.FaultSpec("dispatch_fail", at=(0,))]).replay()
    d, u = _streams(TStreamSet)
    runner = TRunner(_double, [d], out_streams=[u], faults=inj, device="cpu")
    state = torch.tensor(0) if compiled else 0
    with pytest.raises(tfaults.FaultInjected) as err:
        runner.run(state, compiled=compiled)
    assert err.value.record.kind == "dispatch_fail"
    assert runner.hypersteps_run == 0 and d.cursor == 0 and not u.data.any()
    out = runner.run(state, compiled=compiled)      # the retry consults index 1
    assert int(out) == 8 and runner.hypersteps_run == 8
    np.testing.assert_array_equal(u.data, want)
    jinj = jfaults.FaultPlan([jfaults.FaultSpec("dispatch_fail", at=(0,))]).replay()
    jd, ju = _streams(JStreamSet)
    jr = JRunner(_double, [jd], out_streams=[ju], faults=jinj)
    with pytest.raises(jfaults.FaultInjected):
        jr.run(0)
    jr.run(0)
    np.testing.assert_array_equal(u.data, np.asarray(ju.data))
    assert tfaults.fault_signature(inj.trace) == jfaults.fault_signature(jinj.trace)


# ------------------------------------------------------------ health events ----


class _Rec:
    def __init__(self, step, fetch_wait=0.0, compute=0.0):
        self.step_seconds = step
        self.fetch_wait_seconds = fetch_wait
        self.compute_seconds = compute


# measured seconds against a 1 s prediction: a warmup, a healthy stretch, two
# SLO violations, a sustained drift, its return, a fetch-bound record
SERIES = ([1.0, 1.3, 0.9] + [1.1] * 4 + [9.0, 0.05] + [3.5] * 5 + [1.0] * 5
          + [0.2] * 4)


def _events(health, series):
    mon = health.HealthMonitor(band=(0.25, 4.0), warmup=3, name="h", drift_window=4)
    for i, m in enumerate(series):
        mon.observe_record(_Rec(m, fetch_wait=2.0 if i == 6 else 0.0, compute=1.0), 1.0,
                           index=i)
    mon.rebaseline()
    for i, m in enumerate(series[:6]):
        mon.observe_record(_Rec(m), 0.5, index=100 + i)
    mon.check_output(np.array([1.0, np.nan]), index=7)
    mon.check_output(np.array([3, 70000], np.int32), lo=0, hi=512, index=8)
    mon.emit("BSPS207", "page pool exhausted", index=9)
    return mon


def test_health_events_equal_the_reference():
    want, got = _events(jhealth, SERIES), _events(thealth, SERIES)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert got.recalibrations == [thealth.RecalibrationEvent(*dataclasses.astuple(r))
                                  for r in want.recalibrations]
    assert got.rollup() == want.rollup()
    assert {"BSPS201", "BSPS202", "BSPS203", "BSPS207", "BSPS220"} <= set(got.counts_by_code())
    assert thealth.HEALTH_CODES == jhealth.HEALTH_CODES
    assert thealth.HEALTH_SEVERITY == jhealth.HEALTH_SEVERITY


def test_check_output_reads_tensors():
    mon = thealth.HealthMonitor()
    assert mon.check_output({"a": torch.ones(4), "b": [torch.arange(3)]}, lo=0, hi=3)
    assert not mon.check_output(torch.tensor([1.0, float("inf")]))
    assert not mon.check_output(torch.tensor([5], dtype=torch.int32), lo=0, hi=3)
    assert mon.check_output(torch.tensor([5], dtype=torch.int32))     # no range given
    assert [e.code for e in mon.events] == ["BSPS203", "BSPS203"]


# ------------------------------------------------------------------ engine ----


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's ops gain nothing from more, and
    several test processes sharing the cores must not oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def virtual_clock(monkeypatch):
    """The runner's clock made of its injected delays alone: ``sleep``
    advances it, compute takes no time."""
    from repro_torch.core import hyperstep

    now = [0.0]

    def sleep(d: float) -> None:
        now[0] += d

    monkeypatch.setattr(hyperstep, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0], sleep=sleep))
    return now


@pytest.fixture(scope="module")
def tiny():
    import jax

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro_torch.configs import get_config as t_config
    from repro_torch.models import model as TM

    jc = dataclasses.replace(j_config("minicpm-2b", smoke=True), num_layers=2,
                             dtype="float32")
    tc = dataclasses.replace(t_config("minicpm-2b", smoke=True), num_layers=2,
                             dtype="float32")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jc, jp, tc, TM.params_from_numpy(tc, tree, device="cpu")


def _engine(tc, tp, **kw):
    from repro_torch.launch.engine import ServeEngine

    base = dict(max_lanes=2, pool_seq=48, segment_len=4, machine=TPack(**PACK),
                calibstore=False, device="cpu")
    return ServeEngine(tc, tp, **{**base, **kw})


def test_engine_dispatch_retry_and_page_exhaustion_match_the_reference(tiny):
    """One dispatch failure and two page-pool exhaustions: the same trace,
    the same BSPS2xx codes and the same greedy tokens as the JAX engine, and
    the tokens of a clean run."""
    from repro.core.bsp import BSPAccelerator as JPack
    from repro.launch.engine import ServeEngine as JEngine

    jc, jp, tc, tp = tiny
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(3, 8, dtype=np.int32)]
    specs = [("dispatch_fail", dict(at=(1,))), ("page_exhaust", dict(at=(0,), count=2))]
    runs = []
    for faults, make in ((jfaults, lambda inj: JEngine(
            jc, jp, max_lanes=2, pool_seq=48, segment_len=4, machine=JPack(**PACK),
            calibstore=False, faults=inj, retry_backoff_s=0.0)),
                         (tfaults, lambda inj: _engine(tc, tp, faults=inj,
                                                       retry_backoff_s=0.0))):
        inj = faults.FaultPlan([faults.FaultSpec(k, **kw) for k, kw in specs]).replay()
        eng = make(inj)
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run_until_drained()
        runs.append(([out[r].tolist() for r in rids], faults.fault_signature(inj.trace),
                     [e.code for e in eng.health.events]))
    assert runs[1] == runs[0]
    clean = _engine(tc, tp)
    rids = [clean.submit(p, 8) for p in prompts]
    out = clean.run_until_drained()
    assert [out[r].tolist() for r in rids] == runs[1][0]
    assert runs[1][2].count("BSPS204") == 1 and runs[1][2].count("BSPS207") == 2
    assert "BSPS211" not in runs[1][2]


def test_engine_dispatch_retries_exhausted_raises(tiny):
    _, _, tc, tp = tiny
    inj = tfaults.FaultPlan([tfaults.FaultSpec("dispatch_fail", at=(0,), count=10)]).replay()
    eng = _engine(tc, tp, faults=inj, dispatch_retries=1, retry_backoff_s=0.0)
    eng.submit(np.arange(1, 5, dtype=np.int32), 4)
    with pytest.raises(tfaults.FaultInjected):
        eng.step_segment()
    codes = eng.health.counts_by_code()
    assert codes.get("BSPS204", 0) == 2 and codes.get("BSPS211", 0) == 1


def test_engine_deadline_expires_queued_and_running(tiny):
    _, _, tc, tp = tiny
    eng = _engine(tc, tp)
    r_dead = eng.submit(np.arange(1, 5, dtype=np.int32), 4, deadline_s=1e-9)
    r_slow = eng.submit(np.arange(1, 7, dtype=np.int32), 12)
    eng.step_segment()
    assert eng.finished[r_dead].timed_out and not eng.finished[r_dead].generated
    eng.running[r_slow].deadline_s = 1e-9
    eng.step_segment()
    assert eng.finished[r_slow].timed_out
    assert 0 < len(eng.finished[r_slow].generated) < 12
    assert eng.pool.free_lanes == eng.max_lanes
    assert eng.health.counts_by_code().get("BSPS205", 0) == 2


def test_engine_cancel_reclaims_lane_and_pages_immediately(tiny):
    _, _, tc, tp = tiny
    eng = _engine(tc, tp, max_lanes=1)
    ra = eng.submit(np.arange(1, 7, dtype=np.int32), 8)
    rb = eng.submit(np.arange(1, 5, dtype=np.int32), 4)
    eng.step_segment()
    assert ra in eng.running and rb not in eng.running
    assert eng.cancel(ra) and eng.finished[ra].cancelled
    assert eng.pool.free_lanes == 1
    assert eng.pool.table.free_pages == eng.pool.table.num_pages
    assert not eng.cancel(99)
    out = eng.run_until_drained()
    assert len(out[rb]) == 4 + 4
    assert eng.health.counts_by_code().get("BSPS206", 0) == 1


def test_engine_straggler_degrades_sheds_then_recovers(tiny, virtual_clock):
    _, _, tc, tp = tiny
    # on the virtual clock every hyperstep computes for 5 ms; segments 3 and
    # 4 (hypersteps 12..19) take 50 ms more per hyperstep, 11x the warmup
    # baseline, outside the SLO band's 10x
    inj = tfaults.FaultPlan([tfaults.FaultSpec("straggler", at=tuple(range(400)),
                                               delay_s=0.005),
                             tfaults.FaultSpec("straggler", at=tuple(range(12, 20)),
                                               delay_s=0.05)]).replay()
    eng = _engine(tc, tp, pool_seq=64, faults=inj, slo_band=(1e-3, 10.0))
    ra = eng.submit(np.arange(1, 7, dtype=np.int32), 36)
    for _ in range(20):
        eng.step_segment()
        if eng.degraded:
            break
    assert eng.degraded, eng.health.format_events()
    assert eng.health.counts_by_code().get("BSPS208", 0) == 1
    assert eng.stats()["machine_pack"] == "derated"
    rb = eng.submit(np.arange(1, 5, dtype=np.int32), 4)
    eng.step_segment()
    assert eng.running and rb not in eng.running          # shed while degraded
    out = eng.run_until_drained()
    assert not eng.degraded
    codes = eng.health.counts_by_code()
    assert codes.get("BSPS201", 0) == 2 and codes.get("BSPS209", 0) == 1
    assert len(out[ra]) == 6 + 36 and len(out[rb]) == 4 + 4


def test_engine_corruption_flagged_out_of_vocab(tiny):
    _, _, tc, tp = tiny
    inj = tfaults.FaultPlan([tfaults.FaultSpec("corrupt", at=(1,), slot=0,
                                               mode="bitflip")]).replay()
    eng = _engine(tc, tp, faults=inj)
    rid = eng.submit(np.arange(1, 7, dtype=np.int32), 4)
    out = eng.run_until_drained()
    assert eng.health.counts_by_code().get("BSPS203", 0) >= 1
    assert any(t >= tc.vocab_size for t in out[rid])
    assert [(r.kind, r.index) for r in inj.trace] == [("corrupt", 1)]


def test_engine_fault_trace_and_outputs_deterministic(tiny):
    _, _, tc, tp = tiny
    plan = tfaults.FaultPlan([tfaults.FaultSpec("dma_stall", rate=0.2, delay_s=0.001),
                              tfaults.FaultSpec("straggler", rate=0.2, delay_s=0.001),
                              tfaults.FaultSpec("corrupt", rate=0.1, mode="bitflip")],
                             seed=11, horizon=64)
    runs = []
    for _ in range(2):
        inj = plan.replay()
        eng = _engine(tc, tp, faults=inj)
        rids = [eng.submit(np.arange(1, 7, dtype=np.int32), 8),
                eng.submit(np.arange(1, 5, dtype=np.int32), 8)]
        out = eng.run_until_drained()
        runs.append((tfaults.fault_signature(inj.trace), [out[r].tolist() for r in rids]))
    assert runs[0] == runs[1]

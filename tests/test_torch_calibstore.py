"""The port's calibration store and (g, l, e) fitter against the JAX package's.

``fit_gle`` is the same numpy arithmetic in both packages: equal records give
equal floats. The band keys agree on the same plans, a JSONL file written by
either package is read by the other record for record, the runner records
its runs into the store, and the serve engine's drift → refit → re-price
loop runs on the CPU — driven by injected delays on a clock that counts them
alone, so that the host's timing cannot decide it.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.core import calibstore as jcs
from repro.core import plan as jplan
from repro.core.bsp import BSPAccelerator as JPack
from repro_torch.core import calibstore as tcs
from repro_torch.core import plan as tplan
from repro_torch.core.bsp import BSPAccelerator as TPack

PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")


def _raw_records(seed: int, n: int = 12, *, outliers: int = 2, g=0.5, l=3e4, e=4.0,
                 r=1e9) -> list[dict]:
    """Synthetic measured runs obeying the Eq. 1 shape, a few stalled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        flops = float(rng.uniform(1e2, 1e3))
        link = float(rng.uniform(1e5, 3e6))
        disp = int(rng.integers(2, 10))
        comm = float(rng.uniform(0, 1e4)) if seed % 2 else 0.0
        steps = float(rng.integers(1, 8)) if seed % 2 else 0.0
        true = (max(flops + g * comm + l * steps, e * link) + l * disp) / r
        true *= 1 + rng.normal(0, 0.001)
        stall = 6.0 if i < outliers else 1.0
        out.append(dict(
            fingerprint="test:kind:x1:float32", band=8, plan="synthetic",
            hypersteps=int(rng.integers(4, 64)), dispatches=disp, flops=flops,
            comm_words=comm, supersteps=steps, link_words=link,
            measured_seconds=true * stall,
            predicted_seconds=(max(flops, 1.2 * e * link) + 0.9 * l * disp) / r,
            r=r, faulty=i < outliers))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fit_gle_gives_equal_floats(seed):
    raw = _raw_records(seed)
    jp, tp = JPack(**PACK), TPack(**PACK)
    want = jcs.fit_gle([jcs.MeasurementRecord(**d) for d in raw], prior=jp)
    got = tcs.fit_gle([tcs.MeasurementRecord(**d) for d in raw], prior=tp)
    assert want is not None
    assert got.row() == want.row()
    # the refit pack swaps in (g, l, e) only, as the reference's does
    store_t, store_j = tcs.CalibrationStore(), jcs.CalibrationStore()
    for d in raw:
        store_t.add(tcs.MeasurementRecord(**d))
        store_j.add(jcs.MeasurementRecord(**d))
    assert dataclasses.asdict(store_t.refit_machine(tp, fingerprint=raw[0]["fingerprint"])) \
        == dataclasses.asdict(store_j.refit_machine(jp, fingerprint=raw[0]["fingerprint"]))
    assert tcs.fit_gle([tcs.MeasurementRecord(**d) for d in raw[:3]], prior=tp) is None


def _plans(k):
    plans = [k.packed_decode_plan(lanes=b, steps=8, flops_per_token=2e6, params_words=1e6,
                                  kv_words_per_lane=1e5) for b in (1, 3, 8)]
    plans.append(k.StreamPlan(
        name="x", grid=(16,),
        inputs=(k.TokenSpec(name="x", block_shape=(1024,), index_map=lambda h: (h,)),),
        outputs=(), flops_per_hyperstep=1.0))
    return plans


def test_band_keys_equal_the_reference():
    for w in (0, 1, 3, 4, 63, 64, 1e6, -5):
        assert tcs.band_for(w) == jcs.band_for(w)
    assert [tcs.plan_band(p) for p in _plans(tplan)] == \
        [jcs.plan_band(p) for p in _plans(jplan)]
    assert tcs.SCHEMA_VERSION == jcs.SCHEMA_VERSION == 1


def test_fingerprint_names_the_torch_device():
    fp = tcs.machine_fingerprint(device="cpu")
    assert fp == "cpu:cpu:x1:float32"
    assert tcs.machine_fingerprint("bfloat16", device="cpu").endswith(":bfloat16")
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0).replace(" ", "_")
        assert tcs.machine_fingerprint("bfloat16") == \
            f"cuda:{name}:x{torch.cuda.device_count()}:bfloat16"


def test_fingerprint_without_a_card_raises(monkeypatch):
    """No device and no card: the store keys nothing on the CPU by itself,
    as every other entry point of the port refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tcs.CalibrationStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.machine_fingerprint()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.refit_machine(TPack(**PACK), band=0)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_jsonl_round_trips_between_the_packages(tmp_path, writer):
    path = str(tmp_path / "calib.jsonl")
    raw = _raw_records(5, n=4)
    a, b = (jcs, tcs) if writer == "jax" else (tcs, jcs)
    store = a.CalibrationStore(path)
    for d in raw:
        store.add(a.MeasurementRecord(**d))
    assert store.io_error is None
    with open(path, "a") as f:            # a crashed appender's torn tail
        f.write('{"fingerprint": "torn')
    other = b.CalibrationStore(path)
    assert [dataclasses.asdict(r) for r in other.records()] == \
        [dataclasses.asdict(r) for r in store.records()]
    other.add(other.records()[0])         # heals the torn tail, stays JSONL
    with open(path) as f:
        good = sum(1 for line in f if line.strip().startswith("{")
                   and line.strip().endswith("}"))
    assert good == 5
    assert json.loads(open(path).readlines()[0])["schema"] == 1


def test_store_filters_and_summary():
    store = tcs.CalibrationStore()
    for band, fp in ((3, "a"), (3, "a"), (7, "a"), (3, "b")):
        store.add(tcs.MeasurementRecord(**{**_raw_records(0, n=1)[0], "band": band,
                                           "fingerprint": fp}))
    assert len(store.records(band=3)) == 3
    assert store.bands(fingerprint="a") == {3: 2, 7: 1}
    assert len(store.records(band=3, window=1)) == 1
    assert store.summary()["records"] == 4 and store.summary()["fingerprints"] == ["a", "b"]
    old = tcs.set_default_store(store)
    try:
        assert tcs.get_default_store() is store
    finally:
        tcs.set_default_store(old)


def test_runner_records_runs_into_the_store():
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.core.hyperstep import HyperstepRunner
    from repro_torch.core.plan import host_plan
    from repro_torch.core.stream import StreamSet

    acc = TPack(**PACK)
    store = tcs.CalibrationStore()
    data = np.arange(8 * 16, dtype=np.float32)
    for compiled, faults in ((False, None), (True, None), (False, FaultPlan(
            [FaultSpec("dma_stall", at=(2,), delay_s=0.001)]).replay())):
        s = StreamSet().create(data, 8)
        plan = host_plan([s], flops_per_hyperstep=1e4, name="unit")
        runner = HyperstepRunner(lambda a, t: a + t[0].sum(), [s], plan=plan, machine=acc,
                                 prefetch=False, calibstore=store, faults=faults,
                                 device="cpu")
        runner.run(torch.zeros(()), compiled=compiled)
        rec = store.records()[-1]
        assert rec.band == tcs.plan_band(plan)
        assert rec.fingerprint == tcs.machine_fingerprint(device="cpu")
        assert rec.hypersteps == plan.num_hypersteps == 16
        assert rec.dispatches == (1 if compiled else 16)
        assert rec.measured_seconds > 0 and rec.predicted_seconds > 0
        assert rec.faulty == (faults is not None)
    assert len(store) == 3
    # calibstore=False disables recording
    s = StreamSet().create(data, 8)
    HyperstepRunner(lambda a, t: a, [s], plan=host_plan([s], flops_per_hyperstep=1.0),
                    machine=acc, calibstore=False, device="cpu").run(0.0)
    assert len(store) == 3


def test_enumerate_plans_prices_on_the_store_refit():
    def build(k, block):
        return k.StreamPlan(
            name=f"cand_{block}", grid=(16,),
            inputs=(k.TokenSpec(name="x", block_shape=(int(block),),
                                index_map=lambda h: (h,)),),
            outputs=(), flops_per_hyperstep=float(block) * 100)

    fp = tcs.machine_fingerprint(device="cpu")
    band = tcs.plan_band(build(tplan, 1024))
    raw = [dict(d, fingerprint=fp, band=band, faulty=False)
           for d in _raw_records(1, n=8, outliers=0, g=0.0, l=PACK["l"], e=400.0)]
    rows = []
    for k, cs, pack, kw in ((jplan, jcs, JPack(**PACK), {}),
                            (tplan, tcs, TPack(**PACK), {"device": "cpu"})):
        store = cs.CalibrationStore()
        for d in raw:
            store.add(cs.MeasurementRecord(**d))
        choices = k.enumerate_plans(lambda block, k=k: build(k, block),
                                    [{"block": 1024}, {"block": 4}], pack, store=store,
                                    **kw)
        rows.append([(c.params["block"], c.priced_on, c.predicted_seconds) for c in choices])
    by_block = {r[0]: r for r in rows[1]}
    assert by_block[4][1] == "eq1"                     # no records for that band
    plain = tplan.enumerate_plans(lambda block: build(tplan, block), [{"block": 1024}],
                                  TPack(**PACK))[0]
    assert plain.priced_on == "eq1"
    if fp == jcs.machine_fingerprint():
        assert rows[1] == rows[0]
    assert by_block[1024][1] == "measured"
    assert by_block[1024][2] > plain.predicted_seconds


# --------------------------------------------- drift -> refit -> re-price ----


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
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  JM.init_params(jc, jax.random.PRNGKey(0)))
    return tc, TM.params_from_numpy(tc, tree, device="cpu")


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
    advances it, compute takes no time. The drill's walls are then exactly
    the delays its FaultPlan declares, however loaded the host is."""
    from repro_torch.core import hyperstep

    now = [0.0]

    def sleep(d: float) -> None:
        now[0] += d

    monkeypatch.setattr(hyperstep, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0], sleep=sleep))
    return now


# The drill's geometry. Every hyperstep computes for 5 ms (an injected
# straggler at every step on the virtual clock); from segment 4 on a stall of
# 20 ms more lands on each hyperstep, on the DMA lane or on the compute. A
# refit (g, l, e) explains a stalled segment's wall through the record's link
# words — the resident params plus every arrival of the KV stream — while the
# runner's exact Eq. 1 price charges the KV arrivals after the first only
# (hyperstep 0's tokens are resident at program start). With 128-token
# prompts and 8-step segments the KV stream outweighs the params, so the
# refit pack prices a stalled segment inside [0.5, 2] from the first segment
# it prices (see ROADMAP.md, Queue 3).
SEG, PROMPT, NEW, BASE_S, STALL_S = 8, 128, 80, 0.005, 0.02


@pytest.mark.parametrize("kind", ["dma_stall", "straggler"])
def test_engine_drift_refit_reprice(tiny, virtual_clock, kind):
    """Segments 0-3 clean, 4 on stalled: BSPS220 fires, the store's refit is
    adopted (BSPS221) and brings predicted/measured back into [0.5, 2] where
    the calibrated pack stays outside. A stalled DMA lane (``fetch_delay``)
    is link time, and the refit pack's re-priced verdict is the measured
    one; a straggling compute (``compute_delay``) is priced by the refit on
    the link as well (the fitter blames the link first), so its re-priced
    verdict is not held to the measured one."""
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.launch.engine import ServeEngine

    tc, tp = tiny
    faults = FaultPlan([FaultSpec("straggler", at=tuple(range(400)), delay_s=BASE_S),
                        FaultSpec(kind, at=tuple(range(4 * SEG, 400)),
                                  delay_s=STALL_S)]).replay()
    store = tcs.CalibrationStore()
    eng = ServeEngine(tc, tp, max_lanes=2, pool_seq=256, segment_len=SEG,
                      machine=TPack(**PACK), faults=faults, calibstore=store,
                      device="cpu")
    rng = np.random.default_rng(3)
    for i in range(2):
        eng.submit(rng.integers(0, tc.vocab_size, PROMPT), NEW, seed=i)
    eng.run_until_drained()

    codes = eng.health.rollup()["count_by_code"]
    assert codes.get("BSPS220", 0) == 1, eng.health.format_events()
    assert codes.get("BSPS221", 0) == 1, eng.health.format_events()
    assert eng.active_machine is not eng.machine
    assert eng.stats()["machine_pack"] == "refit"

    recs = store.records()
    n = NEW // SEG
    assert len(recs) == n
    walls = [r.measured_seconds for r in recs]
    assert walls == pytest.approx([SEG * BASE_S] * 4 + [SEG * (BASE_S + STALL_S)] * (n - 4))
    ratios = [r.predicted_seconds / r.measured_seconds for r in recs]
    refit_at = next(i for i in range(4, n) if 0.5 <= ratios[i] <= 2.0)
    pre, post = ratios[4:refit_at], ratios[refit_at:]
    assert pre and all(not (0.5 <= x <= 2.0) for x in pre), ratios
    assert len(post) >= 2 and all(0.5 <= x <= 2.0 for x in post), ratios

    repriced = [a for a in eng.admission_log if a["repriced"]]
    assert repriced and all(a["machine_pack"] == "refit" for a in repriced)
    if kind == "dma_stall":
        assert all(a["measured_verdict"] == a["verdict"] for a in repriced), repriced


def test_engine_without_evidence_emits_bsps222(tiny, virtual_clock):
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.launch.engine import ServeEngine

    tc, tp = tiny
    faults = FaultPlan([FaultSpec("straggler", at=tuple(range(200)), delay_s=BASE_S),
                        FaultSpec("dma_stall", at=tuple(range(12, 200)),
                                  delay_s=STALL_S)]).replay()
    eng = ServeEngine(tc, tp, max_lanes=2, pool_seq=64, segment_len=4,
                      machine=TPack(**PACK), faults=faults, calibstore=False,
                      device="cpu")
    eng.submit(np.full(4, 7, np.int32), 32)
    eng.run_until_drained()
    codes = eng.health.rollup()["count_by_code"]
    assert codes.get("BSPS220", 0) >= 1 and codes.get("BSPS222", 0) >= 1
    assert codes.get("BSPS221", 0) == 0
    assert eng.active_machine is eng.machine


def test_engine_drift_refit_at_the_reference_geometry(tiny, virtual_clock):
    """The reference drill's geometry (``tests/test_calibstore.py::
    test_engine_drift_refit_reprice``: 2 lanes, a 96-position pool, 4-step
    segments, two 4-token prompts of 64 new tokens, a 10 ms DMA stall on
    every hyperstep from segment 4 on), where the KV stream is small beside
    the params. The refit regresses a stalled segment's wall on link words
    that hold the resident params and all S KV arrivals, while Eq. 1 charges
    S - 1 of them, so the refit pack prices the next stalled segment at
    (S-1)·kv / (params + S·kv) of its wall — about 0.34, outside [0.5, 2]:
    the defect the port shares with the reference (ROADMAP Queue 3). The
    virtual clock gives each hyperstep 0.1 ms of compute (a clean segment's
    wall must not be 0), far below the stall."""
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.launch.engine import ServeEngine

    tc, tp = tiny
    seg, lanes, stall = 4, 2, 0.01
    faults = FaultPlan([FaultSpec("straggler", at=tuple(range(400)), delay_s=1e-4),
                        FaultSpec("dma_stall", at=tuple(range(4 * seg, 400)),
                                  delay_s=stall)]).replay()
    store = tcs.CalibrationStore()
    eng = ServeEngine(tc, tp, max_lanes=lanes, pool_seq=96, segment_len=seg,
                      machine=TPack(**PACK), faults=faults, calibstore=store,
                      device="cpu")
    for i in range(2):
        eng.submit(np.full(4, 7, np.int32), 64, seed=i)
    eng.run_until_drained()
    codes = eng.health.rollup()["count_by_code"]
    assert codes.get("BSPS220", 0) == 1 and codes.get("BSPS221", 0) == 1, codes
    assert eng.stats()["machine_pack"] == "refit"

    recs = store.records()
    ratios = [r.predicted_seconds / r.measured_seconds for r in recs]
    # the refit is adopted at the first segment whose ratio it moved
    refit_at = next(i for i in range(5, len(recs)) if ratios[i] > 3 * ratios[i - 1])
    params = eng._param_words

    def kv(rec):            # KV words per hyperstep: link words less params and ids up
        return (rec.link_words - params - seg * lanes) / seg

    fitted = float(np.mean([kv(r) for r in recs[4:refit_at]]))
    want = (seg - 1) * kv(recs[refit_at]) / (params + seg * fitted)
    assert 0.30 < want < 0.38
    assert ratios[refit_at] == pytest.approx(want, rel=0.02), (ratios, want)
    assert not 0.5 <= ratios[refit_at] <= 2.0, ratios

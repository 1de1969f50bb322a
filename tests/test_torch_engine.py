"""The port's continuous-batching serve engine against the JAX package's.

On the tiny 2-layer fp32 minicpm cut that the JAX engine tests use, with the
JAX init's weights carried across through numpy: the packed lanes give the
JAX engine's greedy tokens and the port's batch-1 ``generate`` tokens,
requests straddle segments and lanes recycle (a reused lane's stale rows
stay hidden), page pressure defers and recovers, admission prices the same
packs to the same verdicts and floats, and recurrent stacks are refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core.bsp import BSPAccelerator as JPack
from repro_torch.core import plan as tplan
from repro_torch.core.bsp import BSPAccelerator as TPack

# the JAX engine tests' fixed pack: no calibration in tests, compute-bound
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's ops gain nothing from more, and
    several test processes sharing the cores must not oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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

    base = dict(max_lanes=4, pool_seq=48, segment_len=4, machine=TPack(**PACK),
                calibstore=False, device="cpu")
    return ServeEngine(tc, tp, **{**base, **kw})


def _generate(tc, tp, prompt, steps, max_len):
    from repro_torch.launch.serve import generate

    out, _ = generate(tc, tp, prompt[None, :], steps=steps, machine=TPack(**PACK),
                      max_len=max_len, device="cpu")
    return out[0].numpy()


def _log_rows(log):
    """The admission log without the measured verdict (a timing)."""
    return [{k: v for k, v in row.items() if k != "measured_verdict"} for row in log]


def test_packed_batch_matches_the_reference_engine_and_generate(tiny):
    """Three requests of mixed prompt lengths over four lanes: each packed
    lane gives the JAX engine's tokens and its own batch-1 ``generate``
    tokens (the batch-1 cache padded to the pool's geometry), and both
    engines log the same admissions."""
    from repro.launch.engine import ServeEngine as JEngine

    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab_size, size=s).astype(np.int32) for s in (5, 9, 13)]

    jeng = JEngine(jc, jp, max_lanes=4, pool_seq=48, segment_len=4, machine=JPack(**PACK),
                   calibstore=False)
    eng = _engine(tc, tp)
    for e in (jeng, eng):
        for i, p in enumerate(prompts):
            e.submit(p, 8, seed=i)
    want, got = jeng.run_until_drained(), eng.run_until_drained()
    assert sorted(got) == sorted(want)
    for rid, p in enumerate(prompts):
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")
        np.testing.assert_array_equal(got[rid], _generate(tc, tp, p, 8, 48))
    assert _log_rows(eng.admission_log) == _log_rows(jeng.admission_log)

    stats = eng.stats()
    assert stats["requests"] == 3 and stats["tokens"] == 3 * 8
    assert stats["segments"] == jeng.stats()["segments"] == 2
    assert stats["tokens_per_s"] > 0
    assert stats["latency_p99_s"] >= stats["latency_p50_s"] > 0
    assert stats["health"]["count_by_code"] == {}


def test_requests_straddle_segments_and_lanes_recycle(tiny):
    """A late request joins at a boundary into the lane a retired request
    left, over its stale rows (retiring resets ``len``, not the rows): its
    tokens are its batch-1 tokens."""
    _, _, tc, tp = tiny
    rng = np.random.default_rng(1)
    eng = _engine(tc, tp, max_lanes=2)
    p0, p1, p2 = (rng.integers(0, tc.vocab_size, size=s).astype(np.int32) for s in (6, 4, 8))
    r0 = eng.submit(p0, 8)          # 2 segments
    r1 = eng.submit(p1, 4)          # 1 segment -> frees its lane first
    r2 = eng.submit(p2, 6)          # waits for a lane, then straddles two segments
    out = eng.run_until_drained()

    assert set(out) == {r0, r1, r2}
    assert eng.finished[r2].lane == eng.finished[r1].lane   # the retired lane, reused
    assert eng.finished[r2].join_time > eng.finished[r1].done_time
    for rid, p in ((r0, p0), (r1, p1), (r2, p2)):
        steps = eng.finished[rid].max_new_tokens
        np.testing.assert_array_equal(out[rid], _generate(tc, tp, p, steps, 48))
    # the table handed a page of the retired request to the new one
    reused = {p for p, r in eng.pool.table.history if r == r2}
    assert reused & {p for p, r in eng.pool.table.history if r == r1}


def test_block_table_pages_reused_across_requests():
    from repro.launch.engine import BlockTable as JTable
    from repro_torch.launch.engine import BlockTable

    tables = [BlockTable(num_pages=4, page_tokens=8), JTable(num_pages=4, page_tokens=8)]
    trails = []
    for bt in tables:
        assert bt.pages_for(1) == 1 and bt.pages_for(8) == 1 and bt.pages_for(9) == 2
        a = bt.alloc(rid=1, tokens=17)
        assert a is not None and len(a) == 3 and bt.free_pages == 1
        assert bt.alloc(rid=2, tokens=16) is None and bt.free_pages == 1
        assert bt.free(1) == 3
        b = bt.alloc(rid=2, tokens=16)
        assert set(b) <= set(a)                  # same physical pages, new rid
        trails.append(bt.history)
    assert trails[0] == trails[1]
    with pytest.raises(ValueError):
        BlockTable(0, 8)


def test_engine_page_pressure_defers_and_recovers(tiny):
    """Oversubscribed pool: admission refuses on pages with a lane free, then
    admits once a retirement returns pages — and the tokens are unchanged."""
    _, _, tc, tp = tiny
    rng = np.random.default_rng(2)
    eng = _engine(tc, tp, pool_seq=32, segment_len=8, page_tokens=8, num_pages=5)
    prompts = [rng.integers(0, tc.vocab_size, size=8).astype(np.int32) for _ in range(3)]
    rids = [eng.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
    out = eng.run_until_drained()

    joins = [eng.finished[r].join_time for r in rids]
    assert joins[2] > max(joins[:2])
    assert eng.stats()["mean_occupancy"] < 3
    assert eng.health.counts_by_code() == {"BSPS207": 1}     # deferred once
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[rid], _generate(tc, tp, p, 8, 32))


def _plan(k, lanes, params_words=1e6):
    return k.packed_decode_plan(lanes=lanes, steps=8, flops_per_token=2e6,
                                params_words=params_words, kv_words_per_lane=1e5)


# (pack overrides, params words, current lanes, candidate lanes): the
# reference's three regimes — the admission that tips a compute-bound batch,
# an already link-bound batch that keeps admitting while batching pays, a
# saturated link — and an idle engine
ADMISSIONS = {
    "admits_below_the_boundary": (dict(e=25.0, l=5e6), 1e6, 2, 3),
    "refuses_the_tipping_lane": (dict(e=25.0, l=5e6), 1e6, 3, 4),
    "link_bound_keeps_admitting": (dict(e=16.0, l=1e6), 2e6, 2, 3),
    "saturated_link_stops": (dict(e=50.0, l=0.0), 1e6, 2, 3),
    "idle_always_admits": (dict(e=50.0, l=0.0), 1e6, None, 1),
}


@pytest.mark.parametrize("case", list(ADMISSIONS))
def test_admission_decision_equals_the_reference(case):
    over, params_words, cur, cand = ADMISSIONS[case]
    rows = []
    for k, pack in ((jplan, JPack), (tplan, TPack)):
        acc = pack(**{**PACK, **over})
        dec = k.admission_decision(
            None if cur is None else _plan(k, cur, params_words),
            _plan(k, cand, params_words), acc, tokens_per_hyperstep=cand)
        rows.append(dec.row())
    assert rows[1] == rows[0]
    expect_admit = case != "refuses_the_tipping_lane" and case != "saturated_link_stops"
    assert rows[1]["admit"] == expect_admit


def test_packed_decode_plans_price_alike():
    for lanes in (1, 2, 4, 8):
        j, t = _plan(jplan, lanes), _plan(tplan, lanes)
        for pack in (dict(), dict(e=25.0, l=5e6)):
            jacc, tacc = JPack(**{**PACK, **pack}), TPack(**{**PACK, **pack})
            assert t.predicted_seconds(tacc) == j.predicted_seconds(jacc)
            assert t.bandwidth_heavy(tacc) == j.bandwidth_heavy(jacc)
        assert t.vmem_bytes == j.vmem_bytes and t.fingerprint() == j.fingerprint()
        ts, js = t.compiled_schedule(), j.compiled_schedule()
        for a, b in zip(dataclasses.astuple(ts), dataclasses.astuple(js)):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(x, y)
    scratch = tplan.batched_scratch("kv_pool", 1024, 8)
    assert scratch.shape == (8, 1024) and scratch.nbytes == \
        jplan.batched_scratch("kv_pool", 1024, 8).nbytes
    with pytest.raises(ValueError):
        tplan.batched_scratch("kv_pool", 1023, 8, dtype=torch.int32)


def test_engine_logs_admissions_with_measured_verdicts(tiny):
    _, _, tc, tp = tiny
    eng = _engine(tc, tp, max_lanes=2, pool_seq=32)
    eng.submit(np.arange(4, dtype=np.int32), 4)
    eng.submit(np.arange(6, dtype=np.int32), 4)
    eng.run_until_drained()
    assert len(eng.admission_log) >= 2
    for entry in eng.admission_log:
        assert entry["verdict"] in ("compute_bound", "bandwidth_heavy")
        assert entry["measured_verdict"] in ("compute_bound", "bandwidth_heavy")
    assert any(e["measured_verdict"] == e["verdict"] for e in eng.admission_log)


def test_sampled_lanes_repeat_under_their_seeds_and_ignore_their_neighbours(tiny):
    """Each lane samples from its own generator, seeded by its request: the
    same request gives the same tokens whatever shares the batch with it."""
    _, _, tc, tp = tiny
    p = np.arange(1, 6, dtype=np.int32)
    outs = []
    for others in ([], [np.arange(7, 16, dtype=np.int32)]):
        eng = _engine(tc, tp, temperature=1.0)
        for q in others:
            eng.submit(q, 8, seed=5)
        rid = eng.submit(p, 8, seed=3)
        outs.append(eng.run_until_drained()[rid])
    np.testing.assert_array_equal(outs[0], outs[1])
    eng = _engine(tc, tp, temperature=1.0)
    rid = eng.submit(p, 8, seed=4)
    assert not np.array_equal(eng.run_until_drained()[rid], outs[0])


def test_engine_rejects_recurrent_stacks_and_bad_geometry(tiny):
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import model as M

    cfg = get_config("jamba-v0.1-52b", smoke=True)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(cfg, params, machine=TPack(**PACK), device="cpu")
    _, _, tc, tp = tiny
    with pytest.raises(ValueError, match="pool_seq"):
        _engine(tc, tp, pool_seq=2)
    eng = _engine(tc, tp)
    with pytest.raises(ValueError, match="pool_seq"):
        eng.submit(np.arange(40, dtype=np.int32), 16)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.zeros(0, np.int32), 4)


def test_engine_needs_a_named_device_without_a_card(tiny, monkeypatch):
    from repro_torch.launch.engine import ServeEngine

    _, _, tc, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tc, tp, machine=TPack(**PACK))

"""The port's data pipeline and pytree tokens in its runner, against the JAX
package's, on the CPU.

Batches are made in numpy on both sides, so they must be equal element for
element (synthetic source and uint32 token file alike). The runner carries
dict and tuple tokens in both execution modes: the same stream through the
reference's ``HyperstepRunner`` and the port's gives equal records (word
counts and ``fetch_words_*`` exactly) and the same outputs — the step sums
int32 tokens (exact) and the float32 out-stream holds those sums, so every
value is compared for equality too.
"""

import numpy as np
import pytest
import torch

from repro.core.bsp import BSPAccelerator as JPack
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.faults import FaultSpec as JFaultSpec
from repro.core.faults import fault_signature as jsignature
from repro.core.health import HealthMonitor as JHealth
from repro.core.hyperstep import HyperstepRunner as JRunner
from repro.core.plan import host_plan as jhost_plan
from repro.core.stream import Stream as JStream
from repro.data import pipeline as jdata
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.core.faults import FaultInjected, FaultPlan, FaultSpec, fault_signature
from repro_torch.core.health import HealthMonitor
from repro_torch.core.hyperstep import HyperstepRunner as TRunner
from repro_torch.core.plan import host_plan
from repro_torch.core.stream import Stream
from repro_torch.data.pipeline import (
    BatchStream,
    DataConfig,
    DataSourceError,
    Prefetcher,
    TokenStream,
)

# a fixed pack for pricing: no calibration in tests
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")


def _pair(**kw):
    return jdata.DataConfig(**kw), DataConfig(**kw)


# ------------------------------------------------------------ the batches ----


@pytest.mark.parametrize("seed,host_index,host_count", [(0, 0, 1), (7, 1, 2), (3, 2, 3)])
def test_synthetic_batches_equal_the_reference(seed, host_index, host_count):
    jc, tc = _pair(vocab_size=1000, seq_len=24, global_batch=3, seed=seed,
                   host_index=host_index, host_count=host_count)
    js, ts = jdata.TokenStream(jc), TokenStream(tc)
    for _ in range(5):
        jb, tb = js.next_batch(), ts.next_batch()
        assert tb.keys() == jb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])
        assert ts.cursor == js.cursor
    assert ts.state_dict() == js.state_dict()
    assert ts.state_at(4) == js.state_at(4)


def test_memmap_batches_equal_the_reference(tmp_path):
    path = str(tmp_path / "tokens.u32")
    # ids past the vocab wrap (mod vocab) on both sides; 2.5 batches of
    # tokens, so the stream wraps around the file after 2
    rng = np.random.default_rng(5)
    rng.integers(0, 1 << 32, 2 * 4 * 17 + 40, dtype=np.uint64).astype(np.uint32).tofile(path)
    jc, tc = _pair(vocab_size=300, seq_len=16, global_batch=4, source=path)
    js, ts = jdata.TokenStream(jc), TokenStream(tc)
    got = [ts.next_batch() for _ in range(5)]
    want = [js.next_batch() for _ in range(5)]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(got[0]["tokens"], got[2]["tokens"])   # wrapped
    assert got[0]["tokens"].max() < 300


def test_memmap_too_small_for_one_batch_raises(tmp_path):
    path = str(tmp_path / "tiny.u32")
    np.arange(10, dtype=np.uint32).tofile(path)
    with pytest.raises(ValueError, match="too small"):
        TokenStream(DataConfig(vocab_size=50, seq_len=8, global_batch=2, source=path))


def test_token_stream_deterministic_and_seekable():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2, seed=7)
    s1, s2 = TokenStream(cfg), TokenStream(cfg)
    b1, b2 = s1.next_batch(), s2.next_batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    # seek reproduces exactly (checkpoint-restart invariant)
    s1.next_batch()
    state = s1.state_dict()
    b3 = s1.next_batch()
    s2.load_state_dict(state)
    np.testing.assert_array_equal(s2.next_batch()["tokens"], b3["tokens"])


def test_host_sharded_streams_are_disjoint():
    mk = lambda h: TokenStream(DataConfig(vocab_size=50, seq_len=8, global_batch=1,
                                          host_index=h, host_count=2))
    a, b = mk(0), mk(1)
    assert not np.array_equal(a.next_batch()["tokens"], b.next_batch()["tokens"])
    assert (a.cursor, b.cursor) == (2, 3)


def test_prefetcher_preserves_order_and_content():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2, seed=3)
    direct = TokenStream(cfg)
    pre = Prefetcher(TokenStream(cfg), depth=2)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(pre.get()["tokens"],
                                          direct.next_batch()["tokens"])
    finally:
        pre.close()


def test_start_prefetch_keeps_order_and_seek_flushes_the_lookahead():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2, seed=4)
    want = [TokenStream(cfg)._make(i)["tokens"] for i in range(8)]
    ts = TokenStream(cfg)
    ts.start_prefetch(3)
    try:
        assert ts.prefetch_depth == 3
        for i in range(3):
            np.testing.assert_array_equal(ts.next_batch()["tokens"], want[i])
        ts.seek(6)                   # the producer had run past 6: restarted
        assert ts.prefetch_depth == 3
        np.testing.assert_array_equal(ts.next_batch()["tokens"], want[6])
        assert ts.cursor == 7
    finally:
        ts.stop_prefetch()
    assert ts.prefetch_depth == 0


# ------------------------------------------------------ faults and retries ----


def _plans(specs):
    return (JFaultPlan([JFaultSpec(k, **kw) for k, kw in specs]).replay(),
            FaultPlan([FaultSpec(k, **kw) for k, kw in specs]).replay())


def test_data_retry_recovers_and_matches_clean_stream():
    kw = dict(vocab_size=64, seq_len=8, global_batch=2, seed=3, read_retries=2,
              retry_backoff_s=0.0)
    jc, tc = _pair(**kw)
    clean = TokenStream(tc)
    want = [clean.next_batch() for _ in range(4)]
    jinj, inj = _plans([("data_error", dict(at=(1,), count=1))])
    jmon, mon = JHealth(), HealthMonitor()
    js = jdata.TokenStream(jc, faults=jinj, health=jmon)
    ds = TokenStream(tc, faults=inj, health=mon)
    got = [ds.next_batch() for _ in range(4)]
    for _ in range(4):
        js.next_batch()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w["tokens"], g["tokens"])
    assert mon.counts_by_code() == jmon.counts_by_code() == {"BSPS210": 1}
    assert [(r.kind, r.index) for r in inj.trace] == [("data_error", 1)]
    assert fault_signature(inj.trace) == jsignature(jinj.trace)
    assert ds.retry_log == js.retry_log == [(1, 0)]


def test_data_retries_exhausted_surface_batch_index():
    dcfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=3,
                      read_retries=1, retry_backoff_s=0.0)
    inj = FaultPlan([FaultSpec("data_error", at=(2,), count=5)]).replay()
    mon = HealthMonitor()
    ds = TokenStream(dcfg, faults=inj, health=mon)
    with pytest.raises(DataSourceError) as ei:
        for _ in range(4):
            ds.next_batch()
    assert ei.value.batch_index == 2
    assert isinstance(ei.value.cause, FaultInjected)
    assert mon.counts_by_code() == {"BSPS210": 2, "BSPS211": 1}


def test_prefetch_thread_surfaces_error_instead_of_hanging():
    dcfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=3,
                      read_retries=0, retry_backoff_s=0.0)
    inj = FaultPlan([FaultSpec("data_error", at=(3,), count=5)]).replay()
    ds = TokenStream(dcfg, faults=inj)
    ds.start_prefetch(2)
    got = [ds.next_batch() for _ in range(3)]          # 0, 1, 2 arrive clean
    assert len(got) == 3
    with pytest.raises(DataSourceError) as ei:
        ds.next_batch()                                # 3 is the poisoned one
    assert ei.value.batch_index == 3
    ds.stop_prefetch()                                 # joins; must not hang
    assert not ds._producer


def test_prefetcher_wraps_a_source_error_with_its_index():
    dcfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=3,
                      read_retries=0, retry_backoff_s=0.0)
    inj = FaultPlan([FaultSpec("data_error", at=(1,), count=5)]).replay()
    pre = Prefetcher(TokenStream(dcfg, faults=inj), depth=2)
    try:
        pre.get()
        with pytest.raises(DataSourceError) as ei:
            pre.get()
        assert ei.value.batch_index == 1
    finally:
        pre.close()


# ------------------------------------------------------------ BatchStream ----


def test_batch_stream_window_equals_the_reference_and_move_down():
    jc, tc = _pair(vocab_size=500, seq_len=12, global_batch=2, seed=9,
                   host_index=1, host_count=2)
    jts, tts = jdata.TokenStream(jc), TokenStream(tc)
    jts.next_batch()
    tts.next_batch()                    # the window starts mid-stream
    jb, tb = jdata.BatchStream(jts, 4), BatchStream(tts, 4)
    want = jb.as_stacked()
    got = tb.as_stacked("cpu")
    for k in want:
        assert got[k].dtype == torch.int32 and tuple(got[k].shape) == (4, 2, 12)
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert tts.cursor == 3              # staging did not move the durable cursor
    tb.open(0)
    for i in range(4):
        np.testing.assert_array_equal(tb.move_down(0)["tokens"], want["tokens"][i])
    with pytest.raises(IndexError):
        tb.move_down(0)
    tb.seek(0, -2)
    assert (tb.cursor, tts.cursor) == (2, 7)
    tb.close(0)
    assert tb.cursor == 0 and tts.cursor == 7
    for name in ("num_tokens", "token_shape", "token_words"):
        assert getattr(tb, name) == getattr(jb, name)
    assert np.dtype(tb.dtype) == np.dtype(jb.dtype)


class _TupleStream:
    """(ids, scale) pair tokens off two backings, for both runners."""

    token_size = 1
    name = "pairs"
    stream_id = 0

    def __init__(self, ids, scale):
        self.ids, self.scale = ids, scale
        self._cursor = 0

    def open(self, core):
        return 1

    def close(self, core):
        self._cursor = 0

    def move_down(self, core):
        i = self._cursor
        self._cursor += 1
        return (self.ids[i], self.scale[i])

    def seek(self, core, delta):
        self._cursor += delta

    def as_stacked(self, device=None):
        if device is None:
            return (self.ids, self.scale)
        return (torch.from_numpy(self.ids).to(device), torch.from_numpy(self.scale).to(device))

    cursor = property(lambda self: self._cursor)
    num_tokens = property(lambda self: self.ids.shape[0])
    token_shape = property(lambda self: (1, 2) + self.ids.shape[1:])
    dtype = property(lambda self: self.ids.dtype)
    token_words = property(lambda self: 2 * int(np.prod(self.ids.shape[1:])))


def _records(runner):
    return [(r.index, r.fetch_words, r.initial_fetch_words, r.writeback_words)
            for r in runner.records]


def _check_pair(jr, tr, jout, tout):
    assert _records(tr) == _records(jr)
    jrow, trow = jr.predicted_vs_measured(), tr.predicted_vs_measured()
    for k in ("fetch_words_planned", "fetch_words_measured", "bandwidth_heavy_predicted"):
        assert trow[k] == jrow[k], k
    assert trow["fetch_words_planned"] == trow["fetch_words_measured"]
    assert trow["predicted_seconds"] == pytest.approx(jrow["predicted_seconds"], rel=1e-12)
    np.testing.assert_array_equal(np.asarray(tout), np.asarray(jout))


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("rate", [1, 2])
def test_runner_carries_dict_tokens_like_the_reference(compiled, rate):
    """A BatchStream's {"tokens", "labels"} tokens, rate 1 and rate 2 (two
    batches merged leaf by leaf), with a metrics up-stream: the port's
    runner against the reference's, in both modes."""
    jc, tc = _pair(vocab_size=97, seq_len=6, global_batch=2, seed=2)
    n = 6
    jts, tts = jdata.TokenStream(jc), TokenStream(tc)
    jb, tb = jdata.BatchStream(jts, n), BatchStream(tts, n)
    jout = JStream(data=np.zeros((n // rate, 2), np.float32), token_size=1, name="out")
    tout = Stream(data=np.zeros((n // rate, 2), np.float32), token_size=1, name="out")

    def jstep(acc, toks):
        import jax.numpy as jnp
        b = toks[0]
        s = jnp.sum(b["tokens"]) - 2 * jnp.sum(b["labels"][:, -1])
        return acc + s, [jnp.stack([s, jnp.max(b["labels"])]).astype(jnp.float32)]

    def tstep(acc, toks):
        b = toks[0]
        s = torch.sum(b["tokens"]) - 2 * torch.sum(b["labels"][:, -1])
        return acc + s, [torch.stack([s, torch.max(b["labels"])]).float()]

    jplan = jhost_plan([jb], rates=[rate], out_streams=[jout], flops_per_hyperstep=1e6,
                       name="dict")
    tplan = host_plan([tb], rates=[rate], out_streams=[tout], flops_per_hyperstep=1e6,
                      name="dict")
    jr = JRunner(jstep, [jb], rates=[rate], out_streams=[jout], plan=jplan,
                 machine=JPack(**PACK), calibstore=False)
    tr = TRunner(tstep, [tb], rates=[rate], out_streams=[tout], plan=tplan,
                 machine=TPack(**PACK), device="cpu", calibstore=False)
    jacc = jr.run(np.int64(0), compiled=compiled)
    tacc = tr.run(torch.zeros((), dtype=torch.int64), compiled=compiled)
    assert int(tacc) == int(jacc)
    _check_pair(jr, tr, jout.data, tout.data)
    assert tts.cursor == jts.cursor == n


@pytest.mark.parametrize("compiled", [False, True])
def test_runner_carries_tuple_tokens_like_the_reference(compiled):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 50, (6, 4)).astype(np.int32)
    scale = rng.integers(1, 5, (6, 4)).astype(np.int32)

    def jstep(acc, toks):
        ids_t, s = toks[0]
        return acc + (ids_t * s).sum()

    def tstep(acc, toks):
        ids_t, s = toks[0]
        return acc + (ids_t * s).sum()

    js, ts = _TupleStream(ids, scale), _TupleStream(ids, scale)
    jr = JRunner(jstep, [js], rates=[2], plan=jhost_plan([js], rates=[2],
                 flops_per_hyperstep=1e6, name="pairs"), machine=JPack(**PACK),
                 calibstore=False)
    tr = TRunner(tstep, [ts], rates=[2], plan=host_plan([ts], rates=[2],
                 flops_per_hyperstep=1e6, name="pairs"), machine=TPack(**PACK),
                 device="cpu", calibstore=False)
    jacc = jr.run(np.int64(0), compiled=compiled)
    tacc = tr.run(torch.zeros((), dtype=torch.int64), compiled=compiled)
    assert int(tacc) == int(jacc) == int((ids * scale).sum())
    _check_pair(jr, tr, np.zeros(1), np.zeros(1))


def test_dataconfig_fields_equal_the_reference():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(DataConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jdata.DataConfig)])

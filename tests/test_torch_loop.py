"""The port's training loop against the JAX package's, on the CPU.

The fp32 2-layer smoke cut of minicpm-2b, synthetic batches from one
``DataConfig`` (equal element for element in both packages), a fixed
machine pack. Tolerances:

* the port's own runs — compiled against host loop, crashed and resumed
  against uncrashed, resumed against straight — run the same eager ops on
  the same batches and must agree exactly (losses ``==``, parameters
  ``torch.equal``);
* the port against the reference, from the same weights (the JAX init, or
  a checkpoint the JAX package wrote, carried over through numpy): losses
  within rtol 1e-5 per step (float32 sums taken in another order);
* the plan rows: ``fetch_words_*`` and the predicted verdict exactly, the
  predicted seconds within rtol 1e-9 (the same Eq. 1 on the same fields);
* BSPS212 (crash resume) and BSPS220/221 (drift refit) fire in the port
  where they fire in the reference, the same drill run on each; BSPS202
  (fetch wait) deepens the prefetch as the reference's drill asserts.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core.bsp import BSPAccelerator as JPack
from repro.core.calibstore import CalibrationStore as JStore
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.faults import FaultSpec as JFaultSpec
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import model as JM
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train import loop as jloop
from repro_torch.configs import get_config as t_config
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.core.calibstore import CalibrationStore
from repro_torch.core.faults import FaultInjected, FaultPlan, FaultSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamW, leaves
from repro_torch.optim.schedule import constant
from repro_torch.train import checkpoint as ck
from repro_torch.train import loop as tloop
from repro_torch.train.steps import make_train_step

PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")
DATA = dict(seq_len=16, global_batch=2, seed=0)
QUIET = dict(log=lambda s: None)


def _cfgs():
    jc = dataclasses.replace(j_config("minicpm-2b", smoke=True), num_layers=2,
                             dtype="float32")
    tc = dataclasses.replace(t_config("minicpm-2b", smoke=True), num_layers=2,
                             dtype="float32")
    return jc, tc


def _port(tc, steps, *, ckpt_dir="", ckpt_every=50, compiled=True, faults=None,
          max_restarts=0, **kw):
    tcfg = tloop.TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                             log_every=100, compiled=compiled, max_restarts=max_restarts)
    kw.setdefault("machine", TPack(**PACK))
    kw.setdefault("calibstore", False)
    kw.setdefault("log", QUIET["log"])
    return tloop.train(tc, tcfg, AdamW(schedule=constant(1e-3)),
                       data_cfg=DataConfig(vocab_size=tc.vocab_size, **DATA),
                       faults=faults, device="cpu", **kw)


def _ref(jc, steps, *, ckpt_dir="", ckpt_every=50, compiled=True, faults=None,
         max_restarts=0, **kw):
    tcfg = jloop.TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                             log_every=100, compiled=compiled, max_restarts=max_restarts)
    kw.setdefault("machine", JPack(**PACK))
    kw.setdefault("calibstore", False)
    kw.setdefault("log", QUIET["log"])
    return jloop.train(jc, tcfg, JAdamW(schedule=jconstant(1e-3)),
                       data_cfg=JDataConfig(vocab_size=jc.vocab_size, **DATA),
                       faults=faults, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny models. The drills time the eager
    CPU step against injected stalls: with one thread the step takes ~15 ms
    whatever else loads the machine, with a thread per core it took over a
    second while other test processes ran, longer than the stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _losses(out):
    return [h["loss"] for h in out["history"]]


def _check_plan_rows(trow, jrow):
    for k in ("fetch_words_planned", "fetch_words_measured", "bandwidth_heavy_predicted"):
        assert trow[k] == jrow[k], k
    assert trow["fetch_words_planned"] == trow["fetch_words_measured"]
    assert trow["predicted_seconds"] == pytest.approx(jrow["predicted_seconds"], rel=1e-9)


# -------------------------------------------------------------- straggler ----


def test_straggler_monitor_flags_outliers_like_the_reference():
    mon, ref = tloop.StragglerMonitor(warmup=3), jloop.StragglerMonitor(warmup=3)
    times = [1.0 + 0.01 * (i % 3) for i in range(20)] + [10.0, 1.01, 0.99, 7.5]
    got = [mon.observe(i, t) for i, t in enumerate(times)]
    want = [ref.observe(i, t) for i, t in enumerate(times)]
    assert got == want and sum(got) == 2
    assert mon.events == ref.events
    assert not mon.observe(99, 1.01)    # EWMA not poisoned by the outliers


def test_training_descends_on_learnable_data():
    """A tiny model overfits a fixed repeating sequence."""
    _, tc = _cfgs()
    opt = AdamW(schedule=constant(3e-3), weight_decay=0.0)
    params = TM.init_params(tc, 0, device="cpu")
    state = opt.init(params)
    step = make_train_step(tc, opt, device="cpu")
    toks = torch.arange(16, dtype=torch.int32)[None].repeat(4, 2)     # periodic
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(30):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses


# ----------------------------------------------------- the loop's two modes ----


def test_train_compiled_matches_host_loop_exactly():
    _, tc = _cfgs()
    out_c = _port(tc, 3, compiled=True)
    out_h = _port(tc, 3, compiled=False)
    assert len(out_c["history"]) == len(out_h["history"]) == 3
    assert _losses(out_c) == _losses(out_h)
    for a, b in zip(leaves((out_c["params"], out_c["opt_state"])),
                    leaves((out_h["params"], out_h["opt_state"]))):
        assert torch.equal(a, b)
    for out in (out_c, out_h):
        row = out["plan_row"]
        assert row["measured_seconds"] > 0
        assert row["fetch_words_planned"] == row["fetch_words_measured"]
    assert set(out_c["history"][0]) == set(out_h["history"][0]) == {
        "ce", "grad_norm", "loss", "lr", "moe_aux", "step_seconds"}


@pytest.mark.parametrize("compiled", [True, False])
def test_train_matches_the_reference_from_the_jax_init(tmp_path, compiled):
    """The JAX init, written as the port's step-0 checkpoint, resumed by the
    port's train(): the reference's losses and plan row, step for step."""
    jc, tc = _cfgs()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    tp = TM.params_from_numpy(tc, as_np(jp), device="cpu")
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    ck.save(td, 0, {"params": tp, "opt_state": AdamW(constant(1e-3)).init(tp)},
            data_state={"cursor": 0, "seed": 0}, blocking=True)
    # both with a checkpoint directory and one interval: the same up-streams
    out = _port(tc, 4, ckpt_dir=td, ckpt_every=4, compiled=compiled)
    ref = _ref(jc, 4, ckpt_dir=jd, ckpt_every=4, compiled=compiled)
    np.testing.assert_allclose(_losses(out), _losses(ref), rtol=1e-5)
    _check_plan_rows(out["plan_row"], ref["plan_row"])
    assert ck.committed_steps(td)[-1] == ck.committed_steps(jd)[-1] == 4
    assert ck.restore(td, 4, {"params": tp})[1] == {"cursor": 4, "seed": 0}


def test_a_jax_checkpoint_continues_in_the_port(tmp_path):
    """The reference trains 3 steps and checkpoints; its checkpoint carried
    into the port (``restore_reference``) continues for 3 steps within rtol
    1e-5 of the reference continuing from the same files."""
    jc, tc = _cfgs()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _ref(jc, 3, ckpt_dir=jd, ckpt_every=3)
    state, data_state = ck.restore_reference(jd, 3, tc, device="cpu")
    assert data_state == {"cursor": 3, "seed": 0}
    ck.save(td, 3, state, data_state=data_state, blocking=True)
    ref = _ref(jc, 6, ckpt_dir=jd, ckpt_every=3)
    out = _port(tc, 6, ckpt_dir=td, ckpt_every=3)
    assert len(out["history"]) == len(ref["history"]) == 3
    np.testing.assert_allclose(_losses(out), _losses(ref), rtol=1e-5)
    _check_plan_rows(out["plan_row"], ref["plan_row"])


def test_train_resume_is_exact(tmp_path):
    """10 steps straight == 6 steps, then a new job resuming 4 more (same
    data, same params) — the BSPS seek-restart contract."""
    _, tc = _cfgs()
    full = _port(tc, 10)
    d = str(tmp_path / "ck")
    first = _port(tc, 6, ckpt_dir=d, ckpt_every=3)
    resumed = _port(tc, 10, ckpt_dir=d, ckpt_every=3)
    assert _losses(first) + _losses(resumed) == _losses(full)
    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])):
        assert torch.equal(a, b)


# -------------------------------------------------------- crash and resume ----


@pytest.mark.parametrize("compiled", [True, False])
def test_train_crash_mid_interval_resumes_token_for_token(tmp_path, compiled):
    _, tc = _cfgs()
    jc, _ = _cfgs()
    base = _port(tc, 8, ckpt_dir=str(tmp_path / "base"), ckpt_every=4, compiled=compiled)
    # compiled: the 2nd dispatch (segment of steps 4..8); host loop: the
    # consult before hyperstep 5 — either way the crash lands mid-interval,
    # after the step-4 checkpoint exists
    at = 1 if compiled else 5
    res = _port(tc, 8, ckpt_dir=str(tmp_path / "crash"), ckpt_every=4, compiled=compiled,
                faults=FaultPlan([FaultSpec("dispatch_fail", at=(at,))]).replay(),
                max_restarts=2)
    ref = _ref(jc, 8, ckpt_dir=str(tmp_path / "ref"), ckpt_every=4, compiled=compiled,
               faults=JFaultPlan([JFaultSpec("dispatch_fail", at=(at,))]).replay(),
               max_restarts=2)
    assert res["resumes"] == ref["resumes"] == 1
    codes = res["health"]["count_by_code"]
    assert codes.get("BSPS212", 0) == ref["health"]["count_by_code"].get("BSPS212", 0) == 1
    assert len(res["history"]) == 8
    assert _losses(res) == _losses(base)              # token-for-token identical
    for a, b in zip(leaves(res["params"]), leaves(base["params"])):
        assert torch.equal(a, b)


def test_train_crash_without_restart_budget_propagates(tmp_path):
    _, tc = _cfgs()
    with pytest.raises(FaultInjected):
        _port(tc, 8, ckpt_dir=str(tmp_path), ckpt_every=4,
              faults=FaultPlan([FaultSpec("dispatch_fail", at=(1,))]).replay())


def test_train_crash_with_nothing_on_disk_replays_from_scratch(tmp_path):
    _, tc = _cfgs()
    base = _port(tc, 4, compiled=False)
    res = _port(tc, 4, ckpt_dir=str(tmp_path), ckpt_every=10, compiled=False,
                faults=FaultPlan([FaultSpec("dispatch_fail", at=(2,))]).replay(),
                max_restarts=1)
    assert res["resumes"] == 1 and _losses(res) == _losses(base)


def test_train_host_loop_fetch_wait_deepens_prefetch():
    _, tc = _cfgs()
    # stall every fetch hard enough that the bulk sync blocks on the lane:
    # the wait (stall less compute) must outlast the compute, and the eager
    # step takes ~15 ms here (the reference's jitted one a few), so the
    # stall is 0.2 s where the reference's drill takes 0.05
    logs = []
    res = _port(tc, 10, compiled=False, log=logs.append,
                faults=FaultPlan([FaultSpec("dma_stall", at=tuple(range(12)),
                                            delay_s=0.2)]).replay())
    assert res["health"]["count_by_code"].get("BSPS202", 0) >= 3
    assert any("prefetch depth ->" in line for line in logs)


@pytest.fixture
def virtual_clock(monkeypatch):
    """Both packages' runner clocks made of their injected delays alone:
    ``sleep`` advances the clock, compute takes no time. The walls the loop
    reads (each record's step, compute and fetch-wait seconds) are then the
    delays the FaultPlan declares, however loaded the host is: on the wall
    clock a stall counts as drift only while the eager steps are fast."""
    from repro.core import hyperstep as jhyperstep
    from repro_torch.core import hyperstep as thyperstep

    now = [0.0]

    def sleep(d: float) -> None:
        now[0] += d

    clock = types.SimpleNamespace(perf_counter=lambda: now[0], sleep=sleep)
    for mod in (thyperstep, jhyperstep):
        monkeypatch.setattr(mod, "time", clock)
    return now


# the drift drill's compute and stall per hyperstep, in virtual seconds
BASE_S, STALL_S = 0.005, 0.05


def test_train_reprices_prefetch_on_drift(virtual_clock):
    """Sustained stall mid-train -> BSPS220 -> refit from the store -> the
    prefetch depth is re-priced by the measured link slowdown (BSPS221), in
    the port as in the reference (the same drill on each), on the virtual
    clock."""
    jc, tc = _cfgs()
    results = {}
    # on the virtual clock compute takes no time, so every hyperstep's
    # compute is an injected straggler of BASE_S, in the seeding run too
    base, stall = dict(at=tuple(range(64)), delay_s=BASE_S), dict(at=tuple(range(4, 64)),
                                                                  delay_s=STALL_S)
    for name, run, store, plan in (
            ("port", _port, CalibrationStore(), lambda stalled: FaultPlan(
                [FaultSpec("straggler", **base)]
                + [FaultSpec("dma_stall", **stall)] * stalled)),
            ("ref", _ref, JStore(), lambda stalled: JFaultPlan(
                [JFaultSpec("straggler", **base)]
                + [JFaultSpec("dma_stall", **stall)] * stalled))):
        cfg = tc if name == "port" else jc
        lines: list[str] = []
        run(cfg, 4, compiled=False, machine=None, calibstore=store,  # seeds the band
            faults=plan(False).replay())
        assert len(store.records()) == 1
        rec = store.records()[0]
        for _ in range(4):                   # the drifted reality, same band
            store.add(dataclasses.replace(
                rec, measured_seconds=rec.measured_seconds * 8, faulty=True))
        res = run(cfg, 16, compiled=False, machine=None, calibstore=store,
                  faults=plan(True).replay(), log=lines.append)
        results[name] = (res["health"], lines)
    for health, lines in results.values():
        codes = health["count_by_code"]
        assert codes.get("BSPS220", 0) >= 1, "drift never detected"
        assert codes.get("BSPS221", 0) >= 1, f"refit never adopted: {codes}"
        assert health["recalibrations"] >= 1
        assert any("prefetch depth" in ln for ln in lines)


# --------------------------------------------------------- entry points ----


def test_train_then_checkpoint_then_generate(tmp_path):
    """Train, checkpoint, reload, decode greedily (the port has no
    musicgen yet: minicpm-2b's smoke cut)."""
    from repro_torch.launch.serve import generate

    _, tc = _cfgs()
    out = _port(tc, 4, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert ck.latest_step(str(tmp_path)) == 4
    restored = ck.restore_latest(
        str(tmp_path), {"params": out["params"], "opt_state": out["opt_state"]})
    assert restored is not None
    _, state, _ = restored
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    tokens, _ = generate(tc, state["params"], prompt, steps=6, machine=TPack(**PACK),
                         device="cpu")
    assert tuple(tokens.shape) == (2, 10)
    want, _ = generate(tc, out["params"], prompt, steps=6, machine=TPack(**PACK),
                       device="cpu")
    assert torch.equal(tokens, want)


def test_train_refuses_a_mesh():
    """A mesh outside a rank group (shape only) has nowhere to place the
    state: train() refuses it before doing any work."""
    from repro_torch.launch.mesh import make_host_mesh

    _, tc = _cfgs()
    with pytest.raises(ValueError, match="rank group"):
        tloop.train(tc, tloop.TrainConfig(steps=1), AdamW(constant(1e-3)),
                    mesh=make_host_mesh(device="cpu"), device="cpu")


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch import train as launch

    launch.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "3",
                 "--seq-len", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "[done] arch=minicpm-2b steps=3 final_loss=" in out
    assert "[predicted_vs_measured] pred=" in out


def test_embedding_gradient_sums_rows_in_a_fixed_order():
    """The embedding's backward adds each row's gradients in token order,
    every time: indexing's backward (index_put_ with accumulate) adds them
    with atomics on the CPU's threads at this size, and the two modes' losses
    then differed in the last bits."""
    from repro_torch.models.layers import embed_tokens

    torch.set_num_threads(max(2, os.cpu_count() or 2))   # the atomics need threads
    g = torch.Generator().manual_seed(0)
    table = torch.randn(256, 64, generator=g)
    ids = torch.randint(0, 256, (4, 256), generator=g, dtype=torch.int32)
    dy = torch.randn(4, 256, 64, generator=g)
    want = torch.zeros(256, 64)
    for i, t in enumerate(ids.reshape(-1).tolist()):
        want[t] += dy.reshape(-1, 64)[i]
    for _ in range(10):
        w = table.clone().requires_grad_(True)
        (embed_tokens({"tokens": w}, ids) * dy).sum().backward()
        assert torch.equal(w.grad, want)


def test_train_modes_agree_exactly_at_a_full_batch():
    """Compiled against host loop at B 4 x S 256, where the embedding's
    gradient rows gather 1024 tokens."""
    _, tc = _cfgs()
    data = DataConfig(vocab_size=tc.vocab_size, seq_len=256, global_batch=4, seed=0)
    outs = [tloop.train(tc, tloop.TrainConfig(steps=6, log_every=100, compiled=c),
                        AdamW(constant(1e-3)), data_cfg=data, machine=TPack(**PACK),
                        calibstore=False, device="cpu", **QUIET) for c in (True, False)]
    assert _losses(outs[0]) == _losses(outs[1])


def test_train_entry_points_refuse_to_guess_the_device(monkeypatch):
    from repro_torch.launch import train as launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(tc, tloop.TrainConfig(steps=1), AdamW(constant(1e-3)), **QUIET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])

"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write the same on-disk format (``step_%08d/``, one npz per
group, ``manifest.json`` with per-array crc32, shape and dtype), so the
same numpy state saved by each gives equal manifests and either package
restores the other's files. Values round-trip exactly: float32 leaves
bit for bit, bf16 leaves through float32 (an exact widening) back to bf16.
A training state the JAX package wrote (either stack layout) restores into
the port's trees equal to ``params_from_numpy`` / ``opt_state_from_numpy``
of the same arrays, exactly.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_config
from repro.models import model as JM
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train import checkpoint as jck
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config as t_config
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamW, leaves
from repro_torch.optim.schedule import constant
from repro_torch.train import checkpoint as ck
from repro_torch.train.steps import make_train_step


def _np_tree():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones((3,), np.float32)}


def test_checkpoint_atomicity_skips_torn_writes(tmp_path):
    d = str(tmp_path)
    ck.save(d, 5, {"params": {"w": torch.ones(4)}}, blocking=True)
    # a torn write: a .tmp directory without manifest, and a committed-looking
    # directory without one
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000007"))
    assert ck.latest_step(d) == 5
    assert ck.committed_steps(d) == [5]


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path)
    state = {"params": {"w": torch.arange(8, dtype=torch.float32)}}
    ck.save(d, 1, state, blocking=True)
    npz = os.path.join(d, "step_00000001", "params.npz")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["w"] = arrays["w"] + 1
    np.savez(npz, **arrays)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(d, 1, state)
    out, _ = ck.restore(d, 1, state, verify=False)  # opt-out works
    assert torch.equal(out["params"]["w"], torch.arange(8, dtype=torch.float32) + 1)


def test_restore_latest_falls_back_past_corrupted_checkpoint(tmp_path):
    d = str(tmp_path)
    state = {"params": _np_tree()}
    ck.save(d, 2, state, data_state={"cursor": 2}, blocking=True)
    ck.save(d, 4, state, data_state={"cursor": 4}, blocking=True)
    # corrupt the newest: flip bytes inside the committed npz
    with open(os.path.join(d, "step_00000004", "params.npz"), "r+b") as f:
        f.seek(40)
        f.write(b"\xff" * 64)
    seen = []
    out = ck.restore_latest(d, {"params": _np_tree()},
                            on_corrupt=lambda s, e: seen.append(s))
    assert out is not None
    step, st_, data_state = out
    assert step == 2 and data_state["cursor"] == 2
    np.testing.assert_array_equal(st_["params"]["w"], _np_tree()["w"])
    assert seen == [4]
    # and the reference's restore_latest makes the same choice on these files
    jstep, _, jdata_state = jck.restore_latest(d, {"params": _np_tree()})
    assert (jstep, jdata_state) == (step, data_state)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 100))
def test_checkpoint_roundtrip_identity(tmp_path_factory, seed):
    d = tmp_path_factory.mktemp(f"ck{seed}")
    g = torch.Generator().manual_seed(seed)
    state = {
        "params": {
            "a": torch.randn((3, 5), generator=g),
            "nested": {"b": torch.randn(7, generator=g).to(torch.bfloat16)},
            "layers": [{"c": torch.randn(2, 2, generator=g)}],
        },
        "opt_state": {"step": torch.tensor(seed, dtype=torch.int32)},
    }
    ck.save(str(d), 1, state, data_state={"cursor": seed}, blocking=True)
    out, ds = ck.restore(str(d), 1, state)
    assert ds["cursor"] == seed
    for got, want in zip(leaves(out), leaves(state)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    # through the reference's restore too (numpy templates, bf16 as float32)
    jout, _ = jck.restore(str(d), 1, jax.tree_util.tree_map(
        lambda t: np.zeros(t.shape, np.float32 if t.dtype == torch.bfloat16
                           else t.numpy().dtype), state))
    np.testing.assert_array_equal(jout["params"]["nested"]["b"],
                                  state["params"]["nested"]["b"].float().numpy())


def test_restore_onto_template_device_dtype_and_into_it(tmp_path):
    d = str(tmp_path)
    p = {"w": torch.randn(4, 3).to(torch.bfloat16), "s": torch.ones(2)}
    ck.save(d, 3, {"params": p}, blocking=True)
    like = {"w": torch.zeros(4, 3, dtype=torch.bfloat16), "s": torch.zeros(2)}
    out, _ = ck.restore(d, 3, {"params": like}, copy_into=True)
    assert out["params"]["w"] is like["w"] and torch.equal(like["w"], p["w"])
    out, _ = ck.restore(d, 3, {"params": {"w": torch.zeros(4, 3), "s": torch.zeros(2)}})
    assert out["params"]["w"].dtype == torch.float32
    assert torch.equal(out["params"]["w"], p["w"].float())


def test_snapshot_does_not_alias_in_place_updated_parameters(tmp_path):
    """The port's AdamW updates in place: a save on the writer thread must
    hold the values of the step it was taken at, not the next step's."""
    cfg = dataclasses.replace(t_config("minicpm-2b", smoke=True), dtype="float32")
    params = TM.init_params(cfg, 0, device="cpu")
    opt = AdamW(constant(1e-2))
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params, state, _ = step(params, state, batch)
    old = [t.clone() for t in leaves((params, state))]
    gate = threading.Event()
    orig = ck._write_fsync

    def held(path, writer):          # the writer waits until the next step ran
        gate.wait(timeout=30)
        orig(path, writer)

    ck._write_fsync = held
    try:
        writer = ck.save(str(tmp_path), 1, {"params": params, "opt_state": state})
        params, state, _ = step(params, state, batch)       # in place
        gate.set()
        writer.join(timeout=60)
        assert not writer.is_alive()
    finally:
        ck._write_fsync = orig
    assert any(not torch.equal(a, b) for a, b in zip(old, leaves((params, state))))
    out, _ = ck.restore(str(tmp_path), 1, {"params": params, "opt_state": state})
    for got, want in zip(leaves((out["params"], out["opt_state"])), old):
        assert torch.equal(got, want)
    # snapshot() copies as well
    snap = ck.snapshot({"params": params})
    before = snap["params"]["embed/tokens"].copy()
    params["embed"]["tokens"].add_(1.0)
    np.testing.assert_array_equal(snap["params"]["embed/tokens"], before)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_on_disk_format_equals_the_reference(tmp_path):
    """The same numpy state saved by both packages: equal file names, array
    keys, crc32s, shapes, dtypes and data state; each restores the other's."""
    cfg_j = dataclasses.replace(j_config("minicpm-2b", smoke=True), dtype="bfloat16")
    cfg_t = dataclasses.replace(t_config("minicpm-2b", smoke=True), dtype="bfloat16")
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(1))
    jopt = JAdamW(schedule=jconstant(1e-3))
    js = jopt.init(jp)
    tp = TM.params_from_numpy(cfg_t, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), device="cpu")
    ts = TM.opt_state_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, js),
                                 device="cpu")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    data_state = {"cursor": 3, "seed": 0}
    jck.save(jd, 3, {"params": jp, "opt_state": js}, data_state=data_state, blocking=True)
    ck.save(td, 3, {"params": tp, "opt_state": ts}, data_state=data_state, blocking=True)
    assert sorted(os.listdir(os.path.join(td, "step_00000003"))) == sorted(
        os.listdir(os.path.join(jd, "step_00000003")))
    jm, tm = _manifest(jd, 3), _manifest(td, 3)
    assert tm["arrays"] == jm["arrays"]
    assert (tm["step"], tm["data_state"]) == (jm["step"], jm["data_state"])
    # the port restores the reference's files, the reference the port's
    out, ds = ck.restore(jd, 3, {"params": tp, "opt_state": ts})
    assert ds == data_state
    for a, b in zip(leaves(out), leaves({"params": tp, "opt_state": ts})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jout, _ = jck.restore(td, 3, {"params": jp, "opt_state": js})
    for a, b in zip(jax.tree_util.tree_leaves(jout), jax.tree_util.tree_leaves(
            {"params": jp, "opt_state": js})):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_restore_reference_carries_a_jax_training_state(tmp_path, scan_layers):
    """A checkpoint of the JAX package's, one AdamW step into training (the
    moments nonzero), in either stack layout: the port's state equals
    params_from_numpy / opt_state_from_numpy of the same arrays."""
    jc = dataclasses.replace(j_config("minicpm-2b", smoke=True), dtype="float32",
                             scan_layers=scan_layers)
    tc = dataclasses.replace(t_config("minicpm-2b", smoke=True), dtype="float32",
                             scan_layers=scan_layers)
    jopt = JAdamW(schedule=jconstant(1e-2))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    js = jopt.init(jp)
    toks = jnp.asarray(np.random.default_rng(1).integers(0, jc.vocab_size, (2, 9)), jnp.int32)
    jp, js, _ = jax.jit(j_make_train_step(jc, jopt))(
        jp, js, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    d = str(tmp_path)
    jck.save(d, 1, {"params": jp, "opt_state": js}, data_state={"cursor": 1, "seed": 0},
             blocking=True)
    state, data_state = ck.restore_reference(d, 1, tc, device="cpu")
    assert data_state == {"cursor": 1, "seed": 0}
    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    want_p = TM.params_from_numpy(tc, as_np(jp), device="cpu")
    want_s = TM.opt_state_from_numpy(tc, as_np(js), device="cpu")
    assert int(state["opt_state"]["step"]) == 1
    assert any(float(m.abs().max()) > 0 for m in leaves(state["opt_state"]["m"]))
    for a, b in zip(leaves((state["params"], state["opt_state"])), leaves((want_p, want_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_retention_gc_and_manager_keep_the_newest(tmp_path):
    d = str(tmp_path)
    mgr = ck.CheckpointManager(d, every=2, keep=2)
    for step in range(1, 9):
        saved = mgr.maybe_save(step, {"params": {"w": torch.full((3,), float(step))}},
                               {"cursor": step})
        assert saved == (step % 2 == 0)
    mgr.wait()
    ck._retention_gc(d, mgr.keep)
    assert ck.committed_steps(d) == [6, 8]
    out, ds = ck.restore(d, 8, {"params": {"w": torch.zeros(3)}})
    assert torch.equal(out["params"]["w"], torch.full((3,), 8.0)) and ds == {"cursor": 8}


def test_checkpoint_stream_moves_words_only_on_snapshots(tmp_path):
    d = str(tmp_path)
    cs = ck.CheckpointStream(d, every=2, num_tokens=4, state_words=11, keep=1)
    cs.open(0)
    snap = ck.snapshot({"params": {"w": torch.ones(11)}})
    words = [cs.move_up(0, None), cs.move_up(0, (2, snap, {"cursor": 2})),
             cs.move_up(0, None), cs.move_up(0, (4, snap, {"cursor": 4}))]
    cs.close(0)
    assert words == [0, 11, 0, 11] and cs.cursor == 0
    assert ck.committed_steps(d) == [4]
    assert (cs.token_words, cs.token_shape, cs.num_tokens) == (11, (1, 11), 4)

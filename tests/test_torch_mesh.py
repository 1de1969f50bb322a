"""The port's mesh-bound modules against the JAX package, on the CPU.

Multi-rank cases run their rank programs (``tests/torch_mesh_ranks.py``) in
``gloo`` rank groups of 1, 4 and 8 processes started by
``repro_torch.distributed.group.spawn``, each group once for the module with
its own timeout; the JAX side runs here in the test's process. The JAX
package's own mesh tests are red under this JAX (API drift in
``shard_map``, ``device_put`` and the embedding gather), so the port is held
to what they assert — the sequential composition, ``a @ b``, a non-negative
two-point fit — and to the JAX package's pure-Python parts in-process
(``ctx``, ``cannon_plan(...).cost``, ``host_h_relation``, ``moe_forward``
under ``ctx.mesh_axes``). Tolerances:

* placement, gathers, ``ctx`` and the cost model: exact;
* a world-1 mesh against no mesh: bit for bit (every collective an
  identity); the two execution modes under a (2, 2) mesh, and a crash and
  resume: bit for bit (the same eager steps);
* fp32 products: the pipeline within 1e-5, Cannon within 1e-4 of ``a @ b``
  (the reference's bounds), two-level Cannon within 1e-3;
* the MoE against the reference: atol 1e-5 (y) and rtol 1e-6 (aux), fp32;
* ``train(mesh=(2, 2))`` against one process and against the reference:
  losses within rtol 1e-4 — the bf16 gradients are summed over the DP
  ranks in bf16, one rounding more than one process takes.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core.bsp import BSPAccelerator as JPack
from repro.core.cost import cannon_bsps_cost as j_cannon_bsps_cost
from repro.distributed import ctx as jctx
from repro.distributed import sharding as jsh
from repro.distributed.cannon import cannon_plan as j_cannon_plan
from repro.distributed.shardspec import host_h_relation as j_host_h_relation
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train import loop as jloop
from repro_torch.configs import get_config as t_config
from repro_torch.core.bsp import EPIPHANY_III, BSPAccelerator
from repro_torch.core.calibrate import calibrate_host_level
from repro_torch.distributed import ctx as tctx
from repro_torch.distributed import group
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.shardspec import P
from repro_torch.distributed.shardspec import host_h_relation
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train import checkpoint as ck

import torch_mesh_ranks as R

MOE = "qwen2-moe-a2.7b"
MM_SHAPES = [(64, 32, 48), (8, 8, 8), (128, 64, 64)]   # the reference's Cannon shapes


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _minicpm():
    jc = dataclasses.replace(j_config("minicpm-2b", smoke=True), num_layers=2, dtype="float32")
    tc = dataclasses.replace(t_config("minicpm-2b", smoke=True), num_layers=2, dtype="float32")
    return jc, tc


# ------------------------------------------------------------------- ctx ----


AXES = [{}, {"data": 2, "model": 2}, {"data": 16, "model": 16},
        {"pod": 2, "data": 16, "model": 16}, {"host": 2, "data": 4, "model": 2}, {"model": 3}]
ENTRIES = [None, "data", "model", "pod", ("pod", "data"), ("host", "data"),
           ("pod", "host", "data"), ("data", "model"), ("model", "data")]
DIMS = [1, 2, 3, 4, 5, 6, 8, 12, 32, 48, 64, 96]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items())
                         or "none")
def test_ctx_filter_dp_size_and_constrain_match_the_reference(axes):
    with jctx.mesh_axes(axes), tctx.mesh_axes(axes):
        assert tctx.dp_size() == jctx.dp_size()
        for entry in ENTRIES:
            for dim in DIMS:
                assert tctx._filter(entry, dim) == jctx._filter(entry, dim), (entry, dim)
        x = torch.ones(4, 6)
        assert tctx.constrain(x, tctx.DP, tctx.TP) is x
        assert tctx.constrain(x, None, None) is x
    assert tctx.dp_size() == jctx.dp_size() == 1


@pytest.mark.parametrize("case", ["noop_without_mesh", "filters_nondividing_axes",
                                  "dp_size_registers"])
def test_the_reference_ctx_cases(case):
    """``tests/test_distributed.py``'s three ctx cases, on both packages."""
    if case == "noop_without_mesh":
        jx, tx = jnp.ones((4, 4)), torch.ones(4, 4)
        assert jctx.constrain(jx, jctx.DP, None) is jx
        assert tctx.constrain(tx, tctx.DP, None) is tx
    elif case == "filters_nondividing_axes":
        with jctx.mesh_axes({"data": 16, "model": 16}), tctx.mesh_axes({"data": 16, "model": 16}):
            jx, tx = jnp.ones((5, 5)), torch.ones(5, 5)
            assert jctx.constrain(jx, jctx.DP, jctx.TP) is jx
            assert tctx.constrain(tx, tctx.DP, tctx.TP) is tx
        assert jctx.dp_size() == tctx.dp_size() == 1
    else:
        with jctx.mesh_axes({"pod": 2, "data": 16, "model": 16}), \
                tctx.mesh_axes({"pod": 2, "data": 16, "model": 16}):
            assert jctx.dp_size() == tctx.dp_size() == 32


def test_shard_local_counts_each_dp_axis_once():
    with tctx.mesh_axes({"pod": 2, "host": 2, "data": 4, "model": 2}):
        assert tctx.dp_size() == 16
        with tctx.shard_local():
            assert tctx.dp_size() == 1
            assert tctx._filter("model", 4) == "model"
            assert tctx._filter(("host", "data"), 8) == ("host", "data")
        assert tctx.dp_size() == 16


def test_spec_placements_refuse_what_dtensor_cannot_place():
    from torch.distributed.tensor import Replicate, Shard

    names = ("data", "model")
    assert tsh.spec_placements(P(("data", "model"), None), names) == (Shard(0), Shard(0))
    assert tsh.spec_placements(P(None, "model"), names) == (Replicate(), Shard(1))
    assert tsh.spec_placements(P(), names) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.spec_placements(P(("model", "data")), names)
    with pytest.raises(ValueError, match="not on the mesh"):
        tsh.spec_placements(P("pod"), names)
    with pytest.raises(ValueError, match="twice"):
        tsh.spec_placements(P("data", "data"), names)


# ------------------------------------------------------------------- MoE ----


def _moe_inputs(seed: int = 3):
    jc = dataclasses.replace(j_config(MOE, smoke=True), dtype="float32")
    tc = dataclasses.replace(t_config(MOE, smoke=True), dtype="float32")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(tc, _np_tree(jp), device="cpu")
    jpm, tpm = jp["stack"][0][0]["mlp"], tp["stack"][0][0]["mlp"]
    rng = np.random.default_rng(seed)
    # a shared component skews the routing, so the favourite experts overflow
    x = rng.standard_normal((4, 8, jc.d_model)).astype(np.float32)
    x += 2.0 * rng.standard_normal(jc.d_model).astype(np.float32)
    return jc, tc, jpm, tpm, x


def _kept_pairs(dispatch, cfg, router, x, groups: int) -> set:
    """(token, expert) pairs each group keeps under its capacity."""
    t = x.shape[0] * x.shape[1] // groups
    cap = max(1, int(np.ceil(t * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity_factor)))
    kept = set()
    for g, xg in enumerate(x.reshape(groups, t, -1)):
        kept |= {(g * t + tok, e) for tok, e in dispatch(cfg, router, xg, cap)}
    return kept


def _j_dispatch(cfg, router, xg, cap):
    _, (slot, st, _, keep), _ = jmoe._dispatch_group(cfg, router, jnp.asarray(xg), cap)
    slot, st, keep = map(np.asarray, (slot, st, keep))
    return [(int(st[i]), int(slot[i]) // cap) for i in range(len(st)) if keep[i]]


def _t_dispatch(cfg, router, xg, cap):
    _, (slot, _, top_e), _ = tmoe._dispatch_group(cfg, router, torch.as_tensor(xg), cap)
    return [(tok, int(top_e[tok, c])) for tok in range(slot.shape[0])
            for c in range(slot.shape[1]) if slot[tok, c] >= 0]


def test_moe_dispatch_groups_match_the_reference_under_mesh_axes(monkeypatch):
    """Two DP groups under ``ctx.mesh_axes({"data": 2, "model": 2})``: the
    same y, aux and kept (token, expert) pairs as the reference (its
    ``constrain`` the identity: no device mesh here), and other drops than
    one group makes."""
    jc, tc, jpm, tpm, x = _moe_inputs()
    monkeypatch.setattr(jctx, "constrain", lambda v, *spec: v)
    axes = {"data": 2, "model": 2}
    with jctx.mesh_axes(axes), tctx.mesh_axes(axes):
        jy, jaux = jmoe.moe_forward(jc, jpm, jnp.asarray(x))
        ty, taux = tmoe.moe_forward(tc, tpm, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    kept = _kept_pairs(_t_dispatch, tc, tpm["router"], x, 2)
    assert kept == _kept_pairs(_j_dispatch, jc, jpm["router"], np.asarray(x), 2)
    one = _kept_pairs(_t_dispatch, tc, tpm["router"], x, 1)
    assert kept != one and len(kept) < x.shape[0] * x.shape[1] * tc.moe_top_k


# ----------------------------------------------- 4 ranks: place, move, multiply ----


@pytest.fixture(scope="module")
def placement_run():
    rng = np.random.default_rng(0)
    full = [rng.standard_normal(shape).astype(np.float32) for _, shape in R.PLACEMENTS]
    jc, tc, jpm, tpm, x = _moe_inputs()
    moe_in = {"cfg": tc, "params": {k: v.numpy() for k, v in tpm.items()}, "x": x}
    pp = {"ws": (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
          "bs": (rng.standard_normal((4, 8)) * 0.1).astype(np.float32),
          "xs": rng.standard_normal((6, 2, 8)).astype(np.float32)}
    mm = [(rng.standard_normal((m, k)).astype(np.float32),
           rng.standard_normal((k, n)).astype(np.float32)) for m, k, n in MM_SHAPES]
    pack = dataclasses.replace(EPIPHANY_III, g=1.0, e=1.0)
    tl = {"a": rng.standard_normal((64, 64)).astype(np.float32),
          "b": rng.standard_normal((64, 64)).astype(np.float32), "m": 2,
          "pack": {f.name: getattr(pack, f.name) for f in dataclasses.fields(pack)}}
    out = group.spawn(R.placement_rank, 4, full, moe_in, pp, mm, tl, timeout=240)
    return {"ranks": out, "full": full, "moe": (jc, jpm, x), "pp": pp, "mm": mm, "tl": tl}


def _expected_shard(full: np.ndarray, spec: P, coord: tuple, shape: dict) -> np.ndarray:
    names = list(shape)
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        idx, count = 0, 1
        for a in axes:
            idx = idx * shape[a] + coord[names.index(a)]
            count *= shape[a]
        size = full.shape[d] // count
        out = np.take(out, range(idx * size, (idx + 1) * size), axis=d)
    return out


def test_host_meshes_lay_out_the_group_s_ranks(placement_run):
    """One device a rank, the same divisibility errors as over devices."""
    for r in placement_run["ranks"]:
        drop3, hosts3, over = r["mesh_errors"]
        assert "does not divide the 4 available device(s)" in drop3 and "drop 1" in drop3
        assert "hosts=3 does not divide" in hosts3
        assert "model=8 exceeds the 4 available" in over


def test_named_and_logical_to_sharding_place_each_rank_s_slice(placement_run):
    shape = {"data": 2, "model": 2}
    assert sorted(r["coord"] for r in placement_run["ranks"]) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in placement_run["ranks"]:
        for (spec, _), full, shard, gathered in zip(R.PLACEMENTS, placement_run["full"],
                                                    r["shards"], r["full"]):
            np.testing.assert_array_equal(shard, _expected_shard(full, spec, r["coord"], shape))
            np.testing.assert_array_equal(gathered, full)
        assert r["named"][1] == ("Shard(dim=0)", "Shard(dim=0)")
        assert r["named"][4] == ("Replicate()", "Replicate()")


def test_constrain_redistributes_a_dtensor(placement_run):
    for r in placement_run["ranks"]:
        placements, local = r["constrained"]
        assert placements == ("Replicate()", "Shard(dim=1)")
        np.testing.assert_array_equal(local, _expected_shard(
            placement_run["full"][0], P(None, "model"), r["coord"], {"data": 2, "model": 2}))
        assert r["plain_is_same"]


def test_moe_over_two_dp_ranks_matches_the_reference(placement_run, monkeypatch):
    """Each DP rank dispatches its rows as one group: the ranks' y and mean
    aux are the reference's two-group forward under ``ctx.mesh_axes``."""
    jc, jpm, x = placement_run["moe"]
    monkeypatch.setattr(jctx, "constrain", lambda v, *spec: v)
    with jctx.mesh_axes({"data": 2, "model": 2}):
        jy, jaux = jmoe.moe_forward(jc, jpm, jnp.asarray(x))
    ranks = sorted(placement_run["ranks"], key=lambda r: r["coord"])
    assert all(r["moe_groups"] == 1 for r in ranks)
    by_data = {r["coord"][0]: r["moe"] for r in ranks if r["coord"][1] == 0}
    y = np.concatenate([by_data[0][0], by_data[1][0]])
    np.testing.assert_allclose(y, np.asarray(jy), rtol=0, atol=1e-5)
    assert (by_data[0][1] + by_data[1][1]) / 2 == pytest.approx(float(jaux), rel=1e-6)
    for r in ranks:   # model ranks of one DP rank compute the same
        np.testing.assert_array_equal(r["moe"][0], by_data[r["coord"][0]][0])


def test_pipeline_apply_matches_the_sequential_composition(placement_run):
    pp = placement_run["pp"]
    want = pp["xs"].astype(np.float64)
    for i in range(4):
        want = np.tanh(want @ pp["ws"][i] + pp["bs"][i])
    for r in placement_run["ranks"]:
        assert np.abs(r["pipeline"] - want).max() < 1e-5
        np.testing.assert_array_equal(r["pipeline_placed"], r["pipeline"])


def test_cannon_matmul_matches_a_at_b(placement_run):
    for r in placement_run["ranks"]:
        for (a, b), (full, local, _) in zip(placement_run["mm"], r["cannon"]):
            want = a.astype(np.float64) @ b
            assert np.abs(full - want).max() < 1e-4
            np.testing.assert_array_equal(local, _expected_shard(
                full, P("data", "model"), r["coord"], {"data": 2, "model": 2}))


def test_cannon_matmul_takes_placed_operands(placement_run):
    """DTensor operands in another placement are redistributed to the
    grid's blocks first: the same product as full operands."""
    for r in placement_run["ranks"]:
        np.testing.assert_array_equal(r["cannon_placed"], r["cannon"][0][0])


def test_bsps_cannon_example_runs_over_the_rank_grid(placement_run):
    tl = placement_run["tl"]
    for r in placement_run["ranks"]:
        n_grid, shape, c = r["example_cannon"]
        assert n_grid == 2 and shape == {"data": 2, "model": 2}
        assert np.abs(c - tl["a"].astype(np.float64) @ tl["b"]).max() < 1e-3


def test_cannon_sends_one_block_to_each_neighbour_a_step(placement_run):
    """Rank (i, j): one skew batch where i or j is not 0 (A's block when i,
    B's when j), then one rotation (N − 1 = 1) of exactly one A block to
    its left neighbour and one B block to the one above."""
    for r in placement_run["ranks"]:
        i, j = r["coord"]
        for (m, k, n), (_, _, batches) in zip(MM_SHAPES, r["cannon"]):
            a_blk, b_blk = (m // 2) * (k // 2) * 4, (k // 2) * (n // 2) * 4
            skew = [b for b in batches[:-1]]
            assert len(skew) == (1 if (i or j) else 0)
            if skew:
                assert sorted(s for s, _ in skew[0]) == sorted(
                    ([a_blk] if i else []) + ([b_blk] if j else []))
            rotation = batches[-1]
            assert sorted(s for s, _ in rotation) == sorted([a_blk, b_blk])
            assert len({peer for _, peer in rotation}) == 2


def test_two_level_cannon_on_the_rank_grid(placement_run):
    tl = placement_run["tl"]
    pack = tl["pack"]
    jacc = JPack(**{k: v for k, v in pack.items()})
    want_plan = j_cannon_plan(64, tl["m"], 2).cost(jacc)
    want_eq2 = j_cannon_bsps_cost(jacc, 64, tl["m"], 2)
    for r in placement_run["ranks"]:
        for compiled, res in r["two_level"].items():
            assert np.abs(res["c"] - tl["a"].astype(np.float64) @ tl["b"]).max() < 1e-3
            assert res["cores"] == 4
            assert res["records"] == (1 if compiled else tl["m"] ** 3)
            assert res["cost"] == want_plan == want_eq2
            assert res["row"]["fetch_words_measured"] == res["row"]["fetch_words_planned"]


# ------------------------------------------------------- 8 ranks: host level ----


@pytest.fixture(scope="module")
def host_run():
    return group.spawn(R.host_rank, 8, timeout=240)


def test_host_calibration_over_eight_ranks(host_run):
    assert all(r["shape"] == {"host": 2, "data": 2, "model": 2} for r in host_run)
    g_sec, l_sec = host_run[0]["fit"]
    assert g_sec >= 0.0 and l_sec >= 0.0
    hosts, g_host, l_host = host_run[0]["pack"]
    assert hosts == 2 and g_host >= 0.0 and l_host >= 0.0
    assert all(r["pack"] == host_run[0]["pack"] for r in host_run)   # one pack on every rank


def test_train_on_a_host_mesh_prices_the_reference_s_h_relation(host_run):
    """``train(mesh=(2, 2, 2))`` logs the ``[mesh]`` line with the
    reference's h-relation for the same config and mesh; every rank trains
    the same losses."""
    jc, tc = _minicpm()
    shape = {"host": 2, "data": 2, "model": 2}
    jshape = JM.abstract_params(jc)
    want = j_host_h_relation(_FakeMesh(shape), jsh.param_specs(jc, _FakeMesh(shape), jshape),
                             jshape)
    for r in host_run:
        (line,) = r["mesh_lines"]
        m = re.match(r"\[mesh\] hosts=2 h_words/step=(\S+) g_host=(\S+) l_host=(\S+)", line)
        assert float(m.group(1)) == float(f"{want['h_words']:.3g}")
        assert float(m.group(2)) >= 0.0 and float(m.group(3)) >= 0.0
        assert r["losses"] == host_run[0]["losses"] and all(np.isfinite(r["losses"]))
        assert r["plan_row"]["fetch_words_planned"] == r["plan_row"]["fetch_words_measured"]


def test_host_level_without_a_host_axis_is_the_identity():
    kw = dict(p=1, g=0.0, l=0.0, r=1e9, e=1.0, L=4, E=8, hosts=3, g_host=9.0, l_host=9.0)
    mesh = Mesh({"data": 1, "model": 1})
    out = calibrate_host_level(BSPAccelerator(**kw), mesh)
    from repro.core.calibrate import calibrate_host_level as j_calibrate_host_level
    from repro.launch.mesh import make_host_mesh as j_make_host_mesh

    jout = j_calibrate_host_level(JPack(**kw), j_make_host_mesh())
    assert (out.hosts, out.g_host, out.l_host) == (jout.hosts, jout.g_host, jout.l_host) == (
        1, 0.0, 0.0)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_host_h_relation_matches_the_reference(arch):
    shape = {"host": 2, "data": 2, "model": 2}
    jc = j_config(arch)
    jshape = JM.abstract_params(jc)
    want = j_host_h_relation(_FakeMesh(shape), jsh.param_specs(jc, _FakeMesh(shape), jshape),
                             jshape)
    tc, mesh = t_config(arch), Mesh(shape)
    tshape = TM.abstract_params(tc)
    got = host_h_relation(mesh, tsh.param_specs(tc, mesh, tshape), tshape)
    assert got == want


# ----------------------------------------------------- 4 ranks: train(mesh) ----


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX init of minicpm's fp32 2-layer smoke cut, written as a step-0
    checkpoint into each run's directory, and the reference's losses from
    it."""
    jc, tc = _minicpm()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(tc, _np_tree(jp), device="cpu")
    root = tmp_path_factory.mktemp("mesh_train")
    dirs = {}
    for name in (True, False, "crash", "one"):
        dirs[name] = str(root / str(name))
        ck.save(dirs[name], 0, {"params": tp, "opt_state": AdamW(constant(1e-3)).init(tp)},
                data_state={"cursor": 0, "seed": 0}, blocking=True)
    ref = jloop.train(jc, jloop.TrainConfig(steps=4, log_every=100), JAdamW(jconstant(1e-3)),
                      data_cfg=JDataConfig(vocab_size=jc.vocab_size, seq_len=16,
                                           global_batch=4, seed=0),
                      machine=JPack(**R.PACK), log=lambda s: None, calibstore=False)
    return dirs, [h["loss"] for h in ref["history"]]


@pytest.fixture(scope="module")
def train_run(jax_init):
    dirs, _ = jax_init
    return group.spawn(R.train_rank, 4, {k: v for k, v in dirs.items() if k != "one"},
                       timeout=300)


def test_mesh_train_modes_agree_bit_for_bit(train_run):
    first = train_run[0]
    for r in train_run:
        assert r[True] == r[False] == first[True]
        assert all(np.isfinite(r[True]))


def test_mesh_train_matches_one_process_and_the_reference(train_run, jax_init):
    dirs, ref = jax_init
    _, tc = _minicpm()
    one = R._losses(R._train(tc, 4, None, ckpt_dir=dirs["one"], ckpt_every=4))
    np.testing.assert_allclose(train_run[0][True], one, rtol=1e-4)
    np.testing.assert_allclose(train_run[0][True], ref, rtol=1e-4)
    assert train_run[0]["plan_row"]["fetch_words_planned"] == \
        train_run[0]["plan_row"]["fetch_words_measured"]


def test_mesh_train_crash_resumes_bit_for_bit(train_run):
    for r in train_run:
        losses, resumes, bsps212 = r["crash"]
        assert losses == r[True] and resumes == 1 and bsps212 == 1
        assert r["latest"] == 4


def test_mesh_checkpoint_restores_onto_another_mesh_shape(train_run):
    for r in train_run:
        res = r["restored"]
        assert res["mesh"] == {"data": 4, "model": 1}
        assert res["equal"] and res["data_state"] == {"cursor": 4, "seed": 0}
        assert any("Shard" in p for p in res["placements"])


def test_mesh_moe_train_matches_one_process_under_mesh_axes(train_run):
    qc = dataclasses.replace(t_config(MOE, smoke=True), dtype="float32")
    with tctx.mesh_axes({"data": 2, "model": 2}):
        one = R._losses(R._train(qc, 3, None))
    for r in train_run:
        np.testing.assert_allclose(r["moe_train"], one, rtol=1e-4)


# ------------------------------------------------------- 1 rank: identities ----


def test_world1_mesh_is_bit_for_bit_no_mesh():
    out = group.spawn(R.world1_rank, 1, timeout=180)[0]
    for compiled in (True, False):
        (plain, meshed), (params_equal,) = out[compiled]
        assert plain == meshed and params_equal
    assert out["cannon"]


def test_spawn_raises_with_the_failing_rank_s_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*fails on purpose"):
        group.spawn(R.failing_rank, 2, timeout=60)


def test_spawn_kills_every_rank_at_its_timeout():
    with pytest.raises(TimeoutError, match="still running"):
        group.spawn(R.hanging_rank, 2, timeout=5)

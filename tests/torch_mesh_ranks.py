"""Rank programs of ``tests/test_torch_mesh.py``: each runs in one process of
a ``gloo`` rank group started by ``repro_torch.distributed.group.spawn``,
imports only the port, and returns numpy arrays and Python numbers for the
test to hold against the JAX package in its own process."""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import cannon, ctx, pipeline
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.shardspec import P
from repro_torch.launch.mesh import make_host_core_mesh, make_host_mesh
from repro_torch.models import moe
from repro_torch.models.layers import ops_matmul
from repro_torch.optim.adamw import AdamW, leaves
from repro_torch.optim.schedule import constant
from repro_torch.train import checkpoint as ck
from repro_torch.train import loop

#: the placement cases: (spec, shape) of a tensor on the (data=2, model=2) mesh
PLACEMENTS = [
    (P("data", "model"), (4, 6)),
    (P(("data", "model"), None), (8, 3)),
    (P(None, "model"), (3, 4)),
    (P("model", "data"), (2, 4)),
    (P(), (5,)),
]
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy().copy()


def _record_p2p(log: list):
    """Wrap ``batch_isend_irecv`` to record each call's sends as (bytes,
    peer)."""
    real = dist.batch_isend_irecv

    def wrapped(ops):
        log.append([(op.tensor.numel() * op.tensor.element_size(), op.peer)
                    for op in ops if op.op is dist.isend])
        return real(ops)

    return real, wrapped


def placement_rank(rank: int, world: int, full: list, moe_in: dict, pp: dict,
                   mm: list, tl: dict) -> dict:
    """named / logical_to_sharding, constrain on a DTensor, the MoE over
    the DP ranks, the pipeline over the model axis, Cannon on the 2×2 grid
    and two-level Cannon with ``mesh=``."""
    mesh = make_host_mesh(2, device="cpu")
    coord = tuple(int(c) for c in mesh.device_mesh.get_coordinate())
    out: dict = {"coord": coord, "mesh_errors": []}
    for make in (lambda: make_host_mesh(3, device="cpu"),
                 lambda: make_host_core_mesh(3, device="cpu"),
                 lambda: make_host_mesh(8, device="cpu")):
        try:
            make()
        except ValueError as e:
            out["mesh_errors"].append(str(e))

    # placement: each rank's shard of every case
    tree = [torch.as_tensor(a) for a in full]
    placed = sh.logical_to_sharding(mesh, tree, [s for s, _ in PLACEMENTS])
    out["shards"] = [_np(t.to_local()) for t in placed]
    out["named"] = [tuple(repr(p) for p in pl)
                    for pl in sh.named(mesh, [s for s, _ in PLACEMENTS])]
    out["full"] = [_np(t.full_tensor()) for t in placed]
    with ctx.mesh_axes(mesh.shape):
        moved = ctx.constrain(placed[0], None, ctx.TP)      # (4, 6): data,model -> -,model
        out["constrained"] = (tuple(repr(p) for p in moved.placements), _np(moved.to_local()))
        plain = torch.ones(4, 6)
        out["plain_is_same"] = ctx.constrain(plain, ctx.DP, ctx.TP) is plain

    # MoE: this DP rank's rows, one dispatch group
    cfg = moe_in["cfg"]
    p = {k: torch.as_tensor(v) for k, v in moe_in["params"].items()}
    x = torch.as_tensor(moe_in["x"])
    rows = x.shape[0] // 2
    mine = x[coord[0] * rows:(coord[0] + 1) * rows]
    with ctx.mesh_axes(mesh.shape), ctx.shard_local():
        out["moe_groups"] = ctx.dp_size()
        y, aux = moe.moe_forward(cfg, p, mine)
    out["moe"] = (_np(y), float(aux))

    # the pipeline: 4 stages over the model axis of a (1, 4) mesh
    ring = make_host_mesh(4, device="cpu")
    ws, bs = torch.as_tensor(pp["ws"]), torch.as_tensor(pp["bs"])
    out["pipeline"] = _np(pipeline.pipeline_apply(
        lambda prm, h: torch.tanh(h @ prm[0] + prm[1]), (ws, bs), torch.as_tensor(pp["xs"]),
        mesh=ring, axis="model"))

    # the same with the stage parameters placed on the axis
    staged = sh.logical_to_sharding(ring, [ws, bs], [P("model"), P("model")])
    out["pipeline_placed"] = _np(pipeline.pipeline_apply(
        lambda prm, h: torch.tanh(h @ prm[0] + prm[1]), staged, torch.as_tensor(pp["xs"]),
        mesh=ring, axis="model"))

    # Cannon on the 2×2 grid, the sends of each batch recorded
    sent: list = []
    real, wrapped = _record_p2p(sent)
    dist.batch_isend_irecv = wrapped
    try:
        out["cannon"] = []
        for a, b in mm:
            start = len(sent)
            c = cannon.cannon_matmul(torch.as_tensor(a), torch.as_tensor(b), mesh=mesh)
            out["cannon"].append((_np(c.full_tensor()), _np(c.to_local()), sent[start:]))
    finally:
        dist.batch_isend_irecv = real

    # Cannon from operands placed on the grid (rows over data, columns over model)
    a, b = (torch.as_tensor(x) for x in mm[0])
    placed_ab = sh.logical_to_sharding(mesh, [a, b], [P(None, "data"), P("model", None)])
    out["cannon_placed"] = _np(cannon.cannon_matmul(*placed_ab, mesh=mesh).full_tensor())

    # the example: inside a group of 4 ranks it runs Cannon over the 2×2 grid
    from repro_torch.examples import bsps_cannon

    n_grid, grid_mesh = bsps_cannon.grid("cpu")
    c, row = bsps_cannon.run_compiled(tl["a"], tl["b"], tl["m"], n_grid, grid_mesh,
                                      BSPAccelerator(**tl["pack"]), "cpu")
    out["example_cannon"] = (n_grid, grid_mesh.shape, c)

    # two-level Cannon on the rank grid, both modes
    acc = BSPAccelerator(**tl["pack"])
    out["two_level"] = {}
    for compiled in (False, True):
        c, runner = cannon.two_level_cannon(tl["a"], tl["b"], tl["m"], n_grid=2, mesh=mesh,
                                            machine=acc, compiled=compiled, device="cpu")
        row = runner.predicted_vs_measured()
        out["two_level"][compiled] = {
            "c": c, "cores": len(runner.core_records), "records": len(runner.records),
            "cost": runner.plan.cost(acc), "row": row}
    return out


def host_rank(rank: int, world: int) -> dict:
    """The host level calibrated over the (host=2, data=2, model=2) mesh,
    and two train steps of minicpm's fp32 2-layer smoke cut on it (priced
    at the third level: the ``[mesh]`` line)."""
    from repro_torch.core.calibrate import calibrate_host_level, measure_host_superstep

    mesh = make_host_core_mesh(2, model=2, device="cpu")
    g_sec, l_sec = measure_host_superstep(mesh)
    acc = calibrate_host_level(BSPAccelerator(p=1, g=0.0, l=0.0, r=1e9, e=1.0, L=1 << 20,
                                              E=1 << 24), mesh)
    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True), num_layers=2,
                              dtype="float32")
    lines: list[str] = []
    out = loop.train(cfg, loop.TrainConfig(steps=2, log_every=100), AdamW(constant(1e-3)),
                     data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         global_batch=4, seed=0),
                     machine=BSPAccelerator(**PACK), mesh=mesh, log=lines.append,
                     calibstore=False, device="cpu")
    return {"shape": mesh.shape, "fit": (g_sec, l_sec),
            "pack": (acc.hosts, acc.g_host, acc.l_host),
            "mesh_lines": [ln for ln in lines if ln.startswith("[mesh]")],
            "losses": _losses(out), "plan_row": out["plan_row"]}


def _train(cfg, steps: int, mesh, *, compiled: bool = True, ckpt_dir: str = "",
           ckpt_every: int = 50, faults=None, max_restarts: int = 0) -> dict:
    tcfg = loop.TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            log_every=100, compiled=compiled, max_restarts=max_restarts)
    return loop.train(cfg, tcfg, AdamW(schedule=constant(1e-3)),
                      data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                          global_batch=4, seed=0),
                      machine=BSPAccelerator(**PACK), mesh=mesh, log=lambda s: None,
                      faults=faults, calibstore=False, device="cpu")


def _losses(out: dict) -> list[float]:
    return [h["loss"] for h in out["history"]]


def train_rank(rank: int, world: int, dirs: dict) -> dict:
    """train(mesh=(2, 2)): minicpm's fp32 2-layer smoke cut from the JAX
    init (a step-0 checkpoint in each run's directory) in both modes, a
    crash and resume, qwen2-moe's smoke cut, and the last checkpoint
    restored onto a (4, 1) mesh through a sharder."""
    mesh = make_host_mesh(2, device="cpu")
    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True), num_layers=2,
                              dtype="float32")
    out: dict = {}
    runs = {}
    for compiled in (True, False):
        runs[compiled] = _train(cfg, 4, mesh, compiled=compiled, ckpt_dir=dirs[compiled],
                                ckpt_every=4)
        out[compiled] = _losses(runs[compiled])
    out["plan_row"] = runs[True]["plan_row"]
    out["grad_norm"] = [h["grad_norm"] for h in runs[True]["history"]]

    # a crash at the second compiled run (after the step-2 checkpoint)
    crash = FaultPlan([FaultSpec("dispatch_fail", at=(1,))]).replay()
    crashed = _train(cfg, 4, mesh, ckpt_dir=dirs["crash"], ckpt_every=2, faults=crash,
                     max_restarts=1)
    out["crash"] = (_losses(crashed), crashed["resumes"],
                    crashed["health"]["count_by_code"].get("BSPS212", 0))
    out["latest"] = ck.latest_step(dirs["crash"])

    # the step-4 checkpoint onto another mesh shape
    other = make_host_mesh(1, device="cpu")
    specs = sh.param_specs(cfg, other, crashed["params"])
    state_specs = {"params": specs, "opt_state": {"m": specs, "v": specs, "step": P()}}
    state = {"params": crashed["params"], "opt_state": crashed["opt_state"]}
    got, data_state = ck.restore(
        dirs["crash"], 4, state,
        sharder=lambda g, tree: sh.logical_to_sharding(other, tree, state_specs[g]))
    out["restored"] = {
        "mesh": other.shape, "data_state": data_state,
        "equal": all(torch.equal(a.full_tensor(), b.full_tensor())
                     for a, b in zip(leaves(got), leaves(state))),
        "placements": sorted({repr(t.placements) for t in leaves(got["params"])})}
    if rank == 0:
        shutil.rmtree(dirs["crash"], ignore_errors=True)

    qcfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True), dtype="float32")
    out["moe_train"] = _losses(_train(qcfg, 3, mesh))
    return out


def world1_rank(rank: int, world: int) -> dict:
    """train(mesh=(1, 1)) on a world-1 group against train(mesh=None), in
    both modes, and a 1×1 Cannon against the bare product."""
    mesh = make_host_mesh(device="cpu")
    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True), num_layers=2,
                              dtype="float32")
    out = {}
    for compiled in (True, False):
        runs = [_train(cfg, 3, m, compiled=compiled) for m in (None, mesh)]
        out[compiled] = ([_losses(r) for r in runs],
                         [all(torch.equal(a, b.to_local()) for a, b in
                              zip(leaves(runs[0]["params"]), leaves(runs[1]["params"])))])
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((16, 24)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((24, 8)), dtype=torch.float32)
    out["cannon"] = torch.equal(cannon.cannon_matmul(a, b, mesh=mesh).to_local(),
                                ops_matmul(a, b))
    return out


def failing_rank(rank: int, world: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()      # rank 0 waits for a rank that never comes


def hanging_rank(rank: int, world: int) -> None:
    dist.barrier()
    dist.recv(torch.empty(1), src=(rank + 1) % world)   # nobody sends

"""The training loop as a BSPS program: hypersteps + checkpoint/restart +
straggler monitor.

The JAX package's ``train/loop.py``. Training runs through
:class:`repro_torch.core.hyperstep.HyperstepRunner` — the same executor (and
the same Eq. 1 pricing) as every other stream program of the port:

  down stream   :class:`repro_torch.data.pipeline.BatchStream` — one training
                batch per token
  up stream     compiled mode: a per-step metrics vector written back into a
                backing :class:`~repro_torch.core.stream.Stream`; measure
                mode: a :class:`repro_torch.train.checkpoint.CheckpointStream`
                — every ``ckpt_every``-th hyperstep's token is a host
                snapshot, flushed to disk on the DMA lane overlapped with
                compute
  bulk sync     compiled mode: the end of the replayed run; measure mode:
                synchronising the device before advancing

Two execution modes. ``TrainConfig.compiled=True`` (default) runs each
checkpoint interval as **one compiled run**
(:meth:`HyperstepRunner.compile`): the batch window is staged on the device
at once, the replay carries (params, opt_state), the per-step metrics
(:data:`repro_torch.train.steps.TRAIN_METRICS`, 0-d tensors) stream up into
a backing array read after the run — no host read per step — and
checkpoints are written between runs. ``compiled=False`` is the
instrumented host loop: per-step records feed the straggler monitor and the
CheckpointStream overlaps snapshots with compute. Both modes run the same
eager step on the same batches, so their losses are equal bit for bit.

Either way the run is priced by :func:`repro_torch.core.plan.host_plan` (6
FLOPs per parameter per token a hyperstep) and the launcher prints the
runner's ``predicted_vs_measured()`` row.

Fault tolerance: auto-resume from the latest valid checkpoint (params, opt
state, *and* the data-stream cursor — restart is a stream ``seek``, computed
at the hyperstep boundary so prefetch lookahead can't skew it); straggler
monitor flags steps whose wall time is a >3σ outlier of the EWMA (measure
mode only: compiled mode has no per-step wall times).

``mesh=`` (a mesh over a rank group, :mod:`repro_torch.distributed.group`)
runs the job sharded, one process per rank: the mesh's axes registered in
:mod:`repro_torch.distributed.ctx`, parameters and moments placed as
DTensors by the declarative rules, each step the explicit ZeRO-3 step of
:func:`repro_torch.train.steps.make_sharded_train_step` (each DP rank on its
block of the batch's rows, in both modes), checkpoints gathered and written
by rank 0 and restored through a ``sharder``; with a ``host`` axis the plan
is priced at the third level too. The reference's ``jit_kwargs=`` is not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.calibrate import calibrate, calibrate_host_level
from repro_torch.core.calibstore import get_default_store, plan_band
from repro_torch.core.health import HealthMonitor
from repro_torch.core.hyperstep import HyperstepRunner
from repro_torch.core.plan import host_plan
from repro_torch.core.stream import Stream
from repro_torch.data.pipeline import BatchStream, DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import TRAIN_METRICS, make_sharded_train_step, make_train_step

__all__ = ["TrainConfig", "StragglerMonitor", "train"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    aux_weight: float = 0.01
    # True: one compiled run per checkpoint interval (the fast path). False:
    # the instrumented per-step host loop (straggler monitor, per-step
    # records, checkpoint I/O overlapped on the DMA lane).
    compiled: bool = True
    # crash auto-resume (DESIGN.md §10): a crash mid-run restores the latest
    # valid checkpoint and re-enters, up to max_restarts times (0 = crash
    # propagates; needs ckpt_dir). Resume is a stream seek, so the replayed
    # steps are token-for-token identical to an uncrashed run.
    max_restarts: int = 0


class StragglerMonitor:
    """EWMA + z-score outlier detector over hyperstep wall times."""

    def __init__(self, alpha: float = 0.1, zmax: float = 3.0, warmup: int = 5):
        self.alpha, self.zmax, self.warmup = alpha, zmax, warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, seconds: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.mean = seconds if self.n == 1 else (
                self.mean + (seconds - self.mean) / self.n)
            self.var = max(self.var, (seconds - self.mean) ** 2)
            return False
        std = max(np.sqrt(self.var), 1e-6)
        z = (seconds - self.mean) / std
        is_straggler = z > self.zmax
        if is_straggler:
            self.events.append((step, seconds, z))
        else:  # don't poison the EWMA with outliers
            d = seconds - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


def _state_words(params: Any, opt_state: Any) -> int:
    """Words of one snapshot: every leaf's elements (a 0-d leaf is one)."""
    return sum(x.numel() for x in leaves((params, opt_state)))


def _aggregate_rows(rows: list[dict[str, float]]) -> dict[str, float]:
    """Sum per-segment predicted_vs_measured rows into one run-level row."""
    out = {
        "predicted_seconds": sum(r["predicted_seconds"] for r in rows),
        "measured_seconds": sum(r["measured_seconds"] for r in rows),
        "bandwidth_heavy_predicted": rows[0]["bandwidth_heavy_predicted"],
        "bandwidth_heavy_measured": max(
            r["bandwidth_heavy_measured"] for r in rows),
        "fetch_words_planned": sum(r["fetch_words_planned"] for r in rows),
        "fetch_words_measured": sum(r["fetch_words_measured"] for r in rows),
    }
    out["pred_over_meas"] = (out["predicted_seconds"]
                             / max(out["measured_seconds"], 1e-12))
    return out


def _maybe_recalibrate(
    health: Any,
    calibstore: Any,
    runner: HyperstepRunner,
    stream: TokenStream,
    log: Callable[[str], None],
) -> BSPAccelerator | None:
    """Consume a pending drift event: refit the pack, re-price the prefetch.

    The training-side half of the DESIGN.md §11 loop. When the
    HealthMonitor's windowed median predicted/measured ratio leaves the
    drift band (BSPS220), refit (g, l, e) from the calibration store's most
    recent records for this plan's band — the segments whose sustained
    shift fired the detector — and swap the runner onto the refit pack
    (BSPS221). The online response: re-price the prefetch depth. A link
    measured slower than the pack promised (e grew) needs the producer
    running further ahead for the same compute/fetch overlap, so the depth
    scales by ``e_refit / e_old``. No store or an under-evidenced fit keeps
    the original pack (BSPS222). Returns the refit machine or None.
    """
    if health is None:
        return None
    event = health.pop_recalibration()
    if event is None:
        return None
    src = getattr(health, "name", "train")
    if calibstore is None or runner.plan is None or runner.machine is None:
        health.emit(
            "BSPS222", "calibration drift detected but recording is "
            f"disabled; nothing to refit from (ratio {event.ratio:.3g}x "
            "baseline)", source=src, index=event.index, value=event.ratio)
        return None
    band = plan_band(runner.plan)
    old = runner.machine
    refit = calibstore.refit_machine(old, band=band,
                                     window=health.drift_window,
                                     device=runner.device)
    if refit is None:
        health.emit(
            "BSPS222", f"calibration drift (ratio {event.ratio:.3g}x "
            f"baseline) but band {band} is under-evidenced; keeping the "
            "closed-form pack", source=src, index=event.index,
            value=event.ratio)
        return None
    runner.machine = refit
    scale = refit.e / max(old.e, 1e-12)
    if scale > 1.0:
        depth = max(4, int(np.ceil(max(stream.prefetch_depth, 2)
                                   * min(scale, 8.0))))
        stream.start_prefetch(depth)
        log(f"[health] recalibrated: link {scale:.2f}x slower than the pack "
            f"promised; prefetch depth -> {depth}")
    health.rebaseline()
    health.emit(
        "BSPS221", f"adopted calibration-store refit for band {band}: "
        f"g {old.g:.3g}->{refit.g:.3g}, l {old.l:.3g}->{refit.l:.3g}, "
        f"e {old.e:.3g}->{refit.e:.3g}; prefetch re-priced",
        source=src, index=event.index, value=scale)
    return refit


def _hyperstep_flops(cfg: ModelConfig, data_cfg: DataConfig) -> float:
    """Eq. 1's work of one train step: fwd + bwd ≈ 6 FLOPs per parameter per
    processed token (the parameter count in Python integers)."""
    return 6.0 * M.count_params(cfg) * data_cfg.global_batch * data_cfg.seq_len


def _train_compiled(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    step_fn: Callable,
    stream: TokenStream,
    params: Any,
    opt_state: Any,
    start_step: int,
    history: list,
    machine: BSPAccelerator,
    data_cfg: DataConfig,
    log: Callable[[str], None],
    device: torch.device,
    faults: Any | None = None,
    health: Any | None = None,
    calibstore: Any | None = None,
    host_comm_words: float = 0.0,
    host_supersteps: float = 0.0,
) -> tuple[Any, Any, dict[str, float]]:
    """Run training as compiled runs, one per checkpoint interval.

    Each segment stages its batch window (:meth:`BatchStream.as_stacked`),
    replays ``step_fn`` over it with no host read in between, the per-step
    metrics (:data:`TRAIN_METRICS`) streamed up into a backing array, then
    (at a checkpoint boundary) writes the checkpoint between runs. The
    final-step checkpoint is written by :func:`train`'s closing save, as in
    measure mode.
    """
    mkeys = list(TRAIN_METRICS)
    hyperstep_flops = _hyperstep_flops(cfg, data_cfg)

    def hyperstep(state, tokens):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state, tokens[0])
        mvec = torch.stack([metrics[k].float().reshape(()) for k in mkeys])
        return (params, opt_state), [mvec]

    # one runner (= one cached replay schedule) per segment length: a
    # compiled run leaves the BatchStream consumed but rewound, so the same
    # streams serve every equal-length segment
    runners: dict[int, tuple[HyperstepRunner, Stream]] = {}

    def runner_for(seg: int) -> tuple[HyperstepRunner, Stream]:
        if seg not in runners:
            batches = BatchStream(stream, seg)
            metrics_out = Stream(
                data=np.zeros((seg, len(mkeys)), np.float32),
                token_size=1, name="metrics")
            plan = host_plan(
                [batches], out_streams=[metrics_out],
                flops_per_hyperstep=hyperstep_flops, name=f"train_{cfg.name}",
                host_comm_words_per_hyperstep=host_comm_words,
                host_supersteps_per_hyperstep=host_supersteps)
            runners[seg] = (
                HyperstepRunner(hyperstep, [batches],
                                out_streams=[metrics_out],
                                plan=plan, machine=machine, device=device,
                                faults=faults, health=health,
                                calibstore=(calibstore if calibstore
                                            is not None else False)),
                metrics_out)
        return runners[seg]

    rows: list[dict[str, float]] = []
    done = start_step
    while done < tcfg.steps:
        seg = tcfg.steps - done
        if tcfg.ckpt_dir:
            seg = min(seg, tcfg.ckpt_every - done % tcfg.ckpt_every)
        runner, metrics_out = runner_for(seg)
        runner.reset_records()          # per-segment row; schedule stays cached
        params, opt_state = runner.run((params, opt_state), compiled=True)

        seg_seconds = runner.records[-1].step_seconds
        for i in range(seg):
            entry = {k: float(metrics_out.data[i, j])
                     for j, k in enumerate(mkeys)}
            entry["step_seconds"] = seg_seconds / seg   # per-step average
            step_idx = done + i
            if step_idx % tcfg.log_every == 0:
                log(f"[train] step {step_idx} loss {entry['loss']:.4f} "
                    f"gnorm {entry['grad_norm']:.3f}")
            history.append(entry)
        rows.append(runner.predicted_vs_measured())
        refit = _maybe_recalibrate(health, calibstore, runner, stream, log)
        if refit is not None:
            # every cached segment runner re-prices on the refit pack
            machine = refit
            for cached_runner, _ in runners.values():
                cached_runner.machine = refit
        done += seg
        if tcfg.ckpt_dir and done % tcfg.ckpt_every == 0 and done < tcfg.steps:
            # segment boundary: checkpoint I/O between runs (the run's final
            # step is saved by train()'s closing blocking save)
            ckpt.save(tcfg.ckpt_dir, done,
                      {"params": params, "opt_state": opt_state},
                      data_state=stream.state_at(done), blocking=True)
    return params, opt_state, _aggregate_rows(rows)


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    opt: AdamW,
    *,
    batch_putter: Callable[[dict], dict] | None = None,
    data_cfg: DataConfig | None = None,
    machine: BSPAccelerator | None = None,
    mesh: Any | None = None,
    log: Callable[[str], None] = print,
    faults: Any | None = None,
    calibstore: Any | None = None,
    device: Any = None,
) -> dict[str, Any]:
    """Run (or resume) a training job on ``device`` (the card unless the
    caller names another); returns final state + history.

    Parameters start from :func:`repro_torch.models.model.init_params` at
    ``tcfg.seed``, or from the latest valid checkpoint in ``tcfg.ckpt_dir``
    (with its data cursor: BSPS212 is emitted on a crash resume).

    ``faults`` is an optional :class:`~repro_torch.core.faults.FaultInjector`
    threaded through the runner and the data stream (DESIGN.md §10); with
    ``tcfg.max_restarts > 0`` an injected (or real) crash mid-run restores
    the latest valid checkpoint and replays — the returned history is
    token-for-token what an uncrashed run produces. The result carries the
    run's :class:`~repro_torch.core.health.HealthMonitor` rollup under
    ``"health"``.

    ``calibstore`` closes the calibration loop (DESIGN.md §11): measured
    segments land in the store, and a sustained predicted/measured drift
    (BSPS220) refits (g, l, e) from it and re-prices the prefetch depth
    online (BSPS221). ``None`` uses the process default store, a
    :class:`~repro_torch.core.calibstore.CalibrationStore` isolates this run,
    ``False`` disables recording and recalibration.

    ``machine`` is the :class:`BSPAccelerator` the run is priced on (default:
    a fast calibration of ``device``) — the returned ``plan_row`` is the
    runner's predicted-vs-measured table row. ``batch_putter`` is the
    :class:`BatchStream`'s ``put_fn`` (host loop only).

    ``mesh`` (a mesh over a rank group, every rank calling ``train`` alike)
    runs the whole job sharded under that mesh: parameters and optimizer
    moments are placed by the declarative rules
    (:mod:`repro_torch.distributed.shardspec`), each step is
    :func:`~repro_torch.train.steps.make_sharded_train_step`, and if the
    mesh has a ``host`` axis the plan is priced at the third level too —
    ``(g_host, l_host)`` calibrated over real collectives
    (:func:`calibrate_host_level`), the h-relation derived from the same
    resolved specs the step places by
    (:func:`~repro_torch.distributed.shardspec.host_h_relation`), so
    ``plan_row["predicted_seconds"]`` is the full recursion ``T_device +
    g_host·h_host + l_host·s_host``. ``device`` must be the group's device
    type.
    """
    if mesh is not None:
        with ctx.mesh_axes(dict(mesh.shape)):
            return _train_body(cfg, tcfg, opt, batch_putter=batch_putter, data_cfg=data_cfg,
                               machine=machine, mesh=mesh, log=log, faults=faults,
                               calibstore=calibstore, device=device)
    return _train_body(cfg, tcfg, opt, batch_putter=batch_putter, data_cfg=data_cfg,
                       machine=machine, mesh=None, log=log, faults=faults,
                       calibstore=calibstore, device=device)


def _train_body(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    opt: AdamW,
    *,
    batch_putter: Callable[[dict], dict] | None,
    data_cfg: DataConfig | None,
    machine: BSPAccelerator | None,
    mesh: Any | None,
    log: Callable[[str], None],
    faults: Any | None,
    calibstore: Any | None,
    device: Any,
) -> dict[str, Any]:
    device = resolve_device(device)
    if mesh is not None:
        from repro_torch.distributed.group import rank_device

        if mesh.device_mesh is None:
            raise ValueError("train(mesh=...) needs a mesh over a rank group "
                             "(repro_torch.distributed.group.start, then make_host_mesh)")
        if device.type != rank_device().type:
            raise ValueError(f"train: device {device} is not the rank group's "
                             f"{rank_device()}")
    data_cfg = data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=512, global_batch=8, seed=tcfg.seed)
    if calibstore is None:
        calibstore = get_default_store()
    calibstore = calibstore if calibstore is not False else None
    health = HealthMonitor(name=f"train_{cfg.name}")
    stream = TokenStream(data_cfg, faults=faults, health=health)

    def on_corrupt(step: int, err: Exception) -> None:
        log(f"[resume] checkpoint step {step} unreadable ({err}); "
            "falling back")

    params = M.init_params(cfg, tcfg.seed, device=device)
    opt_state = opt.init(params)
    start_step = 0
    host_comm_words = 0.0
    host_supersteps = 0.0
    restore_kw: dict[str, Any] = {"copy_into": True}
    if mesh is not None:
        from repro_torch.distributed import sharding as sh
        from repro_torch.distributed.shardspec import P, host_h_relation

        specs = sh.param_specs(cfg, mesh, params)
        state_specs = {"params": specs, "opt_state": {"m": specs, "v": specs, "step": P()}}

        def place(group: str, tree: Any) -> Any:
            """A checkpoint group's tree on the mesh (the restore's ``sharder``)."""
            return sh.logical_to_sharding(mesh, tree, state_specs[group])

        params, opt_state = place("params", params), place("opt_state", opt_state)
        restore_kw = {"sharder": place}
        machine = machine or calibrate(fast=True, device=device)
        if "host" in mesh.axis_names:
            machine = calibrate_host_level(machine, mesh)
            hrel = host_h_relation(mesh, specs, params)
            host_comm_words = hrel["h_words"]
            host_supersteps = hrel["supersteps"]
            log(f"[mesh] hosts={hrel['hosts']} h_words/step="
                f"{host_comm_words:.3g} g_host={machine.g_host:.3g} "
                f"l_host={machine.l_host:.3g}")

    if tcfg.ckpt_dir:
        resumed = ckpt.restore_latest(
            tcfg.ckpt_dir, {"params": params, "opt_state": opt_state},
            on_corrupt=on_corrupt, **restore_kw)
        if resumed is not None:
            start_step, state, data_state = resumed
            params, opt_state = state["params"], state["opt_state"]
            stream.load_state_dict(data_state)        # seek — the BSPS restart
            log(f"[resume] step {start_step}, stream cursor {stream.cursor}")

    if mesh is not None:
        step_fn = make_sharded_train_step(cfg, opt, mesh, specs, aux_weight=tcfg.aux_weight,
                                          device=device)
    else:
        step_fn = make_train_step(cfg, opt, aux_weight=tcfg.aux_weight, device=device)
    monitor = StragglerMonitor()
    history: list[dict[str, float]] = []
    plan_row: dict[str, float] | None = None

    use_compiled = tcfg.compiled
    if use_compiled and batch_putter is not None:
        # compiled mode stages raw batch windows (BatchStream.as_stacked
        # skips put_fn — placement is the run's job, but a put_fn may
        # transform values), so a custom putter needs the host loop
        log("[train] batch_putter set: falling back to the instrumented "
            "host loop (compiled mode stages raw batches)")
        use_compiled = False

    def _run_host_loop(params, opt_state, start_step, steps_left):
        batches = BatchStream(stream, steps_left, put_fn=batch_putter)
        out_streams: list[Any] = []
        out_every: list[int] = []
        if tcfg.ckpt_dir:
            out_streams = [ckpt.CheckpointStream(
                tcfg.ckpt_dir, every=tcfg.ckpt_every, num_tokens=steps_left,
                state_words=_state_words(params, opt_state))]
            out_every = [tcfg.ckpt_every]

        plan = host_plan(
            [batches], out_streams=out_streams, out_every=out_every,
            flops_per_hyperstep=_hyperstep_flops(cfg, data_cfg),
            name=f"train_{cfg.name}",
            host_comm_words_per_hyperstep=host_comm_words,
            host_supersteps_per_hyperstep=host_supersteps,
        )

        def hyperstep(state, tokens):
            params, opt_state = state
            params, opt_state, metrics = step_fn(params, opt_state, tokens[0])
            metrics = {k: float(v) for k, v in metrics.items()}
            step_idx = initial_start + len(history)
            history.append(metrics)
            if step_idx % tcfg.log_every == 0:
                log(f"[train] step {step_idx} loss {metrics['loss']:.4f} "
                    f"gnorm {metrics['grad_norm']:.3f}")
            tok = None
            if out_streams and (step_idx + 1) % tcfg.ckpt_every == 0:
                # host snapshot *now*, before the next hyperstep updates the
                # tensors in place; the DMA lane flushes it to disk during
                # that compute
                tok = (step_idx + 1,
                       ckpt.snapshot({"params": params, "opt_state": opt_state}),
                       stream.state_at(step_idx + 1))
            state = (params, opt_state)
            return (state, [tok]) if out_streams else state

        fetch_dominant = 0

        def on_end(h: int, _streams) -> None:
            nonlocal fetch_dominant
            if not runner.records:  # the h=0 call precedes the first hyperstep
                return
            rec = runner.records[-1]
            step_idx = start_step + rec.index
            history[-1]["step_seconds"] = rec.step_seconds
            if monitor.observe(step_idx, rec.step_seconds):
                log(f"[straggler] step {step_idx}: {rec.step_seconds:.3f}s "
                    f"(mean {monitor.mean:.3f}s)")
            # fetch-wait response (DESIGN.md §10): when the bulk sync keeps
            # blocking on the down-lane, deepen the stream's prefetch so the
            # producer runs further ahead of the consumer
            if rec.fetch_wait_seconds > rec.compute_seconds:
                fetch_dominant += 1
                if fetch_dominant >= 3:
                    depth = max(4, 2 * stream.prefetch_depth)
                    stream.start_prefetch(depth)
                    log(f"[health] fetch-wait dominant {fetch_dominant} steps "
                        f"running; prefetch depth -> {depth}")
                    fetch_dominant = 0
            else:
                fetch_dominant = 0
            # drift response (DESIGN.md §11): sustained predicted/measured
            # shift → refit from the calibration store, re-price the prefetch
            _maybe_recalibrate(health, calibstore, runner, stream, log)

        runner = HyperstepRunner(
            hyperstep, [batches], out_streams=out_streams,
            on_hyperstep_end=on_end, plan=plan, machine=machine, device=device,
            faults=faults, health=health,
            calibstore=calibstore if calibstore is not None else False,
        )
        params, opt_state = runner.run((params, opt_state))
        if runner.records:  # on_end never fires after the terminal hyperstep
            rec = runner.records[-1]
            history[-1]["step_seconds"] = rec.step_seconds
            monitor.observe(start_step + rec.index, rec.step_seconds)
        return params, opt_state, runner.predicted_vs_measured()

    initial_start = start_step
    resumes = 0
    while True:
        steps_left = tcfg.steps - start_step
        try:
            if steps_left > 0:
                machine = machine or calibrate(fast=True, device=device)
            if steps_left > 0 and use_compiled:
                params, opt_state, plan_row = _train_compiled(
                    cfg, tcfg, step_fn, stream, params, opt_state, start_step,
                    history, machine, data_cfg, log, device,
                    faults=faults, health=health, calibstore=calibstore,
                    host_comm_words=host_comm_words, host_supersteps=host_supersteps)
            elif steps_left > 0:
                params, opt_state, plan_row = _run_host_loop(
                    params, opt_state, start_step, steps_left)
            break
        except Exception as e:  # noqa: BLE001 — crash → checkpoint resume
            if resumes >= tcfg.max_restarts or not tcfg.ckpt_dir:
                raise
            resumes += 1
            log(f"[resume] crash at attempt {resumes}: {e!r}")
            if mesh is not None:
                dist.barrier()      # rank 0's last checkpoint is committed
            restored = ckpt.restore_latest(
                tcfg.ckpt_dir, {"params": params, "opt_state": opt_state},
                on_corrupt=on_corrupt, **restore_kw)
            if restored is None:
                # nothing valid on disk: replay from scratch
                params = M.init_params(cfg, tcfg.seed, device=device)
                opt_state = opt.init(params)
                if mesh is not None:
                    params, opt_state = place("params", params), place("opt_state", opt_state)
                start_step = initial_start = 0
                stream.load_state_dict(stream.state_at(0))
                del history[:]
            else:
                start_step, state, data_state = restored
                params, opt_state = state["params"], state["opt_state"]
                stream.load_state_dict(data_state)    # seek — the BSPS restart
                # drop replayed-step entries so the final history is
                # token-for-token what an uncrashed run produces
                del history[start_step - initial_start:]
            health.emit("BSPS212", f"resumed from step {start_step} "
                        f"(attempt {resumes}/{tcfg.max_restarts})",
                        source=f"train_{cfg.name}", index=start_step)
            log(f"[resume] restored step {start_step}, stream cursor "
                f"{stream.cursor}")

    stream.stop_prefetch()
    if plan_row is not None:
        log("[plan] " + " ".join(f"{k}={v:.4g}" for k, v in plan_row.items()))
    if tcfg.ckpt_dir:
        ckpt.save(tcfg.ckpt_dir, tcfg.steps,
                  {"params": params, "opt_state": opt_state},
                  data_state=stream.state_at(tcfg.steps), blocking=True)
    return {
        "params": params, "opt_state": opt_state,
        "history": history, "stragglers": monitor.events,
        "plan_row": plan_row, "resumes": resumes,
        "health": health.rollup(),
    }

"""Traffic kind "train": a closed loop of back-to-back training steps.

Set-up builds one train step (``train/steps.make_train_step`` with the
program's AdamW on the traffic's schedule) over the benchmark's weights and
a ``data/pipeline.BatchStream`` over the synthetic source, drives it
through its first ``check_steps`` steps (which compile and warm every
shape) and hands that same object to the window. Those steps' readings are
what the check compares with the reference: each step's loss, the first
step's clipped gradient of each leaf (worked out from the first moment after
one step: m₁ = (1 - b1)·g) and each leaf's change over the steps.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench.reference import train as reftrain
from portbench.reference.compare import tokens, worst_leaf
from portbench.weights import make_params

#: units run under the profiler in a traced run
TRACED_UNITS = 2


def synthetic_batch(vocab: int, batch: int, seq: int, seed: int, index: int):
    """Batch ``index`` of the synthetic source: tokens and next-token labels
    drawn uniformly from the vocabulary, seeded by (seed, index)."""
    toks = tokens(vocab, (batch, seq + 1), seed, index)
    return toks[:, :-1], toks[:, 1:]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.tokens_per_unit = self.tr["batch"] * self.tr["seq_len"]
        self.fetch_s: list[float] = []
        self.shapes: list[dict] = []
        self.counters: dict = {}
        self.failed = 0

    # -- the program -----------------------------------------------------------

    def set_up(self) -> None:
        from repro_torch.data.pipeline import BatchStream, DataConfig, TokenStream
        from repro_torch.optim.adamw import AdamW
        from repro_torch.optim.schedule import constant, wsd
        from repro_torch.train.steps import make_train_step

        ctx, tr = self.ctx, self.tr
        dev = ctx.device
        cfg = ctx.program_config(remat=tr["remat"])
        s = tr["schedule"]
        sched = (wsd(s["peak_lr"], s["warmup"], s["total"], s.get("decay_frac", 0.1),
                     s.get("floor", 0.01)) if s["name"] == "wsd" else constant(s["lr"]))
        a = tr["adamw"]
        opt = AdamW(schedule=sched, b1=a["b1"], b2=a["b2"], eps=a["eps"],
                    weight_decay=a["weight_decay"], grad_clip=a["grad_clip"])
        self.opt = opt
        self.params = make_params(ctx.cfg, ctx.seed, dev)
        self.state = opt.init(self.params)
        self.step_fn = make_train_step(cfg, self.opt, device=dev)
        self.fed: list = []
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=tr["seq_len"],
                          global_batch=tr["batch"], seed=ctx.seed)
        self.batches = BatchStream(TokenStream(data), 1 << 40, put_fn=self._put)
        self.batches.open(0)
        self.readings = {"loss": [], "grad1": [], "delta": []}
        b1 = a["b1"]
        for step in range(1, tr["check_steps"] + 1):
            metrics = self._step()
            self.readings["loss"].append(float(metrics["loss"]))
            if step == 1:
                self.readings["grad1"] = [float(m.double().norm()) / (1 - b1)
                                          for m in reftrain.leaves(self.state["m"])]
        init = make_params(ctx.cfg, ctx.seed, dev)
        self.readings["delta"] = [float((p.float() - q.float()).double().norm())
                                  for p, q in zip(reftrain.leaves(self.params),
                                                  reftrain.leaves(init))]
        del init

    def _put(self, batch: dict) -> dict:
        if len(self.fed) < self.tr["check_steps"]:
            self.fed.append((batch["tokens"].copy(), batch["labels"].copy()))
        return {k: torch.as_tensor(v).to(self.ctx.device, non_blocking=True)
                for k, v in batch.items()}

    def _step(self) -> dict:
        t0 = time.perf_counter()
        batch = self.batches.move_down(0)
        self.fetch_s.append(time.perf_counter() - t0)
        self.params, self.state, metrics = self.step_fn(self.params, self.state, batch)
        return metrics

    def run_unit(self) -> None:
        self._step()
        self.shapes.append({})

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"train_tokens_per_s": units * self.tokens_per_unit / window_s}

    def spans(self) -> dict:
        n = self.tr["check_steps"]
        return {"batch_fetch_s": self.fetch_s[n:]}

    def release(self) -> None:
        self.batches.close(0)
        del self.params, self.state, self.step_fn, self.opt, self.batches

    # -- the check -----------------------------------------------------------------

    def check(self) -> list[tuple[str, float]]:
        ctx, tr = self.ctx, self.tr
        dev = ctx.device
        own = [synthetic_batch(ctx.cfg["vocab_size"], tr["batch"], tr["seq_len"],
                               ctx.seed, i) for i in range(tr["check_steps"])]
        mismatch = sum(int((a != c).sum()) + int((b != d).sum())
                       for (a, b), (c, d) in zip(self.fed, own))
        params = make_params(ctx.cfg, ctx.seed, dev)
        batches = [(torch.as_tensor(t, device=dev), torch.as_tensor(lab, device=dev))
                   for t, lab in own]
        ref = reftrain.follow(ctx.cfg, params, batches, tr["schedule"], tr["adamw"])
        return compare(self.readings, ref) + [("batch_mismatch", float(mismatch))]


def compare(prog: dict, ref: dict) -> list[tuple[str, float]]:
    """The train cell's numbers: the worst step's loss gap over the
    reference's loss, the worst leaf's first-gradient gap and the worst
    leaf's change gap (each against the reference's norm of that leaf or
    the median leaf's, whichever is larger). Leaves whose reference gradient
    is under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    g_med = statistics.median(ref["grad1"])
    moved = [i for i, g in enumerate(ref["grad1"]) if g >= 1e-3 * g_med]
    return [("loss_gap", loss_gap),
            ("grad_gap", worst_leaf(prog["grad1"], ref["grad1"])),
            ("update_gap", worst_leaf([prog["delta"][i] for i in moved],
                                      [ref["delta"][i] for i in moved]))]


def _reference(ctx, **kw):
    tr = ctx.traffic
    params = make_params(ctx.cfg, ctx.seed, ctx.device)
    batches = [tuple(torch.as_tensor(x, device=ctx.device)
                     for x in synthetic_batch(ctx.cfg["vocab_size"], tr["batch"], tr["seq_len"],
                                              ctx.seed, i))
               for i in range(tr["check_steps"])]
    return params, batches, reftrain.follow(ctx.cfg, params, batches, tr["schedule"],
                                            tr["adamw"], **kw)


def control_numbers(ctx) -> list[tuple[str, float]]:
    """The control in the program's place: the fp8 reference's readings of
    the cell's first steps against the fp32 reference's."""
    _, _, ref = _reference(ctx)
    _, _, ctl = _reference(ctx, quant=True)
    return compare(ctl, ref)


def fault_numbers(ctx) -> dict[str, list[tuple[str, float]]]:
    """The faults a train cell can have, planted in the reference put in the
    program's place: half of each batch left out (the mean taken over the
    rest). A state left unchanged reads 1 by the change's measure."""
    tr = ctx.traffic
    params, batches, ref = _reference(ctx)
    n = tr["batch"] // 2
    half = reftrain.follow(ctx.cfg, params, [(t[:n], lab[:n]) for t, lab in batches],
                           tr["schedule"], tr["adamw"])
    return {"half_batch": compare(half, ref)}

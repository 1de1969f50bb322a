"""Traffic kind "decode": offline batch generation, a closed loop of
``launch/serve.generate`` calls.

Each call takes ``batch`` prompts of ``prompt_len`` tokens drawn from
(seed, call) and generates ``new_tokens`` greedy tokens a row through the
program's compiled decode. Set-up runs one call of the cell's shape (it
builds and warms everything the calls use). The check takes one window
call drawn from the seed and runs the reference over its prompts and
served tokens a position at a time, all of its rows together (an MoE layer
routes a step's rows as one group, as the program does), and reads how far
each served token's logit lies below the reference's best. It compares the
largest ``check_quantile``-quantile of a span of ``check_span`` served tokens
of one row (``reference.compare.worst_span_quantile``), so that a fault in
one slot, or in the late steps, shows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference.compare import (control_gap, describe, served_gap, tokens,
                                         worst_span_quantile)
from portbench.reference.model import Ref
from portbench.weights import make_params

#: units run under the profiler in a traced run
TRACED_UNITS = 1


#: the compared number
NUMBER = "served_gap_worst_span"


def prompts(vocab: int, batch: int, length: int, seed: int, call: int) -> np.ndarray:
    return tokens(vocab, (batch, length), seed, call)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.shapes: list[dict] = []
        self.counters = {"launches": 0, "token_steps": 0}
        self.prefill_s: list[float] = []
        self.call_s: list[float] = []
        self.outputs: dict[int, np.ndarray] = {}
        self.failed = 0
        self.calls = 0

    def set_up(self) -> None:
        from repro_torch.kernels import ops
        from repro_torch.launch.serve import generate

        self.ops, self.generate = ops, generate
        self.pcfg = self.ctx.program_config()
        self.params = make_params(self.ctx.cfg, self.ctx.seed, self.ctx.device)
        # the warm-up call uses prompts no window call uses
        self._call(-1)
        # the call whose tokens are checked: one of the first few, which
        # every window of the cell's length finishes
        self.checked = self.ctx.seed % 2

    def _call(self, index: int) -> None:
        tr = self.tr
        prompt = prompts(self.ctx.cfg["vocab_size"], tr["batch"], tr["prompt_len"],
                         self.ctx.seed, index + 1)
        self.ops.reset_launch_counts()
        t0 = time.perf_counter()
        out, stats = self.generate(self.pcfg, self.params, torch.from_numpy(prompt),
                                   steps=tr["new_tokens"], device=self.ctx.device)
        wall = time.perf_counter() - t0
        out = out.cpu().numpy()
        if index < 0:
            return
        self.prefill_s.append(stats.prefill_seconds)
        self.call_s.append(wall)
        self.counters["launches"] += sum(self.ops.launch_counts().values())
        self.counters["token_steps"] += tr["prompt_len"] + tr["new_tokens"]
        served = out[:, tr["prompt_len"]:]
        if (out[:, :tr["prompt_len"]] != prompt).any() or served.shape[1] != tr["new_tokens"] \
                or (served < 0).any() or (served >= self.ctx.cfg["vocab_size"]).any():
            self.failed += 1
        if index == getattr(self, "checked", None):
            self.outputs[index] = out

    def run_unit(self) -> None:
        self._call(self.calls)
        self.calls += 1
        self.shapes.append({})

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"decode_tokens_per_s": units * self.tr["batch"] * self.tr["new_tokens"] / window_s}

    def spans(self) -> dict:
        return {"prefill_s": self.prefill_s, "call_s": self.call_s}

    def release(self) -> None:
        del self.params, self.generate, self.ops

    def check(self) -> list[tuple[str, float]]:
        if self.checked not in self.outputs:
            return [(NUMBER, float("inf"))]
        seq = torch.as_tensor(self.outputs[self.checked], device=self.ctx.device)
        gaps = reference_gaps(self.ctx.cfg, make_params(self.ctx.cfg, self.ctx.seed,
                                                        self.ctx.device),
                              seq, self.tr["prompt_len"])
        return numbers("[decode] served", gaps, self.tr)


def reference_gaps(cfg: dict, params: dict, seq: torch.Tensor,
                   prompt_len: int) -> torch.Tensor:
    """Feed ``seq`` (B, prompt + served) a position at a time to the
    reference and return, for every served token, how far its logit lies
    below the reference's best (B, served)."""
    b, n = seq.shape
    ref = Ref(cfg, params)
    st = ref.decode_state(b, n, seq.device)
    gaps = []
    with torch.no_grad():
        for t in range(n - 1):
            logits = ref.step(seq[:, t], st)
            if t >= prompt_len - 1:
                gaps.append(served_gap(logits, seq[:, t + 1]))
    return torch.stack(gaps, dim=1)


def control_gaps(ctx) -> torch.Tensor:
    """The control in the program's place: the reference greedy-decodes the
    cell's first call, the fp8 control reads the same tokens beside it, and
    the gap is of the token the control puts first at each served position
    (B, served)."""
    tr, cfg = ctx.traffic, ctx.cfg
    params = make_params(cfg, ctx.seed, ctx.device)
    prompt = torch.as_tensor(prompts(cfg["vocab_size"], tr["batch"], tr["prompt_len"],
                                     ctx.seed, 1), device=ctx.device)
    n = tr["prompt_len"] + tr["new_tokens"]
    ref, ctl = Ref(cfg, params), Ref(cfg, params, quant=True)
    st, cst = ref.decode_state(tr["batch"], n, ctx.device), ctl.decode_state(tr["batch"], n,
                                                                              ctx.device)
    gaps, tok = [], None
    with torch.no_grad():
        for t in range(n - 1):
            tok = prompt[:, t] if t < tr["prompt_len"] else tok
            logits, c_logits = ref.step(tok, st), ctl.step(tok, cst)
            if t >= tr["prompt_len"] - 1:
                gaps.append(control_gap(logits, c_logits))
                tok = logits.argmax(dim=-1)
    return torch.stack(gaps, dim=1)


def control_numbers(ctx) -> list[tuple[str, float]]:
    return numbers("[decode] control", control_gaps(ctx), ctx.traffic)


def numbers(tag: str, gaps: torch.Tensor, tr: dict) -> list[tuple[str, float]]:
    """The compared number of ``gaps``, their distribution printed."""
    describe(tag, gaps, tr["check_span"], tr["check_quantile"])
    return [(NUMBER, worst_span_quantile(gaps, tr["check_span"], tr["check_quantile"]))]

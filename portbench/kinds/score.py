"""Traffic kind "score": offline scoring, a closed loop of full-sequence
forwards (``train/steps.make_prefill_step``) over ``batch`` documents of
``seq_len`` tokens drawn from (seed, call).

A score is the log-likelihood of each document's next token at every
position. Set-up runs one call of the cell's shape. The check keeps the
logits of one window call drawn from the seed, runs the reference over
the same documents and reads the gap between the program's and the
reference's log-probability of the next token at every position. It
compares the largest ``check_quantile``-quantile of a span of
``check_span`` positions of one document
(``reference.compare.worst_span_quantile``): a fault in one document, or in
the late positions of each, shows.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.compare import describe, tokens, worst_span_quantile
from portbench.reference.model import Ref
from portbench.weights import make_params

#: units run under the profiler in a traced run
TRACED_UNITS = 2


#: the compared number
NUMBER = "logprob_gap_worst_span"


def documents(vocab: int, batch: int, seq: int, seed: int, call: int) -> np.ndarray:
    return tokens(vocab, (batch, seq), seed, call)


def next_logprobs(logits: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """log p(token t+1 | ..t) at every position but the last: (B, S-1)."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return lp.gather(-1, docs[:, 1:].long()[..., None])[..., 0]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.shapes: list[dict] = []
        self.counters: dict = {}
        self.failed = 0
        self.kept = None
        self.checked = ctx.seed % 4

    def set_up(self) -> None:
        from repro_torch.train.steps import make_prefill_step

        ctx = self.ctx
        self.step = make_prefill_step(ctx.program_config(), device=ctx.device)
        self.params = make_params(ctx.cfg, ctx.seed, ctx.device)
        self._call(-1)

    def _call(self, index: int) -> None:
        tr = self.tr
        docs = documents(self.ctx.cfg["vocab_size"], tr["batch"], tr["seq_len"],
                         self.ctx.seed, index + 1)
        batch = {"tokens": torch.from_numpy(docs).to(self.ctx.device, non_blocking=True)}
        logits = self.step(self.params, batch)
        if index == self.checked:
            self.kept = logits

    def run_unit(self) -> None:
        self._call(len(self.shapes))
        self.shapes.append({})

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"score_tokens_per_s": units * self.tr["batch"] * self.tr["seq_len"] / window_s}

    def spans(self) -> dict:
        return {}

    def release(self) -> None:
        del self.params, self.step

    def check(self) -> list[tuple[str, float]]:
        if self.kept is None:
            return [(NUMBER, float("inf"))]
        gaps = self.gaps()
        if gaps is None:
            return [(NUMBER, float("inf"))]
        return numbers("[score] program log-prob", gaps, self.tr)

    def gaps(self) -> torch.Tensor | None:
        """|the program's - the reference's log p(next token)| at every
        position of the kept call (B, S-1); None where the program's are
        not finite."""
        ctx, tr = self.ctx, self.tr
        docs = torch.as_tensor(documents(ctx.cfg["vocab_size"], tr["batch"], tr["seq_len"],
                                         ctx.seed, self.checked + 1), device=ctx.device)
        with torch.no_grad():
            prog = next_logprobs(self.kept, docs)
            self.kept = None
            ref = reference_logprobs(ctx.cfg, make_params(ctx.cfg, ctx.seed, ctx.device), docs)
        return (prog - ref).abs() if torch.isfinite(prog).all() else None


def reference_logprobs(cfg: dict, params: dict, docs: torch.Tensor, *,
                       quant: bool = False) -> torch.Tensor:
    """The reference's next-token log-probabilities; the head a row at a
    time."""
    ref = Ref(cfg, params, quant=quant)
    h = ref.hidden(docs)
    return torch.cat([next_logprobs(ref.head(h[r:r + 1]), docs[r:r + 1])
                      for r in range(docs.shape[0])])


def control_gaps(ctx) -> torch.Tensor:
    """The control in the program's place: the fp8 reference's log-probs of
    the cell's first call against the fp32 reference's (B, S-1)."""
    tr, cfg = ctx.traffic, ctx.cfg
    params = make_params(cfg, ctx.seed, ctx.device)
    docs = torch.as_tensor(documents(cfg["vocab_size"], tr["batch"], tr["seq_len"], ctx.seed, 1),
                           device=ctx.device)
    with torch.no_grad():
        ref = reference_logprobs(cfg, params, docs)
        ctl = reference_logprobs(cfg, params, docs, quant=True)
    return (ctl - ref).abs()


def control_numbers(ctx) -> list[tuple[str, float]]:
    return numbers("[score] control log-prob", control_gaps(ctx), ctx.traffic)


def numbers(tag: str, gaps: torch.Tensor, tr: dict) -> list[tuple[str, float]]:
    """The compared number of ``gaps``, their distribution printed."""
    describe(tag, gaps, tr["check_span"], tr["check_quantile"])
    return [(NUMBER, worst_span_quantile(gaps, tr["check_span"], tr["check_quantile"]))]

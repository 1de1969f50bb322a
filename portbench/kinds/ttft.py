"""Traffic kind "ttft": one client's closed loop of requests that each wait
for their first token.

A request is ``launch/serve.generate`` at batch 1 with ``steps=1`` over a
prompt drawn from (seed, request); its time to first token is the call's
wall, from the call until its token is on the host. The prompt lengths are
the traffic's fixed set, replayed in blocks that each hold every length once
in an order drawn from the seed, so every seed sends the same mix and the
95th percentile falls among the longest. Set-up sends one request of every
length. The check runs the reference over ``check_requests`` requests drawn
from the seed, the longest length among them, and reads how far each served
token's logit lies below the reference's best.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from portbench.reference.compare import control_gap, served_gap, tokens
from portbench.reference.model import Ref
from portbench.weights import make_params

#: units run under the profiler in a traced run
TRACED_UNITS = 5


def prompt(vocab: int, length: int, seed: int, request: int) -> np.ndarray:
    return tokens(vocab, (1, length), seed, request)


def lengths(lens: list[int], seed: int, n: int) -> list[int]:
    """The first ``n`` prompt lengths: blocks of the whole set, each block
    in an order drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2**32]))
    out: list[int] = []
    while len(out) < n:
        out += [lens[i] for i in rng.permutation(len(lens))]
    return out[:n]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.shapes: list[dict] = []
        self.counters: dict = {}
        self.walls: list[float] = []
        self.served: list[tuple[int, int, int]] = []      # (request, length, token)
        self.failed = 0
        self.order = lengths(self.tr["prompt_lens"], ctx.seed, 1 << 16)

    def set_up(self) -> None:
        from repro_torch.launch.serve import generate

        self.generate = generate
        self.pcfg = self.ctx.program_config()
        self.params = make_params(self.ctx.cfg, self.ctx.seed, self.ctx.device)
        for i, n in enumerate(sorted(self.tr["prompt_lens"])):
            self._request(2**40 + i, n)
        self.walls.clear()
        self.served.clear()

    def _request(self, index: int, n: int) -> None:
        p = prompt(self.ctx.cfg["vocab_size"], n, self.ctx.seed, index)
        t0 = time.perf_counter()
        out, _ = self.generate(self.pcfg, self.params, torch.from_numpy(p), steps=1,
                               device=self.ctx.device)
        tok = int(out[0, n])
        self.walls.append(time.perf_counter() - t0)
        if not 0 <= tok < self.ctx.cfg["vocab_size"]:
            self.failed += 1
        self.served.append((index, n, tok))

    def run_unit(self) -> None:
        i = len(self.shapes)
        self._request(i, self.order[i])
        self.shapes.append({"prompt_len": self.order[i]})

    def end_to_end(self, units: int, window_s: float) -> dict:
        walls = self.walls[:units]
        p95 = (statistics.quantiles(walls, n=20, method="inclusive")[18] if len(walls) > 1
               else walls[0])
        return {"ttft_p95_ms": 1e3 * p95}

    def spans(self) -> dict:
        return {"ttft_s": self.walls}

    def release(self) -> None:
        del self.params, self.generate

    def sample(self) -> list[tuple[int, int, int]]:
        """The requests the check compares: drawn from the seed among those
        served, with the longest prompt among them."""
        k = self.tr["check_requests"]
        rng = np.random.default_rng(np.random.SeedSequence([self.ctx.seed, 2**32 + 1]))
        pick = rng.choice(len(self.served), size=min(k, len(self.served)), replace=False)
        chosen = [self.served[i] for i in sorted(pick)]
        longest = max(n for _, n, _ in self.served)
        if all(n != longest for _, n, _ in chosen):
            chosen[-1] = next(s for s in self.served if s[1] == longest)
        return chosen

    def check(self) -> list[tuple[str, float]]:
        ctx = self.ctx
        ref = Ref(ctx.cfg, make_params(ctx.cfg, ctx.seed, ctx.device))
        gaps = []
        with torch.no_grad():
            for index, n, tok in self.sample():
                p = torch.as_tensor(prompt(ctx.cfg["vocab_size"], n, ctx.seed, index),
                                    device=ctx.device)
                logits = ref.head(ref.hidden(p)[:, -1])
                gaps.append(float(served_gap(logits, torch.tensor([tok], device=ctx.device))))
        print(f"[ttft] served gaps: {sorted(gaps)}", file=sys.stderr)
        return [("served_gap", max(gaps))]


def control_numbers(ctx) -> list[tuple[str, float]]:
    """The control in the program's place: at the last position of
    ``check_requests`` prompts (every length, the longest included), the gap
    in the reference's logits of the token the fp8 control puts first."""
    tr, cfg = ctx.traffic, ctx.cfg
    params = make_params(cfg, ctx.seed, ctx.device)
    ref, ctl = Ref(cfg, params), Ref(cfg, params, quant=True)
    order = lengths(tr["prompt_lens"], ctx.seed, tr["check_requests"])
    gaps = []
    with torch.no_grad():
        for i, n in enumerate(order):
            p = torch.as_tensor(prompt(cfg["vocab_size"], n, ctx.seed, i), device=ctx.device)
            logits = ref.head(ref.hidden(p)[:, -1])
            c_logits = ctl.head(ctl.hidden(p)[:, -1])
            gaps.append(float(control_gap(logits, c_logits)))
    print(f"[ttft] control gaps: {sorted(gaps)}", file=sys.stderr)
    return [("served_gap", max(gaps))]

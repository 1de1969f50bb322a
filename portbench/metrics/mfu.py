"""mfu.<kind>: the model's operations in the window (every product and
attention pair of the forward, three times over for a train step: 6·N·D
plus attention; no recompute) over the window's seconds, as a share of the
card's bf16 peak, in %."""

from portbench.count.peaks import PEAK_FLOPS


def read(name, run):
    if run.window_s <= 0 or run.model_flops <= 0:
        return None
    return 100.0 * run.model_flops / run.window_s / PEAK_FLOPS["bf16"]

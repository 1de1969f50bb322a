"""step_roofline.<kind>: the least time the card could take for the
window's counted work (its operations at the peak of their type, or its
bytes at the memory rate, whichever is longer) over the window's seconds,
in %."""

from portbench.count.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def read(name, run):
    if run.window_s <= 0 or not run.work["flops"]:
        return None
    compute = sum(f / PEAK_FLOPS[k] for k, f in run.work["flops"].items())
    memory = run.work["bytes"] / HBM_BYTES_PER_S
    return 100.0 * max(compute, memory) / run.window_s

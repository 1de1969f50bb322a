"""device_idle.<kind>: the share of the traced stretch in which no kernel,
copy or fill ran on the card (1 - the union of their intervals over the
stretch), in %."""


def read(name, run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

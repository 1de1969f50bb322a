"""optimizer_ms.<kind>: device milliseconds a step of the kernels launched
inside the program's AdamW update (the ``optimizer`` class of
``kernel_scopes/``: a harness span around ``AdamW.update`` while traced),
from the traced stretch, over its steps. Busy time only: the gaps between
those kernels are not counted."""


def read(name, run):
    if run.trace is None or run.traced_units <= 0:
        return None
    seconds = run.trace.class_s.get("optimizer", 0.0)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units

"""update_ms.<kind>: device milliseconds a step of the kernels launched
inside the program's optimizer update (its ``repro_torch.optim.update``
span, ``program_spans``), over the traced stretch's steps. Busy time only:
the gaps between those kernels are not counted."""

from portbench.program_spans import program_of


def read(name, run):
    row = program_of(run).get("repro_torch.optim.update")
    if not row or run.traced_units <= 0 or row["device_s"] <= 0:
        return None
    return 1e3 * row["device_s"] / run.traced_units

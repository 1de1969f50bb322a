"""host_step_ms.<kind>: host milliseconds of one call of the program's serve
step (its ``repro_torch.serve.step`` span: one prefill chunk or one token
step), the mean over the traced stretch (``program_spans``)."""

from portbench.program_spans import program_of


def read(name, run):
    row = program_of(run).get("repro_torch.serve.step")
    if not row or not row["count"]:
        return None
    return 1e3 * row["host_s"] / row["count"]

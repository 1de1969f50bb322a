"""fetch_ms.<kind>: host milliseconds of one batch fetch (the program's
``repro_torch.data.fetch`` span around ``BatchStream.move_down``: making the
batch and staging it on the card), the mean over the traced stretch
(``program_spans``)."""

from portbench.program_spans import program_of


def read(name, run):
    row = program_of(run).get("repro_torch.data.fetch")
    if not row or not row["count"]:
        return None
    return 1e3 * row["host_s"] / row["count"]

"""after_prefill_ms.<kind>: host milliseconds of each generate call outside
its prefill (the ``repro_torch.serve.generate`` span less its
``repro_torch.serve.prefill`` span: set-up, the runner lookup, the decode
and the drain), the mean over the traced stretch's calls
(``program_spans``)."""

from portbench.program_spans import program_of


def read(name, run):
    spans = program_of(run)
    gen, pre = spans.get("repro_torch.serve.generate"), spans.get("repro_torch.serve.prefill")
    if not gen or not pre or not gen["count"]:
        return None
    return 1e3 * (gen["host_s"] - pre["host_s"]) / gen["count"]

"""layer_idle_share.<layer>.<kind>: the share (%) of the card's idle time
inside the program's spans that falls in the model layer ``<layer>``
(``attn``, ``mamba``, ``mlstm``, ``slstm``, ``dense``, ``moe``, ``embed``,
``head``): the idle seconds of ``repro_torch.model.<layer>`` over those of
every program span in the traced stretch (``program_spans``: each idle
instant to the latest-started open span). The profiler's cost beside each
op inflates every span's idle alike, so the share reads where the host holds
the card back, not how slowly the traced host ran."""

from portbench.program_spans import program_of


def read(name, run):
    spans = program_of(run)
    layer = spans.get(f"repro_torch.model.{name.split('.')[1]}")
    total = sum(row["idle_s"] for row in spans.values())
    if layer is None or not total:
        return None
    return 100.0 * layer["idle_s"] / total

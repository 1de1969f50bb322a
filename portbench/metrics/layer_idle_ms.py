"""layer_idle_ms.<layer>.<kind>: the card's idle milliseconds a serve step
that fall in the model layer ``<layer>`` (``attn``, ``mamba``, ``mlstm``,
``slstm``, ``dense``, ``moe``, ``embed``, ``head``): idle instants whose
latest-started open program span is ``repro_torch.model.<layer>``
(``program_spans``), over the traced stretch's ``repro_torch.serve.step``
spans."""

from portbench.program_spans import program_of


def read(name, run):
    spans = program_of(run)
    steps = spans.get("repro_torch.serve.step", {}).get("count")
    layer = spans.get(f"repro_torch.model.{name.split('.')[1]}")
    if not steps or layer is None:
        return None
    return 1e3 * layer["idle_s"] / steps

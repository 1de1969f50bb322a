"""attention_roofline.<kind>: the attention class's share of its roofline in
the traced stretch (``class_roofline``): every kernel launched inside the
program's attention (``kernel_scopes/attention.txt``: its forward, the flash
backward, a cache read), whatever implements it, against the attention
pairs counted for the cell's shapes."""

from portbench.metrics.class_roofline import read_class


def read(name, run):
    return read_class("attention", run)

"""scan_roofline.<kind>: the scan kernel class's share of its roofline in
the traced stretch (``class_roofline``)."""

from portbench.metrics.class_roofline import read_class


def read(name, run):
    return read_class("scan", run)

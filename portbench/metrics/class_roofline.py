"""A kernel class's share of its roofline in the traced stretch: the sum,
over the class's counted calls, of each call's least time (its operations
at the peak of their type or its bytes at the memory rate), over the device
seconds of the kernels the trace assigns to the class (``kernel_names/``),
in %. Nothing to read where the trace holds no kernel of the class."""


def read_class(cls, run):
    if run.trace is None or run.traced_work is None:
        return None
    seconds = run.trace.class_s.get(cls, 0.0)
    counted = run.traced_work["class"].get(cls)
    if seconds <= 0 or not counted or counted[2] <= 0:
        return None
    return 100.0 * counted[2] / seconds

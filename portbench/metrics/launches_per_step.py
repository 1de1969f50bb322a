"""launches_per_step.<kind>: the port's kernel launches (the program's
``ops.launch_counts()``, an exact count) over the window, per token step
of a generate call (prompt steps included)."""


def read(name, run):
    launches, steps = run.counters.get("launches"), run.counters.get("token_steps")
    if not steps:
        return None
    return launches / steps

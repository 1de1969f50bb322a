"""batch_fetch_ms.<kind>: host milliseconds a step spends in the program's
``BatchStream.move_down`` (making the batch and staging it on the card),
the mean over the window's steps."""


def read(name, run):
    s = run.spans.get("batch_fetch_s")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)

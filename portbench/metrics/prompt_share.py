"""prompt_share.<kind>: the share of each generate call spent before its
first generated token (the program's ServeStats.prefill_seconds, which ends
on a device synchronise, over the call's wall), the mean over the window's
calls, in %."""


def read(name, run):
    pre, wall = run.spans.get("prefill_s"), run.spans.get("call_s")
    if not pre or not wall:
        return None
    return 100.0 * sum(p / w for p, w in zip(pre, wall)) / len(wall)

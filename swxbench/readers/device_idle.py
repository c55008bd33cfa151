"""The share of the stretch, in %, in which no operation ran on the
device (1 − the union of the trace's device intervals over its length)."""


def read(run):
    if (not run.on_card or run.trace is None
            or run.trace["window_us"] <= 0):
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])

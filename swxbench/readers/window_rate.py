"""Events whose scored records reached the harness's consumer inside the
window, over the window's seconds: all the work over all the time."""


def read(run):
    arrival = run.scored.arrival
    rec = run.record
    n = int(((arrival >= rec.t_window0) & (arrival < rec.t_window1)).sum())
    return n / rec.window_s if n else None

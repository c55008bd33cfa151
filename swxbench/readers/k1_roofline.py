"""K1's share of its roofline over the stretch, in %: the least time the
card could take for the events the stretch scored (`roofline.k1_counts`,
real rows only) over the device time of K1's kernels in the trace."""

from swxbench.roofline import bound_s, k1_counts

KERNEL = "lstm_window_final"


def read(run):
    if not run.on_card or run.trace is None:
        return None
    us = sum(t for name, t in run.trace["by_kernel_us"].items()
             if KERNEL in name)
    launches = run.stretch.delta("k1_launches")
    events = run.stretch.delta("events")
    if us <= 0 or launches <= 0 or events <= 0:
        return None
    w, h = int(run.widths["window"]), int(run.widths["hidden"])
    flops, nbytes = k1_counts(events, w - 1, h, launches)
    return 100.0 * bound_s(flops, nbytes) / (us / 1e6)

"""The TFT forward's share of its roofline over the stretch, in %: the
least time the card could take for the real windows it scored
(`reference.tft.counts`, bucket padding left out) over the device time of
the kernels launched under the `tft.` ranges, both over the stretch.

A `tft.select` range opens each forward (one a dispatch). A forward whose
kernels ran partly outside the stretch counts with the share of its
device time that ran inside; its real rows are the stretch's mean
(events scored over dispatches). A forward already open when the
profiler started is left out. Only a traced run on the card of a
program with those ranges has one."""

from swxbench.readers.range_device import kernels_under
from swxbench.reference.tft import counts
from swxbench.roofline import bound_s

PREFIX = "tft."
FIRST = "tft.select"


def read(run):
    rows = kernels_under(run, PREFIX)
    st = run.stretch
    if not rows or st.delta("dispatches") <= 0 or st.delta("events") <= 0:
        return None
    # one list a forward; a forward that began before the profiler has
    # no `tft.select` range and is left out
    forwards: list = []
    for row in rows:
        if row[0] == FIRST:
            forwards.append([])
        if forwards:
            forwards[-1].append(row)
    share = sum(sum(r[3] for r in f) / sum(r[2] for r in f)
                for f in forwards if sum(r[2] for r in f) > 0)
    device_s = sum(r[3] for f in forwards for r in f) / 1e6
    if device_s <= 0:
        return None
    scored = share * st.delta("events") / st.delta("dispatches")
    flops, nbytes = counts(run.widths, scored)
    return 100.0 * bound_s(flops, nbytes) / device_s

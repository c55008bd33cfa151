"""The share of the traced stretch, in %, in which no operation runs on
the device while one of the program's profiler ranges whose name starts
with `prefix` is open: the card's idle time that this host work spans.
Device-side copies of host labels are no device work. 0.0 where no such
range falls in the stretch; only a run on the card has one."""

from swxbench.readers.range_share import open_under, union, walk


def read(run, prefix: str):
    if not run.on_card:
        return None
    got = open_under(run, prefix)
    if got is None:
        return None
    length, ranges = got
    busy = union(walk(run)[3])
    idle, i = 0.0, 0
    for a, b in ranges:
        idle += b - a
        # subtract the device intervals that overlap [a, b]
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            idle -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return 100.0 * idle / length

"""The share of the traced stretch, in %, during which one of the
program's profiler ranges whose name starts with `prefix` is open: the
union of those ranges (`Tracer.span` opens one for each host span while
the profiler runs) over the stretch, between the stretch's own label.
0.0 where no such range falls in the stretch."""

from swxbench.trace import MARK

_walked: list = [None, None]   # (profile, its walk): one run's readers share it


def union(intervals) -> list:
    """Disjoint, sorted intervals covering `intervals`."""
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        elif hi > lo:
            out.append([lo, hi])
    return out


def walk(run):
    """(lo, hi, host, device) of the stretch on the profiler's clock (µs):
    the stretch's label, the host-side ranges `[(name, lo, hi)]`, and the
    device intervals `[(lo, hi)]` without the device-side copies of host
    labels, each clipped to the stretch; None without a traced stretch."""
    from torch.autograd import DeviceType

    st = run.stretch
    prof = getattr(st, "prof", None)
    if prof is None:
        return None
    if _walked[0] is prof:
        return _walked[1]
    lo = hi = None
    host, device = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name == MARK:
                lo, hi = a, b
            else:
                host.append((e.name, a, b))
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            device.append((a, b))
    got = None
    if lo is not None and hi > lo:
        got = (lo, hi,
               [(n, max(a, lo), min(b, hi)) for n, a, b in host
                if b > lo and a < hi],
               [(max(a, lo), min(b, hi)) for a, b in device
                if b > lo and a < hi])
    _walked[:] = [prof, got]
    return got


def open_under(run, prefix: str):
    """(stretch µs, the union of the `prefix` ranges) or None."""
    got = walk(run)
    if got is None:
        return None
    lo, hi, host, _ = got
    return hi - lo, union((a, b) for n, a, b in host if n.startswith(prefix))


def read(run, prefix: str):
    got = open_under(run, prefix)
    if got is None:
        return None
    length, ranges = got
    return 100.0 * sum(b - a for a, b in ranges) / length

"""Device time of the kernels launched under the program's profiler
ranges, over the traced stretch. Each device kernel in the profiler's
raw results links to the host operation that launched it (its linked
correlation id, the operation's own id in the trace); the innermost
range around that operation whose name starts with `prefix` takes the
kernel. A kernel counts in full (`full_us`, wherever it ran) and clipped
to the stretch (`in_us`), so the time readers put under ranges from
`in_us` is never more than the stretch's busy time."""

from swxbench.readers.range_share import walk


def kernels_under(run, prefix: str):
    """[(range name, range start, full_us, in_us)], one row a range
    instance that launched device work, in start order; None without a
    traced stretch on the card."""
    from torch.autograd import DeviceType

    got = walk(run) if run.on_card else None
    if got is None:
        return None
    lo, hi = got[0], got[1]
    prof = run.stretch.prof
    ops = {e.id: e for e in prof.events() if e.device_type == DeviceType.CPU}
    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    rows: dict = {}
    for k in raw.events():
        if k.device_type() != DeviceType.CUDA or k.is_user_annotation():
            continue
        r = ops.get(k.linked_correlation_id())
        while r is not None and not r.name.startswith(prefix):
            r = r.cpu_parent
        if r is None:
            continue
        a = (k.start_ns() - t0) / 1e3
        b = a + k.duration_ns() / 1e3
        row = rows.setdefault(id(r), [r.name, r.time_range.start, 0.0, 0.0])
        row[2] += b - a
        row[3] += max(0.0, min(b, hi) - max(a, lo))
    return sorted((tuple(r) for r in rows.values()), key=lambda r: r[1])

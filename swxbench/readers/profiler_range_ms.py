"""Mean host duration in ms of one of the program's profiler labels
(`utils/timing.span`) over the traced stretch."""


def read(run, name: str):
    if run.trace is None:
        return None
    ranges = run.trace["host_ranges_us"].get(name)
    if not ranges:
        return None
    return sum(ranges) / len(ranges) / 1e3

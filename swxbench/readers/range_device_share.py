"""The share, in %, of the device time under the program's ranges whose
names start with `prefix` that the kernels under the range `stage` took,
over the traced stretch (`range_device.kernels_under`, clipped to it).
Only a traced run on the card whose ranges launched device work has
one."""

from swxbench.readers.range_device import kernels_under


def read(run, stage: str, prefix: str):
    rows = kernels_under(run, prefix)
    if not rows:
        return None
    total = sum(r[3] for r in rows)
    if total <= 0:
        return None
    return 100.0 * sum(r[3] for r in rows if r[0] == stage) / total

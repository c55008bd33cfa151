"""A quantile of the window's message latencies, in ms: from each
message's due time to the arrival at the harness's consumer of the last
of its events' scored records, over every message due in the window,
from the raw samples. A rejected or unfinished message has no finite
latency and sits above every finished one."""

import numpy as np


def read(run, q: float):
    lat = run.message_latency_s()
    if lat is None or lat.size == 0:
        return None
    value = float(np.quantile(lat, q))
    return 1e3 * value if np.isfinite(value) else None

"""render_p95_ms: the 95th percentile of every call's latency in the
window, from the call to its frames on the host (one client, closed
loop), linear interpolation between order statistics."""

import numpy as np


def read(run):
    if run.kind != "render" or not run.host.get("latency"):
        return None
    return float(np.percentile(np.asarray(run.host["latency"]), 95))

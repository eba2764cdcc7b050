"""host_ms_per_dispatch.train: the median over the measured window of the
host's time to build a group's feeds (the loader's batches) and return
from the S-step dispatch call, with no synchronize of the benchmark's own:
the host's cost per dispatch of S steps. (The dispatch copies the feeds
into its device buffers; from pageable memory such a copy waits for the
stream, so a dispatch issued while the card still works on the last one
reads that wait too.)"""

import statistics


def read(run):
    if run.kind != "train" or not run.host.get("call"):
        return None
    return statistics.median(f + c for f, c in zip(run.host["feeds"], run.host["call"]))

"""host_ms_per_call.render: the median over the measured window of the
host's time from a render call to its return, before the copy to the
host: the launch path of a call."""

import statistics


def read(run):
    if run.kind != "render" or not run.host.get("call"):
        return None
    return statistics.median(run.host["call"])

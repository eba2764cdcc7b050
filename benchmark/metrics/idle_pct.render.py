"""idle_pct.render: the share of the traced window in which no operation
(kernel, copy or fill) ran on the device, from the union of their
intervals in the profiler's trace."""


def read(run):
    if run.kind != "render" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

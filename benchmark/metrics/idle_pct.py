"""The device's idle share of the traced window, %: 1 - the union of its
activity (kernels, copies, sets) over the window. An upper bound: the
profiler's own host work stretches the window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

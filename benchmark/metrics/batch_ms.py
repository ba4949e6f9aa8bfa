"""Mean milliseconds a call takes: the window's whole wall time over its
calls (host clock, the device synchronized at the end of every call).
In a cold cell it is the period at which one caller can have its batch
solved."""


def read(run):
    return 1e3 * run.window_s / len(run.calls)

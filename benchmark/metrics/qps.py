"""QPs solved to the contract a second: the lanes that exit SUCCESS with
a reported residual at most the contract's, summed over the window's
calls, over the window's whole wall time (host clock, the device
synchronized at the end of every call)."""


def read(run):
    return sum(c["ok"] for c in run.calls) / run.window_s

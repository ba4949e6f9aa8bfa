"""The 90th percentile of the window's call times in milliseconds, over
every call (in the closed loop, every step: the solve, the plant update
and the shifted warmstart, host clock, synchronized)."""

import numpy as np


def read(run):
    ms = [1e3 * (c["t_end"] - c["t_start"]) for c in run.calls]
    return float(np.percentile(ms, 90))

"""The refinement's useful share of its work, %: the live lanes above the
target at each step's start (`refine.lanes_pending`) over the lanes the
step computed (`refine.lanes_stepped`: whole chunks run while any of their
live lanes is above the target), summed over the window's steps (program
counters)."""

from benchmark import spans


def read(run):
    rec = spans.recorded() if run.trace is not None else None
    if not rec:
        return None
    c = spans.counts(rec)
    stepped = c.get("refine.lanes_stepped", 0)
    if stepped <= 0:
        return None
    return 100.0 * c.get("refine.lanes_pending", 0) / stepped

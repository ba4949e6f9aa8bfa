"""Mean Newton iterations a QP over the window's lanes, from the
`newton_iters` of the CoreOut the program returns (its counter of the
solver core's loop, csrc/fbstab_solve.cuh on the card)."""


def read(run):
    lanes = sum(c["lanes"] for c in run.calls)
    return sum(c["newton"] for c in run.calls) / lanes

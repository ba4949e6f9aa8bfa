"""Device-timeline milliseconds a call in Ruiz scaling (the program's
`fbstab.scaling` spans: the scaling's computation, the data's and the
guess's scaling and the solution's unscaling around the solve, and again
around the refinement), from the stream reaching each span to the end of
its work (CUDA events the program records while traced)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fbstab.scaling")

"""Device-timeline milliseconds a call in the refinement steps'
double-float residuals (the program's `fbstab.refine.residual` spans: the
margin, the KKT blocks, the original-units norms and the blocks' rounding
to float32), the elementwise ops that surround K1 in each step."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fbstab.refine.residual")

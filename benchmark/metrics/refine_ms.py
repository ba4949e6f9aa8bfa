"""Device-timeline milliseconds a call in the double-float refinement (the
program's `fbstab.refine` span around `refine_solution_mpc`: its entry,
its steps on K1 with their double-float residuals, its exit reads and
gathers and its final residual), from the stream reaching the span to the
end of its work."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fbstab.refine")

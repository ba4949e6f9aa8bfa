"""K1's share of its roofline, %: the least time of the Riccati Newton
steps the window's lanes needed (benchmark/perf.py: the executed
refinement steps of each lane, from the returned CoreOut, one step each;
its stage matrices and vectors read and its direction written once) over
`riccati_step_kernel`'s device time in the trace."""

from benchmark import perf


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s("riccati_step_kernel")
    steps = sum(c["refine"] for c in run.calls)
    if t <= 0 or steps <= 0:
        return None
    bound_ms, _ = perf.bound(steps * perf.riccati_flops(*run.dims),
                             perf.riccati_step_bytes(steps, *run.dims))
    return 100.0 * bound_ms / 1e3 / t

"""K2's share of its roofline, %: the least time the window's fused solves
could take on the card (benchmark/perf.py: operations at the run's mean
Newton and proximal counts against the data read once) over
`mpc_solve_kernel`'s device time in the trace."""

from benchmark import perf


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s("mpc_solve_kernel")
    if t <= 0:
        return None
    flops = nbytes = 0.0
    for c in run.calls:
        n = c["lanes"]
        flops += perf.mpc_solve_flops(n, *run.dims, c["newton"] / n,
                                      c["prox"] / n)
        nbytes += perf.mpc_solve_bytes(n, *run.dims)
    bound_ms, _ = perf.bound(flops, nbytes)
    return 100.0 * bound_ms / 1e3 / t

"""K4's share of its roofline, %: the least time the window's tier-2
solves could take (benchmark/perf.py: operations at the run's mean Newton
and proximal counts; the data and the proximal center read and the
iterate written once a launch, at the trace's count of launches) over
`mpc_subproblem_kernel`'s device time in the trace."""

from benchmark import perf


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s("mpc_subproblem_kernel")
    launches = run.trace.launches("mpc_subproblem_kernel")
    if t <= 0:
        return None
    flops = 0.0
    for c in run.calls:
        n = c["lanes"]
        flops += perf.mpc_solve_flops(n, *run.dims, c["newton"] / n,
                                      c["prox"] / n)
    nbytes = perf.subproblem_bytes(run.calls[0]["lanes"], *run.dims,
                                   launches)
    bound_ms, _ = perf.bound(flops, nbytes)
    return 100.0 * bound_ms / 1e3 / t

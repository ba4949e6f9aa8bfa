"""The whole call's share of the card's float32 peak, %: the operations
the window's lanes needed (benchmark/perf.py: the fused solve at each
call's mean Newton and proximal counts, and one Riccati step for each
executed refinement step) over the window's wall time times the peak.
Whatever kernel carries the work, this share bounds the gain a change
of one kernel can show."""

from benchmark import perf


def read(run):
    flops = 0.0
    for c in run.calls:
        n = c["lanes"]
        flops += perf.mpc_solve_flops(n, *run.dims, c["newton"] / n,
                                      c["prox"] / n)
        flops += c["refine"] * perf.riccati_flops(*run.dims)
    return 100.0 * flops / (run.window_s * perf.PEAK_F32_FLOPS)

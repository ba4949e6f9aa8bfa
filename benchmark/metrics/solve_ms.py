"""Device-timeline milliseconds a call in the tier's solve (the program's
`fbstab.solve` spans around `_solve_mpc_qp_batch_raw`: K2's launch, or
K4's host outer loop with its launches, exit bookkeeping and any-lane
reads), from the stream reaching each span to the end of its work."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fbstab.solve")

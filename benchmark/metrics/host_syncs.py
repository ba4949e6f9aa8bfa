"""Reads of device values a call (program counters `host_sync.*`: each
read on the path of solve_mpc_qp_batch and shift_warmstart at which the
host waits for the device: K4's any-lane read, the retry's read, the
refinement's exit read and its gathers' lane indices)."""

from benchmark import spans


def read(run):
    rec = spans.recorded() if run.trace is not None else None
    if not rec:
        return None
    reads = sum(n for k, n in spans.counts(rec).items()
                if k.startswith("host_sync."))
    return reads / len(run.calls)

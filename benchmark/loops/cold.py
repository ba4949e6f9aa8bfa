"""Cold batches, one caller in a closed loop: each call solves a fresh
batch of `batch` instances of the configuration's plant from zero
guesses, its initial states drawn from the seed, through
`solve_mpc_qp_batch(data, z0, l0, v0, options)` (Ruiz scaling, the tier's
solve, the retry and the refinement inside the call). Set-up makes the
plant and warms the batch's shapes with one call of its own, made as the
timed calls are."""

from __future__ import annotations

from torch.profiler import record_function

from benchmark.mpc_inputs import MpcInputs, record_call


class Cold:
    def __init__(self, ctx):
        self.ctx = ctx
        self.inputs = MpcInputs(ctx, int(ctx.mix["batch"]))
        self.dims = self.inputs.dims
        self.guess = self.inputs.zeros()
        self.checked = int(ctx.mix["checked_lanes"])
        self.call()

    def _solve(self, x0):
        data = self.inputs.data._replace(x0=x0)
        return self.inputs.solve(data, *self.guess)

    def call(self) -> dict:
        with record_function("inputs"):
            x0 = self.inputs.x0()
            idx = self.inputs.checked_lanes(self.checked)
        with record_function("solve"):
            x, core = self._solve(x0)
        with record_function("record"):
            return record_call(self.ctx, x, core, x0, idx)


def setup(ctx) -> Cold:
    return Cold(ctx)

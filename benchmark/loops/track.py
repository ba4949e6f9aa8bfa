"""A fleet in closed loop: `batch` plants of the configuration, each from
its own initial state drawn from the seed, re-solved every sample period.

A step is one `solve_mpc_qp_batch` call over the fleet with the Ruiz
scaling of the shared plant computed once (as the port's
`simulate_batch` does) and the shifted previous solution as the guess
(`shift_warmstart`), then the relay: u(0) of each solution applied to the
plant x+ = A x + B u + c (a copy of the port's `_plant_step`) and the
next guess shifted. Set-up runs the cold first step and the mix's
`settle_steps` - 1 steps of the transient, so that the window holds the
steady state. `relay_s`, the relay's time (the plant update and the
shifted warmstart, not the benchmark's own reading of the step's counts
and checked lanes), is read with the device synchronized after the solve
and after the relay, in traced runs only."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

import fbstab_tpu_torch as fb
from fbstab_tpu_torch.models.receding_horizon import shift_warmstart
from benchmark.mpc_inputs import MpcInputs, record_call


def plant_step(data, x, u):
    """x+ = A(0) x + B(0) u + c(0) on the shared plant, for a batch of
    states x (B, nx) and inputs u (B, nu)."""
    return (torch.einsum("ij,bj->bi", data.A[0, 0], x)
            + torch.einsum("ij,bj->bi", data.B[0, 0], u) + data.c[0, 0])


class Track:
    def __init__(self, ctx):
        self.ctx = ctx
        inp = self.inputs = MpcInputs(ctx, int(ctx.mix["batch"]))
        self.dims = inp.dims
        one = fb.ruiz_mpc_scaling(inp.one)
        self.scaling = fb.MpcScaling(*(a.expand((inp.B,) + a.shape[1:])
                                       for a in one))
        self.checked = int(ctx.mix["checked_lanes"])
        self.x = inp.x0()
        self.guess = inp.zeros()
        for _ in range(int(ctx.mix["settle_steps"])):
            self.call()

    def call(self) -> dict:
        inp, ctx = self.inputs, self.ctx
        idx = inp.checked_lanes(self.checked)
        data = inp.data._replace(x0=self.x)
        with record_function("solve"):
            x, core = inp.solve(data, *self.guess, scaling=self.scaling)
        if ctx.trace:
            ctx.sync()
        t0 = time.perf_counter()
        with record_function("relay"):
            hi = x.hi() if hasattr(x, "hi") else x
            N1, nx, nu = inp.N + 1, inp.nx, inp.nu
            u = hi.z.reshape(inp.B, N1, nx + nu)[:, 0, nx:]
            x_next = plant_step(data, self.x, u)
            nxt = shift_warmstart(hi, data)
            self.guess = (nxt.z, nxt.l, nxt.v)
        if ctx.trace:
            ctx.sync()
            relay_s = time.perf_counter() - t0
        with record_function("record"):
            rec = record_call(ctx, x, core, self.x, idx)
        if ctx.trace:
            rec["relay_s"] = relay_s
        self.x = x_next
        return rec


def setup(ctx) -> Track:
    return Track(ctx)

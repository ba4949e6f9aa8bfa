"""The MPC class of problem: its inputs, made on the device from the seed,
the timed entry, and what a call leaves for the window and for the check.

`MpcInputs` builds one configuration's problem: its plant (the
configuration's `plant`, found by name under plants/), stacked over its
`horizon` and handed to the program as a batch of B views of one float32
instance, and its solver options (the `Options` constructor the
configuration names, with the run's overrides). It draws each call's
initial states with a `torch.Generator` on the device: the same seed
gives the same states, call after call. The configuration's
`x0_perturbation` sets the size of the perturbation and its
`x0_perturbed_states`, where given, the states perturbed. `record_call`
reduces a returned solution to the counts the metrics read and to the
sampled lanes the reference checks, and ends with the device idle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import fbstab_tpu_torch as fb
from benchmark import plants


class MpcInputs:
    def __init__(self, ctx, B: int):
        self.ctx, self.B = ctx, B
        cfg, dev = ctx.config, ctx.device
        self.options = dataclasses.replace(
            getattr(fb.Options, cfg["options"])(), **ctx.overrides)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(ctx.seed % 2 ** 63)
        st = plants.stack(ctx.find("plants", cfg["plant"]).plant(),
                          int(cfg["horizon"]))
        one = fb.mpc_qp_data(**{k: a[None] for k, a in st.items()},
                             dtype=torch.float32, device=dev)
        self.one = one
        self.data = fb.MpcQPData(*(a.expand((B,) + a.shape[1:])
                                   for a in one))
        self.N, self.nx, self.nu, self.nc = self.dims = fb.mpc_dims(one)
        # The nominal state as the float32 data holds it (build_plant's).
        nominal = st["x0"].astype(np.float32).astype(np.float64)
        self.x0_nominal = torch.as_tensor(nominal, device=dev)
        self.scale = plants.perturbation_scale(nominal)
        self.pert = float(cfg["x0_perturbation"])
        states = cfg.get("x0_perturbed_states", range(self.nx))
        self.mask = torch.zeros(self.nx, dtype=torch.float64, device=dev)
        self.mask[list(states)] = 1.0

    def x0(self) -> torch.Tensor:
        """B initial states (float32): the nominal state perturbed by the
        configuration's rule, on the states it names, from the
        generator."""
        n = torch.randn(self.B, self.nx, generator=self.gen,
                        dtype=torch.float64, device=self.ctx.device)
        n *= self.mask
        return plants.perturbed_x0(self.x0_nominal, n, self.pert,
                                   self.scale).float()

    def zeros(self):
        """Zero (z, l, v) guesses for the batch."""
        kw = dict(dtype=torch.float32, device=self.ctx.device)
        N1 = self.N + 1
        return (torch.zeros(self.B, N1 * (self.nx + self.nu), **kw),
                torch.zeros(self.B, N1 * self.nx, **kw),
                torch.zeros(self.B, N1 * self.nc, **kw))

    def checked_lanes(self, S: int) -> torch.Tensor:
        """S lanes drawn from the generator, in order."""
        S = min(S, self.B)
        return torch.randperm(self.B, generator=self.gen,
                              device=self.ctx.device)[:S].sort().values

    def solve(self, data, z0, l0, v0, **kw):
        """The timed entry: `fbstab_tpu_torch.solve_mpc_qp_batch` under the
        configuration's options, looked up at each call."""
        return fb.solve_mpc_qp_batch(data, z0, l0, v0, self.options, **kw)


def _lanes_float64(x, idx):
    """(z, l, v) of the returned point on lanes idx, in float64: hi + lo
    where it is a double-float pair."""
    def up(a):
        if isinstance(a, tuple):
            return a[0][idx].double() + a[1][idx].double()
        return a[idx].double()
    return up(x.z), up(x.l), up(x.v)


def record_call(ctx, x, core, x0, idx) -> dict:
    """Counts of one call (lanes, lanes meeting the contract, Newton,
    proximal and refinement iterations summed over lanes) and its checked
    lanes, moved to the host. Synchronizes the device."""
    ok = ((core.eflag == int(fb.ExitFlag.SUCCESS))
          & (core.residual <= ctx.config["contract"]["residual"]))
    refine = core.refine_steps
    refine = (refine.sum() if isinstance(refine, torch.Tensor)
              else torch.zeros((), device=ok.device))
    counts = torch.stack([ok.sum().double(),
                          core.newton_iters.sum().double(),
                          core.prox_iters.sum().double(),
                          refine.double()])
    z, l, v = _lanes_float64(x, idx)
    sample = dict(x0=x0[idx].double(), z=z, l=l, v=v,
                  eflag=core.eflag[idx], residual=core.residual[idx].double())
    sample = {k: t.cpu().numpy() for k, t in sample.items()}
    lanes_ok, newton, prox, refine = counts.tolist()
    ctx.sync()
    return dict(lanes=int(core.eflag.shape[0]), ok=int(lanes_ok),
                newton=newton, prox=prox, refine=refine, sample=sample)


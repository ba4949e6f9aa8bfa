"""Receding-horizon (closed-loop MPC) simulation with warmstart carry
(counterpart of `fbstab_tpu/models/receding_horizon.py`).

The reference's documented workflow is one FBstabMpc object per control
loop, fed a new x0 each step, with the previous solution as the next
warmstart. Here:

 - `shift_warmstart` advances every stage sequence of a solution by one
   stage and repeats the terminal stage;
 - `simulate` runs the closed loop x+ = A(0) x + B(0) u*(0) + c(0) for one
   instance, one core solve per step;
 - `simulate_batch` runs it for a batch of initial states over a shared
   plant, one batched solve per control step (on the card, the fused
   kernels), BASELINE.json config 2's receding-horizon sweep.

PyTorch runs eagerly, so the time loop is a host loop in place of
`lax.scan`. Per-step results stay on the device and are stacked at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.models.mpc_qp import (
    MPC_OPS, MpcQPData, exact_f32_matmul, mpc_dims)
from fbstab_tpu_torch.options import Options


def shift_warmstart(x: Variable, data: MpcQPData) -> Variable:
    """Shifts a batch of solutions one stage forward for the next MPC step.

    Stage i takes the previous solution's stage i+1; the terminal stage is
    repeated. The margin y is recomputed as b - A z for the shifted z (it
    cannot be shifted, because b is stage-dependent). x and data carry a
    leading batch axis."""
    N, nx, nu, nc = mpc_dims(data)
    B = x.z.shape[0]

    def shift(a, n):
        s = a.reshape(B, N + 1, n)
        return torch.cat([s[:, 1:], s[:, -1:]], 1).reshape(B, -1)

    z = shift(x.z, nx + nu)
    return Variable(z=z, l=shift(x.l, nx), v=shift(x.v, nc),
                    y=MPC_OPS.b_vec(data) - MPC_OPS.gemvA(data, z))


class ClosedLoopResult(NamedTuple):
    """Trajectories of a receding-horizon run. `simulate`: leading axis
    time; `simulate_batch`: scenarios, then time."""

    x: torch.Tensor             # (T+1, nx) / (B, T+1, nx) closed-loop states
    u: torch.Tensor             # (T, nu) / (B, T, nu) applied inputs
    eflag: torch.Tensor         # (T,) / (B, T) per-step solver status
    residual: torch.Tensor      # (T,) / (B, T)
    newton_iters: torch.Tensor  # (T,) / (B, T)
    prox_iters: torch.Tensor    # (T,) / (B, T)


def _plant_step(data: MpcQPData, x, u):
    """x+ = A(0) x + B(0) u + c(0) on the shared plant (lane 0 of data),
    for a batch of states x (B, nx) and inputs u (B, nu)."""
    return (torch.einsum("ij,bj->bi", data.A[0, 0], x)
            + torch.einsum("ij,bj->bi", data.B[0, 0], u) + data.c[0, 0])


def _stack(steps):
    """Per-step tuples of (B, ...) tensors -> batch-major (B, T, ...)."""
    return [torch.stack(col, 1) for col in zip(*steps)]


def simulate(data: MpcQPData, T: int, options: Options = Options(),
             x0: Optional[torch.Tensor] = None,
             shift: bool = True) -> ClosedLoopResult:
    """Runs T closed-loop MPC steps for one instance (`data` a batch of
    one). Each step solves the OCP from the current state with the FBstab
    core (no equilibration or refinement, as in the JAX package), applies
    u*(0) to the plant x+ = A(0) x + B(0) u + c(0), and warmstarts the next
    solve from the (optionally shifted) previous solution. Returns
    unbatched, time-major trajectories."""
    if data.x0.shape[0] != 1:
        raise ValueError(f"simulate takes one instance (a batch of one), "
                         f"got a batch of {data.x0.shape[0]}; use "
                         "simulate_batch")
    N, nx, nu, nc = mpc_dims(data)
    dtype, dev = data.Q.dtype, data.Q.device
    opts = options.validated()
    xk = (data.x0 if x0 is None
          else torch.as_tensor(x0, dtype=dtype, device=dev).reshape(1, nx))
    zeros = lambda n: torch.zeros(1, n, dtype=dtype, device=dev)
    guess = Variable(z=zeros((N + 1) * (nx + nu)), l=zeros((N + 1) * nx),
                     v=zeros((N + 1) * nc), y=None)
    exact_f32_matmul(xk)
    xs, steps = [xk], []
    for _ in range(T):
        d = data._replace(x0=xk)
        sol, core = fbstab_solve_batch(MPC_OPS, d, guess.z, guess.l,
                                       guess.v, opts)
        u = sol.z.reshape(1, N + 1, nx + nu)[:, 0, nx:]
        xk = _plant_step(data, xk, u)
        guess = shift_warmstart(sol, d) if shift else sol
        xs.append(xk)
        steps.append((u, core.eflag, core.residual, core.newton_iters,
                      core.prox_iters))
    u, eflag, res, newton, prox = (a[0] for a in _stack(steps))
    return ClosedLoopResult(x=torch.cat(xs, 0), u=u, eflag=eflag,
                            residual=res, newton_iters=newton,
                            prox_iters=prox)


def simulate_batch(data: MpcQPData, T: int, x0s,
                   options: Options = Options(),
                   shift: bool = True, adaptive: bool = False,
                   phase1_newton_iters: int = 16,
                   phase2_size: Optional[int] = None) -> ClosedLoopResult:
    """Scenario sweep: T closed-loop steps for a batch of initial states
    x0s (B, nx) over a shared plant and problem (`data`, a batch of one).

    Each control step is one `solve_mpc_qp_batch` call over all scenarios
    (on the card, the fused kernels, with the double-float refinement of
    the float32 product path), or with adaptive=True one
    `solve_mpc_qp_batch_adaptive_device` call with the given phase-1
    budget and phase-2 capacity (default B // 8). The Ruiz scaling does not
    depend on x0, the only field the loop moves, so it is computed once
    before the loop and passed to every step. The shared data is a
    broadcast view over the batch, not B copies. Output axes: scenarios,
    then time."""
    from fbstab_tpu_torch.models.mpc_qp import (
        gate_mpc_options, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.refine import VariableDF
    from fbstab_tpu_torch.models.scaling import (
        MpcScaling, ruiz_mpc_scaling, scaling_engaged)

    if data.x0.shape[0] != 1:
        raise ValueError(f"simulate_batch takes the shared problem as a "
                         f"batch of one, got a batch of {data.x0.shape[0]}")
    N, nx, nu, nc = mpc_dims(data)
    dtype, dev = data.Q.dtype, data.Q.device
    x0b = torch.as_tensor(x0s, dtype=dtype, device=dev)
    B = x0b.shape[0]
    batch = MpcQPData(*(a.expand((B,) + a.shape[1:]) for a in data))
    zeros = lambda n: torch.zeros(B, n, dtype=dtype, device=dev)
    gz, gl, gv = (zeros((N + 1) * (nx + nu)), zeros((N + 1) * nx),
                  zeros((N + 1) * nc))

    opts = gate_mpc_options(data, dtype, options)
    scal = None
    if scaling_engaged(opts, dtype):
        one = ruiz_mpc_scaling(data)
        scal = MpcScaling(*(a.expand((B,) + a.shape[1:]) for a in one))

    if adaptive:
        from fbstab_tpu_torch.parallel.adaptive import (
            solve_mpc_qp_batch_adaptive_device)

        def solve_step(d, z, l, v):
            return solve_mpc_qp_batch_adaptive_device(
                d, z, l, v, opts, phase1_newton_iters=phase1_newton_iters,
                phase2_size=phase2_size, scaling=scal)
    else:
        def solve_step(d, z, l, v):
            return solve_mpc_qp_batch(d, z, l, v, opts, scaling=scal)

    xk, xs, steps = x0b, [], []
    for _ in range(T):
        d = batch._replace(x0=xk)
        sol, core = solve_step(d, gz, gl, gv)
        # With refinement engaged the solution is a double-float pair; its
        # float32 view is the next warmstart, and core.residual reports
        # the refined value.
        if isinstance(sol, VariableDF):
            sol = sol.hi()
        u = sol.z.reshape(B, N + 1, nx + nu)[:, 0, nx:]
        xk = _plant_step(data, xk, u)
        nxt = shift_warmstart(sol, d) if shift else sol
        gz, gl, gv = nxt.z, nxt.l, nxt.v
        xs.append(xk)
        steps.append((u, core.eflag, core.residual, core.newton_iters,
                      core.prox_iters))
    u, eflag, res, newton, prox = _stack(steps)
    return ClosedLoopResult(
        x=torch.stack([x0b] + xs, 1), u=u, eflag=eflag, residual=res,
        newton_iters=newton, prox_iters=prox)


__all__ = ["ClosedLoopResult", "shift_warmstart", "simulate",
           "simulate_batch"]

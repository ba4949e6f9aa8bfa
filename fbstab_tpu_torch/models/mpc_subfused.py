"""Batched MPC solver with fused proximal subproblems: the tier of large
stage dimensions (counterpart of `fbstab_tpu/models/mpc_subfused.py`).

Each outer proximal iteration launches one kernel (K4,
ops/mpc_subproblem_cuda.py) that runs, for every lane, the head of the
outer iteration and the whole inner semismooth Newton loop; the outer loop
(success / stall exits, infeasibility certificates, budget bookkeeping,
fbstab_algorithm-impl.h:158-224) runs here in PyTorch on (B,) rows.

Semantics: a batched transcription of the outer loop of
core/algorithm.py. The body is applied to every lane and then selected on
the per-lane condition `(k < max_prox) & ~done`, the value evolution of
`vmap(lax.while_loop)`; the kernel's inactive-lane contract (xi = xbar,
Eo = 0, counters unchanged) stands for the skip branch of the subproblem.
The exits read the kernel's own Ek, success and itol, so every quantity
that decides an exit comes from one arithmetic chain. The "any lane
active" flag is read on the host once per outer iteration.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch.core.algorithm import CoreOut, _pnr_norm
from fbstab_tpu_torch.core.feasibility import check_feasibility
from fbstab_tpu_torch.core.variable import Variable, select_var, var_norm
from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import ExitFlag
from fbstab_tpu_torch.telemetry import count, span


def fbstab_mpc_solve_subfused(data, z0, l0, v0, options: Options,
                              subproblem=None, lowmem: bool = False):
    """Batched MPC solve from (z0, l0, v0), (B, ...) batch-first in and
    out, with the contract of `fbstab_solve_batch`. `subproblem` is one
    outer iteration with the signature of
    ops.mpc_subproblem_cuda.mpc_subproblem_fused (the default, K4 on CUDA
    and its plain version on the CPU); `lowmem` (the JAX signature's) runs
    every launch in K4's recompute-factors mode."""
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, exact_f32_matmul
    from fbstab_tpu_torch.ops.mpc_subproblem_cuda import (
        mpc_subproblem_fused, prep_subfused_data)
    subproblem = subproblem or mpc_subproblem_fused
    opts = options.validated()
    ops = MPC_OPS
    alpha = opts.alpha
    B, dev = z0.shape[0], z0.device
    exact_f32_matmul(z0)
    i32 = dict(dtype=torch.int32, device=dev)

    def flag(code):
        return torch.full((B,), int(code), **i32)

    b_vec = ops.b_vec(data)
    # Initialization (impl.h:139-149).
    xk = Variable(z=z0, l=l0, v=v0, y=b_vec - ops.gemvA(data, z0))
    dxn = var_norm(Variable(z=torch.ones_like(z0), l=torch.ones_like(l0),
                            v=torch.ones_like(v0), y=None))
    E0 = _pnr_norm(ops, data, xk, alpha)
    inner_tol = torch.clamp(E0, opts.inner_tol_min, opts.inner_tol_max)
    Ek = E0
    newton = torch.zeros(B, **i32)
    prox = torch.zeros(B, **i32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    eflag = flag(ExitFlag.MAXITERATIONS)
    out_x, out_res = xk, E0
    # Loop-invariant kernel layout, built once.
    prep = prep_subfused_data(data, lowmem)

    for _ in range(opts.max_prox_iters):
        lane = ~done
        with span("fbstab.sync.k4_any_lane"):
            count("host_sync.k4_any_lane")
            if not bool(lane.any()):
                break
        count("k4.outer_iters")
        with span("fbstab.k4.launch"):
            (xi, Eo, n_iters, lin_fail, Ek_it, success, itol,
             dxn_it) = subproblem(prep, xk, inner_tol, dxn, newton, ~lane,
                                  opts)

        with span("fbstab.k4.exits"):
            # dx <- xi - xk with the margin identity (impl.h:201-203).
            dx = Variable(z=xi.z - xk.z, l=xi.l - xk.l, v=xi.v - xk.v,
                          y=xi.y - xk.y + b_vec)
            exhausted = n_iters >= opts.max_newton_iters
            x_budget = select_var(Eo < Ek_it, xi, xk)
            res_budget = _pnr_norm(ops, data, x_budget, alpha)

            if opts.check_feasibility:
                feas = check_feasibility(ops, data, dx, opts.infeas_tol)
                p_inf = ~feas.primal_feasible
                d_inf = ~feas.dual_feasible
            else:
                p_inf = torch.zeros_like(done)
                d_inf = torch.zeros_like(done)
            infeasible = p_inf | d_inf
            eflag_infeas = torch.where(
                p_inf & d_inf, flag(ExitFlag.PRIMAL_DUAL_INFEASIBLE),
                torch.where(p_inf, flag(ExitFlag.PRIMAL_INFEASIBLE),
                            flag(ExitFlag.DUAL_INFEASIBLE)))

            # Priority: success > linear solver failure > newton budget >
            # infeasibility > continue.
            done_it = success | lin_fail | exhausted | infeasible
            eflag_it = torch.where(
                success, flag(ExitFlag.SUCCESS),
                torch.where(
                    lin_fail, flag(ExitFlag.LINEAR_SOLVER_FAILED),
                    torch.where(exhausted, flag(ExitFlag.MAXITERATIONS),
                                torch.where(infeasible, eflag_infeas,
                                            eflag))))
            out_x_it = select_var(
                success | lin_fail, xk,
                select_var(exhausted, x_budget,
                           select_var(infeasible, dx, out_x)))
            out_res_it = torch.where(
                success | lin_fail, Ek_it,
                torch.where(exhausted, res_budget,
                            torch.where(infeasible, Ek_it, out_res)))
            cont = ~done_it

            # Commit the iteration on the lanes whose outer loop ran.
            xk = select_var(lane & cont, xi, xk)
            prox = torch.where(lane & cont, prox + 1, prox)
            dxn = torch.where(lane, dxn_it, dxn)
            inner_tol = torch.where(lane, itol, inner_tol)
            Ek = torch.where(lane, Ek_it, Ek)
            newton = torch.where(lane, n_iters, newton)
            eflag = torch.where(lane, eflag_it, eflag)
            out_x = select_var(lane, out_x_it, out_x)
            out_res = torch.where(lane, out_res_it, out_res)
            done = done | (lane & done_it)

    # Proximal budget exhausted (impl.h:219-223): xk with the last Ek.
    out_x = select_var(done, out_x, xk)
    out_res = torch.where(done, out_res, Ek)
    eflag = torch.where(done, eflag, flag(ExitFlag.MAXITERATIONS))
    core = CoreOut(eflag=eflag, residual=out_res, newton_iters=newton,
                   prox_iters=prox, initial_residual=E0,
                   raw_residual=out_res, refine_steps=torch.zeros_like(eflag))
    return out_x, core

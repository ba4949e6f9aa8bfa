"""The FBstab algorithm as a batched, masked-lockstep PyTorch loop.

Counterpart of `fbstab_tpu/core/algorithm.py` (reference
fbstab_algorithm-impl.h:113-304). The JAX package writes one instance and
lets `vmap` batch its `while_loop`s; torch cannot vmap data-dependent
loops, so this module writes the batch out: every loop runs while any lane
is still active, and each lane's state only advances where its own loop
condition holds (a per-lane `done` mask), which is exactly the value
evolution `vmap(fbstab_solve)` gives. Lanes are independent, so a lane's
result is the single-instance result.

This is the plain version of the fused CUDA solver kernels
(ops/mpc_solve_cuda.py, ops/dense_solve_cuda.py). `fbstab_solve` is the
single-instance solve on it, and the only solve that prints the
Display.ITER / ITER_DETAILED iteration tables (for lane 0 of a batch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fbstab_tpu_torch.core.feasibility import check_feasibility
from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.residuals import (
    inner_residual,
    penalized_natural_residual,
    residual_block_norms,
    residual_norm,
)
from fbstab_tpu_torch.core.variable import (
    Variable,
    project_duals,
    select_var,
    var_axpy,
    var_norm,
)
from fbstab_tpu_torch.options import Display, Options
from fbstab_tpu_torch.solver_out import ExitFlag

# Depth of the nonmonotone linesearch merit history
# (reference: fbstab_algorithm.h:175 kNonMonotoneLineSearch).
NONMONOTONE_DEPTH = 5


class CoreOut(NamedTuple):
    """Per-lane solver results (solve_time is added by the facades).
    `raw_residual` equals `residual` out of the core solver; refinement
    rewrites `residual` and keeps the pre-refinement value here."""

    eflag: torch.Tensor
    residual: torch.Tensor
    newton_iters: torch.Tensor
    prox_iters: torch.Tensor
    initial_residual: torch.Tensor
    raw_residual: torch.Tensor
    refine_steps: torch.Tensor | int = 0


def _pnr_norm(ops, data, x, alpha):
    return residual_norm(penalized_natural_residual(ops, data, x, alpha))


class _Table:
    """Lane 0's iteration tables (reference: PrintIterLine /
    PrintDetailedLine and their headers, fbstab_algorithm-impl.h:402-489)
    in the JAX package's format strings, through an OutputStream (stdout
    when none is given). Made only when Options.display_level asks for a
    table: every value it prints is read from the device."""

    def __init__(self, level: Display, stream, B: int):
        from fbstab_tpu_torch.utils.printing import OutputStream
        self.detailed = level == Display.ITER_DETAILED
        self.stream = stream or OutputStream()
        self.ri = 0.0       # lane 0's last subproblem residual norm
        if B > 1:
            self.line(f"(iteration table of lane 0 of a batch of {B})")
        if not self.detailed:
            self.line("   prox iter  newton iters          |rz|          |rl|"
                      "          |rv|     Inner res     Inner tol")

    def line(self, fmt: str, **vals) -> None:
        self.stream.print(fmt.format(**vals) + "\n")

    def outer(self, rk, success, k, n, Ek, inner_tol) -> None:
        """The outer iteration's line (ITER), or the subproblem's header
        when it runs (ITER_DETAILED)."""
        if not self.detailed:
            bz, bl, bv = (float(a[0]) for a in residual_block_norms(rk))
            self.line("{k:>12}  {n:>12}  {bz:>12.4e}  {bl:>12.4e}  "
                      "{bv:>12.4e}  {ri:>12.4e}  {t:>12.4e}",
                      k=int(k[0]), n=int(n[0]), bz=bz, bl=bl, bv=bv,
                      ri=self.ri, t=float(inner_tol[0]))
        elif not bool(success[0]):
            self.line("Begin Prox Iter: {k}, Total Newton Iters: {n}, "
                      "Residual: {e:6.4e}\n"
                      "      Iter   Step Size        |rz|        |rl|"
                      "        |rv|",
                      k=int(k[0]), n=int(n[0]), e=float(Ek[0]))

    def inner(self, i, t, ri, Ei, brk, tol) -> None:
        """The Newton iteration's line and the exit footer
        (ITER_DETAILED); records the residual norm for the ITER line."""
        self.ri = float(Ei[0])
        if not self.detailed:
            return
        bz, bl, bv = (float(a[0]) for a in residual_block_norms(ri))
        self.line("{i:>10}  {t:>10.6e}  {bz:>10.6e}  {bl:>10.6e}  "
                  "{bv:>10.6e}", i=i, t=float(t[0]), bz=bz, bl=bl, bv=bv)
        if bool(brk[0]):
            self.line("Exiting inner loop. Inner residual: {e:6.4e}, "
                      "Inner tolerance: {t:6.4e}", e=self.ri,
                      t=float(tol[0]))


def _solve_proximal_subproblem(ops: ProblemOps, data, b_vec, xbar: Variable,
                               tol, sigma, Eouter, newton_iters,
                               opts: Options, run, table=None):
    """Semismooth Newton on x = P(xbar, sigma) for the lanes in `run`
    (impl.h:229-304). Lanes outside `run` return the skip values
    (xbar, Eo = 0, newton_iters, no failure). `table`: lane 0's iteration
    tables (_Table) or None. Returns (x, Eo, newton_iters, lin_fail)."""
    B = run.shape[0]
    dtype, dev = xbar.z.dtype, xbar.z.device
    alpha = opts.alpha

    x = xbar
    Eo = torch.zeros(B, dtype=dtype, device=dev)
    n_iters = newton_iters.clone()
    merit_buf = torch.zeros(B, NONMONOTONE_DEPTH, dtype=dtype, device=dev)
    done = ~run
    lin_fail = torch.zeros(B, dtype=torch.bool, device=dev)
    Ei_best = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    stall_count = torch.zeros(B, dtype=torch.int32, device=dev)
    # The step length of lane 0's last Newton step, for the table only.
    t_last = (torch.ones(B, dtype=dtype, device=dev) if table is not None
              else None)

    for it in range(opts.max_inner_iters):
        act = ~done & ~lin_fail
        if not bool(act.any()):
            break
        ri = inner_residual(ops, data, x, xbar, sigma, alpha)
        Ei = residual_norm(ri)
        Eo_new = _pnr_norm(ops, data, x, alpha)

        # Exit checks (impl.h:250-251, :258).
        brk = (((Ei <= tol) & (Eo_new < Eouter)) | (Ei <= opts.inner_tol_min)
               | (n_iters >= opts.max_newton_iters))
        # f32 stall guard (Options.inner_stall_tol).
        if opts.inner_stall_tol > 0.0:
            improved = Ei < Ei_best * (1.0 - opts.inner_stall_tol)
            stall_new = torch.where(improved, torch.zeros_like(stall_count),
                                    stall_count + 1)
            brk = brk | (stall_new >= 3)
        else:
            stall_new = stall_count
        Ei_best_new = torch.minimum(Ei_best, Ei)
        if table is not None and bool(act[0]):
            table.inner(it, t_last, ri, Ei, brk, tol)

        step = act & ~brk
        x_new, buf_new, n_new = x, merit_buf, n_iters
        fail = torch.zeros_like(lin_fail)
        if bool(step.any()):
            dx, ok = ops.newton_step(data, x, xbar, sigma, alpha,
                                     -ri.z, -ri.l, -ri.v)
            # Nonmonotone merit history (impl.h:277-280).
            current_merit = 0.5 * Ei * Ei
            buf = torch.cat([current_merit[:, None], merit_buf[:, :-1]], 1)
            m0 = (buf.amax(1) if opts.nonmonotone_linesearch
                  else current_merit)

            # Backtracking linesearch (impl.h:283-297). Lanes whose
            # factorization failed exit with LINEAR_SOLVER_FAILED and
            # their trial point is never used, so they do not search.
            t = torch.ones(B, dtype=dtype, device=dev)
            accepted = ~(step & ok)
            for _ in range(opts.max_linesearch_iters):
                if bool(accepted.all()):
                    break
                xp = var_axpy(t, dx, x, b_vec)
                np_ = residual_norm(inner_residual(ops, data, xp, xbar,
                                                   sigma, alpha))
                mp = 0.5 * np_ * np_
                accept = mp <= m0 - 2.0 * t * opts.eta * current_merit
                t = torch.where(~accepted & ~accept, t * opts.beta, t)
                accepted = accepted | accept

            x_new = select_var(step, var_axpy(t, dx, x, b_vec), x)
            buf_new = torch.where(step[:, None], buf, merit_buf)
            # Only successful steps count (impl.h:263-275).
            n_new = torch.where(step & ok, n_iters + 1, n_iters)
            fail = step & ~ok
            if table is not None:
                t_last = torch.where(step, t, t_last)

        x = select_var(act, x_new, x)
        merit_buf = torch.where(act[:, None], buf_new, merit_buf)
        n_iters = torch.where(act, n_new, n_iters)
        Eo = torch.where(act, Eo_new, Eo)
        lin_fail = torch.where(act, fail, lin_fail)
        done = torch.where(act, brk, done)
        Ei_best = torch.where(act, Ei_best_new, Ei_best)
        stall_count = torch.where(act, stall_new, stall_count)

    # Make duals non-negative (impl.h:301) on the lanes that ran.
    x = select_var(run, project_duals(x), x)
    return x, Eo, n_iters, lin_fail


def fbstab_solve_batch(ops: ProblemOps, data, z0, l0, v0,
                       options: Options, stream=None
                       ) -> tuple[Variable, CoreOut]:
    """Solves a batch of QP instances from the warmstarts (B, ...).

    Per lane this is `fbstab_tpu.core.algorithm.fbstab_solve`: the margin
    y is recomputed as b - A z0, and the returned Variable is the
    solution, the best iterate, or an infeasibility certificate depending
    on the lane's eflag.

    stream: the OutputStream (utils/printing.py) that receives lane 0's
    Display.ITER / ITER_DETAILED tables when Options.display_level asks
    for them; None prints them to stdout."""
    opts = options.validated()
    B = z0.shape[0]
    dtype, dev = z0.dtype, z0.device
    sigma = opts.sigma0           # constant per solve (impl.h:136)
    alpha = opts.alpha

    b_vec = ops.b_vec(data)
    combo_tol = opts.abs_tol + opts.rel_tol * (1.0 + ops.forcing_norm(data))

    # Initialization (impl.h:139-149).
    xk = Variable(z=z0, l=l0, v=v0, y=b_vec - ops.gemvA(data, z0))
    dxn = var_norm(Variable(z=torch.ones_like(z0), l=torch.ones_like(l0),
                            v=torch.ones_like(v0), y=None))
    E0 = _pnr_norm(ops, data, xk, alpha)
    inner_tol = torch.clamp(E0, opts.inner_tol_min, opts.inner_tol_max)

    i32 = dict(dtype=torch.int32, device=dev)
    Ek = E0
    newton = torch.zeros(B, **i32)
    prox = torch.zeros(B, **i32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    eflag = torch.full((B,), int(ExitFlag.MAXITERATIONS), **i32)
    out_x = xk
    out_res = E0

    def flag(code):
        return torch.full((B,), int(code), **i32)

    table = (_Table(opts.display_level, stream, B)
             if opts.display_level >= Display.ITER else None)

    for _ in range(opts.max_prox_iters):
        act = ~done
        if not bool(act.any()):
            break
        rk = penalized_natural_residual(ops, data, xk, alpha)
        Ek_new = residual_norm(rk)
        # Success / stall exit (impl.h:162-169).
        success = (Ek_new <= combo_tol) | (dxn <= opts.stall_tol)
        if table is not None and bool(act[0]):
            table.outer(rk, success, prox, newton, Ek_new, inner_tol)
        # Subproblem tolerance update (impl.h:179-180).
        itol = torch.minimum(
            torch.clamp(inner_tol * opts.delta, min=opts.inner_tol_min),
            Ek_new)

        run = act & ~success
        xi, Eo, n_iters, lin_fail = _solve_proximal_subproblem(
            ops, data, b_vec, xk, itol, sigma, Ek_new, newton, opts, run,
            table)

        # dx <- xi - xk with the margin identity (impl.h:201-203).
        dx = Variable(z=xi.z - xk.z, l=xi.l - xk.l, v=xi.v - xk.v,
                      y=xi.y - xk.y + b_vec)

        # Newton budget exit (impl.h:188-199): the better of xi / xk.
        exhausted = n_iters >= opts.max_newton_iters
        x_budget = select_var(Eo < Ek_new, xi, xk)
        res_budget = _pnr_norm(ops, data, x_budget, alpha)

        # Infeasibility detection on dx (impl.h:204-212).
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
            torch.where(lin_fail, flag(ExitFlag.LINEAR_SOLVER_FAILED),
                        torch.where(exhausted, flag(ExitFlag.MAXITERATIONS),
                                    torch.where(infeasible, eflag_infeas,
                                                eflag))))
        out_x_it = select_var(
            success | lin_fail, xk,
            select_var(exhausted, x_budget,
                       select_var(infeasible, dx, out_x)))
        out_res_it = torch.where(
            success | lin_fail, Ek_new,
            torch.where(exhausted, res_budget,
                        torch.where(infeasible, Ek_new, out_res)))

        # Continue: x(k+1) = xi (impl.h:215-216).
        cont = ~done_it
        xk_it = select_var(cont, xi, xk)
        prox_it = torch.where(cont, prox + 1, prox)

        # Commit the iteration on the lanes whose outer loop ran.
        xk = select_var(act, xk_it, xk)
        dxn = torch.where(act, var_norm(dx), dxn)
        inner_tol = torch.where(act, itol, inner_tol)
        Ek = torch.where(act, Ek_new, Ek)
        newton = torch.where(act, n_iters, newton)
        prox = torch.where(act, prox_it, prox)
        eflag = torch.where(act, eflag_it, eflag)
        out_x = select_var(act, out_x_it, out_x)
        out_res = torch.where(act, out_res_it, out_res)
        done = done | (act & done_it)

    # Proximal budget exhausted (impl.h:219-223): xk with the last Ek.
    out_x = select_var(done, out_x, xk)
    out_res = torch.where(done, out_res, Ek)
    eflag = torch.where(done, eflag, flag(ExitFlag.MAXITERATIONS))
    core = CoreOut(eflag=eflag, residual=out_res, newton_iters=newton,
                   prox_iters=prox, initial_residual=E0,
                   raw_residual=out_res, refine_steps=torch.zeros_like(eflag))
    return out_x, core


def fbstab_solve(ops: ProblemOps, data, z0, l0, v0, options: Options,
                 stream=None) -> tuple[Variable, CoreOut]:
    """Solves one QP instance (the JAX package's `fbstab_solve`): `data`
    with a batch of one, the guesses z0 (nz,), l0 (nl,), v0 (nv,)
    unbatched. Returns the lane's (Variable, CoreOut), unbatched. The
    Display.ITER / ITER_DETAILED tables go to `stream` (stdout when
    None)."""
    for a in data:
        if a.shape[0] != 1:
            raise ValueError(f"fbstab_solve takes one instance (a batch of "
                             f"one), got a batch of {a.shape[0]}")
    x, core = fbstab_solve_batch(ops, data, z0[None], l0[None], v0[None],
                                 options, stream)
    one = lambda a: a[0] if isinstance(a, torch.Tensor) else a
    return Variable(*(one(a) for a in x)), CoreOut(*(one(a) for a in core))

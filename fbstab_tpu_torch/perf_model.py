"""The card's arithmetic: peak rates, the least time a piece of work can
take (`bound`), the operation counts of the kernels, and the first-order
performance model of the batched MPC solve that the bench reports.

`chip_smoke.py` and the bench (`python -m fbstab_tpu_torch.bench`) take
every rate and count from here. Operation counts are per instance, from
the shapes (the dominant products; a multiply-add counts two).
"""

from __future__ import annotations

import numpy as np

# One H100 SXM (NVIDIA's data sheet, dense rates at the 700 W limit):
# float32 outside the tensor cores, TF32 on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
# Lanes that run in lockstep on the card: a warp.
WARP = 32


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over `peak` and
    the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def riccati_flops(N, nx, nu, nc):
    """One Riccati Newton step (K1): stage Hessians, the factor recursion
    (Choleskys, triangular solves with matrix right-hand sides, products)
    and the vector recursions. It is the bound's work in both modes: the
    recompute-factors mode (lowmem) computes the same step, bit for bit,
    and forms each stage's factors twice more by its own choice."""
    stage = (2 * nc * (nx * nx + nu * nu + nu * nx)      # E'GE, L'GL, L'GE
             + 2 * nx ** 3 + nx ** 3 / 3                 # inv(L L'), chol M
             + nx * nx * nu + nu ** 3 / 3 + 2 * nu * nu * nx   # SM, SG
             + nx ** 3 + 2 * nx * nx * nu + nu * nu * nx       # AM, P
             + nx ** 3 / 3 + 2 * nx * nx * nu + 2 * nx ** 3    # L(i+1)
             + 12 * (nx * nx + nx * nu + nu * nu))        # vector passes
    return (N + 1) * stage


def mpc_solve_bound(B, N, nx, nu, nc, newton, prox, launches=1):
    """(bound_ms, bound_by) of a fused MPC solve of B instances from the
    shapes and this run's mean Newton and proximal counts (one linesearch
    trial a Newton iteration, solve_flops): K2 (launches=1) reads the data
    and the guess once and writes the point and five scalars a lane; K4
    under the host outer loop reads the data and the proximal center and
    writes the iterate and eight scalars a lane in each of `launches`
    launches."""
    N1 = N + 1
    point = N1 * (2 * nx + nu + 2 * nc)                 # z, l, v, y
    data = mpc_data_floats(N, nx, nu, nc)
    flops = B * solve_flops(
        riccati_flops(N, nx, nu, nc) + 8 * N1 * nc,
        mpc_residual_flops(N, nx, nu, nc), newton, prox)
    if launches == 1:
        floats = data + (point - N1 * nc) + point + 5
    else:
        floats = launches * (data + 2 * point + 8)
    return bound(flops, 4 * B * floats)


def mpc_residual_flops(N, nx, nu, nc):
    ns = nx + nu
    return (N + 1) * (2 * ns * ns + 6 * nx * ns + 2 * nc * ns + 10 * nc)


# Rounding float32 operations of one double-float multiply-add
# (doublefloat.cuh's df_mac): Dekker's two_prod 17, the error term's product
# and sum 2, the pair sum df_add 11. None of them contracts into an FMA, so
# each takes an instruction slot of its own: the card's float32 rate is
# then half its FMA-counted peak.
DF_MAC_OPS = 30
PEAK_F32_NO_FMA = PEAK_F32_FLOPS / 2


def refine_residual_flops(N, nx, nu, nc):
    """Rounding operations of one evaluation of the MPC refinement's
    double-float residual for one instance (ops/refine_residual_cuda.py):
    DF_MAC_OPS for each multiply-add of the margin (E zx + L zu), the KKT
    blocks (Q zx + S' zu + A' l + E' v, S zx + R zu + B' l + L' v) and rl
    (A zx + B zu); the pair epilogues, a few percent more, are not
    counted. Bound it against PEAK_F32_NO_FMA."""
    ns = nx + nu
    return DF_MAC_OPS * ns * ((N + 1) * (ns + 2 * nc) + 2 * N * nx)


def dense_step_flops(n, q, nl):
    f = n * n * q + n ** 3 / 3 + 4 * n * q + 4 * n * n
    if nl > 0:
        f += n * n * nl + n * nl * nl + nl ** 3 / 3 + 4 * n * nl + 4 * nl * nl
    return f


def dense_residual_flops(n, q, nl):
    return 2 * n * n + 4 * n * q + 4 * n * nl + 10 * q


def solve_flops(step, residual, newton, prox):
    """A fused solve: per Newton iteration one step, the inner residual,
    the outer residual and one linesearch trial (the fewest: a full step
    accepted); per proximal iteration the outer residual and the
    infeasibility check (about two residuals)."""
    return newton * (step + 3 * residual) + (prox + 1) * 3 * residual


def combine_flops(n):
    """One combine of the associative scan (K5) per (pair, instance): the
    factor of K, the solves of its 2n + 1 right-hand sides, the six
    products."""
    return n ** 3 / 3 + 2 * n * n * (2 * n + 1) + 6 * n ** 3 + 4 * n * n


def stage_matvec_flops(N1, n, B, T):
    """The stage-matvec probe: T applications of an n x n matrix to every
    stage vector of every lane."""
    return 2 * n * n * N1 * B * T


def mpc_data_floats(N, nx, nu, nc):
    """Floats of one MPC instance's data (Q, R, S, q, r, A, B, c, E, L, d,
    x0)."""
    N1 = N + 1
    return (N1 * (nx * nx + nu * nu + nu * nx + nx + nu + nc * nx + nc * nu
                  + nc) + N * (nx * nx + nx * nu + nx) + nx)


# ------------------------------------------------------------------
# The bench's performance model of the batched MPC solve.
# ------------------------------------------------------------------

def executed_refine_steps(core) -> int:
    """Worst-lane executed refinement iterations of a solve (CoreOut's
    refine_steps; never Options.refine_steps, the early-exit loop's
    maximum)."""
    return int(np.max(core.refine_steps.cpu().numpy()))


def mean_refine_steps(core) -> float:
    """Mean per-lane executed refinement iterations: the model's refine
    weight (chunks exit on their own, so the batch's cost follows the
    mean)."""
    return float(np.mean(core.refine_steps.cpu().numpy()))


def lockstep_warp_iters(newton_iters, two_phase=None, width=WARP):
    """Newton iterations the card executes in lockstep: the sum over warps
    of `width` lanes of the slowest lane's count (a warp of K2 holds one
    block of teams, an instance a team, and runs until its slowest
    instance exits).

    two_phase=(k1, P): phase 1 runs each warp to min(its slowest lane,
    k1); the lanes beyond k1 are compacted in index order into phase-2
    warps (at most P lanes) that each run their slowest lane's remaining
    count. newton_iters holds both phases' sums per lane."""
    ni = np.asarray(newton_iters, np.int64)
    warps = [ni[i:i + width] for i in range(0, len(ni), width)]
    if two_phase is None:
        return int(sum(int(w.max()) for w in warps))
    k1, P = two_phase
    phase1 = int(sum(min(int(w.max()), k1) for w in warps))
    rest = (ni[ni > k1] - k1)[:P]
    phase2 = int(sum(int(rest[i:i + width].max())
                     for i in range(0, len(rest), width)))
    return phase1 + phase2


def mpc_perf_model(B, N, nx, nu, nc, newton_iters, t_solve, refine_steps,
                   two_phase=None, width=WARP):
    """First-order model of a batched MPC solve on the card: operations per
    Newton iteration and per solve (bench.py's counts: per Newton iteration
    one Riccati factorization and back-solve and ~2.5 residual evaluations;
    per executed refinement step one double-float KKT residual, ~8 plain
    ones, and one factor and solve), the sustained rate, and the least
    time the card could take for the batch (`bound`: those operations over
    the float32 peak against the data read once and the double-float
    solution written once).

    `refine_steps` is the EXECUTED count (mean_refine_steps), not
    Options.refine_steps: the maximum would overstate the refine term
    several times over. `width` is the instances a warp holds
    (lockstep_warp_iters)."""
    N1 = N + 1
    f_hess = 2 * N1 * nc * (nx * nx + nu * nu + nu * nx)
    f_factor = 2 * N1 * (
        nx ** 3 + nx ** 3 // 3 + nx * nx * nu + nu ** 3 // 3 + nu * nu * nx
        + nx ** 3 // 2 + nx * nu * nx + nu * nu * nx
        + nx ** 3 // 3 + nx * nx * nu + nx ** 3 // 2)
    f_solve = 2 * N1 * (3 * nx * nx + 2 * nu * nx + nu * nu
                        + 2 * nc * (nx + nu))
    f_resid = 2 * N1 * (nx * nx + nu * nu + 2 * nu * nx + 2 * nx * nx
                        + 2 * nc * (nx + nu) + 6 * nc)
    flops_iter = f_hess + f_factor + f_solve + 2.5 * f_resid
    flops_refine = refine_steps * (8 * f_resid + f_hess + f_factor + f_solve)
    ni = np.asarray(newton_iters, np.int64)
    flops_solve_mean = float(flops_iter * ni.mean() + flops_refine)
    # Read the data once, write (z, l, v, y) as double-float pairs.
    out_floats = 2 * N1 * ((nx + nu) + nx + 2 * nc)
    bound_ms, bound_by = bound(
        B * flops_solve_mean,
        4 * B * (mpc_data_floats(N, nx, nu, nc) + out_floats))
    t = float(t_solve)
    return {
        "flops_per_newton_iter": int(flops_iter),
        "flops_per_solve_mean": int(flops_solve_mean),
        "sustained_gflops": round(flops_solve_mean * B / t / 1e9, 2),
        "newton_iters_mean": round(float(ni.mean()), 2),
        "executed_refine_steps": round(float(refine_steps), 2),
        "lockstep_warp_iters": lockstep_warp_iters(ni, two_phase, width),
        "measured_s": round(t, 4),
        "bound_s": bound_ms / 1e3,
        "bound_by": bound_by,
        "pct_of_bound": 100.0 * bound_ms / 1e3 / max(t, 1e-12),
    }

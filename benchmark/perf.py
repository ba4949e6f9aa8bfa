"""The card's peaks and the work of the port's kernels: the yardstick of
every roofline share and of `solve_mfu`.

Frozen copy of fbstab_tpu_torch/perf_model.py at commit 326587a (the
peaks, `bound`, `riccati_flops`, `mpc_residual_flops`, `solve_flops`,
`mpc_data_floats` and the arithmetic of `mpc_solve_bound`, split here
into its operations and its bytes so that a window's work can be summed
over calls), and of chip_smoke.py's byte count of one K1 launch at the
same commit. Operation counts are per instance, from the shapes and the
run's measured Newton and proximal counts (a multiply-add counts two);
bytes count each input read once and each output written once.
"""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet, dense rates at the 700 W limit):
# float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over `peak` and
    the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def riccati_flops(N, nx, nu, nc):
    """One Riccati Newton step (K1): stage Hessians, the factor recursion
    (Choleskys, triangular solves with matrix right-hand sides, products)
    and the vector recursions."""
    stage = (2 * nc * (nx * nx + nu * nu + nu * nx)      # E'GE, L'GL, L'GE
             + 2 * nx ** 3 + nx ** 3 / 3                 # inv(L L'), chol M
             + nx * nx * nu + nu ** 3 / 3 + 2 * nu * nu * nx   # SM, SG
             + nx ** 3 + 2 * nx * nx * nu + nu * nu * nx       # AM, P
             + nx ** 3 / 3 + 2 * nx * nx * nu + 2 * nx ** 3    # L(i+1)
             + 12 * (nx * nx + nx * nu + nu * nu))        # vector passes
    return (N + 1) * stage


def mpc_residual_flops(N, nx, nu, nc):
    ns = nx + nu
    return (N + 1) * (2 * ns * ns + 6 * nx * ns + 2 * nc * ns + 10 * nc)


def solve_flops(step, residual, newton, prox):
    """A fused solve: per Newton iteration one step, the inner residual,
    the outer residual and one linesearch trial (the fewest: a full step
    accepted); per proximal iteration the outer residual and the
    infeasibility check (about two residuals)."""
    return newton * (step + 3 * residual) + (prox + 1) * 3 * residual


def mpc_data_floats(N, nx, nu, nc):
    """Floats of one MPC instance's data (Q, R, S, q, r, A, B, c, E, L, d,
    x0)."""
    N1 = N + 1
    return (N1 * (nx * nx + nu * nu + nu * nx + nx + nu + nc * nx + nc * nu
                  + nc) + N * (nx * nx + nx * nu + nx) + nx)


def mpc_solve_flops(B, N, nx, nu, nc, newton, prox):
    """Operations of a fused MPC solve (K2, or K4 under the host outer
    loop) of B instances at the mean Newton and proximal counts."""
    return B * solve_flops(
        riccati_flops(N, nx, nu, nc) + 8 * (N + 1) * nc,
        mpc_residual_flops(N, nx, nu, nc), newton, prox)


def mpc_solve_bytes(B, N, nx, nu, nc, launches=1):
    """Bytes of a fused MPC solve of B instances: K2 (launches=1) reads
    the data and the guess once and writes the point and five scalars a
    lane; K4 under the host outer loop, `launches` launches of
    subproblem_bytes."""
    N1 = N + 1
    point = N1 * (2 * nx + nu + 2 * nc)                 # z, l, v, y
    if launches == 1:
        data = mpc_data_floats(N, nx, nu, nc)
        return F32 * B * (data + (point - N1 * nc) + point + 5)
    return subproblem_bytes(B, N, nx, nu, nc, launches)


def subproblem_bytes(B, N, nx, nu, nc, launches):
    """Bytes of `launches` K4 launches over B instances: each reads the
    data and the proximal center and writes the iterate and eight scalars
    a lane."""
    point = (N + 1) * (2 * nx + nu + 2 * nc)
    return F32 * B * launches * (mpc_data_floats(N, nx, nu, nc)
                                 + 2 * point + 8)


def riccati_step_bytes(lanes, N, nx, nu, nc):
    """Bytes of K1 over `lanes` instance-steps: each reads the stage
    matrices (Q, R, S, A, B, E, L) and six vectors (v, y, vbar, rz, rl,
    rv) and writes dz and dl."""
    N1 = N + 1
    mats = (N1 * (nx * nx + nu * nu + nu * nx + nc * nx + nc * nu)
            + N * (nx * nx + nx * nu))
    vecs = N1 * (3 * nc + (nx + nu) + nx + nc)
    outs = N1 * ((nx + nu) + nx)
    return F32 * lanes * (mats + vecs + outs)

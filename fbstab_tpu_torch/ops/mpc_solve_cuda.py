"""K2, the fused FBstab MPC solver, as a CUDA kernel (csrc/mpc_solve.cu).

Counterpart of `fbstab_tpu/ops/mpc_solve_pallas.py::fbstab_mpc_solve_fused`
in its modes: one launch runs the whole algorithm (outer proximal
loop, inner Newton loop on the shared Riccati device function,
nonmonotone linesearch, infeasibility checks, exit flags) for every
instance, a team of threads per instance, on the batch-first
(instance-major) tensors as torch holds them. `lowmem=True` launches the
recompute-factors kernel (the JAX package's serial lowmem launch,
mpc_solve_pallas.py:1191), whose Newton steps are bit for bit the standard
kernel's; the JAX package's `staged` formulation is the device code's own
in every mode (csrc/mpc_solve.cu). The kernel stages its teams' stage
blocks in shared memory where a block can hold them and works in place
otherwise, at every shape.

`fbstab_mpc_solve_fused` takes the plain version (`fbstab_mpc_solve_plain`,
the batched lockstep solver of core/algorithm.py on the MPC operators with
the plain Newton step) only for tensors on the CPU. For CUDA tensors it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch import telemetry
from fbstab_tpu_torch.core.algorithm import CoreOut
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.ops.riccati_cuda import _check_f32, check_batch
from fbstab_tpu_torch.options import Options

def fbstab_mpc_solve_plain(data, z0, l0, v0, options: Options):
    """The plain PyTorch version of K2, whose Newton step is the plain K1
    on every device: returns (Variable, CoreOut)."""
    from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
    from fbstab_tpu_torch.models.mpc_qp import MPC_PLAIN_OPS, exact_f32_matmul
    exact_f32_matmul(z0)
    return fbstab_solve_batch(MPC_PLAIN_OPS, data, z0, l0, v0, options)


def solve_opts(options: Options, struct=None):
    """The kernel's option struct (`_build.SolveOpts`, or a `struct` with
    the same fields) from validated options."""
    from fbstab_tpu_torch.ops._build import SolveOpts
    o = options.validated()
    return (struct or SolveOpts)(
        sigma=o.sigma0, alpha=o.alpha, om_alpha=1.0 - o.alpha, beta=o.beta,
        eta=o.eta, delta=o.delta, abs_tol=o.abs_tol, rel_tol=o.rel_tol,
        stall_tol=o.stall_tol, infeas_tol=o.infeas_tol,
        inner_tol_max=o.inner_tol_max, inner_tol_min=o.inner_tol_min,
        inner_stall_tol=o.inner_stall_tol, om_stall=1.0 - o.inner_stall_tol,
        max_newton=o.max_newton_iters, max_prox=o.max_prox_iters,
        max_inner=o.max_inner_iters, max_ls=o.max_linesearch_iters,
        check_feasibility=int(o.check_feasibility),
        nonmonotone=int(o.nonmonotone_linesearch))


def launch_mpc_solve(lib, data, z0, l0, v0, options: Options, stream: int,
                     lowmem: bool = False):
    """Allocates outputs and scratch and launches K2 from `lib` on the
    batch-first inputs (contiguous, as the kernel reads them), in the
    standard or (lowmem) the recompute-factors mode. Returns batch-first
    (Variable, CoreOut). Raises KernelResourceError, before anything is
    allocated, where the card cannot give the scratch."""
    N, nx, nu, nc = (data.A.shape[-3], data.A.shape[-1], data.B.shape[-1],
                     data.E.shape[-2])
    B = z0.shape[0]
    N1, ns = N + 1, nx + nu
    dev = z0.device
    _check_f32(dev, z0=z0, l0=l0, v0=v0, **data._asdict())
    for name, t, n in (("z0", z0, N1 * ns), ("l0", l0, N1 * nx),
                       ("v0", v0, N1 * nc)):
        if tuple(t.shape) != (B, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(B, n)}")
    check_batch(B, data)
    from fbstab_tpu_torch.ops._build import check, check_scratch
    wsf = lib.fb_solve_ws_floats(N, nx, nu, nc, int(lowmem))
    check_scratch("fbstab_mpc_solve", B, wsf, dev)
    ins = [a.contiguous() for a in (
        data.q, data.r, data.c, data.x0, data.d, data.Q, data.R, data.S,
        data.A, data.B, data.E, data.L, z0, l0, v0)]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    z = torch.empty(B, N1 * ns, **f32)
    l = torch.empty(B, N1 * nx, **f32)
    v = torch.empty(B, N1 * nc, **f32)
    y = torch.empty(B, N1 * nc, **f32)
    eflag = torch.empty(B, **i32)
    res = torch.empty(B, **f32)
    newton = torch.empty(B, **i32)
    prox = torch.empty(B, **i32)
    res0 = torch.empty(B, **f32)
    ws = torch.empty(B, wsf, **f32)
    outs = (z, l, v, y, eflag, res, newton, prox, res0, ws)
    err = lib.fb_mpc_solve(N, nx, nu, nc, B, int(lowmem), solve_opts(options),
                           *[a.data_ptr() for a in ins],
                           *[a.data_ptr() for a in outs], stream)
    check(err, "fbstab_mpc_solve")
    x = Variable(z=z, l=l, v=v, y=y)
    core = CoreOut(eflag=eflag, residual=res, newton_iters=newton,
                   prox_iters=prox, initial_residual=res0, raw_residual=res,
                   refine_steps=torch.zeros_like(eflag))
    return x, core


def fbstab_mpc_solve_fused(data, z0, l0, v0, options: Options,
                           lowmem: bool = False):
    """Batched MPC solve, (B, ...) batch-first in and out, matching
    `fbstab_solve_batch`'s contract lane for lane. CPU tensors take the
    plain version; CUDA float32 tensors launch K2, in the recompute-factors
    mode with `lowmem` (the JAX signature's; the batch dispatch picks it
    with models.mpc_qp.riccati_mode). Counts the standard kernel's
    launches as `launch.k2`, the recompute-factors kernel's as
    `launch.k2_lowmem` (telemetry.counters())."""
    if z0.device.type == "cpu":
        return fbstab_mpc_solve_plain(data, z0, l0, v0, options)
    if not z0.is_cuda:
        raise ValueError(f"no solver kernel for device {z0.device}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    out = launch_mpc_solve(lib, data, z0, l0, v0, options, stream, lowmem)
    telemetry.count("launch.k2_lowmem" if lowmem else "launch.k2")
    return out


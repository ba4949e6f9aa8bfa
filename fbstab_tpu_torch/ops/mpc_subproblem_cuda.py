"""K4, one outer proximal iteration of the MPC solver, as a CUDA kernel
(csrc/mpc_subproblem.cu).

Counterpart of `fbstab_tpu/ops/mpc_solve_pallas.py::mpc_subproblem_fused`:
for every instance one launch computes Ek, the success / stall test and
the inner tolerance, runs the whole inner Newton loop with its linesearch
about the proximal center xbar, and returns the new dx norm. The outer
loop runs in PyTorch (models/mpc_subfused.py). Lanes that enter done, or
that succeed in the kernel, return xi = xbar, Eo = 0 and their counters
and dx norm unchanged.

The mode is part of the loop-invariant layout (`SubfusedData.lowmem`):
lowmem launches the recompute-factors kernel (the JAX package's
`_make_subproblem_kernel(lowmem=True)`), whose Newton steps are bit for
bit the standard kernel's; the plain version does not depend on it. The
kernel works stage by stage in every mode, the counterpart of the JAX
kernel's `staged` formulation, and stages its team's stage block in shared
memory where a block can hold it, in place otherwise.

`mpc_subproblem_fused` takes the plain version (`mpc_subproblem_plain`,
the lockstep inner loop of core/algorithm.py on the plain Newton step) only
for tensors on the CPU. For CUDA tensors it launches the kernel or raises;
it never falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fbstab_tpu_torch.core.variable import Variable, var_norm
from fbstab_tpu_torch.ops.riccati_cuda import _check_f32, check_batch
from fbstab_tpu_torch.options import Options


class SubfusedData(NamedTuple):
    """The problem data of one subfused solve, batch-first; for CUDA
    float32 data contiguous, the instance-major layout K4 reads."""

    data: object                  # MpcQPData, (B, ...)
    lowmem: bool = False          # K4's recompute-factors mode


def prep_subfused_data(data, lowmem: bool = False) -> SubfusedData:
    """The loop-invariant kernel layout, built once per solve outside the
    outer loop (`prep_subfused_data` in the JAX package): a contiguous copy
    of any array of CUDA float32 data that is not contiguous already, and
    the mode every launch of the solve takes."""
    if data.Q.is_cuda and data.Q.dtype == torch.float32:
        data = type(data)(*(a.contiguous() for a in data))
    return SubfusedData(data=data, lowmem=lowmem)


def mpc_subproblem_plain(prep: SubfusedData, xbar: Variable, itol_prev,
                         dxn_prev, newton0, done, options: Options):
    """The plain PyTorch version of K4: one outer iteration of
    core/algorithm.py's lockstep solver on the plain Newton step, with the
    kernel's inactive-lane contract. Returns
    (xi, Eo, newton, lfail, Ek, success, itol, dxn), scalars per lane."""
    from fbstab_tpu_torch.core.algorithm import (
        _pnr_norm, _solve_proximal_subproblem)
    from fbstab_tpu_torch.models.mpc_qp import MPC_PLAIN_OPS, exact_f32_matmul
    opts = options.validated()
    ops, data = MPC_PLAIN_OPS, prep.data
    exact_f32_matmul(xbar.z)
    combo_tol = opts.abs_tol + opts.rel_tol * (1.0 + ops.forcing_norm(data))
    Ek = _pnr_norm(ops, data, xbar, opts.alpha)
    success = (Ek <= combo_tol) | (dxn_prev <= opts.stall_tol)
    itol = torch.minimum(
        torch.clamp(itol_prev * opts.delta, min=opts.inner_tol_min), Ek)
    active = ~done & ~success
    xi, Eo, newton, lfail = _solve_proximal_subproblem(
        ops, data, ops.b_vec(data), xbar, itol, opts.sigma0, Ek, newton0,
        opts, active)
    step = Variable(z=xi.z - xbar.z, l=xi.l - xbar.l, v=xi.v - xbar.v,
                    y=None)
    dxn = torch.where(active, var_norm(step), dxn_prev)
    return xi, Eo, newton, lfail, Ek, success, itol, dxn


def launch_subproblem(lib, prep: SubfusedData, xbar: Variable, itol_prev,
                      dxn_prev, newton0, done, options: Options,
                      stream: int):
    """Allocates outputs and scratch and launches K4 from `lib` on the
    batch-first data of `prep` and iterate, in `prep`'s mode. Returns
    batch-first results. Raises KernelResourceError, before anything is
    allocated, where the card cannot give the scratch."""
    from fbstab_tpu_torch.models.mpc_qp import mpc_dims
    from fbstab_tpu_torch.ops._build import check, check_scratch
    from fbstab_tpu_torch.ops.mpc_solve_cuda import solve_opts
    data = prep.data
    N, nx, nu, nc = mpc_dims(data)
    B = xbar.z.shape[0]
    N1, ns = N + 1, nx + nu
    dev = xbar.z.device
    _check_f32(dev, z=xbar.z, l=xbar.l, v=xbar.v, y=xbar.y,
               itol_prev=itol_prev, dxn_prev=dxn_prev, **data._asdict())
    for name, t, n in (("z", xbar.z, N1 * ns), ("l", xbar.l, N1 * nx),
                       ("v", xbar.v, N1 * nc), ("y", xbar.y, N1 * nc)):
        if tuple(t.shape) != (B, n):
            raise ValueError(f"xbar.{name} has shape {tuple(t.shape)}, "
                             f"expected {(B, n)}")
    for name, t in (("itol_prev", itol_prev), ("dxn_prev", dxn_prev),
                    ("newton0", newton0), ("done", done)):
        if tuple(t.shape) != (B,) or t.device != dev:
            raise ValueError(f"{name}: expected ({B},) on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    check_batch(B, data)
    lowmem = int(prep.lowmem)
    wsf = lib.fb_subproblem_ws_floats(N, nx, nu, nc, lowmem)
    check_scratch("mpc_subproblem", B, wsf, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ins = (*(a.contiguous() for a in (
        data.q, data.r, data.c, data.x0, data.d, data.Q, data.R, data.S,
        data.A, data.B, data.E, data.L)), *(a.contiguous() for a in xbar),
        itol_prev.contiguous(), dxn_prev.contiguous(),
        newton0.to(**i32).contiguous(), done.to(**i32).contiguous())
    z, l, v, y = (torch.empty(B, n, **f32)
                  for n in (N1 * ns, N1 * nx, N1 * nc, N1 * nc))
    Eo, Ek, itol, dxn = (torch.empty(B, **f32) for _ in range(4))
    newton, lfail, success = (torch.empty(B, **i32) for _ in range(3))
    ws = torch.empty(B, wsf, **f32)
    outs = (z, l, v, y, Eo, newton, lfail, Ek, success, itol, dxn, ws)
    err = lib.fb_mpc_subproblem(N, nx, nu, nc, B, lowmem, solve_opts(options),
                                *[a.data_ptr() for a in ins],
                                *[a.data_ptr() for a in outs], stream)
    check(err, "mpc_subproblem")
    xi = Variable(z, l, v, y)
    return xi, Eo, newton, lfail > 0, Ek, success > 0, itol, dxn


def mpc_subproblem_fused(prep: SubfusedData, xbar: Variable, itol_prev,
                         dxn_prev, newton0, done, options: Options):
    """One outer iteration over a batch: Ek, success, the inner tolerance,
    the inner Newton loop and the dx norm, per lane. xbar is the proximal
    center (B, ...); itol_prev, dxn_prev (B,) float, newton0 (B,) int,
    done (B,) bool. CPU tensors take the plain version; CUDA float32
    tensors launch K4 in `prep`'s mode, counted in `.launches` (standard)
    or `.launches_lowmem` (recompute-factors)."""
    args = (prep, xbar, itol_prev, dxn_prev, newton0, done, options)
    if xbar.z.device.type == "cpu":
        return mpc_subproblem_plain(*args)
    if not xbar.z.is_cuda:
        raise ValueError(f"no subproblem kernel for device {xbar.z.device}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream(xbar.z.device).cuda_stream
    out = launch_subproblem(lib, *args, stream)
    if prep.lowmem:
        mpc_subproblem_fused.launches_lowmem += 1
    else:
        mpc_subproblem_fused.launches += 1
    return out


mpc_subproblem_fused.launches = 0
mpc_subproblem_fused.launches_lowmem = 0

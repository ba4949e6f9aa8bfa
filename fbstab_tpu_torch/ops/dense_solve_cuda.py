"""K3, the fused FBstab dense QP solver, as a CUDA kernel
(csrc/dense_solve.cu).

Counterpart of `fbstab_tpu/ops/dense_solve_pallas.py::
fbstab_dense_solve_fused`: one launch runs the whole algorithm (outer
proximal loop, inner Newton loop on the quasi-definite block step,
nonmonotone linesearch, infeasibility checks, exit flags) for every
instance, a team of threads per instance on the batch-first (instance-major)
tensors as torch holds them, on the loop K2 shares (csrc/fbstab_solve.cuh).

The kernel's Newton step reports failure as a NaN in (dz, dl), as the
Pallas kernel does; the plain step reports it as a non-finite factor
diagonal, as `models/dense_qp.py::_factor_ok` does. The two agree except
on lanes whose factorization breaks down without a NaN reaching the step.

`fbstab_dense_solve_fused` takes the plain version
(`fbstab_dense_solve_plain`, the batched lockstep solver of
core/algorithm.py on the plain dense step) only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch.core.algorithm import CoreOut
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.ops.mpc_solve_cuda import solve_opts
from fbstab_tpu_torch.ops.riccati_cuda import _check_f32
from fbstab_tpu_torch.options import Options


def fbstab_dense_solve_plain(data, z0, l0, v0, options: Options):
    """The plain PyTorch version of K3: returns (Variable, CoreOut)."""
    from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
    from fbstab_tpu_torch.models.dense_qp import DENSE_OPS
    from fbstab_tpu_torch.models.mpc_qp import exact_f32_matmul
    exact_f32_matmul(z0)
    return fbstab_solve_batch(DENSE_OPS, data, z0, l0, v0, options)


def _within_cap(n, q, nl) -> bool:
    from fbstab_tpu_torch.models.dense_qp import DENSE_DIMS_CAP as cap
    return n <= cap["n"] and q <= cap["q"] and nl <= cap["nl"]


def launch_dense_solve(lib, data, z0, l0, v0, options: Options, stream: int):
    """Allocates outputs and scratch and launches K3 from `lib` on the
    contiguous batch-first float32 tensors, at any size (DENSE_DIMS_CAP is
    the caller's policy). Returns batch-first (Variable, CoreOut)."""
    n, q, nl = data.H.shape[-1], data.A.shape[-2], data.G.shape[-2]
    B = z0.shape[0]
    dev = z0.device
    tensors = dict(z0=z0, l0=l0, v0=v0, **data._asdict())
    _check_f32(dev, **tensors)
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: K3 takes contiguous tensors")
    for name, t, k in (("z0", z0, n), ("l0", l0, nl), ("v0", v0, q)):
        if tuple(t.shape) != (B, k):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(B, k)}")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    x = Variable(z=torch.empty(B, n, **f32), l=torch.empty(B, nl, **f32),
                 v=torch.empty(B, q, **f32), y=torch.empty(B, q, **f32))
    eflag = torch.empty(B, **i32)
    res = torch.empty(B, **f32)
    newton = torch.empty(B, **i32)
    prox = torch.empty(B, **i32)
    res0 = torch.empty(B, **f32)
    ws = torch.empty(B, lib.fb_dense_ws_floats(n, q, nl), **f32)
    outs = (*x, eflag, res, newton, prox, res0, ws)
    err = lib.fb_dense_solve(n, q, nl, B, solve_opts(options),
                             *[a.data_ptr() for a in (*data, z0, l0, v0)],
                             *[a.data_ptr() for a in outs], stream)
    from fbstab_tpu_torch.ops._build import check
    check(err, "fbstab_dense_solve")
    core = CoreOut(eflag=eflag, residual=res, newton_iters=newton,
                   prox_iters=prox, initial_residual=res0, raw_residual=res,
                   refine_steps=torch.zeros_like(eflag))
    return x, core


def fbstab_dense_solve_fused(data, z0, l0, v0, options: Options):
    """Batched dense solve, (B, ...) batch-first in and out, matching
    `fbstab_solve_batch`'s contract lane for lane. CPU tensors take the
    plain version; CUDA float32 tensors within DENSE_DIMS_CAP launch K3;
    any other CUDA tensor raises."""
    if z0.device.type == "cpu":
        return fbstab_dense_solve_plain(data, z0, l0, v0, options)
    if not z0.is_cuda:
        raise ValueError(f"no solver kernel for device {z0.device}")
    n, q, nl = data.H.shape[-1], data.A.shape[-2], data.G.shape[-2]
    if not _within_cap(n, q, nl):
        raise ValueError(f"K3 takes n, q, nl within DENSE_DIMS_CAP, got "
                         f"n={n} q={q} nl={nl}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream(z0.device).cuda_stream
    out = launch_dense_solve(lib, data, z0, l0, v0, options, stream)
    fbstab_dense_solve_fused.launches += 1
    return out


fbstab_dense_solve_fused.launches = 0

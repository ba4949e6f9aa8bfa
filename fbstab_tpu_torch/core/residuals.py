"""Batched residuals of the FBstab optimality systems (counterpart of
`fbstab_tpu/core/residuals.py`; reference full_residual.{h,cc})."""

from __future__ import annotations

from typing import NamedTuple

import torch

from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.ops.pfb import pfb


class Residual(NamedTuple):
    z: torch.Tensor  # stationarity block (B, nz)
    l: torch.Tensor  # equality block (B, nl)
    v: torch.Tensor  # complementarity block (B, nv)


def residual_norm(r: Residual):
    """Per-lane sqrt(|rz|^2 + |rl|^2 + |rv|^2) (full_residual.cc:39-41)."""
    s = (r.z * r.z).sum(-1) + (r.l * r.l).sum(-1) + (r.v * r.v).sum(-1)
    return torch.sqrt(s)


def residual_block_norms(r: Residual):
    """Per-lane (|rz|, |rl|, |rv|), the per-block norms of the reference
    (full_residual.h z_norm()/l_norm()/v_norm()) that the ITER display
    tables print (fbstab_algorithm-impl.h:414-430)."""
    return tuple(torch.sqrt((a * a).sum(-1)) for a in r)


def inner_residual(ops: ProblemOps, data, x: Variable, xbar: Variable,
                   sigma, alpha) -> Residual:
    """Proximal-subproblem residual (full_residual.cc:49-74):
    rz = Hz + f + G'l + A'v + sigma(z - zbar), rl = h - Gz + sigma(l - lbar),
    rv = pfb(y + sigma(v - vbar), v)."""
    rz = (ops.f_vec(data) + ops.gemvH(data, x.z) + ops.gemvGT(data, x.l)
          + ops.gemvAT(data, x.v) + sigma * (x.z - xbar.z))
    rl = ops.h_vec(data) - ops.gemvG(data, x.z) + sigma * (x.l - xbar.l)
    ys = x.y + sigma * (x.v - xbar.v)
    rv = pfb(ys, x.v, alpha)
    return Residual(z=rz, l=rl, v=rv)


def natural_residual(ops: ProblemOps, data, x: Variable) -> Residual:
    """KKT natural residual, paper (17) (full_residual.cc:76-97)."""
    rz = (ops.f_vec(data) + ops.gemvH(data, x.z) + ops.gemvGT(data, x.l)
          + ops.gemvAT(data, x.v))
    rl = ops.h_vec(data) - ops.gemvG(data, x.z)
    rv = torch.minimum(x.y, x.v)
    return Residual(z=rz, l=rl, v=rv)


def penalized_natural_residual(ops: ProblemOps, data, x: Variable,
                               alpha) -> Residual:
    """The convergence metric (full_residual.cc:99-109):
    rv <- alpha*min(y, v) + (1 - alpha)*max(0, y)*max(0, v)."""
    r = natural_residual(ops, data, x)
    rv = (alpha * r.v + (1.0 - alpha) * torch.clamp(x.y, min=0.0)
          * torch.clamp(x.v, min=0.0))
    return Residual(z=r.z, l=r.l, v=rv)

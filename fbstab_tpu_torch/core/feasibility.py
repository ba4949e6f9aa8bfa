"""Batched primal/dual infeasibility detection, paper Alg. 3 (counterpart
of `fbstab_tpu/core/feasibility.py`; reference full_feasibility.cc:25-88)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.variable import Variable


class FeasibilityResult(NamedTuple):
    primal_feasible: torch.Tensor  # (B,) bool
    dual_feasible: torch.Tensor    # (B,) bool


def _inf_norm(x):
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return x.abs().amax(-1)


def check_feasibility(ops: ProblemOps, data, x: Variable,
                      tol) -> FeasibilityResult:
    """Infeasibility certificates at the proximal step x = dx.

    Dual infeasible: max(Az) <= tol*|z|, |Gz| <= tol*|z|, |Hz| <= tol*|z|,
    f'z < 0 and |z| > 1e-14 (infinity norms). Primal infeasible:
    |A'v + G'l| <= tol*max(|v|, |l|) and b'v + h'l < 0."""
    z, l, v = x.z, x.l, x.v

    d1 = ops.gemvA(data, z).amax(-1)
    d2 = _inf_norm(ops.gemvG(data, z))
    d3 = _inf_norm(ops.gemvH(data, z))
    d4 = (ops.f_vec(data) * z).sum(-1)
    w = _inf_norm(z)
    dual_infeasible = ((d1 <= w * tol) & (d2 <= tol * w) & (d3 <= tol * w)
                       & (d4 < 0) & (w > 1e-14))

    p1 = _inf_norm(ops.gemvAT(data, v) + ops.gemvGT(data, l))
    p2 = (ops.h_vec(data) * l).sum(-1) + (ops.b_vec(data) * v).sum(-1)
    u = torch.maximum(_inf_norm(v), _inf_norm(l))
    primal_infeasible = (p1 <= tol * u) & (p2 < 0)

    return FeasibilityResult(primal_feasible=~primal_infeasible,
                             dual_feasible=~dual_infeasible)

"""Exit flags and structured solver output (counterpart of
`fbstab_tpu/solver_out.py`; reference fbstab_algorithm.h:17-37)."""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch


class ExitFlag(enum.IntEnum):
    """Return codes; LINEAR_SOLVER_FAILED is the per-instance status that
    replaces the reference's exception on factorization failure."""

    SUCCESS = 0
    DIVERGENCE = 1
    MAXITERATIONS = 2
    PRIMAL_INFEASIBLE = 3
    DUAL_INFEASIBLE = 4
    PRIMAL_DUAL_INFEASIBLE = 5
    LINEAR_SOLVER_FAILED = 6


class SolverOut(NamedTuple):
    """Per-instance results (batched tensors, one entry per lane).

    `residual` is the double-float-verified penalized natural residual
    when refinement ran and `raw_residual` the pre-refinement value;
    otherwise the two are equal. `solve_time` is wall-clock seconds
    (-1.0 when not timed)."""

    eflag: torch.Tensor
    residual: torch.Tensor
    newton_iters: torch.Tensor
    prox_iters: torch.Tensor
    solve_time: torch.Tensor
    initial_residual: torch.Tensor
    raw_residual: torch.Tensor
    refine_steps: torch.Tensor | int = 0

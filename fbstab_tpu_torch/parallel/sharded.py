"""Batch statistics of a batched solve (counterpart of the `BatchStats`
part of `fbstab_tpu/parallel/sharded.py`).

Only `BatchStats` and `batch_stats` are here, for the batch facades and
`print_batch_final`. Sharding a batch over several devices (the JAX
module's mesh, `shard_batch` and the sharded solvers, with
`torch.distributed` in their place) is not ported yet: ROADMAP §1
item 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fbstab_tpu_torch.solver_out import ExitFlag


class BatchStats(NamedTuple):
    """Batch-level convergence summary; every field is a 0-d tensor on
    the device of the solve."""

    num_instances: torch.Tensor
    num_success: torch.Tensor       # eflag == SUCCESS count
    num_infeasible: torch.Tensor    # primal/dual/both infeasibility count
    num_failed: torch.Tensor        # maxiters + linear solver failures
    max_residual: torch.Tensor
    mean_residual: torch.Tensor
    total_newton_iters: torch.Tensor
    max_newton_iters: torch.Tensor


def batch_stats(core_out) -> BatchStats:
    """Reduces a batched CoreOut / SolverOut into BatchStats (on the
    device: no host sync)."""
    eflag = core_out.eflag
    n = eflag.shape[0]
    i32 = dict(dtype=torch.int32, device=eflag.device)
    success = eflag == int(ExitFlag.SUCCESS)
    infeas = ((eflag >= int(ExitFlag.PRIMAL_INFEASIBLE))
              & (eflag <= int(ExitFlag.PRIMAL_DUAL_INFEASIBLE)))
    count = lambda m: m.sum().to(torch.int32)
    return BatchStats(
        num_instances=torch.tensor(n, **i32),
        num_success=count(success),
        num_infeasible=count(infeas),
        num_failed=torch.tensor(n, **i32) - count(success | infeas),
        max_residual=core_out.residual.amax(),
        mean_residual=core_out.residual.mean(),
        total_newton_iters=core_out.newton_iters.sum(),
        max_newton_iters=core_out.newton_iters.amax(),
    )

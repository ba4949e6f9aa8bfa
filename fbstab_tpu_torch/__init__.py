"""fbstab_tpu_torch: the PyTorch / CUDA port of fbstab_tpu.

The batched float32 MPC contract solve (`solve_mpc_qp_batch` under
`Options.single_precision()`) runs on an NVIDIA H100 through two
hand-written CUDA kernels, the fused solver (ops/mpc_solve_cuda.py) and
the Riccati Newton step (ops/riccati_cuda.py), and everywhere else through
their plain PyTorch versions. The JAX package `fbstab_tpu` is the
reference this package is tested against; nothing here imports JAX.
"""

from fbstab_tpu_torch.core.algorithm import CoreOut, fbstab_solve_batch
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.models.mpc_qp import (
    FBstabMpc,
    MpcQPData,
    batch_data,
    mpc_dims,
    mpc_qp_data,
    solve_mpc_qp_batch,
)
from fbstab_tpu_torch.models.refine import VariableDF
from fbstab_tpu_torch.options import Display, Options
from fbstab_tpu_torch.solver_out import ExitFlag, SolverOut

__all__ = [
    "CoreOut", "Display", "ExitFlag", "FBstabMpc", "MpcQPData", "Options",
    "SolverOut", "Variable", "VariableDF", "batch_data",
    "fbstab_solve_batch", "mpc_dims", "mpc_qp_data", "solve_mpc_qp_batch",
]

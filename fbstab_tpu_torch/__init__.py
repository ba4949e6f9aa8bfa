"""fbstab_tpu_torch: the PyTorch / CUDA port of fbstab_tpu.

The batched float32 contract solves of the MPC and dense QP classes
(`solve_mpc_qp_batch` / `solve_dense_qp_batch` under
`Options.single_precision()`, one-shot or through the adaptive two-phase
wrappers of parallel/adaptive.py) run on an NVIDIA H100 through
hand-written CUDA kernels: the fused MPC solver (ops/mpc_solve_cuda.py),
the per-subproblem MPC kernel of large stage dimensions
(ops/mpc_subproblem_cuda.py), the Riccati Newton step (ops/riccati_cuda.py),
the combine of the associative Riccati scan (ops/assoc_combine_cuda.py,
`riccati="assoc"` and the single-instance `solve_mpc_qp`) and the fused
dense solver (ops/dense_solve_cuda.py); on the CPU, through their plain
PyTorch versions. The sparse QP class (models/sparse_qp.py) runs its CSR
products where its data lies and factors each Newton step's KKT system on
the host with a C sparse LDL' (native/sparse_ldl.c), as the JAX package
does. Data goes on the card unless the caller passes device="cpu".
The receding-horizon loop (models/receding_horizon.py) runs closed-loop
sweeps on these solves, the batch facades (models/batch_facade.py) bundle
them with the warmstart carry and the batch statistics, the
differentiable layer (diff.py) differentiates them implicitly with one
batched Newton step (the Riccati kernel for the MPC class on the card),
`parallel/sharded.py` and `parallel/ragged.py` shard a batch over the
ranks of a torch.distributed world (NCCL on the card, gloo on the CPU),
and `python -m fbstab_tpu_torch.bench` measures them with the JAX
package's bench modes. The exports are the JAX package's.
The JAX package `fbstab_tpu` is the reference this package is tested
against; nothing here imports JAX.
"""

from fbstab_tpu_torch.core.algorithm import (
    CoreOut,
    fbstab_solve,
    fbstab_solve_batch,
)
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.diff import (
    make_differentiable_batch_solver,
    make_differentiable_solver,
    make_jvp_solver,
    mpc_feedback_gain,
    solve_dense_qp_diff,
    solve_mpc_qp_batch_diff,
    solve_mpc_qp_diff,
    solve_sparse_qp_diff,
)
from fbstab_tpu_torch.models.batch_facade import (
    FBstabDenseBatch,
    FBstabMpcBatch,
)
from fbstab_tpu_torch.models.dense_qp import (
    DENSE_OPS,
    DenseQPData,
    FBstabDense,
    dense_qp_data,
    solve_dense_qp,
    solve_dense_qp_batch,
)
from fbstab_tpu_torch.models.mpc_qp import (
    MPC_OPS,
    FBstabMpc,
    MpcQPData,
    batch_data,
    mpc_dims,
    mpc_qp_data,
    solve_mpc_qp,
    solve_mpc_qp_batch,
)
from fbstab_tpu_torch.models.refine import (
    VariableDF,
    refine_dense_batch,
    refine_mpc_batch,
)
from fbstab_tpu_torch.models.scaling import (
    DenseScaling,
    MpcScaling,
    apply_dense_scaling,
    apply_mpc_scaling,
    equilibrate_dense,
    equilibrate_mpc,
    ruiz_dense_scaling,
    ruiz_mpc_scaling,
)
from fbstab_tpu_torch.models.sparse_qp import (
    FBstabSparse,
    SparsePattern,
    SparseQPData,
    mpc_sparse_pattern,
    mpc_sparse_values,
    pattern_values,
    solve_sparse_qp,
    solve_sparse_qp_batch,
    sparse_qp_data,
)
from fbstab_tpu_torch.options import Display, Options
from fbstab_tpu_torch.parallel.adaptive import (
    solve_dense_qp_batch_adaptive,
    solve_dense_qp_batch_adaptive_device,
    solve_dense_qp_batch_adaptive_schedule,
    solve_mpc_qp_batch_adaptive,
    solve_mpc_qp_batch_adaptive_device,
    solve_mpc_qp_batch_adaptive_schedule,
)
from fbstab_tpu_torch.solver_out import ExitFlag, SolverOut

__all__ = [
    "CoreOut", "DENSE_OPS", "DenseQPData", "DenseScaling", "Display",
    "ExitFlag", "FBstabDense", "FBstabDenseBatch", "FBstabMpc",
    "FBstabMpcBatch", "FBstabSparse", "MPC_OPS", "MpcQPData", "MpcScaling",
    "Options", "SolverOut", "SparsePattern", "SparseQPData", "Variable",
    "VariableDF", "apply_dense_scaling",
    "apply_mpc_scaling", "batch_data", "dense_qp_data", "equilibrate_dense",
    "equilibrate_mpc", "fbstab_solve", "fbstab_solve_batch",
    "make_differentiable_batch_solver", "make_differentiable_solver",
    "make_jvp_solver", "mpc_dims", "mpc_feedback_gain", "mpc_qp_data",
    "mpc_sparse_pattern", "mpc_sparse_values", "pattern_values",
    "refine_dense_batch", "refine_mpc_batch", "ruiz_dense_scaling",
    "ruiz_mpc_scaling", "solve_dense_qp", "solve_dense_qp_batch",
    "solve_dense_qp_batch_adaptive", "solve_dense_qp_batch_adaptive_device",
    "solve_dense_qp_batch_adaptive_schedule", "solve_dense_qp_diff",
    "solve_mpc_qp", "solve_mpc_qp_batch", "solve_mpc_qp_batch_adaptive",
    "solve_mpc_qp_batch_adaptive_device",
    "solve_mpc_qp_batch_adaptive_schedule", "solve_mpc_qp_batch_diff",
    "solve_mpc_qp_diff", "solve_sparse_qp", "solve_sparse_qp_batch",
    "solve_sparse_qp_diff", "sparse_qp_data",
]

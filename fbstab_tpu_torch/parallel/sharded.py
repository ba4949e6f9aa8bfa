"""Sharded batch solving over `torch.distributed` (counterpart of
`fbstab_tpu/parallel/sharded.py`).

The instances of a batch are independent, so the batch axis is the only
one worth sharding: it is split over a 1-D mesh of ranks, one rank per
device, and each rank solves its own contiguous block of rows through the
port's batched solvers. The only collectives are the post-solve
`BatchStats` reductions (two all-reduces of a few numbers), as in the JAX
design, where XLA partitions the solve over a `jax.sharding.Mesh`.

The code is SPMD: every rank runs it. A mesh over the card is NCCL
(`make_mesh()`: a world of one when no launcher started a group, so one
card needs none); a CPU mesh is gloo (`make_mesh(device="cpu")`, the
tests' worlds). The solvers take this rank's shard (`shard_batch`) and
return this rank's rows of the solution and the statistics of the whole
global batch, the same on every rank.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import ExitFlag

BATCH_AXIS = "batch"


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


# ------------------------------------------------------------------
# Trees of batch-leading tensors (MpcQPData, DenseQPData, Variable,
# CoreOut, tuples, lists, dicts); other leaves pass through unchanged.
# ------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# ------------------------------------------------------------------
# The mesh.
# ------------------------------------------------------------------

def _start_world(dev: torch.device) -> None:
    """Starts the default process group: from the launcher's environment
    under torchrun (WORLD_SIZE, MASTER_ADDR), else a world of one on an
    in-memory store. NCCL on the card (each rank on cuda:LOCAL_RANK, set
    before the group starts), gloo on the CPU."""
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _check_backend(dev: torch.device) -> None:
    """A card mesh needs NCCL in the default group, a CPU mesh gloo:
    a mesh never runs its collectives on another backend."""
    import torch.distributed as dist
    backend = str(dist.get_backend())
    want = "nccl" if dev.type == "cuda" else "gloo"
    if want not in backend:
        raise RuntimeError(
            f"a {dev.type} mesh reduces over {want}, but the default "
            f"process group's backend is {backend!r}")


def make_mesh(devices=None, axis_name: str = BATCH_AXIS, *, device=None):
    """A 1-D `DeviceMesh` over the ranks of the world, with the one axis
    `axis_name` (the JAX package's `Mesh(devices, (axis_name,))`): there
    is no tensor to shard inside one small QP, so the batch is the mesh's
    only axis.

    device: the device type of every rank, the card unless "cpu" (and it
    raises without CUDA, as every entry point of the port does).
    devices: the ranks in mesh order; None is every rank of the world in
    rank order. A mesh holds every rank of the world once.

    When no default process group exists this starts one (see
    _start_world): a world of one unless torchrun's environment names a
    larger one. A card mesh runs on NCCL and raises where NCCL does not
    start; it never takes gloo instead."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from fbstab_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: no mesh of {dev.type} devices")
    if not dist.is_available():
        raise RuntimeError("make_mesh: this torch has no torch.distributed")
    if not dist.is_initialized():
        _start_world(dev)
    _check_backend(dev)
    world = dist.get_world_size()
    ranks = (list(range(world)) if devices is None
             else [int(r) for r in devices])
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"make_mesh: the ranks {ranks} are not every rank "
                         f"of the world of {world} once")
    return DeviceMesh(dev.type, torch.tensor(ranks),
                      mesh_dim_names=(axis_name,))


def _mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, tree, axis_name: str = BATCH_AXIS):
    """This rank's shard of a tree of batch-leading tensors that every
    rank holds whole (MpcQPData, DenseQPData, tuples of guesses, ...):
    for each leaf of B rows, rank r of a mesh of W ranks gets the
    contiguous rows [r B/W, (r + 1) B/W) on its device, the block
    `PartitionSpec(axis_name)` gives device r in JAX.

    Each leaf's batch must divide by W, as the JAX package's `device_put`
    requires; pad a ragged batch with
    `parallel.ragged.pad_batch_for_mesh` first."""
    W = mesh.size()
    r = mesh.get_local_rank(axis_name)
    dev = _mesh_device(mesh)

    def take(a):
        if a.dim() == 0:
            raise ValueError("shard_batch: a 0-d leaf has no batch axis")
        B = a.shape[0]
        if B % W:
            raise ValueError(
                f"shard_batch: a batch of {B} does not divide over the "
                f"mesh's {W} ranks; pad it with "
                f"parallel.ragged.pad_batch_for_mesh")
        n = B // W
        return a[r * n:(r + 1) * n].to(dev)

    return tree_map(take, tree)


# ------------------------------------------------------------------
# The statistics over the mesh.
# ------------------------------------------------------------------

def _local_parts(core_out, valid=None):
    """This rank's parts of the statistics over its lanes where `valid`
    (all lanes when None): an int64 vector (count, successes,
    infeasibility verdicts, summed and largest Newton count) and a
    float64 one (largest residual, summed residual). A rank without a
    valid lane gives 0 counts, a 0 sum and -inf as its largest
    residual."""
    eflag = core_out.eflag
    if valid is None:
        valid = torch.ones_like(eflag, dtype=torch.bool)
    valid = valid.to(torch.bool)
    success = (eflag == int(ExitFlag.SUCCESS)) & valid
    infeas = ((eflag >= int(ExitFlag.PRIMAL_INFEASIBLE))
              & (eflag <= int(ExitFlag.PRIMAL_DUAL_INFEASIBLE)) & valid)
    ni = torch.where(valid, core_out.newton_iters, 0).to(torch.int64)
    res = core_out.residual.double()
    zero_i = torch.zeros((), dtype=torch.int64, device=eflag.device)
    ints = torch.stack([valid.sum(), success.sum(), infeas.sum(), ni.sum(),
                        ni.amax() if ni.numel() else zero_i])
    floats = torch.stack([
        torch.where(valid, res, -torch.inf).amax() if res.numel()
        else torch.tensor(-torch.inf, dtype=torch.float64,
                          device=eflag.device),
        torch.where(valid, res, 0.0).sum()])
    return ints, floats


def _mesh_stats(core_out, mesh=None, valid=None,
                     axis_name: str = BATCH_AXIS) -> BatchStats:
    """BatchStats of the global batch over `mesh` (of this rank's lanes
    alone when mesh is None), over the lanes where `valid` (all when
    None). Counts, the summed Newton count and the summed residual are
    sums over the ranks, the largest residual and Newton count maxima,
    and the mean is the global sum over the global count.

    Each rank's parts go in its own row of a (W, k) int64 and a (W, k)
    float64 tensor, zeros elsewhere: two all-reduces (SUM) gather them
    exactly, and every rank reduces the same rows in the same order, so
    the statistics are identical on every rank. Dtypes as batch_stats':
    int32 counts, the Newton counts' sums int64 and maxima their own
    dtype, the residuals in the residual's dtype."""
    ints, floats = _local_parts(core_out, valid)
    if mesh is None:
        gi, gf = ints[None], floats[None]
    else:
        import torch.distributed as dist
        W, r = mesh.size(), mesh.get_local_rank(axis_name)
        gi = ints.new_zeros(W, ints.numel())
        gf = floats.new_zeros(W, floats.numel())
        gi[r] = ints
        gf[r] = floats
        group = mesh.get_group(axis_name)
        dist.all_reduce(gi, group=group)
        dist.all_reduce(gf, group=group)
    n, succ, inf, tot = gi[:, :4].sum(0)
    rdt = core_out.residual.dtype
    i32 = lambda t: t.to(torch.int32)
    return BatchStats(
        num_instances=i32(n), num_success=i32(succ),
        num_infeasible=i32(inf), num_failed=i32(n - succ - inf),
        max_residual=gf[:, 0].amax().to(rdt),
        mean_residual=(gf[:, 1].sum() / n.clamp(min=1)).to(rdt),
        total_newton_iters=tot,
        max_newton_iters=gi[:, 4].amax().to(core_out.newton_iters.dtype))


def _check_on_mesh(mesh, t: torch.Tensor) -> None:
    if t.device.type != mesh.device_type:
        raise ValueError(
            f"the shard lies on {t.device}, the mesh's ranks on "
            f"{mesh.device_type} devices: place it with shard_batch")


def _finish(local_solve, mesh, axis_name: str, with_stats: bool):
    """solve(data, z0, l0, v0) on this rank's shard: `local_solve`, then
    the global statistics when with_stats."""
    def solve(data, z0, l0, v0):
        _check_on_mesh(mesh, z0)
        x, core = local_solve(data, z0, l0, v0)
        if with_stats:
            return x, core, _mesh_stats(core, mesh, axis_name=axis_name)
        return x, core
    return solve


# ------------------------------------------------------------------
# The sharded solvers.
# ------------------------------------------------------------------

def _make_sharded_solver(ops, mesh, options: Options, axis_name: str,
                         with_stats: bool):
    """The JAX package's sharded body on each rank's shard: Ruiz scaling
    when engaged, the lockstep core of the class (`fbstab_solve_batch`,
    the JAX package's `vmap(fbstab_solve)`) on the scaled problem, then
    the double-float refinement when engaged. There is no
    LINEAR_SOLVER_FAILED retry and no option gate, as in the JAX body;
    the fused kernels are sharded_mpc_solver_fused's. On the card in
    float32 the MPC Newton step of the core is the Riccati kernel K1, as
    is every refinement correction."""
    from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, exact_f32_matmul
    from fbstab_tpu_torch.models.refine import (
        refine_engaged, refine_solution_dense, refine_solution_mpc)
    from fbstab_tpu_torch.models.scaling import (
        ruiz_dense_scaling, ruiz_mpc_scaling, scaling_engaged,
        solve_scaled_dense, solve_scaled_mpc)

    is_mpc = ops is MPC_OPS
    scaled = solve_scaled_mpc if is_mpc else solve_scaled_dense
    ruiz = ruiz_mpc_scaling if is_mpc else ruiz_dense_scaling
    refine = refine_solution_mpc if is_mpc else refine_solution_dense

    def raw(d, z, l, v):
        exact_f32_matmul(z)
        return fbstab_solve_batch(ops, d, z, l, v, options)

    def local_solve(data, z0, l0, v0):
        opts = options.validated()
        # Ruiz scaling computed once per shard and shared by the solve
        # and the refinement; the float32 residual rewrite is skipped
        # when refinement re-reports in verified original units.
        scal = ruiz(data) if scaling_engaged(opts, z0.dtype) else None
        will_refine = refine_engaged(opts, z0.dtype)
        x, core = scaled(raw, data, z0, l0, v0, opts, scal=scal,
                         skip_residual_rewrite=will_refine)
        if will_refine:
            x, core = refine(data, x, core, opts, scal=scal)
        return x, core

    return _finish(local_solve, mesh, axis_name, with_stats)


def sharded_dense_solver(mesh, options: Options = Options(),
                         axis_name: str = BATCH_AXIS,
                         with_stats: bool = True):
    """A dense batch solver over the mesh: returns solve(data, z0, l0, v0)
    -> (Variable, CoreOut[, BatchStats]) taking this rank's shard (see
    shard_batch) and returning this rank's rows and the global
    statistics. The lanes of a shard run masked lockstep; the ranks meet
    only in the statistics' reduction."""
    from fbstab_tpu_torch.models.dense_qp import DENSE_OPS
    return _make_sharded_solver(DENSE_OPS, mesh, options, axis_name,
                                with_stats)


def sharded_mpc_solver(mesh, options: Options = Options(),
                       axis_name: str = BATCH_AXIS,
                       with_stats: bool = True):
    """An MPC batch solver over the mesh (see sharded_dense_solver)."""
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS
    return _make_sharded_solver(MPC_OPS, mesh, options, axis_name,
                                with_stats)


def sharded_mpc_solver_adaptive(mesh, options: Options = Options(),
                                axis_name: str = BATCH_AXIS,
                                with_stats: bool = True,
                                phase1_newton_iters: int = 16,
                                phase2_size: int | None = None):
    """An MPC batch solver running the two-phase adaptive scheme
    (`solve_mpc_qp_batch_adaptive_device`) on each rank's shard: the
    phase-1 budget, the fixed-size compaction of the shard's own
    stragglers (phase2_size per shard; None is the shard's B // 8), the
    fallback and the deferred refinement. A lane's counts thus depend on
    its shard-mates, as in the JAX package; only the statistics cross
    ranks."""
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)

    def local_solve(data, z0, l0, v0):
        return solve_mpc_qp_batch_adaptive_device(
            data, z0, l0, v0, options,
            phase1_newton_iters=phase1_newton_iters,
            phase2_size=phase2_size)

    return _finish(local_solve, mesh, axis_name, with_stats)


def sharded_mpc_solver_fused(mesh, options: Options = Options(),
                             axis_name: str = BATCH_AXIS,
                             with_stats: bool = True,
                             interpret: bool = False,
                             tile_b: int | None = None):
    """An MPC batch solver running the fused solver on each rank's shard.

    With tile_b None and interpret False, the production dispatch
    `solve_mpc_qp_batch` per shard: Ruiz scaling, the fused kernel K2 on
    the card (or the tier the shard's dims take), the LINEAR_SOLVER_FAILED
    retry and the refinement. Otherwise the explicit-knob path: the raw
    fused solve, K2 (`fbstab_mpc_solve_fused`; on CPU tensors its plain
    version), or its plain version on any device when the caller passes
    interpret=True, the counterpart of the JAX kernel's interpret mode.

    tile_b has no meaning inside K2, whose blocks are four teams of 8
    threads, one team per instance, over any number of instances: it is
    kept for the JAX signature (where it is the kernel's lane tile) and
    for the ragged path's alignment (pad_batch_for_mesh)."""
    if tile_b is not None and tile_b < 1:
        raise ValueError(f"tile_b must be positive, got {tile_b}")

    def local_solve(data, z0, l0, v0):
        if tile_b is None and not interpret:
            from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
            return solve_mpc_qp_batch(data, z0, l0, v0, options)
        from fbstab_tpu_torch.ops.mpc_solve_cuda import (
            fbstab_mpc_solve_fused, fbstab_mpc_solve_plain)
        solve = fbstab_mpc_solve_plain if interpret else fbstab_mpc_solve_fused
        return solve(data, z0, l0, v0, options)

    return _finish(local_solve, mesh, axis_name, with_stats)


__all__ = [
    "BATCH_AXIS", "BatchStats", "batch_stats", "make_mesh", "shard_batch",
    "sharded_dense_solver",
    "sharded_mpc_solver", "sharded_mpc_solver_adaptive",
    "sharded_mpc_solver_fused",
]

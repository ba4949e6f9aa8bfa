"""Ragged global batches over a mesh of ranks (counterpart of
`fbstab_tpu/parallel/ragged.py`).

`shard_batch` needs a batch that divides over the mesh. This module pads
one that does not and keeps the padding out of the results:

 - `pad_batch_for_mesh` pads every batch-leading leaf to the next
   multiple of W * tile_b (W ranks) by repeating the LAST instance
   (well-posed data, where zeros could be singular) and returns the
   validity mask;
 - `masked_batch_stats` reduces a CoreOut / SolverOut over the valid
   lanes only, over the mesh when given one;
 - `solve_mpc_ragged` / `solve_dense_ragged` run the sharded solvers end
   to end: pad, shard, solve, trim, masked statistics.

The code is SPMD, as parallel/sharded.py: every rank holds the whole
global batch, solves its shard and keeps its own rows whose global index
is below B, so a rank whose shard is all padding ends with no rows.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.parallel.sharded import (
    BATCH_AXIS,
    BatchStats,
    _mesh_stats,
    make_mesh,
    shard_batch,
    sharded_dense_solver,
    sharded_mpc_solver,
    sharded_mpc_solver_fused,
    tree_leaves,
    tree_map,
)


def batch_size(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def pad_batch_for_mesh(mesh, tree, tile_b: int = 1):
    """Pads batch-leading leaves so that B divides W * tile_b.

    Returns (padded_tree, valid), valid a (Bp,) bool mask on the first
    leaf's device, True on the caller's instances and False on padding.
    Padding repeats the last instance, so padded lanes converge like real
    work and slow no lockstep shard. A batch that already divides comes
    back as the same objects."""
    B = batch_size(tree)
    m = int(mesh.size()) * int(tile_b)
    Bp = -(-B // m) * m
    valid = torch.arange(Bp, device=tree_leaves(tree)[0].device) < B
    if Bp == B:
        return tree, valid

    def pad(a):
        rep = a[-1:].expand((Bp - B,) + tuple(a.shape[1:]))
        return torch.cat([a, rep], dim=0)

    return tree_map(pad, tree), valid


def masked_batch_stats(core_out, valid, mesh=None,
                       axis_name: str = BATCH_AXIS) -> BatchStats:
    """BatchStats over the valid lanes only: of this rank's lanes, or of
    the global batch when `mesh` is given (core_out and valid are then
    this rank's shards). A rank whose shard is all padding adds nothing:
    0 to the counts and sums, -inf to the largest residual."""
    return _mesh_stats(core_out, mesh, valid, axis_name)


def _solve_ragged(make_solver, mesh, data, z0, l0, v0, options: Options,
                  tile_b: int, **solver_kwargs):
    if mesh is None:
        mesh = make_mesh()
    B = batch_size(z0)
    (data_p, z_p, l_p, v_p), valid = pad_batch_for_mesh(
        mesh, (data, z0, l0, v0), tile_b=tile_b)
    solver = make_solver(mesh, options, with_stats=False, **solver_kwargs)
    args = shard_batch(mesh, (data_p, z_p, l_p, v_p))
    mine = shard_batch(mesh, valid)
    x, core = solver(*args)
    stats = masked_batch_stats(core, mine, mesh)
    # Rank r holds the global rows [r n, (r + 1) n): those below B are
    # its first `keep`.
    n = z_p.shape[0] // mesh.size()
    keep = min(max(B - mesh.get_local_rank() * n, 0), n)
    trim = lambda t: tree_map(lambda a: a[:keep], t)
    return trim(x), trim(core), stats


def solve_mpc_ragged(data, z0, l0, v0, options: Options = Options(),
                     mesh=None, tile_b: int = 1, fused: bool = True,
                     **solver_kwargs):
    """Sharded MPC solve of a global batch of any size: pads it to the
    mesh, runs sharded_mpc_solver_fused (fused) or sharded_mpc_solver on
    each rank's shard, drops the padding and returns this rank's rows
    with the statistics of the caller's B instances. tile_b > 1 also
    aligns each shard to a multiple of tile_b. mesh=None is make_mesh(),
    the card."""
    make = sharded_mpc_solver_fused if fused else sharded_mpc_solver
    return _solve_ragged(make, mesh, data, z0, l0, v0, options, tile_b,
                         **solver_kwargs)


def solve_dense_ragged(data, z0, l0, v0, options: Options = Options(),
                       mesh=None, tile_b: int = 1, **solver_kwargs):
    """Sharded dense solve of a global batch of any size (see
    solve_mpc_ragged)."""
    return _solve_ragged(sharded_dense_solver, mesh, data, z0, l0, v0,
                         options, tile_b, **solver_kwargs)


__all__ = [
    "batch_size", "masked_batch_stats", "pad_batch_for_mesh",
    "solve_dense_ragged", "solve_mpc_ragged",
]

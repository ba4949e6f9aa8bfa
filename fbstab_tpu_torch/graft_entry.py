"""Entry points of the port (counterpart of the JAX package's
`__graft_entry__.py`).

entry(device=None)       -> (fn, example_args): the headline family's
                            batched MPC step, solve_mpc_qp_batch in
                            float32 on a small batch (B = 8, N = 5).
dryrun_multichip(n, ...) -> the sharded batch solve over a mesh of n
                            ranks, in the JAX dry run's four passes.

    python -m fbstab_tpu_torch.graft_entry               # one card, NCCL
    torchrun --nproc_per_node=4 -m fbstab_tpu_torch.graft_entry --device cpu

runs `entry`, then `dryrun_multichip` over the whole world: alone, a
world of one on the card; under torchrun, the launcher's world (gloo on
the CPU with --device cpu, NCCL on the cards otherwise).
"""

from __future__ import annotations

import argparse

import torch


def _mpc_batch(B: int, N: int, dtype, device):
    """A batch of B double-integrator instances with varied feasible x0,
    and zero guesses."""
    from fbstab_tpu_torch.models.mpc_qp import batch_data, mpc_dims
    from fbstab_tpu_torch.models.ocp_fixtures import double_integrator

    one, _ = double_integrator(N, dtype=dtype, device=device)
    nN, nx, nu, nc = mpc_dims(one)
    batch = batch_data(one, B)
    i = torch.arange(B, dtype=torch.float64)
    x0s = torch.stack([0.05 * (i % 30), 0.01 * (i % 17)], 1)
    batch = batch._replace(x0=x0s.to(dtype=dtype, device=one.x0.device))
    zeros = lambda n: torch.zeros(B, n, dtype=dtype, device=one.x0.device)
    return (batch, zeros((nN + 1) * (nx + nu)), zeros((nN + 1) * nx),
            zeros((nN + 1) * nc))


def entry(device=None):
    """The single-device step: solve_mpc_qp_batch under
    Options.single_precision() on a float32 batch (B = 8, N = 5) on the
    card (the fused kernel K2, then the refinement on K1) unless
    device="cpu". Returns (step, (data, z0, l0, v0))."""
    from fbstab_tpu_torch.device import resolve_device
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.options import Options

    dev = resolve_device(device)
    opts = Options.single_precision()
    args = _mpc_batch(B=8, N=5, dtype=torch.float32, device=dev)

    def step(data, z0, l0, v0):
        return solve_mpc_qp_batch(data, z0, l0, v0, opts)

    return step, args


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _all_converged(tag: str, stats, B: int) -> None:
    n, ok = int(stats.num_instances), int(stats.num_success)
    _require(n == B, f"{tag}: the statistics count {n} instances, not {B}")
    _require(ok == B, f"{tag}: only {ok}/{B} instances converged")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Runs the sharded batch solve on a mesh of `n_devices` ranks, which
    must be the whole world (make_mesh starts a world of one when no
    group exists). Every rank runs it. The multi-device strategy is data
    parallelism over independent QP instances: the batch is the only
    axis worth sharding, and the statistics' reductions are the only
    collectives.

    Four passes, each asserting that every instance converged:
    (1) sharded_mpc_solver, B = 2W (the lockstep core; under the float32
    profile also the equilibration and the double-float refinement);
    (2) sharded_mpc_solver_fused on two tiles a shard: K2 on the card
    (tile_b = 128), the plain version elsewhere (interpret, tile_b = 2);
    (3) a ragged global batch, B = 2W + 1, through solve_mpc_ragged's
    pad / trim / masked statistics on the lockstep path; (4) the headline
    configuration, sharded_mpc_solver_adaptive (phase 1 of 16 Newton
    steps, phase-2 size 2 a shard), B = 4W."""
    import torch.distributed as dist

    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.parallel.ragged import solve_mpc_ragged
    from fbstab_tpu_torch.parallel.sharded import (
        make_mesh, shard_batch, sharded_mpc_solver,
        sharded_mpc_solver_adaptive, sharded_mpc_solver_fused)

    mesh = make_mesh(device=device)
    W = mesh.size()
    _require(W == n_devices, f"need {n_devices} ranks, the world has {W}")
    dev = mesh.device_type
    dtype = torch.float32
    opts = Options.single_precision()
    batch = lambda B: _mpc_batch(B=B, N=3, dtype=dtype, device=dev)

    # Pass 1: the sharded lockstep path.
    B = 2 * W
    _, _, stats = sharded_mpc_solver(mesh, opts)(
        *shard_batch(mesh, batch(B)))
    _all_converged("sharded_mpc_solver", stats, B)

    # Pass 2: the fused solver, two tiles a shard.
    on_card = dev == "cuda"
    tile_b = 128 if on_card else 2
    Bf = 2 * tile_b * W
    solver = sharded_mpc_solver_fused(mesh, opts, interpret=not on_card,
                                      tile_b=tile_b)
    _, _, stats = solver(*shard_batch(mesh, batch(Bf)))
    _all_converged("sharded_mpc_solver_fused", stats, Bf)

    # Pass 3: a ragged global batch, B not a multiple of W.
    Br = 2 * W + 1
    _, core, stats = solve_mpc_ragged(*batch(Br), opts, mesh=mesh,
                                      fused=False)
    rows = torch.tensor(core.eflag.shape[0], device=core.eflag.device)
    dist.all_reduce(rows, group=mesh.get_group())
    _require(int(rows) == Br, f"solve_mpc_ragged: {int(rows)} rows, not {Br}")
    _all_converged("solve_mpc_ragged", stats, Br)

    # Pass 4: the headline configuration, two-phase adaptive per shard.
    Ba = 4 * W
    solver = sharded_mpc_solver_adaptive(mesh, opts, phase1_newton_iters=16,
                                         phase2_size=2)
    _, _, stats = solver(*shard_batch(mesh, batch(Ba)))
    _all_converged("sharded_mpc_solver_adaptive", stats, Ba)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fbstab_tpu_torch.graft_entry")
    p.add_argument("--device", default=None,
                   help='"cpu" for a CPU world (gloo); the card by default')
    a = p.parse_args(argv)
    fn, args = entry(a.device)
    _, core = fn(*args)
    _require(bool((core.eflag == 0).all()), "entry: an instance failed")
    print("entry: OK", flush=True)
    import torch.distributed as dist

    from fbstab_tpu_torch.parallel.sharded import make_mesh
    n = make_mesh(device=a.device).size()
    dryrun_multichip(n, device=a.device)
    print(f"dryrun_multichip({n}): OK (rank {dist.get_rank()})", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

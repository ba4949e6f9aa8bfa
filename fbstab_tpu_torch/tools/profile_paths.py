"""Device busy and idle share of the port's main paths on one GPU.

    python3 -m fbstab_tpu_torch.tools.profile_paths

For each path, all under Options.single_precision() — the one-shot MPC
solve and the adaptive MPC headline (phase1 = 16, P2 = B // 8) at
B = 8192 on the headline batch, the dense solve at B = 4096, n = 32,
q = 64, the copolymerization reactor (N = 80) at B = 2048 through tier 2,
the batched riccati="assoc" solve of it at B = 256, the
single-instance scan and assoc solves of the double integrator at N = 480,
the
receding-horizon sweep of the headline plant at B = 8192 for 8 steps
(`bench.py warmstart`), and, in float64 under Options(abs_tol = 1e-8),
the sparse batch of `bench.py sparse` (B = 32, its LDL' on the host), and
the batch sharded over a world of one on NCCL (parallel/sharded.py): the
fused solver at B = 8192, the lockstep solver (a K1 launch a Newton
step) at B = 1024 and the dense lockstep solver at B = 4096 — one
warm call, one timed call (host clock around the
synchronized call), then one call under torch.profiler. Prints one JSON
line per path: the plain wall time, the profiled wall time, the device
time summed over the kernels that ran (one stream, so they do not
overlap), the idle share 1 - device / profiled wall, the number of
kernels, the five with the most device time, and the device time and
launches of each of the port's MPC and dense kernels K1-K5 (`by_kernel`,
summed over the path's call). The profiler's own host overhead inflates
the profiled wall time of launch-heavy stages, so the idle share is an
upper bound.
"""

from __future__ import annotations

import json
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fbstab_tpu_torch import workloads as wl


# The port's kernels by the name of their __global__ function in csrc/.
KERNELS = dict(K1="riccati_step_kernel", K2="mpc_solve_kernel",
               K3="dense_solve_kernel", K4="mpc_subproblem_kernel",
               K5="assoc_combine_kernel")


def wall_ms(fn):
    return wl.timed(fn)[1]


def device_busy(fn):
    """One warm call, one timed call, then one call under torch.profiler.
    Returns (plain wall ms, profiled wall ms, the profiler's device
    events)."""
    fn()
    plain = wall_ms(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = wall_ms(fn)
    return plain, prof_wall, [e for e in prof.events()
                              if e.device_type == DeviceType.CUDA]


def profile_path(name, fn):
    plain, prof_wall, kernels = device_busy(fn)
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {}
    for k, fn_name in KERNELS.items():
        mine = [e for e in kernels if fn_name in e.name]
        if mine:
            ours[k] = dict(ms=sum(e.time_range.end - e.time_range.start
                                  for e in mine) / 1e3, launches=len(mine))
    print(json.dumps(dict(
        path=name, wall_ms=plain, profiled_wall_ms=prof_wall,
        device_ms=busy if kernels else None,
        idle_share=1.0 - busy / prof_wall if kernels else None,
        kernels=len(kernels), by_kernel=ours,
        top=[(k[:60], round(v / 1e3, 3)) for k, v in top])), flush=True)


def main():
    from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch
    from fbstab_tpu_torch.models.mpc_qp import (
        MpcQPData, solve_mpc_qp, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.receding_horizon import simulate_batch
    from fbstab_tpu_torch.models.ocp_fixtures import double_integrator
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(wl.card())
    opts = Options.single_precision()
    mpc = wl.build_batch(8192, **wl.HEADLINE, device=dev)
    mg = wl.zeros_guess(mpc)
    dense = wl.build_dense(4096, wl.DENSE["n"], wl.DENSE["q"], 0, dev)
    dg = wl.dense_zeros(dense)
    profile_path("mpc_one_shot",
                 lambda: solve_mpc_qp_batch(mpc, *mg, opts))
    profile_path("mpc_adaptive", lambda: solve_mpc_qp_batch_adaptive_device(
        mpc, *mg, opts, phase1_newton_iters=16, phase2_size=1024))
    profile_path("dense", lambda: solve_dense_qp_batch(dense, *dg, opts))
    copoly = wl.build_copoly(2048, dev)
    cg = wl.zeros_guess(copoly)
    profile_path("mpc_copoly",
                 lambda: solve_mpc_qp_batch(copoly, *cg, opts))
    small = wl.build_copoly(256, dev)
    sg = wl.zeros_guess(small)
    profile_path("mpc_assoc_batch", lambda: solve_mpc_qp_batch(
        small, *sg, opts, riccati="assoc"))
    di, _ = double_integrator(480, dtype=torch.float32, device=dev)
    dig = tuple(g[0] for g in wl.zeros_guess(di))
    profile_path("longhorizon_scan", lambda: solve_mpc_qp(
        di, *dig, opts, riccati="scan"))
    profile_path("longhorizon_assoc", lambda: solve_mpc_qp(
        di, *dig, opts, riccati="assoc"))
    shared = MpcQPData(*(a[:1] for a in mpc))
    profile_path("mpc_warmstart", lambda: simulate_batch(
        shared, 8, mpc.x0, opts))
    from fbstab_tpu_torch.models.sparse_qp import solve_sparse_qp_batch
    pat, sp = wl.sparse_batch(32, dev, **wl.SPARSE)
    sg = tuple(torch.zeros(32, k, dtype=torch.float64, device=dev)
               for k in (pat.nz, pat.nl, pat.nv))
    profile_path("sparse", lambda: solve_sparse_qp_batch(
        pat, sp, *sg, Options(abs_tol=1e-8)))
    import torch.distributed as dist

    from fbstab_tpu_torch.parallel.sharded import (
        make_mesh, shard_batch, sharded_dense_solver, sharded_mpc_solver,
        sharded_mpc_solver_fused)
    mesh = make_mesh()
    fused = sharded_mpc_solver_fused(mesh, opts)
    margs = shard_batch(mesh, (mpc, *mg))
    profile_path("sharded_fused", lambda: fused(*margs))
    lock = wl.build_batch(1024, **wl.HEADLINE, device=dev)
    largs = shard_batch(mesh, (lock, *wl.zeros_guess(lock)))
    lockstep = sharded_mpc_solver(mesh, opts)
    profile_path("sharded_lockstep", lambda: lockstep(*largs))
    dargs = shard_batch(mesh, (dense, *dg))
    dense_lockstep = sharded_dense_solver(mesh, opts)
    profile_path("sharded_dense", lambda: dense_lockstep(*dargs))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

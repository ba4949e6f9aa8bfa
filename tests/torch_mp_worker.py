"""A world of ranks for the port's sharding tests (tests/test_torch_sharded.py,
tests/test_torch_ragged.py), the counterpart of tests/mp_worker.py. Not
collected by pytest (no test_ prefix); imports no JAX.

    python tests/torch_mp_worker.py <suite> <rank> <world> <port> <outdir>

Each rank joins a gloo world over TCP on localhost, runs every case of
SUITES[suite] through the port's sharded solvers on a CPU mesh of all the
ranks (float64), and writes its own rows of each case's results with
torch.save to <outdir>/<suite>_rank<rank>.pt; the parent reassembles them
in rank order. `run_world` is the parent's side: it starts the world, one
process per rank with one torch thread each, and kills the whole world
when it outlives its timeout. The cases' inputs are built here in numpy,
so the parent feeds the same arrays to the JAX package.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

from torch_parity import (  # noqa: E402
    dims, plant_arrays, torch_data, torch_dense_data)

from fbstab_tpu_torch.core.algorithm import CoreOut  # noqa: E402
from fbstab_tpu_torch.graft_entry import dryrun_multichip  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.parallel.ragged import (  # noqa: E402
    masked_batch_stats, pad_batch_for_mesh, solve_dense_ragged,
    solve_mpc_ragged)
from fbstab_tpu_torch.parallel.sharded import (  # noqa: E402
    make_mesh, shard_batch, sharded_dense_solver, sharded_mpc_solver,
    sharded_mpc_solver_adaptive, sharded_mpc_solver_fused)
from fbstab_tpu_torch.workloads import (  # noqa: E402
    dense_arrays, headline_arrays)

# ------------------------------------------------------------------
# Inputs (numpy float64), shared with the parent.
# ------------------------------------------------------------------

# tests/test_sharded.py's batch (N = 5): x0 inside the reachable set.
X0_SHARDED = [[0.05 * i, 0.01 * i] for i in range(16)]
# tests/test_sharded_fused.py's batch (N = 4).
X0_FUSED = [[0.04 * i, 0.01 * i] for i in range(16)]
# Unbudgeted Newton counts 5-7 (N = 4): after a phase-1 budget of 5 the
# four shards of four lanes hold 0, 4, 2 and 3 stragglers, so at a
# phase-2 size of 2 one shard has none, one fills its capacity and two
# overflow it.
X0_MIXED = [[0.12 * i, 0.02 * (i % 5)] for i in range(16)]


def x0_tiles(B):
    """tests/test_sharded_fused.py's ragged-tiles batch."""
    return [[0.04 * (i % 20), 0.01 * (i % 11)] for i in range(B)]


def x0_local(lo, hi):
    """tests/mp_worker.py's rows lo .. hi - 1."""
    return [[0.05 * (i % 30), 0.01 * (i % 17)] for i in range(lo, hi)]


def di(N, x0s):
    return plant_arrays("double_integrator", N, len(x0s), x0s=x0s)


def mpc_guess(arrays):
    B = arrays["x0"].shape[0]
    _, _, _, _, nz, nl, nv = dims(arrays)
    return np.zeros((B, nz)), np.zeros((B, nl)), np.zeros((B, nv))


def dense_guess(arrays):
    B, q, n = arrays["A"].shape
    return (np.zeros((B, n)), np.zeros((B, arrays["G"].shape[1])),
            np.zeros((B, q)))


def dense_mixed():
    """tests/test_sharded.py's B = 8 batch: min |z|^2 s.t. z0 <= 1 on even
    lanes, z0 <= -1 and z0 >= 2 (primal infeasible) on odd ones."""
    B = 8
    infeasible = np.arange(B) % 2 == 1
    b = np.where(infeasible[:, None], [-1.0, -2.0], [1.0, 1.0])
    return dict(H=np.broadcast_to(np.eye(2), (B, 2, 2)).copy(),
                f=np.zeros((B, 2)), G=np.zeros((B, 0, 2)), h=np.zeros((B, 0)),
                A=np.broadcast_to([[1.0, 0.0], [-1.0, 0.0]], (B, 2, 2)).copy(),
                b=b)


def dense_ragged():
    """tests/test_ragged.py's B = 1001 dense batch (bench.build_dense_batch
    at n = 4, q = 6) with lanes 100 and 999 made primal infeasible."""
    a = {k: np.array(v) for k, v in dense_arrays(1001, 4, 6, 0).items()}
    for i in (100, 999):
        a["A"][i, 0, :] = a["A"][i, 1, :] = 0.0
        a["A"][i, 0, 0], a["A"][i, 1, 0] = 1.0, -1.0
        a["b"][i, 0], a["b"][i, 1] = -1.0, -1.0    # z0 <= -1 and z0 >= 1
    return a


def mpc_ragged():
    """tests/test_ragged.py's B = 37 MPC batch (bench.build_batch at N = 5,
    nx = 3, nu = 2, nc = 4)."""
    return {k: np.array(v) for k, v in headline_arrays(37, 5, 3, 2,
                                                       4).items()}


# The hand-made CoreOut of tests/test_ragged.py::
# test_masked_stats_excludes_padding (the last two lanes padding).
MASKED = dict(eflag=[0, 0, 2, 0, 0, 0],
              residual=[1e-8, 2e-8, 0.5, 3e-8, 9.0, 9.0],
              newton_iters=[3, 4, 50, 5, 99, 99], valid=[1, 1, 1, 1, 0, 0])
# Over four ranks, two lanes a rank: rank 3's shard is all padding.
MASKED_MESH = dict(eflag=[0, 0, 2, 0, 3, 0, 0, 0],
                   residual=[1e-8, 2e-8, 0.5, 3e-8, 0.25, 9.0, 9.0, 9.0],
                   newton_iters=[3, 4, 50, 5, 7, 99, 99, 99],
                   valid=[1, 1, 1, 1, 1, 0, 0, 0])


def masked_core(m):
    eflag = torch.tensor(m["eflag"], dtype=torch.int32)
    res = torch.tensor(m["residual"], dtype=torch.float64)
    ni = torch.tensor(m["newton_iters"], dtype=torch.int32)
    core = CoreOut(eflag=eflag, residual=res, newton_iters=ni,
                   prox_iters=ni, initial_residual=res, raw_residual=res)
    return core, torch.tensor(m["valid"], dtype=torch.bool)


# ------------------------------------------------------------------
# The cases, run on every rank. Each returns what the parent reads: this
# rank's rows and the statistics it holds.
# ------------------------------------------------------------------

F64 = torch.float64


def pack(x, core, stats=None):
    out = dict(x={k: getattr(x, k) for k in ("z", "l", "v", "y")},
               core={k: v for k, v in core._asdict().items()
                     if isinstance(v, torch.Tensor)})
    if stats is not None:
        out["stats"] = {k: v.item() for k, v in stats._asdict().items()}
    return out


def _mpc_args(mesh, arrays):
    g = tuple(torch.tensor(a) for a in mpc_guess(arrays))
    return shard_batch(mesh, (torch_data(arrays, F64), *g))


def case_mpc(mesh):
    solver = sharded_mpc_solver(mesh, Options(abs_tol=1e-8))
    return pack(*solver(*_mpc_args(mesh, di(5, X0_SHARDED))))


def case_dense(mesh):
    a = dense_mixed()
    g = tuple(torch.tensor(t) for t in dense_guess(a))
    args = shard_batch(mesh, (torch_dense_data(a, F64), *g))
    return pack(*sharded_dense_solver(mesh, Options(abs_tol=1e-8))(*args))


def case_fused(mesh):
    solver = sharded_mpc_solver_fused(mesh, Options(abs_tol=1e-8),
                                      interpret=True, tile_b=2)
    return pack(*solver(*_mpc_args(mesh, di(4, X0_FUSED))))


def case_fused_tiles(mesh):
    solver = sharded_mpc_solver_fused(mesh, Options(abs_tol=1e-8),
                                      interpret=True, tile_b=4)
    return pack(*solver(*_mpc_args(mesh, di(4, x0_tiles(6 * mesh.size())))))


def _adaptive(mesh, x0s, phase1):
    solver = sharded_mpc_solver_adaptive(
        mesh, Options(abs_tol=1e-8), phase1_newton_iters=phase1,
        phase2_size=2)
    return pack(*solver(*_mpc_args(mesh, di(4, x0s))))


def case_adaptive_overflow(mesh):
    return _adaptive(mesh, X0_FUSED, 4)


def case_adaptive_mixed(mesh):
    return _adaptive(mesh, X0_MIXED, 5)


def case_local_rows(mesh):
    """tests/mp_worker.py's pattern: each rank builds only the rows it
    owns and solves them; the statistics cover the global batch."""
    W, r = mesh.size(), mesh.get_local_rank()
    B = 4 * W
    lo, hi = r * (B // W), (r + 1) * (B // W)
    a = di(4, x0_local(lo, hi))
    g = tuple(torch.tensor(t) for t in mpc_guess(a))
    solver = sharded_mpc_solver(mesh, Options(abs_tol=1e-8))
    return pack(*solver(torch_data(a, F64), *g))


def case_errors(mesh):
    """What the sharding refuses: a batch that does not divide over the
    mesh, and a mesh that leaves out a rank."""
    out = {}
    for name, call in (
            ("indivisible", lambda: shard_batch(mesh, torch.zeros(5, 2))),
            ("partial_mesh", lambda: make_mesh([0, 1], device="cpu"))):
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def case_dryrun(mesh):
    dryrun_multichip(mesh.size(), device="cpu")
    return {"ok": True}


def case_pad(mesh):
    tree = (torch.arange(1001 * 3, dtype=F64).reshape(1001, 3),
            torch.zeros(1001))
    padded, valid = pad_batch_for_mesh(mesh, tree)
    padded16, _ = pad_batch_for_mesh(mesh, tree, tile_b=16)
    tree16 = (torch.ones(16, 2),)
    same, v16 = pad_batch_for_mesh(mesh, tree16)
    return dict(rows=[padded[0].shape[0], padded[1].shape[0]],
                valid=int(valid.sum()), pad=padded[0][1001:],
                last=tree[0][1000], rows16=padded16[0].shape[0],
                identity=same[0] is tree16[0], valid16=int(v16.sum()))


def case_masked_mesh(mesh):
    core, valid = shard_batch(mesh, masked_core(MASKED_MESH))
    local = masked_batch_stats(core, valid)
    stats = masked_batch_stats(core, valid, mesh)
    return dict(stats={k: v.item() for k, v in stats._asdict().items()},
                local={k: v.item() for k, v in local._asdict().items()},
                dtypes={k: str(v.dtype) for k, v in stats._asdict().items()})


def case_dense_ragged(mesh):
    a = dense_ragged()
    g = tuple(torch.tensor(t) for t in dense_guess(a))
    return pack(*solve_dense_ragged(torch_dense_data(a, F64), *g,
                                    Options(abs_tol=1e-8), mesh=mesh))


def case_mpc_ragged(mesh):
    a = mpc_ragged()
    g = tuple(torch.tensor(t) for t in mpc_guess(a))
    return pack(*solve_mpc_ragged(torch_data(a, F64), *g, Options(),
                                  mesh=mesh, fused=False))


SUITES = {
    "sharded": dict(mpc=case_mpc, dense=case_dense, fused=case_fused,
                    fused_tiles=case_fused_tiles,
                    adaptive_overflow=case_adaptive_overflow,
                    adaptive_mixed=case_adaptive_mixed,
                    local_rows=case_local_rows, errors=case_errors,
                    dryrun=case_dryrun),
    "ragged": dict(pad=case_pad, masked_mesh=case_masked_mesh,
                   dense_ragged=case_dense_ragged, mpc_ragged=case_mpc_ragged),
}


def main(suite: str, rank: int, world: int, port: int, outdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    mesh = make_mesh(device="cpu")
    results = {name: case(mesh) for name, case in SUITES[suite].items()}
    torch.save(results, Path(outdir) / f"{suite}_rank{rank}.pt")
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


# ------------------------------------------------------------------
# The parent's side.
# ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(suite: str, world: int, outdir, timeout: float = 300.0):
    """Runs SUITES[suite] in a gloo world of `world` ranks, one process
    each; returns each rank's results in rank order. Raises with the
    ranks' output when a rank fails, or when the world outlives
    `timeout` seconds (then every rank is killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(TESTS)] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(port),
         str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        raise RuntimeError(f"the {suite} world of {world} ranks outlived "
                           f"{timeout} s:\n" + "\n".join(outs))
    failed = [f"rank {r} (exit {p.returncode}):\n{o}"
              for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise RuntimeError(f"the {suite} world failed:\n" + "\n".join(failed))
    return [torch.load(Path(outdir) / f"{suite}_rank{r}.pt")
            for r in range(world)]


def rows(world, case, part, field):
    """A field's global array: the ranks' rows of it, in rank order."""
    return torch.cat([r[case][part][field] for r in world]).numpy()


def same_stats(world, case):
    """The statistics of a case, which every rank must hold alike."""
    stats = [r[case]["stats"] for r in world]
    assert all(s == stats[0] for s in stats[1:]), stats
    return stats[0]


def assert_lanes_match(world, case, x, core, tol, fields="zlv", lanes=None,
                       rtol=0.0):
    """Equal exit flags on every lane; on `lanes` (all when None) equal
    Newton and proximal counts and the iterate `fields` within tol (and
    rtol) of the reference's (x, core)."""
    np.testing.assert_array_equal(rows(world, case, "core", "eflag"),
                                  np.asarray(core.eflag))
    m = slice(None) if lanes is None else lanes
    for f in ("newton_iters", "prox_iters"):
        np.testing.assert_array_equal(rows(world, case, "core", f)[m],
                                      np.asarray(getattr(core, f))[m],
                                      err_msg=f)
    for f in fields:
        np.testing.assert_allclose(rows(world, case, "x", f)[m],
                                   np.asarray(getattr(x, f))[m], rtol=rtol,
                                   atol=tol, err_msg=f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])

"""PyTorch port: the batch sharded over torch.distributed
(fbstab_tpu_torch/parallel/sharded.py, graft_entry.py) against the JAX
package's sharded solvers, in float64 on the CPU.

The port's cases run in one 4-rank gloo world (tests/torch_mp_worker.py,
one process a rank); each rank writes its rows and the statistics it
holds, and the rows are reassembled in rank order. The JAX references run
here on a mesh of the same 4 devices, so that each shard holds the same
lanes (the adaptive scheme compacts each shard's own stragglers, so its
counts depend on the shard). Per lane: equal exit flags, Newton and
proximal counts, iterates within 1e-9; the statistics' counts equal,
their residuals within 1e-9, and identical on every rank. After
tests/test_sharded.py, test_sharded_fused.py and test_multiprocess.py.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mp_worker as mw  # noqa: E402
from fbstab_tpu.models.mpc_qp import solve_mpc_qp_batch  # noqa: E402
from fbstab_tpu.options import Options as JaxOptions  # noqa: E402
from fbstab_tpu.parallel import sharded as jsh  # noqa: E402
from torch_parity import jax_data, jax_dense_data, torch_data  # noqa: E402

from fbstab_tpu_torch.ops.mpc_solve_cuda import (  # noqa: E402
    fbstab_mpc_solve_plain)
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402

W = 4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results of the `sharded` suite, in rank order."""
    return mw.run_world("sharded", W, tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(jax.devices()[:W])


def jax_sharded(jmesh, solver, arrays, guess, dense=False):
    data = (jax_dense_data if dense else jax_data)(arrays, jnp.float64)
    args = jsh.shard_batch(jmesh, (data,) + tuple(jnp.asarray(g)
                                                  for g in guess))
    return solver(*args)


def assert_stats_match(got, want, tol=1e-9):
    for f in ("num_instances", "num_success", "num_infeasible", "num_failed",
              "total_newton_iters", "max_newton_iters"):
        assert got[f] == int(getattr(want, f)), f
    for f in ("max_residual", "mean_residual"):
        assert abs(got[f] - float(getattr(want, f))) <= tol, f


def test_sharded_mpc_solver_matches_reference(world, jmesh):
    """tests/test_sharded.py's batch: the double integrator, N = 5,
    B = 16, Options(abs_tol=1e-8)."""
    a = mw.di(5, mw.X0_SHARDED)
    x, core, stats = jax_sharded(
        jmesh, jsh.sharded_mpc_solver(jmesh, JaxOptions(abs_tol=1e-8)), a,
        mw.mpc_guess(a))
    mw.assert_lanes_match(world, "mpc", x, core, 1e-9)
    got = mw.same_stats(world, "mpc")
    assert_stats_match(got, stats)
    assert got["num_success"] == 16 and got["max_residual"] <= 1e-6


def test_sharded_dense_solver_mixed_batch(world, jmesh):
    """tests/test_sharded.py's mixed batch: per-lane exit flags, four
    SUCCESS and four PRIMAL_INFEASIBLE."""
    a = mw.dense_mixed()
    x, core, stats = jax_sharded(
        jmesh, jsh.sharded_dense_solver(jmesh, JaxOptions(abs_tol=1e-8)), a,
        mw.dense_guess(a), dense=True)
    ef = mw.rows(world, "dense", "core", "eflag")
    np.testing.assert_array_equal(ef, np.asarray(core.eflag))
    odd = np.arange(8) % 2 == 1
    assert (ef[~odd] == ExitFlag.SUCCESS).all()
    assert (ef[odd] == ExitFlag.PRIMAL_INFEASIBLE).all()
    got = mw.same_stats(world, "dense")
    assert got["num_success"] == 4 and got["num_infeasible"] == 4
    assert got["num_instances"] == int(stats.num_instances) == 8


def test_sharded_mpc_solver_fused_interpret(world):
    """sharded_mpc_solver_fused(interpret=True, tile_b=2), the plain K2
    on each shard, against the JAX package's solve_mpc_qp_batch on the
    XLA path (the function tests/test_sharded_fused.py holds JAX's
    sharded fused solver to; cheaper than its interpret-mode kernel)."""
    a = mw.di(4, mw.X0_FUSED)
    g = tuple(jnp.asarray(t) for t in mw.mpc_guess(a))
    x, core = jax.jit(lambda d, z, l, v: solve_mpc_qp_batch(
        d, z, l, v, JaxOptions(abs_tol=1e-8)))(jax_data(a, jnp.float64), *g)
    mw.assert_lanes_match(world, "fused", x, core, 1e-9, fields="z")
    got = mw.same_stats(world, "fused")
    assert got["num_success"] == 16 == got["num_instances"]


def test_sharded_fused_ragged_tiles_equal_unsharded_plain_k2(world):
    """B = 6 W with tile_b = 4: a shard (6 lanes) is no multiple of the
    tile, which K2 does not have. The sharded result against the port's
    unsharded plain K2 on all 24 lanes: flags and counts equal and every
    output bit for bit, since a lane's arithmetic in the masked lockstep
    core does not depend on its batch-mates."""
    a = mw.di(4, mw.x0_tiles(6 * W))
    g = tuple(torch.tensor(t) for t in mw.mpc_guess(a))
    x, core = fbstab_mpc_solve_plain(torch_data(a, torch.float64), *g,
                                     Options(abs_tol=1e-8))
    for part, ref in (("x", x), ("core", core)):
        for f, want in ref._asdict().items():
            if isinstance(want, torch.Tensor):
                np.testing.assert_array_equal(
                    mw.rows(world, "fused_tiles", part, f), want.numpy(),
                    err_msg=f)
    assert mw.same_stats(world, "fused_tiles")["num_success"] \
        == 6 * W


@pytest.mark.parametrize("case,x0s,phase1", [
    ("adaptive_overflow", mw.X0_FUSED, 4),
    ("adaptive_mixed", mw.X0_MIXED, 5),
])
def test_sharded_mpc_solver_adaptive_matches_reference(world, jmesh, case,
                                                       x0s, phase1):
    """B = 16 on four shards, phase-2 size 2 a shard. Phase 1 of 4 Newton
    steps leaves every lane a straggler (every shard overflows, the
    fallback runs); phase 1 of 5 leaves 0, 4, 2 and 3 stragglers on the
    four shards."""
    a = mw.di(4, x0s)
    solver = jsh.sharded_mpc_solver_adaptive(
        jmesh, JaxOptions(abs_tol=1e-8), phase1_newton_iters=phase1,
        phase2_size=2)
    x, core, stats = jax_sharded(jmesh, solver, a, mw.mpc_guess(a))
    mw.assert_lanes_match(world, case, x, core, 1e-9)
    assert_stats_match(mw.same_stats(world, case), stats)


def test_each_rank_solves_only_its_own_rows(world):
    """tests/mp_worker.py's pattern: no rank holds the global batch, and
    the statistics still count B of B."""
    B = 4 * W
    got = mw.same_stats(world, "local_rows")
    assert got["num_instances"] == B and got["num_success"] == B
    assert got["max_residual"] <= 1e-6
    assert mw.rows(world, "local_rows", "x", "v").min() >= -1e-12
    np.testing.assert_array_equal(
        mw.rows(world, "local_rows", "core", "eflag"), np.zeros(B))


def test_sharding_refuses_what_jax_refuses(world):
    """A batch that does not divide over the mesh raises ValueError (pad
    it first), and so does a mesh that leaves out a rank."""
    for r in world:
        errs = r["errors"]
        assert errs["indivisible"].startswith("ValueError")
        assert "pad_batch_for_mesh" in errs["indivisible"]
        assert errs["partial_mesh"].startswith("ValueError")


def test_dryrun_multichip_on_four_ranks(world):
    assert all(r["dryrun"]["ok"] for r in world)


def _public_names(path: Path) -> set:
    """Top-level functions, classes and constants a module defines."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("jax_file,port_module", [
    ("fbstab_tpu/parallel/sharded.py", "fbstab_tpu_torch.parallel.sharded"),
    ("fbstab_tpu/parallel/ragged.py", "fbstab_tpu_torch.parallel.ragged"),
    ("__graft_entry__.py", "fbstab_tpu_torch.graft_entry"),
])
def test_port_defines_every_public_name(jax_file, port_module):
    mod = importlib.import_module(port_module)
    missing = {n for n in _public_names(ROOT / jax_file)
               if not hasattr(mod, n)}
    assert not missing, missing

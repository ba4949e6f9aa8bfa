"""PyTorch port: ragged global batches over a mesh of ranks
(fbstab_tpu_torch/parallel/ragged.py) against the JAX package's, in
float64 on the CPU, after tests/test_ragged.py.

The solves run in one 4-rank gloo world (tests/torch_mp_worker.py) and
are held to the JAX package's ragged solves on a mesh of the same 4
devices: the batch comes back trimmed to B rows (a rank keeps its rows
below B), each lane's results equal JAX's, and the statistics exclude the
padding. The padding helper and the masked statistics also run here, in
this process, on a world of one that the fixture ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mp_worker as mw  # noqa: E402
from fbstab_tpu.options import Options as JaxOptions  # noqa: E402
from fbstab_tpu.parallel import ragged as jrg  # noqa: E402
from fbstab_tpu.parallel import sharded as jsh  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_data, jax_dense_data, torch_data, torch_dense_data)

from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch  # noqa
from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.parallel.ragged import (  # noqa: E402
    masked_batch_stats, pad_batch_for_mesh)
from fbstab_tpu_torch.parallel.sharded import make_mesh  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402

W = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results of the `ragged` suite, in rank order."""
    return mw.run_world("ragged", W, tmp_path_factory.mktemp("ragged"))


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(jax.devices()[:W])


@pytest.fixture
def mesh_of_one():
    """A CPU mesh on a world of one started in this process, ended after
    the test."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_pad_batch_for_mesh_on_a_world_of_one(mesh_of_one):
    tree = (torch.arange(1001 * 3, dtype=torch.float64).reshape(1001, 3),
            torch.zeros(1001))
    same, valid = pad_batch_for_mesh(mesh_of_one, tree)
    assert same is tree and bool(valid.all()) and valid.shape == (1001,)
    padded, valid = pad_batch_for_mesh(mesh_of_one, tree, tile_b=16)
    assert padded[0].shape == (1008, 3) and padded[1].shape == (1008,)
    assert int(valid.sum()) == 1001 and not bool(valid[1001:].any())
    np.testing.assert_array_equal(          # padding repeats the last row
        padded[0][1001:].numpy(),
        np.broadcast_to(tree[0][1000].numpy(), (7, 3)))


def test_pad_batch_for_mesh_on_four_ranks(world):
    """tests/test_ragged.py::test_pad_batch_for_mesh_shapes on 4 ranks:
    1001 -> 1004, -> 1024 with tile_b = 16, and a batch that divides
    comes back as the same objects."""
    for r in world:
        p = r["pad"]
        assert p["rows"] == [1004, 1004] and p["valid"] == 1001
        np.testing.assert_array_equal(
            p["pad"].numpy(), np.broadcast_to(p["last"].numpy(), (3, 3)))
        assert p["rows16"] == 1024
        assert p["identity"] and p["valid16"] == 16


def _jax_core(m):
    from fbstab_tpu.core.algorithm import CoreOut
    eflag = jnp.asarray(m["eflag"], jnp.int32)
    res = jnp.asarray(m["residual"])
    ni = jnp.asarray(m["newton_iters"], jnp.int32)
    return (CoreOut(eflag=eflag, residual=res, newton_iters=ni,
                    prox_iters=ni, initial_residual=res, raw_residual=res),
            jnp.asarray(m["valid"], bool))


@pytest.mark.parametrize("over_mesh", [False, True])
def test_masked_stats_excludes_padding(mesh_of_one, over_mesh):
    """tests/test_ragged.py's hand-made CoreOut (the last two lanes
    padding), reduced locally and over the world of one; equal to JAX's
    masked_batch_stats, with batch_stats' dtypes."""
    core, valid = mw.masked_core(mw.MASKED)
    s = masked_batch_stats(core, valid, mesh_of_one if over_mesh else None)
    assert int(s.num_instances) == 4
    assert int(s.num_success) == 3
    assert int(s.num_failed) == 1
    assert float(s.max_residual) == 0.5
    assert int(s.total_newton_iters) == 62
    assert int(s.max_newton_iters) == 50
    ref = jrg.masked_batch_stats(*_jax_core(mw.MASKED))
    for f in ref._fields:
        np.testing.assert_allclose(getattr(s, f).item(),
                                   float(getattr(ref, f)), rtol=1e-12,
                                   err_msg=f)
    assert s.num_instances.dtype == torch.int32
    assert s.max_newton_iters.dtype == torch.int32
    assert s.max_residual.dtype == torch.float64


def test_masked_stats_over_four_ranks_with_an_all_padding_rank(world):
    """Eight lanes, two a rank, five real: rank 3 holds only padding (its
    own statistics: no instance, -inf largest residual) and adds nothing
    to the global ones, which equal JAX's on the whole batch."""
    for r in world:
        assert r["masked_mesh"]["stats"] == world[0]["masked_mesh"]["stats"]
    last = world[3]["masked_mesh"]["local"]
    assert last["num_instances"] == 0 and last["total_newton_iters"] == 0
    assert last["max_residual"] == -np.inf
    got = world[0]["masked_mesh"]["stats"]
    ref = jrg.masked_batch_stats(*_jax_core(mw.MASKED_MESH))
    for f in ref._fields:
        np.testing.assert_allclose(got[f], float(getattr(ref, f)),
                                   rtol=1e-12, err_msg=f)
    assert got["num_instances"] == 5 and got["num_infeasible"] == 1
    assert world[0]["masked_mesh"]["dtypes"]["num_success"] == "torch.int32"


def assert_equals_unsharded(world, case, x, core):
    """The trimmed rows equal the port's unsharded solve of the whole
    batch bit for bit: a lane's arithmetic in the masked lockstep core
    does not depend on its batch-mates, and the padding does not leak."""
    for part, ref in (("x", x), ("core", core)):
        for f, want in ref._asdict().items():
            if isinstance(want, torch.Tensor):
                np.testing.assert_array_equal(mw.rows(world, case, part, f),
                                              want.numpy(), err_msg=f)


def assert_stats_exclude_padding(got, stats, world, case, B):
    """The statistics count the B real instances: equal to a host
    reduction over the trimmed rows (the mean to 1e-12: its summation
    order differs), with the verdict counts of JAX's masked
    statistics."""
    res = mw.rows(world, case, "core", "residual")
    ni = mw.rows(world, case, "core", "newton_iters")
    ef = mw.rows(world, case, "core", "eflag")
    assert got["num_instances"] == B
    assert got["num_success"] == int((ef == 0).sum())
    assert got["total_newton_iters"] == int(ni.sum())
    assert got["max_newton_iters"] == int(ni.max())
    assert got["max_residual"] == res.max()
    np.testing.assert_allclose(got["mean_residual"], res.mean(), rtol=1e-12)
    for f in ("num_instances", "num_success", "num_infeasible", "num_failed"):
        assert got[f] == int(getattr(stats, f)), f


def test_ragged_dense_b1001_on_4_ranks(world, jmesh):
    """tests/test_ragged.py's B = 1001 dense batch with lanes 100 and 999
    primal infeasible: 1001 rows back (251, 251, 251, 248 a rank), equal
    to the port's unsharded solve, each lane's flag as JAX's, two
    infeasibility verdicts counted.

    The Newton step at which the infeasible lanes certify is rounding:
    on lane 999 alone JAX's own solve takes 55 Newton steps, and 6, 8 or
    55 when H, f or b is scaled by 1 +- 1e-15 or 3e-15 (the port's the
    same, 6 unperturbed). Counts and iterates are held to JAX's on the
    999 SUCCESS lanes, within 1e-9."""
    B = 1001
    a = mw.dense_ragged()
    g = tuple(jnp.asarray(t) for t in mw.dense_guess(a))
    x, core, stats = jrg.solve_dense_ragged(
        jax_dense_data(a, jnp.float64), *g, JaxOptions(abs_tol=1e-8),
        mesh=jmesh)
    assert [r["dense_ragged"]["core"]["eflag"].shape[0] for r in world] == \
        [251, 251, 251, 248]
    assert_equals_unsharded(world, "dense_ragged", *solve_dense_qp_batch(
        torch_dense_data(a, torch.float64),
        *(torch.tensor(t) for t in mw.dense_guess(a)), Options(abs_tol=1e-8)))
    success = np.asarray(core.eflag) == ExitFlag.SUCCESS
    assert success.sum() == B - 2
    mw.assert_lanes_match(world, "dense_ragged", x, core, 1e-9,
                            lanes=success)
    np.testing.assert_allclose(
        mw.rows(world, "dense_ragged", "core", "residual")[success],
        np.asarray(core.residual)[success], rtol=0, atol=1e-9)
    got = mw.same_stats(world, "dense_ragged")
    assert_stats_exclude_padding(got, stats, world, "dense_ragged", B)
    ef = mw.rows(world, "dense_ragged", "core", "eflag")
    n_inf = int(((ef >= ExitFlag.PRIMAL_INFEASIBLE)
                 & (ef <= ExitFlag.PRIMAL_DUAL_INFEASIBLE)).sum())
    assert got["num_infeasible"] == n_inf == 2
    assert got["num_success"] + n_inf == B


def test_ragged_mpc_lockstep_path(world, jmesh):
    """tests/test_ragged.py's B = 37 MPC batch through the lockstep path
    (fused=False, default Options): 37 -> 40 on 4 ranks, the last rank
    keeps 7 rows, equal to the port's unsharded solve; flags and counts
    as JAX's, iterates within 1e-8 + 1e-8 |x| and residuals within
    1e-9. At the default abs_tol of 1e-6 the lanes stop on iterates that
    the two packages' roundoff moves by up to 5.6e-9 unsharded (l, of
    |l| <= 3.7; z 1.5e-9), 1.1e-8 against JAX's sharded compilation."""
    B = 37
    a = mw.mpc_ragged()
    g = tuple(jnp.asarray(t) for t in mw.mpc_guess(a))
    x, core, stats = jrg.solve_mpc_ragged(
        jax_data(a, jnp.float64), *g, JaxOptions(), mesh=jmesh, fused=False)
    assert [r["mpc_ragged"]["core"]["eflag"].shape[0] for r in world] == \
        [10, 10, 10, 7]
    assert_equals_unsharded(world, "mpc_ragged", *solve_mpc_qp_batch(
        torch_data(a, torch.float64),
        *(torch.tensor(t) for t in mw.mpc_guess(a)), Options()))
    mw.assert_lanes_match(world, "mpc_ragged", x, core, 1e-8, rtol=1e-8)
    np.testing.assert_allclose(
        mw.rows(world, "mpc_ragged", "core", "residual"),
        np.asarray(core.residual), rtol=0, atol=1e-9)
    got = mw.same_stats(world, "mpc_ragged")
    assert_stats_exclude_padding(got, stats, world, "mpc_ragged", B)
    assert got["num_success"] == B
    for f in ("total_newton_iters", "max_newton_iters"):
        assert got[f] == int(getattr(stats, f)), f
    for f in ("max_residual", "mean_residual"):
        assert abs(got[f] - float(getattr(stats, f))) <= 1e-9, f

"""PyTorch port: the adaptive wrappers against the JAX package's, in float64
on small MPC and dense batches. For each class: the fixed-size two-phase
wrapper with a phase-1 budget that leaves stragglers under the phase-2
capacity and one that overflows it so the fallback pass fires, the
three-stage schedule of tests/test_adaptive.py, and the host variant with
its padded phase-2 size. Per lane: equal exit flag, Newton and proximal
counts (accumulated across stages), z within 1e-9, the phase-1 initial
residual; infeasibility verdicts survive the phases.

JAX's wrappers run eagerly here with the class dispatchers they call
compiled once per options and shapes, so a stage that two cases share
(the same budget, profile and size) compiles once; the cases' budgets and
capacities are chosen so that most stages coincide."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fbstab_tpu.models import dense_qp as jdq  # noqa: E402
from fbstab_tpu.models import mpc_qp as jmq  # noqa: E402
from fbstab_tpu.models.mpc_qp import MpcQPData  # noqa: E402
from fbstab_tpu.options import Options as JaxOptions  # noqa: E402
from fbstab_tpu.parallel import adaptive as jad  # noqa: E402
from torch_parity import (  # noqa: E402
    dims, jax_dense_data, plant_arrays, torch_data, torch_dense_data)

from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch  # noqa
from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.parallel import adaptive as tad  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402

SCHEDULE = [(3, None, "same"), (6, 8, "same"), (None, 8, "reliable")]


def _dense():
    """tests/test_adaptive.py's random dense batch (B = 16, n = 8,
    q = 12, seed 0). Lanes left after a Newton budget of 3: 14; of 7: 6."""
    B, n, q = 16, 8, 12
    rng = np.random.default_rng(0)
    M = rng.standard_normal((B, n, n))
    return dict(H=M @ np.transpose(M, (0, 2, 1)) / n + np.eye(n),
                f=rng.standard_normal((B, n)), G=np.zeros((B, 0, n)),
                h=np.zeros((B, 0)), A=rng.standard_normal((B, q, n)),
                b=np.abs(rng.standard_normal((B, q))) + 0.5)


def _mpc(x0s):
    return plant_arrays("double_integrator", 4, len(x0s), x0s=x0s)


# Lanes 1 and 3 start infeasible (stage-1 position below 0); after a
# Newton budget of 6, four lanes are left.
MPC_INFEASIBLE = [[0.1, 0.0], [-1.0, 0.0], [0.2, 0.0], [-2.0, 0.0],
                  [0.6, 0.05], [1.0, 0.1], [1.4, 0.05], [0.3, 0.02]]
# Mixed hardness, all feasible: eight lanes left after 3 Newton steps,
# three after 6.
MPC_MIXED = [[0.2 * i, 0.01 * i] for i in range(8)]

# name: (class, arrays, wrapper, keyword arguments). Stages the cases
# share: dense budget 3 and budget 7 at B = 16, reliable at 8; MPC budgets
# 3 and 6 at B = 8, reliable at 8 and at 4.
CASES = {
    "dense_under_capacity": ("dense", _dense, "device",
                             dict(phase1_newton_iters=7, phase2_size=8)),
    "dense_overflow_fallback": ("dense", _dense, "device",
                                dict(phase1_newton_iters=3, phase2_size=8)),
    "dense_three_stage": ("dense", _dense, "schedule",
                          dict(stages=SCHEDULE)),
    "dense_host_padded": ("dense", _dense, "host",
                          dict(phase1_newton_iters=7, pad_multiple=4)),
    "mpc_under_capacity_infeasible": (
        "mpc", lambda: _mpc(MPC_INFEASIBLE), "device",
        dict(phase1_newton_iters=6, phase2_size=8)),
    "mpc_overflow_fallback": ("mpc", lambda: _mpc(MPC_MIXED), "device",
                              dict(phase1_newton_iters=3, phase2_size=4)),
    "mpc_three_stage": ("mpc", lambda: _mpc(MPC_MIXED), "schedule",
                        dict(stages=SCHEDULE)),
    "mpc_host_padded": ("mpc", lambda: _mpc(MPC_MIXED), "host",
                        dict(phase1_newton_iters=6, pad_multiple=2)),
}


def _compiled(fn, **defaults):
    """fn (a JAX class dispatcher) compiled once per options, keyword
    choices and shapes."""
    static = ("options",) + tuple(defaults)
    jitted = jax.jit(fn, static_argnames=static)

    def solve(data, z0, l0, v0, options, **kw):
        return jitted(data, z0, l0, v0, options=options,
                      **{**defaults, **kw})
    return solve


@pytest.fixture(scope="module")
def jax_adaptive():
    """JAX's adaptive module with its class dispatchers compiled once per
    stage and shared by every case of this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdq, "solve_dense_qp_batch",
                   _compiled(jdq.solve_dense_qp_batch))
        mp.setattr(jmq, "solve_mpc_qp_batch",
                   _compiled(jmq.solve_mpc_qp_batch, riccati="auto"))
        yield jad


def _inputs(cls, arrays):
    """(JAX data, port data, zero guesses for each) in float64."""
    if cls == "dense":
        jd = jax_dense_data(arrays, jnp.float64)
        td = torch_dense_data(arrays, torch.float64)
        sizes = (arrays["f"].shape[1], arrays["h"].shape[1],
                 arrays["b"].shape[1])
    else:
        jd = MpcQPData(**{k: jnp.asarray(v) for k, v in arrays.items()})
        td = torch_data(arrays, torch.float64)
        sizes = dims(arrays)[4:]
    B = arrays["A"].shape[0]
    return (jd, td, tuple(jnp.zeros((B, k)) for k in sizes),
            tuple(torch.zeros(B, k, dtype=torch.float64) for k in sizes))


def _wrapper(module, cls, wrapper):
    suffix = "" if wrapper == "host" else f"_{wrapper}"
    return getattr(module, f"solve_{cls}_qp_batch_adaptive{suffix}")


def _check(jr, tr):
    (xj, cj), (xt, ct) = jr, tr
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cj, f)), err_msg=f)
    zj = np.asarray(xj.z)
    np.testing.assert_allclose(xt.z.numpy(), zj, rtol=1e-9,
                               atol=1e-9 * (1 + np.abs(zj).max()))
    np.testing.assert_allclose(ct.initial_residual.numpy(),
                               np.asarray(cj.initial_residual), rtol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_matches_reference_per_lane(jax_adaptive, case):
    cls, make, wrapper, kw = CASES[case]
    arrays = make()
    jd, td, jz, tz = _inputs(cls, arrays)
    jr = _wrapper(jax_adaptive, cls, wrapper)(
        jd, *jz, JaxOptions(abs_tol=1e-8), **kw)
    tr = _wrapper(tad, cls, wrapper)(td, *tz, Options(abs_tol=1e-8), **kw)
    _check(jr, tr)
    ef = tr[1].eflag.numpy()
    if "infeasible" in case:
        assert ef[[1, 3]].tolist() == [int(ExitFlag.PRIMAL_INFEASIBLE)] * 2
        assert (ef[[0, 2, 4, 5, 6, 7]] == 0).all()
    else:
        assert (ef == 0).all()
    # Phase 2 (or a later stage) ran: some lane took more than phase 1's
    # budget.
    assert int(tr[1].newton_iters.max()) > kw.get("phase1_newton_iters", 3)
    if "overflow" in case:
        # More stragglers than capacity: without the fallback some lanes
        # keep their phase-1 budget exit, so the fallback re-solved them.
        solve = solve_dense_qp_batch if cls == "dense" else solve_mpc_qp_batch
        _, c1 = tad.solve_batch_adaptive_device(
            solve, None, td, *tz, Options(abs_tol=1e-8),
            phase2_fallback=False, **kw)
        assert (c1.eflag.numpy() == int(ExitFlag.MAXITERATIONS)).any()


def test_host_variant_equals_fixed_size_variant_at_full_capacity():
    """The host variant (phase 2 sized to the stragglers) gives the fixed
    size variant's lanes when the capacity holds every straggler."""
    data = torch_dense_data(_dense(), torch.float64)
    z = tuple(torch.zeros(16, k, dtype=torch.float64) for k in (8, 0, 12))
    opts = Options(abs_tol=1e-8)
    xh, ch = tad.solve_dense_qp_batch_adaptive(
        data, *z, opts, phase1_newton_iters=3, pad_multiple=4)
    xd, cd = tad.solve_dense_qp_batch_adaptive_device(
        data, *z, opts, phase1_newton_iters=3, phase2_size=16)
    for f in ("eflag", "newton_iters", "prox_iters"):
        assert getattr(ch, f).tolist() == getattr(cd, f).tolist(), f
    torch.testing.assert_close(xh.z, xd.z, rtol=0, atol=1e-12)
    assert (ch.newton_iters > 3).any()          # phase 2 ran


def test_assoc_riccati_is_not_ported():
    """riccati="assoc" threads through the adaptive wrapper to every stage:
    the two-phase solve on the associative Riccati step takes the same
    decisions per lane as on the sequential one (the two steps solve one
    system and differ at roundoff)."""
    arrays = _mpc(MPC_MIXED[:2])
    data = torch_data(arrays, torch.float64)
    z = tuple(torch.zeros(2, k, dtype=torch.float64)
              for k in dims(arrays)[4:])
    out = {r: tad.solve_mpc_qp_batch_adaptive_device(
        data, *z, Options(abs_tol=1e-8), phase1_newton_iters=2,
        phase2_size=2, riccati=r) for r in ("assoc", "scan")}
    (xa, ca), (xs, cs) = out["assoc"], out["scan"]
    for f in ("eflag", "newton_iters", "prox_iters"):
        assert getattr(ca, f).tolist() == getattr(cs, f).tolist(), f
    assert (ca.newton_iters > 2).all()          # phase 2 ran
    torch.testing.assert_close(xa.z, xs.z, rtol=0, atol=1e-9)

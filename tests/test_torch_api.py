"""PyTorch port: the public API closed against fbstab_tpu's. The exports
(every name of fbstab_tpu.__all__, the sparse QP class's ten included),
the single-instance solves (`solve_dense_qp`, `fbstab_solve`), the
equilibration entry points, the unrolled `refine_mpc_batch` (against the
JAX package's history, and the unrolled contract pins of
tests/test_contract.py:126-166), and the MPC oracles the port had not
been run against: the quadprog vectors of tests/test_mpc_solve.py:187-205
and the MPC fuzz batch of tests/test_fuzz_parity.py:279, both in
float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fbstab_tpu  # noqa: E402
from fbstab_tpu import Options as JaxOptions  # noqa: E402
from fbstab_tpu.core.variable import Variable as JaxVariable  # noqa: E402
from fbstab_tpu.models import dense_qp as jdense  # noqa: E402
from fbstab_tpu.models import mpc_qp as jmpc  # noqa: E402
from fbstab_tpu.models import refine as jref  # noqa: E402
from fbstab_tpu.models import scaling as jscal  # noqa: E402
from fbstab_tpu.core.feasibility import check_feasibility  # noqa: E402
from test_fuzz_parity import FUZZ_OPTS, _mpc_fuzz_batch  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_data, plant_arrays, torch_data, torch_dense_data, torch_options)

import fbstab_tpu_torch  # noqa: E402
from fbstab_tpu_torch.core.algorithm import fbstab_solve  # noqa: E402
from fbstab_tpu_torch.models import dense_qp as tdense  # noqa: E402
from fbstab_tpu_torch.models import mpc_qp as tmpc  # noqa: E402
from fbstab_tpu_torch.models import refine as tref  # noqa: E402
from fbstab_tpu_torch.models import scaling as tscal  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402
from fbstab_tpu_torch.workloads import mpc_f64_residual  # noqa: E402

F64, F32 = torch.float64, torch.float32
SPARSE_NAMES = {
    "FBstabSparse", "SparsePattern", "SparseQPData", "sparse_qp_data",
    "pattern_values", "mpc_sparse_pattern", "mpc_sparse_values",
    "solve_sparse_qp", "solve_sparse_qp_batch", "solve_sparse_qp_diff"}


def test_exports_are_the_reference_exports():
    """Every name of fbstab_tpu.__all__ is exported by the port, the ten
    of the sparse QP class (models/sparse_qp.py, diff.py) among them."""
    missing = set(fbstab_tpu.__all__) - set(fbstab_tpu_torch.__all__)
    assert missing == set()
    assert SPARSE_NAMES <= set(fbstab_tpu_torch.__all__)
    for name in fbstab_tpu_torch.__all__:
        assert hasattr(fbstab_tpu_torch, name), name
    assert fbstab_tpu_torch.DENSE_OPS is tdense.DENSE_OPS
    assert fbstab_tpu_torch.MPC_OPS is tmpc.MPC_OPS


def _dense_test_diff():
    """tests/test_diff.py's dense problem (nz=5, nl=2, nv=4), batch of
    one."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((5, 5))
    H = M @ M.T + 0.5 * np.eye(5)
    arrays = dict(H=H, f=rng.standard_normal(5),
                  G=rng.standard_normal((2, 5)),
                  h=rng.standard_normal(2) * 0.2,
                  A=rng.standard_normal((4, 5)),
                  b=rng.standard_normal(4) * 0.5 + 1.0)
    return {k: a[None] for k, a in arrays.items()}


DENSE_CASES = {
    "test_diff": _dense_test_diff,
    # fbstab_dense_unit_tests.cc's degenerate QP (solution set {1}x[1,3]).
    "degenerate": lambda: dict(
        H=np.array([[[1.0, 0.0], [0.0, 0.0]]]), f=np.array([[1.0, 0.0]]),
        G=np.zeros((1, 0, 2)), h=np.zeros((1, 0)),
        A=np.array([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0],
                     [0.0, -1.0]]]),
        b=np.array([[0.0, 3.0, 3.0, -1.0, -1.0]])),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_solve_dense_qp_matches_reference(case):
    """solve_dense_qp (one instance: a batch of one, unbatched guesses)
    against the JAX package's: the same exit flag and iteration counts,
    iterates within 1e-10; fbstab_solve on DENSE_OPS is the same solve."""
    arrays = DENSE_CASES[case]()
    jopts = JaxOptions(abs_tol=1e-10)
    n, nl, q = arrays["H"].shape[-1], arrays["G"].shape[1], \
        arrays["A"].shape[1]
    jd = jdense.DenseQPData(**{k: jnp.asarray(a[0]) for k, a in
                               arrays.items()})
    xj, cj = jax.jit(lambda d: jdense.solve_dense_qp(
        d, jnp.zeros(n), jnp.zeros(nl), jnp.zeros(q), jopts))(jd)
    data = torch_dense_data(arrays, F64)
    guesses = tuple(torch.zeros(m, dtype=F64) for m in (n, nl, q))
    xt, ct = tdense.solve_dense_qp(data, *guesses, torch_options(jopts))
    for f in ("eflag", "newton_iters", "prox_iters"):
        assert int(getattr(ct, f)) == int(getattr(cj, f)), f
    for f in ("z", "l", "v", "y"):
        got = getattr(xt, f)
        assert got.shape == (getattr(xj, f).shape[0],)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(xj, f)),
                                   atol=1e-10, err_msg=f)
    xg, cg = fbstab_solve(tdense.DENSE_OPS, data, *guesses,
                          torch_options(jopts))
    assert torch.equal(xg.z, xt.z) and int(cg.newton_iters) == \
        int(ct.newton_iters)
    with pytest.raises(ValueError, match="batch of one"):
        fbstab_solve(tdense.DENSE_OPS, tmpc.MpcQPData(*(
            a.expand(2, *a.shape[1:]) for a in torch_data(
                plant_arrays("double_integrator", 2, 1), F64))), *guesses,
            Options())


@pytest.mark.parametrize("kind", ["mpc", "dense"])
def test_equilibrate_matches_reference(kind):
    """equilibrate_mpc / equilibrate_dense (batched) equal the JAX
    package's per-instance ones under vmap, bit for bit in float32 (the
    diagonals are powers of two there; XLA's float64 exp2 is not exact,
    so JAX's float64 diagonals miss powers of two by an ulp)."""
    if kind == "mpc":
        arrays = plant_arrays("servo_motor", 3, 2, x0s=[[0.1, 0.0, 0.2,
                                                         0.0],
                                                        [0.0, 0.3, 0.0,
                                                         -0.1]])
        jd = jax_data(arrays, jnp.float32)
        jdata, js = jax.jit(jax.vmap(jscal.equilibrate_mpc))(jd)
        tdata, ts = tscal.equilibrate_mpc(torch_data(arrays, F32))
    else:
        arrays = {k: np.repeat(a, 2, 0) for k, a in
                  _dense_test_diff().items()}
        arrays["f"][1] *= 7.0
        jd = jdense.DenseQPData(**{k: jnp.asarray(a, jnp.float32)
                                   for k, a in arrays.items()})
        jdata, js = jax.jit(jax.vmap(jscal.equilibrate_dense))(jd)
        tdata, ts = tscal.equilibrate_dense(torch_dense_data(arrays, F32))
    for got, want in zip(list(tdata) + list(ts), list(jdata) + list(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _raw_f32(arrays):
    """The port's raw float32 product solve (refine_steps = 0), its data,
    Options.single_precision() and the solution."""
    opts = Options.single_precision()
    data = torch_data(arrays, F32)
    N1 = data.Q.shape[1]
    nx, nu, nc = data.Q.shape[-1], data.R.shape[-1], data.E.shape[-2]
    B = data.x0.shape[0]
    z = lambda n: torch.zeros(B, N1 * n, dtype=F32)
    x, core = tmpc.solve_mpc_qp_batch(
        data, z(nx + nu), z(nx), z(nc),
        dataclasses.replace(opts, refine_steps=0))
    assert bool((core.eflag == int(ExitFlag.SUCCESS)).all())
    return data, opts, x


def test_refine_mpc_batch_matches_reference(monkeypatch):
    """refine_mpc_batch against the JAX package's on the same float32
    point (the port's raw solve of the double integrator, two lanes): the
    entry residual to float32 rounding of its final sum, then an
    unrolled step whose residual falls as the reference's does, to within
    float32 rounding of the correction solve."""
    monkeypatch.setattr(jmpc, "PALLAS_MODE", "off")
    jmpc._make_fused_step.cache_clear()
    arrays = plant_arrays("double_integrator", 2, 2)
    arrays["x0"][1] *= 0.5
    data, opts, x = _raw_f32(arrays)
    refined, hist = tref.refine_mpc_batch(data, x, opts, steps=1)
    jd = jax_data(arrays, jnp.float32)
    jx = JaxVariable(*(jnp.asarray(a.numpy()) for a in x))
    jrefined, jhist = jax.jit(lambda d, xx: jref.refine_mpc_batch(
        d, xx, JaxOptions.single_precision(), steps=1))(jd, jx)
    jhist = np.asarray(jhist)
    assert tuple(hist.shape) == jhist.shape == (2, 2)
    np.testing.assert_allclose(hist[0].numpy(), jhist[0], rtol=1e-6)
    assert np.all(hist[-1].numpy() <= np.maximum(4 * jhist[-1], 1e-9))
    assert np.all(hist[-1].numpy() < hist[0].numpy())
    got = refined.to_float64().z.numpy()
    want = (np.asarray(jrefined.z[0], np.float64)
            + np.asarray(jrefined.z[1], np.float64))
    np.testing.assert_allclose(got, want, atol=1e-6)


# tests/test_contract.py:126-131's per-plant (sigma, steps) of the unrolled
# refinement on the equilibrated problem, at the plant's own horizon.
@pytest.mark.parametrize("plant,horizon,sigma,steps", [
    ("double_integrator", 20, 1e-4, 8),
    ("servo_motor", 25, 1e-4, 8),
])
def test_unrolled_refine_pins_contract(plant, horizon, sigma, steps):
    """The raw float32 solve polished by refine_mpc_batch in equilibrated
    coordinates meets 3e-6 in float64 on the host (the reference's own
    instance, nominal x0)."""
    arrays = plant_arrays(plant, horizon, 1)
    data, opts, x = _raw_f32(arrays)
    sdata, scal = tscal.equilibrate_mpc(data)
    refined_s, hist = tref.refine_mpc_batch(
        sdata, tscal.scale_mpc_variable(x, scal),
        dataclasses.replace(opts, sigma0=sigma), steps=steps)
    assert tuple(hist.shape) == (steps + 1, 1)
    sol = tscal.unscale_mpc_variable_df(refined_s, scal)
    res64 = mpc_f64_residual(data, sol, opts.alpha)
    assert np.all(res64 <= 3e-6), res64


def test_double_integrator_quadprog_oracle():
    """N = 2 double integrator against the MATLAB quadprog oracle
    (tests/test_mpc_solve.py:187-205, fbstab_mpc_unit_tests.cc:37-47),
    componentwise to 1e-8, through the port's FBstabMpc."""
    data = torch_data(plant_arrays("double_integrator", 2, 1), F64)
    solver = tmpc.FBstabMpc(2, 2, 1, 6, device="cpu")
    solver.update_options(Options(abs_tol=1e-8))
    x, out = solver.solve(data)
    assert int(out.eflag) == ExitFlag.SUCCESS
    assert float(out.residual) <= 1e-6
    zopt = np.array([
        -5.31028204670497e-14, 5.02854354118183e-13, 0.311688311338095,
        5.35637944798588e-13, 0.311688311339015, -0.0779220779990502,
        0.311688311339667, 0.233766233340057, -0.103896103779874])
    lopt = np.array([
        -5.24675324688535, -4.49350649223710, -3.55844155822323,
        -0.935064934014372, -1.48051948022526, 0.233766233996585])
    vopt = np.array([
        1.06213597221667e-13, -1.41190425869539e-21, 0, 0, 0, 0,
        -1.50393600622818e-21, -8.75144622575045e-10, 0, 0, 0, 0,
        -8.75144611157041e-10, -6.56358459377444e-10, 0, 0, 0, 0])
    np.testing.assert_allclose(x.z[0].numpy(), zopt, atol=1e-8)
    np.testing.assert_allclose(x.l[0].numpy(), lopt, atol=1e-8)
    np.testing.assert_allclose(x.v[0].numpy(), vopt, atol=1e-8)


def test_mpc_fuzz_parity():
    """tests/test_fuzz_parity.py's MPC fuzz batch (B = 40, N = 5, five
    classes of lane) through the port's batched solve against the JAX
    package's, under that file's parity contract (_assert_parity) on the
    feasible, degenerate, infeasible and indefinite lanes: exit flags
    exact; Newton and proximal counts exact, iterates within 5e-8
    (relative to 1 + |x|) and residuals within rtol 1e-7 on SUCCESS
    lanes; and the port's certificates certify under the JAX package's
    check_feasibility (at 10x infeas_tol).

    The unbounded lanes (class 4: Q = R = 0, so the Newton matrix is
    sigma0 I = 1e-8 I plus the constraint terms) are chaotic across
    implementations: the Newton system there has a condition number of
    ~3e8, both Riccati recursions solve it with O(1) residuals (on lane 9,
    0.52 for JAX's and 3.9 for the port's, against 3e-15 for an LU solve)
    and JAX's own Newton counts on them move under a 1e-15 perturbation of
    the guess. There the port must report unboundedness with a valid
    certificate, or exhaust the Newton budget (MAXITERATIONS, which it
    does on lane 9, where JAX finds the certificate in 13 steps): never
    SUCCESS, never primal infeasibility."""
    data, z0, l0, v0 = _mpc_fuzz_batch(40, 5, 3, 2, 4, seed=11)
    x_ref, core_ref = jax.jit(lambda d, z, l, v: jmpc.solve_mpc_qp_batch(
        d, z, l, v, FUZZ_OPTS))(data, z0, l0, v0)
    tdata = torch_data({k: np.asarray(getattr(data, k))
                        for k in data._fields}, F64)
    tg = [torch.tensor(np.asarray(a)) for a in (z0, l0, v0)]
    xt, ct = tmpc.solve_mpc_qp_batch(tdata, *tg, torch_options(FUZZ_OPTS))

    eflag, ref_flag = ct.eflag.numpy(), np.asarray(core_ref.eflag)
    bounded = np.arange(40) % 5 != 4
    np.testing.assert_array_equal(eflag[bounded], ref_flag[bounded])
    succ = ref_flag == int(ExitFlag.SUCCESS)
    for f in ("newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy()[succ],
                                      np.asarray(getattr(core_ref, f))[succ])
    for f in ("z", "l", "v", "y"):
        a, r = getattr(xt, f).numpy()[succ], np.asarray(getattr(x_ref, f))[
            succ]
        np.testing.assert_allclose(a / (1 + np.abs(r)), r / (1 + np.abs(r)),
                                   atol=5e-8, err_msg=f)
    np.testing.assert_allclose(ct.residual.numpy()[succ],
                               np.asarray(core_ref.residual)[succ],
                               rtol=1e-7, atol=1e-10)
    feas = jax.jit(jax.vmap(lambda d, z, l, v, y: check_feasibility(
        jmpc.MPC_OPS, d, JaxVariable(z=z, l=l, v=v, y=y),
        FUZZ_OPTS.validated().infeas_tol * 10.0)))(
            data, *(jnp.asarray(a.numpy()) for a in xt))
    p_lane = np.isin(eflag, [int(ExitFlag.PRIMAL_INFEASIBLE),
                             int(ExitFlag.PRIMAL_DUAL_INFEASIBLE)])
    d_lane = np.isin(eflag, [int(ExitFlag.DUAL_INFEASIBLE),
                             int(ExitFlag.PRIMAL_DUAL_INFEASIBLE)])
    assert not np.any(np.asarray(feas.primal_feasible)[p_lane])
    assert not np.any(np.asarray(feas.dual_feasible)[d_lane])

    unb = eflag[~bounded]
    assert set(unb.tolist()) <= {int(ExitFlag.DUAL_INFEASIBLE),
                                 int(ExitFlag.MAXITERATIONS)}
    assert (unb == int(ExitFlag.DUAL_INFEASIBLE)).sum() >= 6, unb
    assert {0, 3, 6} <= set(eflag[bounded].tolist())

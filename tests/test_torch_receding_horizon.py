"""PyTorch port: the receding-horizon loop against
`fbstab_tpu.models.receding_horizon`, in float64 on the same numpy inputs
(through interop): the warmstart shift, the single-instance closed loop on
the servo motor, and the batched sweep on a small scenario-MPC batch, one
shot and adaptive. Per lane and step: equal exit flag, Newton and proximal
counts; x and u within 1e-9. Also the shifted warmstart scaled by the
hoisted Ruiz scaling as a cold guess is scaled, and the port-only checks
of tests/test_receding_horizon.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fbstab_tpu.models import receding_horizon as jrh  # noqa: E402
from fbstab_tpu.models import scaling as jsc  # noqa: E402
from fbstab_tpu.models.mpc_qp import MpcQPData  # noqa: E402
from fbstab_tpu.options import Options as JaxOptions  # noqa: E402
from torch_parity import (  # noqa: E402
    headline_arrays, jax_data, plant_arrays, torch_data, torch_options)

from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch  # noqa: E402
from fbstab_tpu_torch.core.variable import Variable  # noqa: E402
from fbstab_tpu_torch.models import ocp_fixtures as tfix  # noqa: E402
from fbstab_tpu_torch.models import receding_horizon as trh  # noqa: E402
from fbstab_tpu_torch.models.mpc_qp import (  # noqa: E402
    MPC_OPS, solve_mpc_qp_batch)
from fbstab_tpu_torch.models.scaling import (  # noqa: E402
    ruiz_mpc_scaling, scale_mpc_variable)
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.parallel.adaptive import (  # noqa: E402
    solve_mpc_qp_batch_adaptive_device)

JOPTS = JaxOptions(abs_tol=1e-8)
F64 = torch.float64


def _np(a):
    return np.asarray(a)


def _lane0(arrays):
    return {k: v[:1] for k, v in arrays.items()}


def _random_solution(arrays, seed=3):
    """A batched point (z, l, v) with the arrays' dims, Gaussian entries."""
    B = arrays["x0"].shape[0]
    N, nx = arrays["A"].shape[1], arrays["A"].shape[-1]
    nu, nc = arrays["B"].shape[-1], arrays["E"].shape[-2]
    rng = np.random.default_rng(seed)
    g = lambda n: rng.standard_normal((B, (N + 1) * n))
    return g(nx + nu), g(nx), g(nc), g(nc)


def test_shift_warmstart_matches_reference():
    arrays = headline_arrays(4, N=8, nx=3, nu=2, nc=4)
    z, l, v, y = _random_solution(arrays)
    jd = jax_data(arrays, jnp.float64)
    want = jax.vmap(jrh.shift_warmstart)(
        jrh.Variable(z=jnp.asarray(z), l=jnp.asarray(l), v=jnp.asarray(v),
                     y=jnp.asarray(y)), jd)
    t = lambda a: torch.tensor(a, dtype=F64)
    got = trh.shift_warmstart(Variable(t(z), t(l), t(v), t(y)),
                              torch_data(arrays, F64))
    for f in ("z", "l", "v", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(want, f)), rtol=0, atol=1e-12,
                                   err_msg=f)


def test_shifted_guess_scaled_by_hoisted_ruiz_as_a_cold_one():
    """solve_scaled_mpc scales any guess by the scaling it is given: the
    shifted warmstart under the Ruiz scaling computed once before the loop
    (on the shared instance, expanded over the batch) equals the JAX
    package's scaling of it under the per-lane vmapped Ruiz scaling."""
    arrays = headline_arrays(4, N=8, nx=3, nu=2, nc=4)
    shared = {k: np.broadcast_to(v[:1], v.shape).copy()
              for k, v in arrays.items() if k != "x0"}
    shared["x0"] = arrays["x0"]
    z, l, v, y = _random_solution(shared)
    jd = jax_data(shared, jnp.float64)
    jx = jax.vmap(jrh.shift_warmstart)(
        jrh.Variable(z=jnp.asarray(z), l=jnp.asarray(l), v=jnp.asarray(v),
                     y=jnp.asarray(y)), jd)
    want = jax.vmap(jsc.scale_mpc_variable)(
        jx, jax.vmap(jsc.ruiz_mpc_scaling)(jd))
    td = torch_data(shared, F64)
    t = lambda a: torch.tensor(a, dtype=F64)
    tx = trh.shift_warmstart(Variable(t(z), t(l), t(v), t(y)), td)
    one = ruiz_mpc_scaling(torch_data(_lane0(shared), F64))
    hoisted = type(one)(*(a.expand((4,) + a.shape[1:]) for a in one))
    got = scale_mpc_variable(tx, hoisted)
    for f in ("z", "l", "v", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(want, f)), rtol=1e-13,
                                   atol=1e-13, err_msg=f)


def _assert_same_loop(got, want, batched):
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)), err_msg=f)
    for f in ("x", "u"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(want, f)), rtol=0, atol=1e-9,
                                   err_msg=f)
    # At the solution the residual is roundoff (1e-10 and below), where the
    # two packages' orders of summation differ in the leading digit.
    np.testing.assert_allclose(got.residual.numpy(), _np(want.residual),
                               rtol=0, atol=1e-9)
    assert got.x.shape[:1 + batched] == _np(want.x).shape[:1 + batched]


def test_simulate_servo_matches_reference():
    arrays = plant_arrays("servo_motor", 5, 1)
    jd = MpcQPData(**{k: jnp.asarray(v[0]) for k, v in arrays.items()})
    want = jax.jit(lambda: jrh.simulate(jd, 4, JOPTS))()
    got = trh.simulate(torch_data(arrays, F64), 4, torch_options(JOPTS))
    _assert_same_loop(got, want, False)
    assert (got.eflag == 0).all()


@pytest.mark.parametrize("adaptive", [False, True])
def test_simulate_batch_matches_reference(adaptive):
    """simulate_batch on headline_arrays(B=4, N=8, nx=3, nu=2, nc=4) over
    lane 0's plant, T = 3; adaptive with a phase-1 budget of 3 and a
    phase-2 capacity of 2."""
    arrays = headline_arrays(4, N=8, nx=3, nu=2, nc=4)
    x0s = arrays["x0"]
    kw = dict(adaptive=adaptive, phase1_newton_iters=3, phase2_size=2)
    jd = MpcQPData(**{k: jnp.asarray(v[0]) for k, v in arrays.items()})
    want = jrh.simulate_batch(jd, 3, jnp.asarray(x0s), JOPTS, **kw)
    got = trh.simulate_batch(torch_data(_lane0(arrays), F64), 3,
                             torch.tensor(x0s, dtype=F64),
                             torch_options(JOPTS), **kw)
    assert got.x.shape == (4, 4, 3) and got.u.shape == (4, 3, 2)
    _assert_same_loop(got, want, True)
    if adaptive:
        assert int(_np(want.newton_iters)[:, 0].max()) > 3   # phase 2 ran


def test_shift_preserves_margin_identity():
    data, _ = tfix.double_integrator(6, device="cpu")
    x, _ = fbstab_solve_batch(MPC_OPS, data, torch.zeros(1, 7 * 3, dtype=F64),
                              torch.zeros(1, 7 * 2, dtype=F64),
                              torch.zeros(1, 7 * 6, dtype=F64),
                              Options(abs_tol=1e-8))
    shifted = trh.shift_warmstart(x, data)
    y = MPC_OPS.b_vec(data) - MPC_OPS.gemvA(data, shifted.z)
    np.testing.assert_allclose(shifted.y.numpy(), y.numpy(), atol=1e-14)
    zs, ss = x.z.reshape(7, 3), shifted.z.reshape(7, 3)
    np.testing.assert_array_equal(ss[:-1].numpy(), zs[1:].numpy())
    np.testing.assert_array_equal(ss[-1].numpy(), zs[-1].numpy())


def test_warmstart_reduces_iterations():
    data, _ = tfix.double_integrator(8, device="cpu")
    res = trh.simulate(data, 10, Options(abs_tol=1e-8),
                       x0=torch.tensor([1.5, 0.0], dtype=F64))
    newtons = res.newton_iters.numpy()
    assert (res.eflag == 0).all()
    assert newtons[-1] <= newtons[0]
    assert newtons[1:].mean() <= newtons[0]


def _hoisted_scaling_case(**adaptive):
    """simulate_batch on the float32 product path against the same loop
    with every step's solve computing its own scaling; returns the sweep
    and its batch and x0s."""
    arrays = headline_arrays(3, N=6, nx=3, nu=2, nc=4)
    opts = Options.single_precision()
    shared = torch_data(_lane0(arrays), torch.float32)
    x0s = torch.tensor(arrays["x0"], dtype=torch.float32)
    got = trh.simulate_batch(shared, 2, x0s, opts, **adaptive)
    batch = type(shared)(*(a.expand((3,) + a.shape[1:]) for a in shared))
    guess = [torch.zeros(3, n) for n in (7 * 5, 7 * 3, 7 * 4)]
    xk = x0s
    for t in range(2):
        d = batch._replace(x0=xk)
        if adaptive:
            sol, core = solve_mpc_qp_batch_adaptive_device(
                d, *guess, opts, phase1_newton_iters=adaptive[
                    "phase1_newton_iters"],
                phase2_size=adaptive["phase2_size"])
        else:
            sol, core = solve_mpc_qp_batch(d, *guess, opts)
        sol = sol.hi()
        u = sol.z.reshape(3, 7, 5)[:, 0, 3:]
        np.testing.assert_array_equal(got.u[:, t].numpy(), u.numpy())
        np.testing.assert_array_equal(got.newton_iters[:, t].numpy(),
                                      core.newton_iters.numpy())
        np.testing.assert_array_equal(got.residual[:, t].numpy(),
                                      core.residual.numpy())
        xk = trh._plant_step(shared, xk, u)
        nxt = trh.shift_warmstart(sol, d)
        guess = [nxt.z, nxt.l, nxt.v]
    assert (got.eflag == 0).all() and (got.residual <= 1e-6).all()
    return got, batch, x0s, opts


def test_simulate_batch_float32_hoisted_scaling_equals_per_step():
    """The float32 product path (equilibration and refinement engaged): a
    sweep whose Ruiz scaling is computed once equals, bit for bit, the same
    loop with every step computing its own scaling (Ruiz does not read
    x0), and every step meets the 1e-6 contract."""
    _, batch, x0s, opts = _hoisted_scaling_case()
    with pytest.raises(ValueError, match="batch of one"):
        trh.simulate_batch(batch, 1, x0s, opts)


def test_simulate_batch_float32_adaptive_hoisted_scaling_equals_per_step():
    """The same through the adaptive dispatch, at a phase-1 budget and a
    phase-2 capacity small enough that stragglers are gathered (the
    hoisted scaling taken lane by lane) and the capacity fallback fires:
    bit for bit the per-step adaptive solves that compute their own
    scaling."""
    got, _, _, _ = _hoisted_scaling_case(adaptive=True,
                                         phase1_newton_iters=3,
                                         phase2_size=2)
    assert (got.newton_iters[:, 0] > 3).any()

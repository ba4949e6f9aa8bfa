"""PyTorch port: the differentiable layer (fbstab_tpu_torch/diff.py) held
against fbstab_tpu/diff.py in float64 on the problems of
tests/test_diff.py: gradients of solve_dense_qp_diff, solve_mpc_qp_diff
and solve_mpc_qp_batch_diff against jax.grad on every data field, the
feedback gain against JAX and central differences, plus the port's own
finite-difference, forward-mode and robustness checks. Each JAX reference
is jitted once, in a module fixture.

The gradients are held against jax.grad (each package's own solve, JAX's
under jit) to rtol 1e-6, atol 1e-8 at sigma_vjp = SIGMA_PARITY. At the
default sigma_vjp = 1e-9 that tolerance lies below the float64 floor of
the implicit backward: the Newton matrix carries Gamma = gamma / mus ~
1 / sigma_vjp = 1e9 on active rows, so one ulp of Gamma moves a gradient
by ~1e-7. The JAX package disagrees with itself there: jax.grad eager
against jitted differs by 3.5e-7 on the dense problem's b (largest
gradient 0.39) and 5.7e-7 on the MPC problem's E (largest 41); the port,
given JAX's own x*, by 3.1e-8 and 3.4e-7. So at the default the dense
gradients are held to rtol 1e-6 and GRAD_FLOOR times the field's largest
gradient."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fbstab_tpu import Options as JaxOptions  # noqa: E402
from fbstab_tpu import diff as jdiff  # noqa: E402
from fbstab_tpu.models.dense_qp import DenseQPData as JaxDense  # noqa: E402
from fbstab_tpu.models.mpc_qp import MpcQPData as JaxMpc  # noqa: E402
from test_mpc_solve import random_mpc  # noqa: E402
from torch_parity import (  # noqa: E402
    plant_arrays, torch_data, torch_dense_data, torch_options)

from fbstab_tpu_torch import diff as tdiff  # noqa: E402
from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch  # noqa: E402
from fbstab_tpu_torch.models.dense_qp import DENSE_OPS  # noqa: E402
from fbstab_tpu_torch.models.mpc_qp import (  # noqa: E402
    MPC_OPS, solve_mpc_qp, solve_mpc_qp_batch)
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402

JOPTS = JaxOptions(abs_tol=1e-11)       # tests/test_diff.py's OPTS
OPTS = torch_options(JOPTS)
RTOL, ATOL = 1e-6, 1e-8
GRAD_FLOOR = 1e-5
SIGMA_PARITY = 1e-6
EPS = 1e-6
F64 = torch.float64
DENSE_FIELDS = ("H", "f", "G", "h", "A", "b")
MPC_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "c", "E", "L", "d", "x0")
N, NX, NU, NC = 4, 3, 2, 4
NZ, NL, NV = (N + 1) * (NX + NU), (N + 1) * NX, (N + 1) * NC


def _dense_arrays(seed=0, nz=5, nl=2, nv=4):
    """tests/test_diff.py's _dense_problem, as a batch of one."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((nz, nz))
    H = M @ M.T + 0.5 * np.eye(nz)
    f = rng.standard_normal(nz)
    G = rng.standard_normal((nl, nz))
    h = rng.standard_normal(nl) * 0.2
    A = rng.standard_normal((nv, nz))
    b = rng.standard_normal(nv) * 0.5 + 1.0
    return {k: a[None] for k, a in zip(DENSE_FIELDS, (H, f, G, h, A, b))}


@functools.lru_cache(maxsize=None)
def _random_mpc(key):
    """tests/test_mpc_solve.py's random_mpc(key) at N=4, nx=3, nu=2, nc=4,
    jitted (eagerly each call compiles its random ops anew)."""
    d = jax.jit(random_mpc, static_argnums=(1, 2, 3, 4))(
        jax.random.key(key), N, NX, NU, NC)
    return {k: np.asarray(getattr(d, k)) for k in MPC_FIELDS}


def _mpc_arrays(key, B=None):
    """_random_mpc(key) as a batch of one, or of B lanes with q scaled per
    lane as tests/test_diff.py's batch test does."""
    arrays = {k: a[None] for k, a in _random_mpc(key).items()}
    if B is not None:
        arrays = {k: np.repeat(a, B, 0) for k, a in arrays.items()}
        arrays["q"] = arrays["q"] * np.asarray([1.0, 1.05, 0.95])[:, None,
                                                                 None]
    return arrays


def _zeros(*ns, lead=()):
    return tuple(torch.zeros(*lead, n, dtype=F64) for n in ns)


def _dense_loss(z, l, v, xp=torch):
    w = xp.arange(1.0, v.shape[-1] + 1.0)
    return 0.5 * (z * z).sum() + l.sum() + (v * w).sum()


def _mpc_loss(z, l, v):
    return 0.5 * (z * z).sum() + 0.1 * l.sum()


def _port_grads(solve, data, guesses, loss):
    """{field: gradient} of loss(solve(data, *guesses)) for every field of
    the port's (batched) data, through torch.autograd."""
    fields = [a.clone().requires_grad_() for a in data]
    z, l, v = solve(type(data)(*fields), *guesses)
    loss(z, l, v).backward()
    return {k: f.grad for k, f in zip(data._fields, fields)}


def _assert_grads(port, ref, lane=None, floor=None):
    for k, want in ref.items():
        got = port[k].numpy() if lane is None else port[k][lane].numpy()
        assert np.all(np.isfinite(got)), k
        atol = ATOL if floor is None else floor * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=k)


def _jax_grad(solve, loss, data, fields):
    """({field: jax.grad}, JAX's (z, l, v)) of loss(solve(data)), one jit
    for both."""
    def f(d):
        out = solve(d)
        return loss(*out), out
    g, out = jax.jit(jax.grad(f, has_aux=True))(data)
    return ({k: np.asarray(getattr(g, k)) for k in fields},
            tuple(np.asarray(a) for a in out))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's gradients and solutions on the test_diff problems
    at SIGMA_PARITY (and the dense one at the default sigma_vjp), and its
    feedback gain; each jitted once."""
    refs = {}
    da = _dense_arrays()
    jd = JaxDense(**{k: jnp.asarray(a[0]) for k, a in da.items()})
    dz = (jnp.zeros(5), jnp.zeros(2), jnp.zeros(4))
    dloss = lambda z, l, v: _dense_loss(z, l, v, xp=jnp)
    for sig in (SIGMA_PARITY, None):
        refs["dense", sig] = _jax_grad(
            lambda d: jdiff.solve_dense_qp_diff(d, *dz, JOPTS, sig), dloss,
            jd, DENSE_FIELDS)

    # One compile serves the MPC case and every lane of the batch case:
    # the loss 0.5 |z|^2 + w sum(l) takes w as an argument.
    mz = (jnp.zeros(NZ), jnp.zeros(NL), jnp.zeros(NV))

    def f(d, w):
        out = jdiff.solve_mpc_qp_diff(d, *mz, JOPTS, SIGMA_PARITY)
        return 0.5 * jnp.sum(out[0] ** 2) + w * jnp.sum(out[1]), out
    mpc_grad = jax.jit(jax.grad(f, has_aux=True))

    def mpc_ref(arrays, w):
        lanes = [mpc_grad(JaxMpc(**{k: jnp.asarray(a[b])
                                    for k, a in arrays.items()}), w)
                 for b in range(arrays["x0"].shape[0])]
        stack = lambda xs: np.stack([np.asarray(a) for a in xs])
        return ({k: stack([getattr(g, k) for g, _ in lanes])
                 for k in MPC_FIELDS},
                tuple(stack([o[i] for _, o in lanes]) for i in range(3)))

    refs["mpc", SIGMA_PARITY] = mpc_ref(_mpc_arrays(7), 0.1)
    refs["mpc_batch", SIGMA_PARITY] = mpc_ref(_mpc_arrays(9, B=3), 0.0)

    jk = JaxMpc(**{k: jnp.asarray(a) for k, a in _random_mpc(13).items()})
    refs["gain"] = np.asarray(jax.jit(
        lambda d: jdiff.mpc_feedback_gain(d, JOPTS))(jk))
    return refs


def _dense_case():
    data = torch_dense_data(_dense_arrays(), F64)
    return data, _zeros(5, 2, 4)


def _mpc_case(key=7):
    return torch_data(_mpc_arrays(key), F64), _zeros(NZ, NL, NV)


def _batch_case():
    return torch_data(_mpc_arrays(9, B=3), F64), _zeros(NZ, NL, NV,
                                                        lead=(3,))


def _batch_loss(z, l, v):
    return 0.5 * (z * z).sum()


# case -> (data, guesses, solve(data, z0, l0, v0, sigma_vjp=None), loss)
PORT = {
    "dense": lambda: (*_dense_case(), lambda d, z, l, v, s=None:
                      tdiff.solve_dense_qp_diff(d, z, l, v, OPTS, s),
                      _dense_loss),
    "mpc": lambda: (*_mpc_case(), lambda d, z, l, v, s=None:
                    tdiff.solve_mpc_qp_diff(d, z, l, v, OPTS, s), _mpc_loss),
    "mpc_batch": lambda: (*_batch_case(), lambda d, z, l, v, s=None:
                          tdiff.solve_mpc_qp_batch_diff(d, z, l, v, OPTS, s),
                          _batch_loss),
}


def _assert_end_to_end(jax_refs, case, sigma, floor=None):
    data, guesses, solve, loss = PORT[case]()
    ref, jx = jax_refs[case, sigma]
    fields = [a.clone().requires_grad_() for a in data]
    out = solve(type(data)(*fields), *guesses, sigma)
    for got, want in zip(out, jx):
        np.testing.assert_allclose(got.detach().numpy().reshape(want.shape),
                                   want, atol=1e-10)
    loss(*out).backward()
    port = {k: f.grad for k, f in zip(data._fields, fields)}
    k0 = next(iter(ref))
    batched = ref[k0].shape == tuple(port[k0].shape)
    _assert_grads(port, ref, lane=None if batched else 0, floor=floor)


@pytest.mark.parametrize("case", sorted(PORT))
def test_gradients_match_jax(jax_refs, case):
    """Through each package's own solve at sigma_vjp = SIGMA_PARITY: the
    solutions agree to 1e-10 and every data field's gradient equals
    jax.grad's to rtol 1e-6, atol 1e-8. The batch case's reference is
    jax.grad of solve_mpc_qp_diff lane by lane (one compile for both MPC
    cases): tests/test_diff.py holds the JAX package's batched gradient
    equal to it (test_batch_diff_matches_per_instance_diff)."""
    _assert_end_to_end(jax_refs, case, SIGMA_PARITY)


def test_gradients_match_jax_at_default_sigma(jax_refs):
    """At the default sigma_vjp = 1e-9 the dense gradients agree to
    rtol 1e-6 within the float64 floor of the backward there (GRAD_FLOOR
    times the field's largest gradient, module docstring)."""
    _assert_end_to_end(jax_refs, "dense", None, floor=GRAD_FLOOR)


@pytest.mark.parametrize("case", sorted(PORT))
def test_every_field_gets_a_gradient(case):
    """The data's fields are flattened into the autograd Function: each
    one gets a gradient tensor of its own shape (none silently None), and
    the warmstart gets none."""
    data, guesses, solve, loss = PORT[case]()
    fields = [a.clone().requires_grad_() for a in data]
    g0 = [g.clone().requires_grad_() for g in guesses]
    z, l, v = solve(type(data)(*fields), *g0)
    loss(z, l, v).backward()
    for name, f in zip(data._fields, fields):
        if f.numel() == 0:
            continue
        assert f.grad is not None, name
        assert f.grad.shape == f.shape, name
        assert bool(torch.isfinite(f.grad).all()), name
        assert float(f.grad.abs().max()) > 0.0, name
    assert all(g.grad is None for g in g0)


def _fd_check(ops, solve, loss, data, guesses, fields, rng, probes,
              rtol=5e-4, atol=1e-4):
    """tests/test_diff.py's central-difference check on the port: the
    autograd gradient of loss(solve(data)) against (loss(+EPS) -
    loss(-EPS)) / (2 EPS) at `probes` random entries of each field. The
    perturbed instances are lanes of one batched solve of the core (lanes
    are independent, so each is its own instance's solve)."""
    leaves = [a.clone().requires_grad_() for a in data]
    loss(*solve(type(data)(*leaves), *guesses)).backward()
    grads = dict(zip(data._fields, (a.grad for a in leaves)))
    picks = [(f, tuple(int(rng.integers(0, n)) for n in
                       getattr(data, f).shape[1:]))
             for f in fields for _ in range(probes)]
    lanes = 2 * len(picks)
    batch = {f: getattr(data, f).expand(lanes, *getattr(data, f).shape[1:])
             .clone() for f in data._fields}
    for k, (f, idx) in enumerate(picks):
        batch[f][(2 * k,) + idx] += EPS
        batch[f][(2 * k + 1,) + idx] -= EPS
    x, _ = fbstab_solve_batch(ops, type(data)(**batch), *(
        g[None].expand(lanes, -1) for g in guesses), OPTS)
    lane_loss = [float(loss(*(a[i:i + 1] for a in (x.z, x.l, x.v))))
                 for i in range(lanes)]
    for k, (field, idx) in enumerate(picks):
        fdv = (lane_loss[2 * k] - lane_loss[2 * k + 1]) / (2 * EPS)
        av = float(grads[field][(0,) + idx])
        adiff = abs(av - fdv)
        err = adiff / max(1e-6, abs(av), abs(fdv))
        assert err < rtol or adiff < atol, (
            f"grad mismatch {field}{idx}: ad={av} fd={fdv} rel={err}")


@pytest.mark.parametrize("case", ["dense", "mpc"])
def test_gradients_match_finite_differences(case):
    """The port's gradients against central differences of its own solve
    (tests/test_diff.py:72-91 and :94-119: three probes of every dense
    field, one of every MPC field)."""
    data, guesses, solve, loss = PORT[case]()
    dense = case == "dense"
    _fd_check(DENSE_OPS if dense else MPC_OPS, solve, loss, data, guesses,
              DENSE_FIELDS if dense else MPC_FIELDS,
              np.random.default_rng(1 if dense else 2),
              probes=3 if dense else 1)


def test_out_of_range_alpha_gradients_consistent():
    """The solve saturates alpha = 1.5; the backward Newton matrix uses
    the same saturated alpha (tests/test_diff.py:232)."""
    data, guesses = _dense_case()

    def grad_b(opts):
        return _port_grads(
            lambda d, *g: tdiff.solve_dense_qp_diff(d, *g, opts), data,
            guesses, lambda z, l, v: 0.5 * (z * z).sum() + v.sum())["b"]

    bad = Options(abs_tol=1e-11, alpha=1.5)
    sat = Options(abs_tol=1e-11, alpha=bad.validated().alpha)
    np.testing.assert_allclose(grad_b(bad).numpy(), grad_b(sat).numpy(),
                               atol=1e-9)


def test_jacfwd_matches_jacrev():
    """Forward mode (make_jvp_solver, through torch.func.jvp one column at
    a time) and reverse mode (torch.autograd.functional.jacobian) agree on
    the Jacobian d z*/d f (tests/test_diff.py:251)."""
    data, guesses = _dense_case()
    fwd = tdiff.make_jvp_solver(DENSE_OPS, OPTS, 1e-9)

    def z_fwd(fv):
        return fwd(data._replace(f=fv[None]), *guesses)[0]

    def z_rev(fv):
        return tdiff.solve_dense_qp_diff(data._replace(f=fv[None]),
                                         *guesses, OPTS, 1e-9)[0]

    f0 = data.f[0]
    eye = torch.eye(f0.shape[0], dtype=F64)
    Jf = torch.stack([torch.func.jvp(z_fwd, (f0,), (eye[j],))[1]
                      for j in range(f0.shape[0])], 1)
    Jr = torch.autograd.functional.jacobian(z_rev, f0)
    np.testing.assert_allclose(Jf.numpy(), Jr.numpy(), atol=1e-8)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(z_fwd(fwAD.make_dual(f0, eye[1]))).tangent
    np.testing.assert_allclose(tangent.numpy(), Jr[:, 1].numpy(), atol=1e-8)


def test_feedback_gain_matches_jax_and_finite_differences(jax_refs):
    """K = d u0*/d x0 (nu, nx) against the JAX package's (jacfwd) and
    central differences of solve_mpc_qp (tests/test_diff.py:274)."""
    data, guesses = _mpc_case(13)
    K = tdiff.mpc_feedback_gain(data, OPTS)
    assert tuple(K.shape) == (NU, NX)
    np.testing.assert_allclose(K.numpy(), jax_refs["gain"], rtol=RTOL,
                               atol=ATOL)

    def u0(x0):
        x, core = solve_mpc_qp(data._replace(x0=x0[None]), *guesses, OPTS)
        assert int(core.eflag) == ExitFlag.SUCCESS
        return x.z[NX:NX + NU]

    x0 = data.x0[0]
    for j in range(NX):
        e = torch.zeros(NX, dtype=F64)
        e[j] = EPS
        fd = (u0(x0 + e) - u0(x0 - e)) / (2 * EPS)
        np.testing.assert_allclose(K[:, j].numpy(), fd.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_feedback_gain_takes_one_newton_step_for_its_tangents():
    """The nx tangents are nx lanes of one batched Newton step (one K1
    launch on the card), where the JAX package takes jacfwd: counted here
    through the core's solve and the step's dispatch."""
    from fbstab_tpu_torch.models import mpc_qp
    data, _ = _mpc_case(13)
    calls = []
    real = mpc_qp.mpc_newton_step

    def counting(*a):
        calls.append(a[1].shape[0])
        return real(*a)

    ops = MPC_OPS._replace(newton_step=mpc_qp._newton_step_op(counting))
    orig = mpc_qp.MPC_OPS
    try:
        mpc_qp.MPC_OPS = ops
        tdiff.mpc_feedback_gain(data, OPTS)
    finally:
        mpc_qp.MPC_OPS = orig
    # The solve's steps take one lane, the tangents one step of nx lanes.
    assert calls[-1] == NX and calls[:-1] and set(calls[:-1]) == {1}


def test_batch_backward_is_one_newton_step():
    """solve_mpc_qp_batch_diff's backward pass is one batched Newton step
    of the class (one K1 launch on the card in float32), and the makers
    keep one autograd Function per (ops, options, sigma)."""
    data, guesses = _batch_case()
    calls = []

    def counting(*a):
        calls.append(a[1].z.shape[0])
        return MPC_OPS.newton_step(*a)

    ops = MPC_OPS._replace(newton_step=counting)
    solve = tdiff.make_differentiable_batch_solver(
        ops, solve_mpc_qp_batch, OPTS, 1e-9)
    assert solve is tdiff.make_differentiable_batch_solver(
        ops, solve_mpc_qp_batch, OPTS, 1e-9)
    port = _port_grads(solve, data, guesses, _batch_loss)
    assert calls == [3]
    ref = _port_grads(lambda d, *g: tdiff.solve_mpc_qp_batch_diff(
        d, *g, OPTS), data, guesses, _batch_loss)
    for k in MPC_FIELDS:
        torch.testing.assert_close(port[k], ref[k], rtol=0, atol=0)


def test_degenerate_fixture_gradients_finite():
    """The double integrator sits on its feasibility boundary: the
    gradient is a subgradient and must stay finite
    (tests/test_diff.py:335)."""
    arrays = plant_arrays("double_integrator", 8, 1)
    data = torch_data(arrays, F64)
    N1 = 9
    guesses = _zeros(N1 * 3, N1 * 2, N1 * 6)
    port = _port_grads(lambda d, *g: tdiff.solve_mpc_qp_diff(d, *g, OPTS),
                       data, guesses, lambda z, l, v: 0.5 * (z * z).sum())
    for k, g in port.items():
        assert bool(torch.isfinite(g).all()), k


def test_f32_gradients_close_to_f64():
    """The float32 profile (sigma_vjp = 1e-5 by default) gives gradients
    within rtol 5e-3, atol 5e-4 of the float64 ones
    (tests/test_diff.py:306-332)."""
    arrays = _dense_arrays()
    loss = lambda z, l, v: 0.5 * (z * z).sum()
    g64 = _port_grads(lambda d, *g: tdiff.solve_dense_qp_diff(d, *g, OPTS),
                      torch_dense_data(arrays, F64), _zeros(5, 2, 4), loss)
    opts32 = Options(abs_tol=1e-6, sigma0=1e-6)
    g32 = _port_grads(
        lambda d, *g: tdiff.solve_dense_qp_diff(d, *g, opts32),
        torch_dense_data(arrays, torch.float32),
        tuple(torch.zeros(n) for n in (5, 2, 4)), loss)
    for k in DENSE_FIELDS:
        assert g32[k].dtype == torch.float32
        assert bool(torch.isfinite(g32[k]).all())
        np.testing.assert_allclose(g32[k].numpy(), g64[k].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=k)


def test_default_sigma_by_dtype():
    assert tdiff._default_sig(None, torch.float32) == 1e-5
    assert tdiff._default_sig(None, F64) == 1e-9
    assert tdiff._default_sig(3e-7, torch.float32) == 3e-7


def test_options_are_hashable_for_the_makers_cache():
    """The makers are lru_cached on (ops, options, sigma): the port's
    Options is a frozen dataclass, so equal options hit one entry."""
    a = tdiff.make_differentiable_solver(DENSE_OPS, Options(abs_tol=1e-9))
    b = tdiff.make_differentiable_solver(
        DENSE_OPS, dataclasses.replace(Options(), abs_tol=1e-9))
    assert a is b

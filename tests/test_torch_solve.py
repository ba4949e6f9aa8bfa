"""PyTorch port: the batched lockstep solver (the plain version of the
fused kernel K2) against `fbstab_tpu.solve_mpc_qp_batch` in float64 on the
mixed feasible/infeasible batch of tests/test_fused_solve.py: the same exit
flag, Newton and proximal iteration counts per lane, iterates within 1e-9.
The CUDA kernel itself is compared with the plain version on the card
(marked `cuda`); JAX is imported inside the parity tests only, so the
`cuda` test also runs where JAX is not installed (README)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    dims, headline_arrays, jax_data, mixed_batch, plant_arrays, require_cuda,
    torch_data, torch_options)

from fbstab_tpu_torch.models import dense_qp as td_  # noqa: E402
from fbstab_tpu_torch.models import mpc_qp as tm  # noqa: E402
from fbstab_tpu_torch.models import ocp_fixtures  # noqa: E402
from fbstab_tpu_torch.models.scaling import (  # noqa: E402
    apply_mpc_scaling, ruiz_mpc_scaling)
from fbstab_tpu_torch.ops import mpc_solve_cuda  # noqa: E402
from fbstab_tpu_torch.options import Display, Options  # noqa: E402


def _jax_options(profile):
    from fbstab_tpu.options import Options as JaxOptions
    if profile == "single_precision":
        return JaxOptions.single_precision()
    return JaxOptions(abs_tol=1e-8)


def _solve_both(arrays, jopts):
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.models.mpc_qp import solve_mpc_qp_batch as jax_solve

    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    B = arrays["x0"].shape[0]
    xr, cr = jax.jit(lambda *a: jax_solve(*a, jopts))(
        jax_data(arrays, jnp.float64), jnp.zeros((B, nz)),
        jnp.zeros((B, nl)), jnp.zeros((B, nv)))
    z = lambda n: torch.zeros(B, n, dtype=torch.float64)
    xt, ct = tm.solve_mpc_qp_batch(torch_data(arrays, torch.float64), z(nz),
                                   z(nl), z(nv), torch_options(jopts))
    return xr, cr, xt, ct


@pytest.mark.parametrize("profile", ["abs_tol_1e-8", "single_precision"])
def test_plain_solver_matches_reference_per_lane(profile):
    xr, cr, xt, ct = _solve_both(mixed_batch(), _jax_options(profile))
    assert {0, 3} <= set(np.asarray(cr.eflag).tolist())   # mixed batch
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cr, f)), err_msg=f)
    scale = 1.0 + np.abs(np.asarray(xr.v))
    np.testing.assert_allclose(xt.v.numpy() / scale,
                               np.asarray(xr.v) / scale, atol=1e-9)
    np.testing.assert_allclose(xt.z.numpy(), np.asarray(xr.z), atol=1e-9)
    np.testing.assert_allclose(ct.residual.numpy(), np.asarray(cr.residual),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ct.initial_residual.numpy(),
                               np.asarray(cr.initial_residual), rtol=1e-12)


def test_plain_solver_matches_reference_on_servo():
    """A badly scaled plant (cost spread 1e7) at the default sigma0; the
    second lane's initial state is infeasible (a certificate lane)."""
    arrays = plant_arrays("servo_motor", 10, 2,
                          x0s=[[0.0, 0.0, 0.0, 0.0], [0.1, 0.0, 0.0, 0.0]])
    xr, cr, xt, ct = _solve_both(arrays, _jax_options("abs_tol_1e-8"))
    assert np.asarray(cr.eflag).tolist() == [0, 3]
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cr, f)), err_msg=f)
    zr = np.asarray(xr.z)
    np.testing.assert_allclose(xt.z.numpy(), zr, rtol=1e-9,
                               atol=1e-9 * (1 + np.abs(zr).max()))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    arrays = mixed_batch()
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    td = torch_data(arrays, torch.float64)
    z = lambda n: torch.zeros(8, n, dtype=torch.float64)
    opts = Options(abs_tol=1e-8)
    before = mpc_solve_cuda.fbstab_mpc_solve_fused.launches
    x1, c1 = mpc_solve_cuda.fbstab_mpc_solve_fused(td, z(nz), z(nl), z(nv),
                                                   opts)
    x2, c2 = mpc_solve_cuda.fbstab_mpc_solve_plain(td, z(nz), z(nl), z(nv),
                                                   opts)
    assert mpc_solve_cuda.fbstab_mpc_solve_fused.launches == before
    torch.testing.assert_close(x1.z, x2.z, rtol=0, atol=0)
    assert c1.eflag.tolist() == c2.eflag.tolist()


def test_facade_solves_one_instance_like_the_batch():
    arrays = plant_arrays("double_integrator", 6, 1, x0s=[[1.5, 0.3]])
    td = torch_data(arrays, torch.float64)
    solver = tm.FBstabMpc(6, 2, 1, 6, device="cpu")
    solver.update_options(Options(abs_tol=1e-8))
    x, out = solver.solve(td)
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    z = lambda n: torch.zeros(1, n, dtype=torch.float64)
    xb, cb = tm.solve_mpc_qp_batch(td, z(nz), z(nl), z(nv), solver.options)
    assert int(out.eflag) == 0 == int(cb.eflag[0])
    assert int(out.newton_iters) == int(cb.newton_iters[0])
    torch.testing.assert_close(x.z, xb.z, rtol=0, atol=0)
    assert float(out.solve_time) >= 0.0
    with pytest.raises(ValueError):
        tm.FBstabMpc(5, 2, 1, 6, device="cpu").solve(td)


def _double_integrator_pair(dtype):
    data, _ = ocp_fixtures.double_integrator(10, dtype=dtype, device="cpu")
    data = tm.batch_data(data, 2)
    N, nx, nu, nc = tm.mpc_dims(data)
    z = lambda n: torch.zeros(2, n, dtype=dtype)
    return data, (z((N + 1) * (nx + nu)), z((N + 1) * nx), z((N + 1) * nc))


def test_riccati_is_the_sixth_positional_parameter():
    """solve_mpc_qp_batch takes (data, z0, l0, v0, options, riccati,
    scaling), the JAX package's order: a positional "assoc" selects the
    associative step, bit for bit the keyword call, and not the scan."""
    data, guess = _double_integrator_pair(torch.float64)
    opts = Options(abs_tol=1e-8)
    xp, cp = tm.solve_mpc_qp_batch(data, *guess, opts, "assoc")
    xa, ca = tm.solve_mpc_qp_batch(data, *guess, opts, riccati="assoc")
    xs, _ = tm.solve_mpc_qp_batch(data, *guess, opts, riccati="scan")
    assert cp.eflag.tolist() == ca.eflag.tolist() == [0, 0]
    for a, b in zip(xp, xa):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The two steps solve the same system in another order of operations.
    assert not torch.equal(xp.z, xs.z)


def test_positional_riccati_in_float32_does_not_raise():
    """The float32 product path with a positional riccati (before the
    parameters were put in the JAX package's order, "assoc" landed in
    `scaling` there and raised)."""
    data, guess = _double_integrator_pair(torch.float32)
    x, core = tm.solve_mpc_qp_batch(data, *guess,
                                    Options.single_precision(), "assoc")
    assert core.eflag.tolist() == [0, 0]
    assert bool(torch.isfinite(x.to_float64().z).all())


@pytest.mark.parametrize("facade", ["FBstabMpc", "FBstabDense"])
def test_facade_positional_stream_reaches_the_stream_check(facade):
    """The facades' positional parameters are the JAX facades'
    ((N, nx, nu, nc, dtype, stream) and (nz, nl, nv, dtype, stream)): a
    positional stream becomes the facade's stream (set_stream replaces
    it), and `device` is keyword-only."""
    make = dict(FBstabMpc=lambda *a, **k: tm.FBstabMpc(4, 2, 1, 6, *a, **k),
                FBstabDense=lambda *a, **k: td_.FBstabDense(2, 0, 2, *a,
                                                            **k))[facade]
    sink, other = object(), object()
    solver = make(torch.float64, sink, device="cpu")
    assert solver._stream is sink
    solver.set_stream(other)
    assert solver._stream is other
    with pytest.raises(TypeError):
        make(torch.float64, None, "cpu")
    assert make(torch.float64, None, device="cpu").device.type == "cpu"


class RecordingLib:
    """Stands in for the kernel library: records each launch's arguments
    and each size query, answers the queries with `ws_floats` and
    `smem_bytes`, and reports success."""

    def __init__(self, ws_floats=11):
        self.calls, self.sizes = [], []
        self.ws_floats = ws_floats

    def _ws(self, *dims):
        self.sizes.append(("ws", dims))
        return self.ws_floats

    fb_solve_ws_floats = fb_subproblem_ws_floats = _ws

    def fb_mpc_solve(self, *args):
        self.calls.append(args)
        return 0

    def fb_mpc_subproblem(self, *args):
        self.calls.append(args)
        return 0


def test_launcher_hands_the_batch_first_tensors_to_the_kernel(monkeypatch):
    """K2 reads the data and the initial guess in place (instance-major is
    torch's batch-first layout) and writes (B, n) outputs that become the
    result: no transposed copy on either side. The mode goes to the kernel
    as an int after B."""
    from fbstab_tpu_torch.ops import _build

    arrays = headline_arrays(5, N=4)
    data = torch_data(arrays, torch.float32)
    data = type(data)(*(a.contiguous() for a in data))
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    guess = [torch.zeros(5, n) for n in (nz, nl, nv)]
    for lowmem in (False, True):
        lib = RecordingLib()
        x, core = mpc_solve_cuda.launch_mpc_solve(
            lib, data, *guess, Options.single_precision(), 7, lowmem)
        (args,) = lib.calls
        assert args[:6] == (N, nx, nu, nc, 5, int(lowmem)) and args[-1] == 7
        ins = (data.q, data.r, data.c, data.x0, data.d, data.Q, data.R,
               data.S, data.A, data.B, data.E, data.L, *guess)
        assert list(args[7:22]) == [a.data_ptr() for a in ins]
        assert list(args[22:26]) == [a.data_ptr() for a in x]
        assert [tuple(a.shape) for a in x] == [(5, nz), (5, nl), (5, nv),
                                               (5, nv)]
        assert args[26] == core.eflag.data_ptr()
        # The scratch is sized by the library's own layout function for the
        # launch in this mode.
        assert lib.sizes == [("ws", (N, nx, nu, nc, int(lowmem)))]
    assert not hasattr(mpc_solve_cuda, "to_batch_last")
    with pytest.raises(ValueError, match="instances"):
        mpc_solve_cuda.launch_mpc_solve(
            lib, data._replace(q=data.q[:4]), *guess,
            Options.single_precision(), 7)
    # Scratch beyond what the card can give raises the named error before
    # anything is allocated or launched: no fallback.
    monkeypatch.setattr(_build, "device_memory_bytes",
                        lambda dev: 4 * 5 * 11 - 1)
    big = RecordingLib()
    with pytest.raises(_build.KernelResourceError, match="scratch"):
        mpc_solve_cuda.launch_mpc_solve(big, data, *guess,
                                        Options.single_precision(), 7)
    assert big.calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["headline_equilibrated", "mixed",
                                  "headline_equilibrated_ragged"])
def test_cuda_kernel_matches_plain_version(case):
    """K2 on the card against its plain version in float32, on the
    equilibrated headline problem (B = 128, and B = 37, which leaves the
    last block of teams part empty) and on the mixed feasible / infeasible
    batch: equal exit flags, Newton counts within +-2 on at least 90% of
    lanes (float32 knife edges of the stall guard, see chip_smoke.py; the
    per-lane counts are pinned in float64 by test_torch_device_code.py), z
    within 1e-3 (1 + |z|) where both succeed."""
    require_cuda()
    dev = torch.device("cuda", 0)
    arrays = {"headline_equilibrated": lambda: headline_arrays(128),
              "headline_equilibrated_ragged": lambda: headline_arrays(37),
              "mixed": mixed_batch}[case]()
    data = torch_data(arrays, torch.float32, dev)
    if case != "mixed":
        data = apply_mpc_scaling(data, ruiz_mpc_scaling(data))
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    B = arrays["x0"].shape[0]
    z = lambda n: torch.zeros(B, n, dtype=torch.float32, device=dev)
    opts = Options.single_precision()
    before = mpc_solve_cuda.fbstab_mpc_solve_fused.launches
    xk, ck = mpc_solve_cuda.fbstab_mpc_solve_fused(data, z(nz), z(nl), z(nv),
                                                   opts)
    torch.cuda.synchronize()
    assert mpc_solve_cuda.fbstab_mpc_solve_fused.launches == before + 1
    xp, cp = mpc_solve_cuda.fbstab_mpc_solve_plain(data, z(nz), z(nl), z(nv),
                                                   opts)
    assert (ck.eflag == cp.eflag).float().mean().item() >= 0.99
    if case == "mixed":
        assert ck.eflag.tolist() == [0, 0, 3, 0, 0, 3, 0, 0]
    both = (ck.eflag == 0) & (cp.eflag == 0)
    dn = (ck.newton_iters - cp.newton_iters).abs()[both]
    assert (dn <= 2).float().mean().item() >= 0.90
    zerr = (xk.z - xp.z).abs().amax(1) / (1 + xp.z.abs().amax(1))
    assert zerr[both].max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_batch_diff_backward_is_one_k1_launch():
    """The differentiable batched MPC solve on the card in float32: the
    forward launches K2, the backward exactly one K1, and the gradient of
    every data field equals the plain Newton step's backward on the card
    (1e-3 of the field's largest entry, K1's own tolerance)."""
    require_cuda()
    from fbstab_tpu_torch.diff import (
        make_differentiable_batch_solver, solve_mpc_qp_batch_diff)
    from fbstab_tpu_torch.ops.riccati_cuda import riccati_newton_step_batched
    from fbstab_tpu_torch.workloads import build_batch, zeros_guess

    data = build_batch(64, 30, 8, 3, 6, "cuda")
    guess = zeros_guess(data)
    opts = Options.single_precision()

    def grads(solve, counted):
        fields = [a.clone().requires_grad_() for a in data]
        z, _, _ = solve(type(data)(*fields), *guess)
        torch.cuda.synchronize()
        riccati_newton_step_batched.launches = 0
        (0.5 * (z * z).sum()).backward()
        torch.cuda.synchronize()
        if counted:
            assert riccati_newton_step_batched.launches == 1
        return [f.grad for f in fields]

    before = mpc_solve_cuda.fbstab_mpc_solve_fused.launches
    got = grads(lambda d, *g: solve_mpc_qp_batch_diff(d, *g, opts), True)
    assert mpc_solve_cuda.fbstab_mpc_solve_fused.launches > before
    plain = make_differentiable_batch_solver(
        tm.MPC_PLAIN_OPS, tm.solve_mpc_qp_batch, opts, 1e-5)
    for g, p in zip(got, grads(plain, False)):
        assert bool(torch.isfinite(g).all())
        assert (g - p).abs().max().item() <= 1e-3 * (1 + p.abs().max().item())


@pytest.mark.cuda
def test_cuda_facade_float32_default_options_launches_k2():
    """FBstabMpc in float32 on the card with its own default options and no
    iteration display solves through solve_mpc_qp_batch: one instance of
    the headline batch launches K2 and returns that solve's lane 0."""
    require_cuda()
    from fbstab_tpu_torch.workloads import build_batch, zeros_guess

    data = build_batch(1, 30, 8, 3, 6, "cuda")
    solver = tm.FBstabMpc(30, 8, 3, 6, dtype=torch.float32, device="cuda")
    assert solver.options.display_level < Display.ITER
    before = mpc_solve_cuda.fbstab_mpc_solve_fused.launches
    x, out = solver.solve(data)
    torch.cuda.synchronize()
    assert mpc_solve_cuda.fbstab_mpc_solve_fused.launches > before
    xb, cb = tm.solve_mpc_qp_batch(data, *zeros_guess(data), solver.options)
    assert int(out.eflag) == int(cb.eflag[0])
    assert int(out.newton_iters) == int(cb.newton_iters[0])
    torch.testing.assert_close(x.z, xb.z, rtol=0, atol=0)

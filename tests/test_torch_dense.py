"""PyTorch port: the dense QP class. The reference's five dense oracles and
warmstart reuse (tests/test_dense_solve.py) through `FBstabDense`; the
batched lockstep solver against `fbstab_tpu.solve_dense_qp_batch` (float64,
XLA path) and K3's plain version against the JAX package's fused dense
kernel in interpret mode, on a mixed batch with a rank-deficient, a
primal-infeasible and an unbounded lane, without and with equality rows:
the same exit flag, Newton and proximal counts per lane, iterates within
1e-9. The CUDA kernel itself runs through the dispatch on the card (marked
`cuda`); JAX is imported inside the parity tests only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    dense_arrays, dense_mixed_batch, jax_dense_data, require_cuda,
    torch_dense_data)

from fbstab_tpu_torch.models import dense_qp as td  # noqa: E402
from fbstab_tpu_torch.ops import dense_solve_cuda  # noqa: E402
from fbstab_tpu_torch.options import Display, Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402


def _one(**arrays):
    """One dense instance as a batch of one on the CPU."""
    return td.dense_qp_data(**{k: np.asarray(v, float)[None]
                               for k, v in arrays.items()}, device="cpu")


def _solver(nz, nl, nv):
    s = td.FBstabDense(nz, nl, nv, device="cpu")
    s.update_options(Options(abs_tol=1e-8))
    return s


FEASIBLE = dict(H=[[3.0, 1.0], [1.0, 1.0]], f=[10.0, 5.0],
                A=[[-1.0, 0.0], [0.0, 1.0]], b=[0.0, 0.0])
DEGENERATE = dict(
    H=[[1.0, 0.0], [0.0, 0.0]], f=[1.0, 0.0],
    A=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
    b=[0.0, 3.0, 3.0, -1.0, -1.0])


@pytest.mark.parametrize("case", ["feasible", "feasible_eq", "degenerate",
                                  "infeasible", "unbounded"])
def test_reference_dense_oracles(case):
    """fbstab_dense_unit_tests.cc's five end-to-end solves at
    abs_tol = 1e-8 with their analytic answers (atol 1e-8)."""
    if case == "feasible":
        x, out = _solver(2, 0, 2).solve(_one(**FEASIBLE))
        assert int(out.eflag) == ExitFlag.SUCCESS
        np.testing.assert_allclose(x.z[0].numpy(), [0.0, -5.0], atol=1e-8)
        np.testing.assert_allclose(x.v[0].numpy(), [5.0, 0.0], atol=1e-8)
    elif case == "feasible_eq":
        data = _one(H=[[4.0, 1.0], [1.0, 2.0]], f=[1.0, 1.0],
                    G=[[1.0, 1.0]], h=[1.0],
                    A=[[-1.0, 0.0], [0.0, -1.0]], b=[0.0, 0.0])
        x, out = _solver(2, 1, 2).solve(data)
        assert int(out.eflag) == ExitFlag.SUCCESS
        np.testing.assert_allclose(x.z[0].numpy(), [0.25, 0.75], atol=1e-8)
    elif case == "degenerate":
        x, out = _solver(2, 0, 5).solve(_one(**DEGENERATE))
        assert int(out.eflag) == ExitFlag.SUCCESS
        z, v, y = (a[0].numpy() for a in (x.z, x.v, x.y))
        np.testing.assert_allclose(z[0], 1.0, atol=1e-8)
        assert 1.0 - 1e-8 <= z[1] <= 3.0 + 1e-8
        H, f, A = (np.asarray(DEGENERATE[k]) for k in ("H", "f", "A"))
        r1 = H @ z + f + A.T @ v
        assert np.linalg.norm(r1) + np.linalg.norm(np.minimum(y, v)) <= 1e-6
    elif case == "infeasible":
        data = _one(H=[[1.0, 0.0], [0.0, 0.0]], f=[1.0, -1.0],
                    A=[[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0],
                       [0.0, -1.0]], b=[0.0, 3.0, 3.0, -1.0, -1.0])
        _, out = _solver(2, 0, 5).solve(data)
        assert int(out.eflag) == ExitFlag.PRIMAL_INFEASIBLE
    else:
        data = _one(H=[[1.0, 0.0], [0.0, 0.0]], f=[1.0, -1.0],
                    A=[[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, -1.0]],
                    b=[0.0, 3.0, -1.0, -1.0])
        _, out = _solver(2, 0, 4).solve(data)
        assert int(out.eflag) == ExitFlag.DUAL_INFEASIBLE


def test_facade_warmstart_validation_and_stream():
    """Warmstarting from the solution exits at once (prox_iters == 0); a
    wrong shape names its field; a stream given to solve() receives the
    Display.FINAL summary of that call, and only with display on."""
    solver = _solver(2, 0, 2)
    data = _one(**FEASIBLE)
    x1, out1 = solver.solve(data)
    x2, out2 = solver.solve(data, x0=x1)
    assert int(out2.eflag) == ExitFlag.SUCCESS
    assert int(out2.newton_iters) <= int(out1.newton_iters)
    assert int(out2.prox_iters) == 0
    np.testing.assert_allclose(x2.z.numpy(), x1.z.numpy(), atol=1e-10)
    with pytest.raises(ValueError, match="A has shape"):
        _solver(2, 0, 3).solve(data)
    class Sink:
        def __init__(self):
            self.buf = []

        def print(self, msg):
            self.buf.append(msg)

    quiet = Sink()
    solver.solve(data, stream=quiet)
    assert quiet.buf == []
    sink = Sink()
    solver.update_options(Options(abs_tol=1e-8, display_level=Display.FINAL))
    solver.solve(data, stream=sink)
    text = "".join(sink.buf)
    assert "Optimization completed!  Exit code: Success" in text
    assert "Tolerance" in text
    assert td.FBstabDense.reliable_options() == Options.reliable()


def _check_lanes(cr, xr, ct, xt):
    """Equal flags and counts; z, l, v within 1e-9 relative to the lane's
    largest entry (an infeasibility certificate is a difference of
    iterates of ~1e8, so its roundoff scales with them)."""
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cr, f)), err_msg=f)
    ref = [np.asarray(getattr(xr, f)) for f in ("z", "l", "v")]
    scale = 1.0 + np.max(np.abs(np.concatenate(ref, 1)), 1, keepdims=True)
    for f, r in zip(("z", "l", "v"), ref):
        np.testing.assert_allclose(getattr(xt, f).numpy() / scale,
                                   r / scale, atol=1e-9, err_msg=f)


def _solve_reference(arrays, kernel):
    """JAX's float64 solve of the batch (zero guesses): its XLA lockstep
    path, or its fused kernel in interpret mode with tile_b = 4."""
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.models.dense_qp import solve_dense_qp_batch
    from fbstab_tpu.ops.dense_solve_pallas import fbstab_dense_solve_fused
    from fbstab_tpu.options import Options as JaxOptions

    data = jax_dense_data(arrays, jnp.float64)
    B, n = arrays["f"].shape
    nl, q = arrays["h"].shape[1], arrays["b"].shape[1]
    guess = (jnp.zeros((B, n)), jnp.zeros((B, nl)), jnp.zeros((B, q)))
    opts = JaxOptions(abs_tol=1e-8)
    if kernel:
        return fbstab_dense_solve_fused(data, *guess, opts, interpret=True,
                                        tile_b=4)
    return jax.jit(lambda *a: solve_dense_qp_batch(*a, opts))(data, *guess)


def _zeros(arrays):
    B, n = arrays["f"].shape
    nl, q = arrays["h"].shape[1], arrays["b"].shape[1]
    return tuple(torch.zeros(B, k, dtype=torch.float64) for k in (n, nl, q))


@pytest.mark.parametrize("nl", [0, 2])
def test_lockstep_solver_matches_reference_per_lane(nl):
    arrays = dense_mixed_batch(nl)
    xr, cr = _solve_reference(arrays, kernel=False)
    xt, ct = td.solve_dense_qp_batch(torch_dense_data(arrays, torch.float64),
                                     *_zeros(arrays), Options(abs_tol=1e-8))
    flags = set(np.asarray(cr.eflag).tolist())
    assert {0, 3, 4} <= flags            # success, infeasible, unbounded
    _check_lanes(cr, xr, ct, xt)


@pytest.mark.parametrize("nl", [0, 2])
def test_k3_plain_version_matches_jax_kernel_per_lane(nl):
    """K3's plain version against the JAX package's fused dense kernel
    (Pallas, interpret mode), lane by lane."""
    arrays = dense_mixed_batch(nl)
    xr, cr = _solve_reference(arrays, kernel=True)
    xt, ct = dense_solve_cuda.fbstab_dense_solve_plain(
        torch_dense_data(arrays, torch.float64), *_zeros(arrays),
        Options(abs_tol=1e-8))
    _check_lanes(cr, xr, ct, xt)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    arrays = dense_mixed_batch(2)
    data = torch_dense_data(arrays, torch.float64)
    opts = Options(abs_tol=1e-8)
    before = dense_solve_cuda.fbstab_dense_solve_fused.launches
    x1, c1 = dense_solve_cuda.fbstab_dense_solve_fused(data, *_zeros(arrays),
                                                       opts)
    x2, c2 = dense_solve_cuda.fbstab_dense_solve_plain(data, *_zeros(arrays),
                                                       opts)
    assert dense_solve_cuda.fbstab_dense_solve_fused.launches == before
    torch.testing.assert_close(x1.z, x2.z, rtol=0, atol=0)
    assert c1.eflag.tolist() == c2.eflag.tolist()
    assert tuple(x1.l.shape) == (8, 2)


class _RecordingLib:
    """Stands in for the kernel library: records the launch's arguments."""

    def __init__(self):
        self.calls = []

    def fb_dense_ws_floats(self, n, q, nl):
        return 11

    def fb_dense_solve(self, *args):
        self.calls.append(args)
        return 0


def test_launcher_hands_the_batch_first_tensors_uncopied():
    """K3's launcher passes the data and guesses' own pointers (K3 reads the
    batch-first tensors as torch holds them: no transposed copies), and
    the kernel writes (B, .) outputs and a (B, floats per instance)
    scratch."""
    B, n, q, nl = 3, 4, 6, 2
    data = torch_dense_data(dense_arrays(B, n, q, nl), torch.float32)
    data = type(data)(*(a.contiguous() for a in data))
    guess = [torch.zeros(B, k) for k in (n, nl, q)]
    lib = _RecordingLib()
    x, core = dense_solve_cuda.launch_dense_solve(
        lib, data, *guess, Options.single_precision(), 5)
    (args,) = lib.calls
    assert args[:4] == (n, q, nl, B) and args[-1] == 5
    assert list(args[5:14]) == [a.data_ptr() for a in (*data, *guess)]
    assert list(args[14:18]) == [a.data_ptr() for a in x]
    assert [tuple(a.shape) for a in x] == [(B, n), (B, nl), (B, q), (B, q)]
    assert not hasattr(dense_solve_cuda, "to_batch_last")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,q,nl", [(512, 32, 64, 0), (128, 16, 32, 8)])
def test_cuda_kernel_through_the_dispatch(B, n, q, nl):
    """K3, reached through solve_dense_qp_batch's dispatch on the card, at
    the bench shape and at an equality-constrained shape: float32
    single_precision solves launch it, succeed on >= 99% of lanes and meet
    1e-6 in host float64 on every SUCCESS lane (l comes back (B, nl))."""
    require_cuda()
    from fbstab_tpu_torch.workloads import dense_f64_residual
    dev = torch.device("cuda", 0)
    data = torch_dense_data(dense_arrays(B, n, q, nl), torch.float32, dev)
    guess = tuple(torch.zeros(B, k, dtype=torch.float32, device=dev)
                  for k in (n, nl, q))
    opts = Options.single_precision()
    before = dense_solve_cuda.fbstab_dense_solve_fused.launches
    x, core = td.solve_dense_qp_batch(data, *guess, opts)
    torch.cuda.synchronize()
    assert dense_solve_cuda.fbstab_dense_solve_fused.launches > before
    good = (core.eflag == 0).cpu().numpy()
    assert good.mean() >= 0.99
    assert tuple(x.l[0].shape) == (B, nl)
    res = dense_f64_residual(data, x, opts.alpha)
    assert np.all(res[good] <= 1e-6), res.max()


@pytest.mark.cuda
def test_cuda_facade_float32_default_options_launches_k3():
    """FBstabDense in float32 on the card with its own default options and
    no iteration display solves through solve_dense_qp_batch: one instance
    of the bench shape launches K3 and returns that solve's lane 0."""
    require_cuda()
    dev = torch.device("cuda", 0)
    n, q = 32, 64
    data = torch_dense_data(dense_arrays(1, n, q, 0), torch.float32, dev)
    solver = td.FBstabDense(n, 0, q, dtype=torch.float32, device="cuda")
    assert solver.options.display_level < Display.ITER
    before = dense_solve_cuda.fbstab_dense_solve_fused.launches
    x, out = solver.solve(data)
    torch.cuda.synchronize()
    assert dense_solve_cuda.fbstab_dense_solve_fused.launches > before
    guess = tuple(torch.zeros(1, k, dtype=torch.float32, device=dev)
                  for k in (n, 0, q))
    xb, cb = td.solve_dense_qp_batch(data, *guess, solver.options)
    assert int(out.eflag) == int(cb.eflag[0])
    assert int(out.newton_iters) == int(cb.newton_iters[0])
    torch.testing.assert_close(x.z, xb.z, rtol=0, atol=0)

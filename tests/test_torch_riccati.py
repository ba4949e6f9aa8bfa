"""PyTorch port: the batched MPC Newton step (kernel K1) and its plain
version, held against the JAX package's `_fused_step_impl` (the per-lane
semantics of `riccati_newton_step_batched`) in float64, with a per-lane
proximal sigma. The CUDA kernel itself is compared with the plain version
on the card (marked `cuda`); JAX is imported inside the parity tests only,
so the `cuda` tests also run where JAX is not installed (README)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    dims, headline_arrays, jax_data, launches, plant_arrays, require_cuda,
    torch_data)

from fbstab_tpu_torch.models import mpc_qp as tm  # noqa: E402
from fbstab_tpu_torch.ops import riccati_cuda  # noqa: E402
from fbstab_tpu_torch.ops.smallchol import (  # noqa: E402
    cho_solve_small, cholesky, cholesky_small)

ALPHA = 0.95


def _step_inputs(arrays, seed):
    """Random iterate pieces and residuals (numpy, float64) for one batch:
    positive margins/duals around the complementarity corner, one sigma
    per lane."""
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    B = arrays["x0"].shape[0]
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal((B, nv)))
    y = rng.standard_normal((B, nv))
    vbar = v + 0.1 * rng.standard_normal((B, nv))
    rz = rng.standard_normal((B, nz))
    rl = rng.standard_normal((B, nl))
    rv = rng.standard_normal((B, nv))
    sigma = 10.0 ** rng.uniform(-4, -1, B)
    return v, y, vbar, rz, rl, rv, sigma


CASES = [
    ("double_integrator", 8, 4),
    ("spacecraft_relative_motion", 6, 3),
    ("servo_motor", 5, 2),
]


@pytest.mark.parametrize("plant,N,B", CASES)
def test_plain_newton_step_matches_reference_f64(plant, N, B):
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.models.mpc_qp import _fused_step_impl

    arrays = plant_arrays(plant, N, B)
    ins = _step_inputs(arrays, seed=N)
    jd = jax_data(arrays, jnp.float64)
    ref = jax.jit(jax.vmap(lambda d, *a: _fused_step_impl(
        d, *a, alpha=ALPHA)))(jd, *(jnp.asarray(a) for a in ins))
    td = torch_data(arrays, torch.float64)
    got = tm._fused_step_impl(td, *(torch.tensor(a) for a in ins), ALPHA)
    for name, r, g in zip(("dz", "dl", "dv", "dy"), ref[:4], got[:4]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10,
                                   atol=1e-10 * (1 + np.abs(r).max()),
                                   err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    """On a CPU tensor the K1 wrapper returns the plain version's step and
    launches nothing."""
    arrays = headline_arrays(3, N=4)
    v, y, vbar, rz, rl, rv, sigma = (torch.tensor(a, dtype=torch.float32)
                                     for a in _step_inputs(arrays, seed=1))
    td = torch_data(arrays, torch.float32)
    before = launches("k1")
    got = riccati_cuda.riccati_newton_step_batched(
        td, v, y, vbar, rz, rl, rv, sigma, ALPHA)
    want = tm._fused_step_impl(td, v, y, vbar, rz, rl, rv, sigma, ALPHA)
    for g, w in zip(got, want[:4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert launches("k1") == before


class RecordingLib:
    """Stands in for the kernel library: records each launch's arguments
    and each scratch-size query and reports success."""

    def __init__(self, ws_floats=11):
        self.calls, self.sizes, self.ws_floats = [], [], ws_floats

    def fb_riccati_ws_floats(self, *dims):
        self.sizes.append(dims)
        return self.ws_floats

    def fb_riccati_step(self, *args):
        self.calls.append(args)
        return 0


def test_launcher_hands_the_batch_first_tensors_to_the_kernel():
    """K1 reads the data, the iterate pieces and the residuals in place
    (instance-major is torch's batch-first layout) and writes (B, n)
    outputs that become dz and dl: no transposed copy on either side. The
    scratch is (B, the library's floats per instance)."""
    arrays = headline_arrays(5, N=4)
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    td = torch_data(arrays, torch.float32)
    td = type(td)(*(a.contiguous() for a in td))
    ins = [torch.tensor(a, dtype=torch.float32)
           for a in _step_inputs(arrays, seed=2)]
    lib = RecordingLib()
    dz, dl = riccati_cuda.launch_riccati_step(lib, td, *ins[:-1], ins[-1],
                                              ALPHA, 7)
    (args,) = lib.calls
    assert args[:6] == (N, nx, nu, nc, 5, 0) and args[-1] == 7
    assert args[6] == pytest.approx(ALPHA) and args[7] == pytest.approx(
        1 - ALPHA)
    want = (td.Q, td.R, td.S, td.A, td.B, td.E, td.L, *ins[:-1])
    assert list(args[9:22]) == [a.data_ptr() for a in want]
    assert args[22:24] == (dz.data_ptr(), dl.data_ptr())
    assert (tuple(dz.shape), tuple(dl.shape)) == ((5, nz), (5, nl))
    assert lib.sizes == [(N, nx, nu, nc, 0)]
    # The recompute-factors mode: the same arguments, the mode an int after
    # B, the scratch the library's size for that mode.
    lib = RecordingLib()
    riccati_cuda.launch_riccati_step(lib, td, *ins[:-1], ins[-1], ALPHA, 7,
                                     lowmem=True)
    assert lib.calls[0][:6] == (N, nx, nu, nc, 5, 1)
    assert lib.sizes == [(N, nx, nu, nc, 1)]
    assert not hasattr(riccati_cuda, "to_batch_last")
    with pytest.raises(ValueError, match="instances"):
        riccati_cuda.launch_riccati_step(lib, td._replace(Q=td.Q[:4]),
                                         *ins[:-1], ins[-1], ALPHA, 7)


def test_factor_failure_is_nan_and_flags_the_lane():
    """A non-SPD stage (negative cost) fails the factorization on that lane
    only, through NaN factor diagonals, as in the reference."""
    arrays = plant_arrays("double_integrator", 5, 3)
    arrays["R"][1] = -50.0 * np.eye(1)
    v, y, vbar, rz, rl, rv, _ = (torch.tensor(a) for a in
                                 _step_inputs(arrays, seed=3))
    td = torch_data(arrays, torch.float64)
    *_, ok = tm._fused_step_impl(td, v, y, vbar, rz, rl, rv, 1e-4, ALPHA)
    assert ok.tolist() == [True, False, True]


@pytest.mark.parametrize("n", [1, 3, 8, 40])
def test_cholesky_nan_on_failure_semantics(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((4, n, n))
    A = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    A[2] = -A[2]                                    # not SPD
    L = cholesky(torch.tensor(A))
    assert torch.isfinite(L[[0, 1, 3]]).all()
    assert torch.isnan(torch.diagonal(L[2], dim1=-2, dim2=-1)).any()
    good = torch.tensor(A[[0, 1, 3]])
    np.testing.assert_allclose((L[[0, 1, 3]] @ L[[0, 1, 3]].mT).numpy(),
                               good.numpy(), rtol=1e-12, atol=1e-12)
    b = torch.tensor(rng.standard_normal((3, n)))
    x = cho_solve_small(L[[0, 1, 3]], b)
    np.testing.assert_allclose((good @ x[..., None])[..., 0].numpy(),
                               b.numpy(), rtol=1e-9, atol=1e-9)
    if n <= 32:
        torch.testing.assert_close(cholesky_small(torch.tensor(A)), L,
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["headline", "copolymerization",
                                   "gate_corner", "beyond_a_block"])
@pytest.mark.parametrize("sigma_per_lane", [False, True])
def test_cuda_kernel_matches_plain_version(shape, sigma_per_lane):
    """K1, reached through the solvers' Newton-step dispatch, on the card
    against its plain version on the same float32 inputs, at the headline
    stage dims (a team of 8 per instance, B = 255 leaves the last block
    part empty), at the copolymerization reactor's (N=80 nx=18 nu=5 nc=10;
    a warp per instance) and at the JAX package's gate corner (N=6 nx=32
    nu=24 nc=48, a stage block beyond 48 KB): max |dK - dP| / (1 + max
    |dP|) <= 1e-3 per lane on dz and dl (float32 Choleskys in another
    summation order; float32 vs float64 of the plain version is <= 2e-4 on
    these inputs). At nx=112 (N=2 nu=8 nc=16), whose stage block no block
    can hold, so the team works in place, float32 rounding alone moves the
    plain version up to 7.4e-4 from its float64 run on these inputs: there
    the bound is three times that distance where it exceeds 1e-3."""
    require_cuda()
    dev = torch.device("cuda", 0)
    arrays = {"headline": lambda: headline_arrays(255),
              "copolymerization": lambda: plant_arrays(
                  "copolymerization_reactor", 80, 64),
              "gate_corner": lambda: headline_arrays(16, 6, 32, 24, 48),
              "beyond_a_block": lambda: headline_arrays(4, 2, 112, 8, 16),
              }[shape]()
    ins = _step_inputs(arrays, seed=5)
    sig = ins[-1] if sigma_per_lane else 3e-4
    td = torch_data(arrays, torch.float32, dev)
    args = [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in ins[:-1]]
    if sigma_per_lane:
        sig = torch.tensor(sig, dtype=torch.float32, device=dev)
    before = launches("k1")
    got = tm.mpc_newton_step(td, *args, sig, ALPHA)   # the solvers' dispatch
    torch.cuda.synchronize()
    assert launches("k1") == before + 1
    assert bool(got[4].all())
    want = riccati_cuda.riccati_newton_step_plain(td, *args, sig, ALPHA)
    from fbstab_tpu_torch.ops import _build
    info = _build.kernel_info(_build.load_library().fb_riccati_info,
                              *tm.mpc_dims(td), 0)
    assert (info["smem_bytes"] == 0) == (shape == "beyond_a_block")
    rel = lambda g, w: ((g.double() - w).abs().amax(1)
                        / (1 + w.abs().amax(1)))
    tol = 1e-3
    if shape == "beyond_a_block":
        f64 = riccati_cuda.riccati_newton_step_plain(
            type(td)(*(a.double() for a in td)),
            *(a.double() for a in args),
            sig.double() if sigma_per_lane else sig, ALPHA)
        gap = max(rel(w, w64).max().item()
                  for w, w64 in zip(want[:2], f64[:2]))
        tol = max(tol, 3 * gap)
    for g, w in zip(got[:2], want[:2]):
        err = rel(g, w)
        assert bool(torch.isfinite(err).all()) and err.max().item() <= tol

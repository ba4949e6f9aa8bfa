"""PyTorch port: the tier of large stage dimensions, the host outer loop
of models/mpc_subfused.py on the per-subproblem kernel K4 (on the CPU its
plain version), against `fbstab_tpu`'s `fbstab_mpc_solve_subfused` with
its Pallas kernel in interpret mode, as tests/test_subfused.py runs it, in
float64: the same exit flag, Newton and proximal counts per lane, z within
1e-9 and the residual within 1e-9 relative. At the copolymerization
reactor's stage dims the reference is the JAX package's XLA batch solve,
which tests/test_subfused.py holds its interpret-mode kernel to on that
case (the same exit flags and Newton counts, z within 1e-9): the
interpret-mode kernel there took ~170 s of the suite's single slowest
port file. The kernel itself is compared
with its plain version on the card (marked `cuda`); JAX is imported inside
the parity tests only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    copoly_arrays, dims, jax_data, launches, mixed_batch, require_cuda,
    torch_data)

from fbstab_tpu_torch.models import mpc_qp as tm  # noqa: E402
from fbstab_tpu_torch.models.mpc_subfused import (  # noqa: E402
    fbstab_mpc_solve_subfused)
from fbstab_tpu_torch.ops import mpc_subproblem_cuda as k4  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402

# (arrays, tile_b, lowmem) of tests/test_subfused.py: the mixed feasible /
# infeasible double-integrator batch through the interpret-mode kernel, and
# the copolymerization reactor's stage dims at a short horizon (B = 3)
# through the XLA solve that test holds that kernel to (tile_b None).
CASES = {
    "double_integrator_mixed": (mixed_batch, 8, False),
    "copoly_n4": (lambda: copoly_arrays(3, 4), None, None),
}


def _zeros(arrays, dtype=torch.float64, device="cpu"):
    B = arrays["x0"].shape[0]
    return tuple(torch.zeros(B, n, dtype=dtype, device=device)
                 for n in dims(arrays)[4:])


@pytest.mark.parametrize("case", list(CASES))
def test_subfused_matches_reference_per_lane(case):
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.models.mpc_qp import solve_mpc_qp_batch as jax_solve
    from fbstab_tpu.models.mpc_subfused import (
        fbstab_mpc_solve_subfused as jax_subfused)
    from fbstab_tpu.options import Options as JaxOptions

    make, tile_b, lowmem = CASES[case]
    arrays = make()
    B = arrays["x0"].shape[0]
    guess = [jnp.zeros((B, n)) for n in dims(arrays)[4:]]
    jopts = JaxOptions(abs_tol=1e-8)
    if tile_b is None:
        xr, cr = jax.jit(lambda d, z, l, v: jax_solve(d, z, l, v, jopts))(
            jax_data(arrays, jnp.float64), *guess)
    else:
        xr, cr = jax_subfused(jax_data(arrays, jnp.float64), *guess, jopts,
                              interpret=True, tile_b=tile_b, lowmem=lowmem)
    xt, ct = fbstab_mpc_solve_subfused(torch_data(arrays, torch.float64),
                                       *_zeros(arrays), Options(abs_tol=1e-8))
    if case == "copoly_n4":
        assert np.all(np.asarray(cr.eflag) == 0)
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cr, f)), err_msg=f)
    np.testing.assert_allclose(xt.z.numpy(), np.asarray(xr.z), atol=1e-9)
    scale = 1.0 + np.abs(np.asarray(xr.v))
    np.testing.assert_allclose(xt.v.numpy() / scale,
                               np.asarray(xr.v) / scale, atol=1e-9)
    np.testing.assert_allclose(ct.residual.numpy(), np.asarray(cr.residual),
                               rtol=1e-9, atol=1e-12)


def test_subfused_matches_lockstep_solver():
    """The host outer loop on the plain K4 takes the lockstep solver's
    decisions (the plain version of K2) on the mixed batch under the
    float32 options."""
    from fbstab_tpu_torch.ops.mpc_solve_cuda import fbstab_mpc_solve_plain
    arrays = mixed_batch()
    data = torch_data(arrays, torch.float64)
    opts = Options.single_precision()
    xs, cs = fbstab_mpc_solve_subfused(data, *_zeros(arrays), opts)
    xp, cp = fbstab_mpc_solve_plain(data, *_zeros(arrays), opts)
    for f in ("eflag", "newton_iters", "prox_iters"):
        assert getattr(cs, f).tolist() == getattr(cp, f).tolist(), f
    torch.testing.assert_close(xs.z, xp.z, rtol=0, atol=1e-12)


def test_tier_gate_sends_large_stage_dims_to_k4():
    """CUDA float32 batches within SUBPROBLEM_DIMS_CAP beyond
    SOLVE_DIMS_CAP, and those the JAX package sends to its per-subproblem
    kernel, take tier 2, decided from the shapes alone; tier 3 only where
    the JAX package runs its scan."""
    copoly = (80, 18, 5, 10)
    cuda, f32 = torch.device("cuda"), torch.float32
    assert tm.mpc_solve_tier(copoly, f32, cuda) == 2
    assert tm.mpc_solve_tier((62, 2, 1, 6), f32, cuda) == 2
    assert tm.mpc_solve_tier((30, 8, 3, 6), f32, cuda) == 1
    # Past the box, on the JAX package's K4 shapes: the copolymerization
    # reactor to N = 89, the spacecraft plant to N = 160.
    assert tm.mpc_solve_tier((81, 18, 5, 10), f32, cuda) == 2
    assert tm.mpc_solve_tier((89, 18, 5, 10), f32, cuda) == 2
    assert tm.mpc_solve_tier((160, 6, 3, 12), f32, cuda) == 2
    # Where the JAX package runs its scan.
    assert tm.mpc_solve_tier((90, 18, 5, 10), f32, cuda) == 3
    assert tm.mpc_solve_tier((161, 2, 1, 6), f32, cuda) == 3
    assert tm.mpc_solve_tier(copoly, torch.float64, cuda) == 3
    assert tm.mpc_solve_tier(copoly, f32, "cpu") == 3
    cap = tm.SUBPROBLEM_DIMS_CAP
    assert (cap["N"], cap["nx"], cap["nu"], cap["nc"]) == copoly


def test_wrapper_takes_plain_version_for_cpu_tensors():
    arrays = mixed_batch()
    data = torch_data(arrays, torch.float64)
    prep = k4.prep_subfused_data(data)
    assert prep.data is data   # nothing to lay out for the plain version
    z, l, v = _zeros(arrays)
    xbar = tm.Variable(z=z, l=l, v=v, y=tm._b_vec(data) - tm._gemvA(data, z))
    B = z.shape[0]
    row = torch.ones(B, dtype=torch.float64)
    args = (prep, xbar, row, 10 * row, torch.zeros(B, dtype=torch.int32),
            torch.tensor([False] * (B - 1) + [True]), Options(abs_tol=1e-8))
    before = launches("k4")
    got = k4.mpc_subproblem_fused(*args)
    want = k4.mpc_subproblem_plain(*args)
    assert launches("k4") == before
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The lane that entered done: xi = xbar, Eo = 0, counters unchanged.
    xi, Eo, newton, lfail, _, _, _, dxn = got
    assert Eo[-1].item() == 0.0 and newton[-1].item() == 0
    assert not lfail[-1] and dxn[-1].item() == 10.0
    torch.testing.assert_close(xi.z[-1], xbar.z[-1], rtol=0, atol=0)
    assert (newton[:-1] > 0).any()


def test_launcher_hands_the_batch_first_tensors_to_the_kernel(monkeypatch):
    """K4 reads the data and the proximal center in place and writes the
    (B, n) iterate that becomes xi: no transposed copy on either side. The
    mode of the prepared data goes to the kernel as an int after B."""
    from test_torch_solve import RecordingLib

    from fbstab_tpu_torch.ops import _build

    arrays = copoly_arrays(3, 4)
    data = torch_data(arrays, torch.float32)
    data = type(data)(*(a.contiguous() for a in data))
    z, l, v = _zeros(arrays, torch.float32)
    xbar = tm.Variable(z=z, l=l, v=v, y=tm._b_vec(data) - tm._gemvA(data, z))
    row = torch.ones(3)
    state = (row, 10 * row, torch.zeros(3, dtype=torch.int32),
             torch.zeros(3, dtype=torch.bool), Options.single_precision(), 7)
    dims = tm.mpc_dims(data)
    for lowmem in (False, True):
        lib = RecordingLib()
        out = k4.launch_subproblem(lib, k4.SubfusedData(data, lowmem), xbar,
                                   *state)
        (args,) = lib.calls
        assert args[:6] == (*dims, 3, int(lowmem))
        ins = (data.q, data.r, data.c, data.x0, data.d, data.Q, data.R,
               data.S, data.A, data.B, data.E, data.L, *xbar)
        assert list(args[7:23]) == [a.data_ptr() for a in ins]
        assert list(args[27:31]) == [a.data_ptr() for a in out[0]]
        assert tuple(out[0].z.shape) == tuple(z.shape) and args[-1] == 7
        # The scratch is sized by the library's own layout function for the
        # launch in this mode.
        assert lib.sizes == [("ws", (*dims, int(lowmem)))]
    assert not hasattr(k4, "to_batch_last")
    # Scratch beyond what the card can give raises the named error before
    # the launch: no fallback.
    monkeypatch.setattr(_build, "device_memory_bytes",
                        lambda dev: 4 * 3 * 11 - 1)
    big = RecordingLib()
    with pytest.raises(_build.KernelResourceError, match="scratch"):
        k4.launch_subproblem(big, k4.SubfusedData(data), xbar, *state)
    assert big.calls == []


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The outer loop on K4 against the same loop on the plain version, on
    the card in float32, at the copolymerization reactor's stage dims
    (short horizon): exit flags equal on 99% of lanes, Newton counts within
    +-2 on 90% (float32 knife edges, see chip_smoke.py), z within
    1e-3 (1 + |z|) where both succeed."""
    require_cuda()
    dev = torch.device("cuda", 0)
    arrays = copoly_arrays(64, 8)
    data = torch_data(arrays, torch.float32, dev)
    guess = _zeros(arrays, torch.float32, dev)
    opts = Options.single_precision()
    before = launches("k4")
    xk, ck = fbstab_mpc_solve_subfused(data, *guess, opts)
    torch.cuda.synchronize()
    assert launches("k4") > before
    xp, cp = fbstab_mpc_solve_subfused(data, *guess, opts,
                                       subproblem=k4.mpc_subproblem_plain)
    assert (ck.eflag == cp.eflag).float().mean().item() >= 0.99
    both = (ck.eflag == 0) & (cp.eflag == 0)
    assert both.float().mean().item() >= 0.99
    dn = (ck.newton_iters - cp.newton_iters).abs()[both]
    assert (dn <= 2).float().mean().item() >= 0.90
    zerr = (xk.z - xp.z).abs().amax(1) / (1 + xp.z.abs().amax(1))
    assert zerr[both].max().item() <= 1e-3

"""PyTorch port: the JAX package's kernel envelope. The port routes a float32
batch on the card to K2 where the JAX package runs its full-solve kernel,
to K4 where it runs its per-subproblem kernel, and to tier 3 (the lockstep
solver on K1) only where it runs its scan; the mode of a launch (storing
or recompute-factors Riccati) is the card's memory's choice. The routing
is pure arithmetic on shapes and is held here against the JAX package's
own gate functions (in interpret mode, as tests/test_dispatch.py reads
them). The tier-2 plain path at a shape beyond the old boxes, and the
plain solver against the JAX package's staged lowmem kernel in interpret
mode, are held against the JAX package on the CPU in float64."""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    dims, jax_data, perturbed_x0, plant_arrays, torch_data)

from fbstab_tpu_torch.models import mpc_qp as tm  # noqa: E402
from fbstab_tpu_torch.models.mpc_subfused import (  # noqa: E402
    fbstab_mpc_solve_subfused)
from fbstab_tpu_torch.ops.mpc_solve_cuda import (  # noqa: E402
    fbstab_mpc_solve_plain)
from fbstab_tpu_torch.options import Options  # noqa: E402

# A grid over the JAX package's caps (_DIMS_CAP: N <= 160, nx <= 32,
# nu <= 24, nc <= 48): 9 x 8 x 7 x 7 = 3,528 shapes.
GRID = list(itertools.product(
    (10, 20, 30, 40, 60, 80, 100, 120, 160), (2, 4, 6, 8, 12, 18, 24, 32),
    (1, 2, 3, 5, 8, 16, 24), (0, 4, 8, 12, 24, 36, 48)))
# The four reference plants' stage dims, at every horizon 5..160.
PLANTS = {"double_integrator": (2, 1, 6), "servo_motor": (4, 1, 4),
          "spacecraft_relative_motion": (6, 3, 12),
          "copolymerization_reactor": (18, 5, 10)}
PLANT_SHAPES = [(N, *d) for d in PLANTS.values() for N in range(5, 161)]
SHAPES = GRID + PLANT_SHAPES

# Shapes where the port keeps the tier of its first boxes against the JAX
# package's choice: (JAX's kernel, the port's tier).
KEPT_BOX = {
    # SOLVE_DIMS_CAP's corner: beyond 1,024 state rows JAX runs K4.
    "solve box corner (40, 8, 3, 12)": ((40, 8, 3, 12), 2, 1),
    "headline N=40 (40, 8, 3, 6)": ((40, 8, 3, 6), 2, 1),
    # SUBPROBLEM_DIMS_CAP: short horizons JAX runs on K2.
    "copolymerization N=10 (10, 18, 5, 10)": ((10, 18, 5, 10), 1, 2),
    "copolymerization N=5 (5, 18, 5, 10)": ((5, 18, 5, 10), 1, 2),
    "nu=5 N=20 (20, 2, 5, 0)": ((20, 2, 5, 0), 1, 2),
}
# Their number on GRID and PLANT_SHAPES: 159 shapes JAX runs on K2 inside
# SUBPROBLEM_DIMS_CAP and 49 it runs on K4 inside SOLVE_DIMS_CAP.
KEPT_BOX_COUNT = {(1, 2): 159, (2, 1): 49}


@pytest.fixture
def jax_gates(monkeypatch):
    """The JAX package's gate module, its gates reading a shape tuple in
    place of data, in interpret mode (their answer as on the TPU; no
    kernel runs), for the test's duration."""
    import fbstab_tpu.models.mpc_qp as jm

    monkeypatch.setattr(jm, "PALLAS_MODE", "interpret")
    monkeypatch.setattr(jm, "mpc_dims", lambda shape: shape)
    return jm


def _jax_tier(jm, shape):
    if jm._fused_solve_eligible(shape, None) is not None:
        return 1
    if jm._subfused_eligible(shape, None) is not None:
        return 2
    return 3


def test_port_sends_every_jax_kernel_shape_to_a_kernel(jax_gates):
    """No shape that the JAX package sends to a fused kernel goes to tier 3
    in the port, and tier 3 only where the JAX package runs its scan;
    outside the port's two first boxes the port takes JAX's kernel."""
    cuda, f32 = torch.device("cuda"), torch.float32
    kept = {}
    for shape in SHAPES:
        want = _jax_tier(jax_gates, shape)
        got = tm.mpc_solve_tier(shape, f32, cuda)
        assert (got == 3) == (want == 3), shape
        if got != want:
            box = tm.SOLVE_DIMS_CAP if got == 1 else tm.SUBPROBLEM_DIMS_CAP
            assert tm._in_box(shape, box), shape
            kept[(want, got)] = kept.get((want, got), 0) + 1
    assert kept == KEPT_BOX_COUNT
    for name, (shape, want, got) in KEPT_BOX.items():
        assert _jax_tier(jax_gates, shape) == want, name
        assert tm.mpc_solve_tier(shape, f32, cuda) == got, name


def test_port_gate_arithmetic_is_the_jax_packages(jax_gates):
    """The port's copies of _state_rows, _fused_vmem_mb, _kernel_mode and
    of the two gates' modes equal the JAX package's on every shape."""
    jm = jax_gates
    for shape in SHAPES:
        assert tm._state_rows(*shape) == jm._state_rows(*shape)
        assert tm._kernel_mode(*shape) == jm._kernel_mode(*shape), shape
        for lowmem in (False, True):
            assert (tm._fused_vmem_mb(*shape, lowmem=lowmem)
                    == jm._fused_vmem_mb(*shape, lowmem=lowmem))
        assert tm.fused_solve_mode(shape) == jm._fused_solve_eligible(
            shape, None)
        sub = jm._subfused_eligible(shape, None)
        assert tm.subfused_mode(shape) == (None if sub is None else sub[0])


def test_plants_run_a_fused_kernel_over_the_jax_envelope():
    """The four plants on the card: K2 or K4 at every horizon the JAX
    package runs a fused kernel, tier 3 beyond (the copolymerization
    reactor from N = 90, the others beyond N = 160)."""
    cuda, f32 = torch.device("cuda"), torch.float32
    for name, d in PLANTS.items():
        last = 89 if name == "copolymerization_reactor" else 160
        for N in range(5, 200):
            tier = tm.mpc_solve_tier((N, *d), f32, cuda)
            assert (tier == 3) == (N > last), (name, N, tier)
    assert tm.mpc_solve_tier((160, 6, 3, 12), f32, cuda) == 2
    assert tm.mpc_solve_tier((10, 24, 8, 8), f32, cuda) == 1
    assert tm.mpc_solve_tier((4, 32, 24, 48), f32, cuda) == 1
    assert tm.mpc_solve_tier((17, 32, 24, 48), f32, cuda) == 2


@pytest.mark.parametrize("floats", [115_000, 480_000, 7_000_000])
def test_riccati_mode_takes_lowmem_past_a_quarter_of_memory(floats):
    """lowmem exactly where the batch's storing Riccati scratch,
    B * store_floats * 4 bytes, exceeds a quarter of the card's memory
    (here a stated 80 GiB and stated floats per instance), at any B; std
    on the CPU."""
    dims4, total = (85, 18, 5, 10), 80 * 2 ** 30
    per = 4 * floats
    line = tm.LOWMEM_MEMORY_SHARE * total
    B = int(line // per)                  # the largest batch within it
    assert B * per <= line < (B + 1) * per
    mode = lambda b: tm.riccati_mode(dims4, b, "cuda", total_memory=total,
                                     store_floats=floats)
    assert mode(B) == "std"
    assert mode(B + 1) == "lowmem"
    assert mode(10 * B) == "lowmem"
    assert tm.riccati_mode(dims4, 10 * B, "cpu") == "std"


@pytest.fixture(scope="module")
def jax_batch_solve():
    """The JAX package's XLA batch solve (vmap of its lockstep core) in
    float64 on the CPU under abs_tol = 1e-8 and a Newton budget (None:
    the Options' default), jitted once per budget."""
    import functools

    import jax
    from fbstab_tpu.models.mpc_qp import _solve_mpc_qp_batch_raw
    from fbstab_tpu.options import Options as JaxOptions

    @functools.cache
    def solve(budget=None):
        opts = JaxOptions(abs_tol=1e-8)
        if budget is not None:
            opts = dataclasses.replace(opts, max_newton_iters=budget)
        return jax.jit(lambda d, z, l, v: _solve_mpc_qp_batch_raw(
            d, z, l, v, opts, "scan"))
    return solve


def _held_to_jax(cs, cj, xs, xj):
    """Equal exit flags, Newton and proximal counts per lane, z within
    1e-9."""
    for name in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(),
                                      np.asarray(getattr(cj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(xs.z.numpy(), np.asarray(xj.z), rtol=0,
                               atol=1e-9)


def test_tier2_plain_path_at_spacecraft_n48_matches_jax(jax_batch_solve):
    """The spacecraft plant at N = 48 (1,911 state rows, beyond the full-
    solve kernel's 1,024: JAX runs K4 there, and so does the port, beyond
    its first boxes), B = 4 with perturbed x0, through the port's tier-2
    plain path (the host outer loop on the plain K4; the plain version
    has no mode, so this holds K4's lowmem launches as its standard ones)
    against the JAX package's XLA batch solve, float64: equal exit flags,
    Newton and proximal counts per lane, z within 1e-9."""
    import jax.numpy as jnp

    arrays = perturbed_x0(plant_arrays("spacecraft_relative_motion", 48, 4),
                          0.2)
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    assert tm._state_rows(N, nx, nu, nc) > tm._FULL_SOLVE_ROWS_CAP
    assert tm.mpc_solve_tier((N, nx, nu, nc), torch.float32, "cuda") == 2
    xj, cj = jax_batch_solve()(jax_data(arrays, jnp.float64),
                               *(jnp.zeros((4, n)) for n in (nz, nl, nv)))
    data = torch_data(arrays, torch.float64)
    guess = [torch.zeros(4, n, dtype=torch.float64) for n in (nz, nl, nv)]
    xs, cs = fbstab_mpc_solve_subfused(data, *guess, Options(abs_tol=1e-8))
    _held_to_jax(cs, cj, xs, xj)


@pytest.mark.parametrize("budget", [None, 400])
def test_jax_needs_over_200_newton_steps_at_spacecraft_n160(jax_batch_solve,
                                                            budget):
    """The spacecraft plant at N = 160 (chip_smoke's envelope path), B = 2
    with lane 1's x0 perturbed as that path perturbs it, through the JAX
    package's XLA batch solve in float64: under the default Newton budget
    (200) every lane exits MAXITERATIONS, under 400 every lane exits
    SUCCESS after more than 200 Newton steps. The raised budget the
    envelope path runs the port under answers a need of the reference
    algorithm at this horizon."""
    import jax.numpy as jnp

    B = 2
    arrays = perturbed_x0(plant_arrays("spacecraft_relative_motion", 160, B),
                          0.001)
    nz, nl, nv = dims(arrays)[4:]
    _, cj = jax_batch_solve(budget)(
        jax_data(arrays, jnp.float64),
        *(jnp.zeros((B, n)) for n in (nz, nl, nv)))
    newton = np.asarray(cj.newton_iters)
    if budget is None:
        assert Options().max_newton_iters == 200
        assert np.all(np.asarray(cj.eflag) == 2), cj.eflag  # MAXITERATIONS
        assert np.all(newton == 200)
    else:
        assert np.all(np.asarray(cj.eflag) == 0), cj.eflag  # SUCCESS
        assert np.all((newton > 200) & (newton < budget)), newton


def test_plain_solver_matches_jax_staged_lowmem_kernel():
    """The port's plain solver (K2's plain version, which K2 in lowmem and
    in the standard mode is held to) against the JAX package's full-solve
    kernel in its staged lowmem serial launch (mpc_solve_pallas.py:1191),
    interpret mode, float64, on the double integrator at N = 4, B = 3 with
    x0 perturbed (tile_b = 2 pads the last tile). tests/test_staged_fused.py
    holds that launch to the XLA path on this plant and at the
    copolymerization reactor's stage dims, whose trace takes some 145 s in
    interpret mode, against some 13 s here. Equal exit
    flags, Newton and proximal counts per lane, z within 1e-9 and the
    residual within 1e-9 relative (the tolerance that test holds the
    kernel to the XLA path with)."""
    import jax.numpy as jnp
    from fbstab_tpu.ops.mpc_solve_pallas import fbstab_mpc_solve_fused
    from fbstab_tpu.options import Options as JaxOptions

    B = 3
    arrays = perturbed_x0(plant_arrays("double_integrator", 4, B), 0.2)
    nz, nl, nv = dims(arrays)[4:]
    xj, cj = fbstab_mpc_solve_fused(
        jax_data(arrays, jnp.float64),
        *(jnp.zeros((B, n)) for n in (nz, nl, nv)), JaxOptions(abs_tol=1e-8),
        interpret=True, tile_b=2, lowmem=True, staged=True)
    data = torch_data(arrays, torch.float64)
    guess = [torch.zeros(B, n, dtype=torch.float64) for n in (nz, nl, nv)]
    xp, cp = fbstab_mpc_solve_plain(data, *guess, Options(abs_tol=1e-8))
    _held_to_jax(cp, cj, xp, xj)
    np.testing.assert_allclose(cp.residual.numpy(), np.asarray(cj.residual),
                               rtol=1e-9, atol=1e-12)

"""PyTorch port: the CUDA kernels' device code replayed on the CPU in
float64. The headers of fbstab_tpu_torch/csrc are plain C++ behind FB_DEV,
so tests/torch_host_replay.cpp compiles them with the host compiler, with
double in place of float, behind the CUDA library's C interface. In float64
the replayed fused solvers (K2, MPC; K3, dense) must take exactly the plain
solvers' decisions on every lane: the same exit flag, Newton and proximal
iteration counts, iterates within 1e-9; so must the host outer loop of the
subfused tier on the replayed per-subproblem kernel (K4). Every kernel is
replayed in its instance-major layout on the team of one and on teams of
host threads, which stage their operands or work in place as the card's
teams do. The replayed Newton step (K1) must match its plain version
within 1e-10 and, on every team, give the team of one's bits; so must the
scan-level combine (K5); K2 and K3 on teams must take the plain solvers'
decisions. P1's two CUDA-core forms must match their plain versions within
1e-12 and give the team of one's bits on every team. This pins the
per-lane semantics of the
stall guard, the linesearch and the exit checks, which float32 knife edges
hide on the card (chip_smoke.py bounds the float32 Newton counts there).
The double-float transforms of P3 (csrc/doublefloat.cuh) are replayed in
float32: the replay is built with -ffp-contract=off, so the host compiler
contracts nothing, and they must be exact. So is the MPC refinement's
residual (csrc/refine_residual.cuh), whose margin and KKT blocks must be
bit for bit the eager composition's."""

import contextlib
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    copoly_arrays, dense_arrays, dense_mixed_batch, dims, headline_arrays,
    mixed_batch, plant_arrays, residual_case, span_arrays, torch_data,
    torch_dense_data)

from fbstab_tpu_torch.models import mpc_qp as tm  # noqa: E402
from fbstab_tpu_torch.models.mpc_subfused import (  # noqa: E402
    fbstab_mpc_solve_subfused)
from fbstab_tpu_torch.models.scaling import (  # noqa: E402
    apply_dense_scaling, apply_mpc_scaling, ruiz_dense_scaling,
    ruiz_mpc_scaling)
from fbstab_tpu_torch.ops import _build  # noqa: E402
from fbstab_tpu_torch.ops.assoc_combine_cuda import (  # noqa: E402
    SpanElement, combine_im_plain)
from fbstab_tpu_torch.ops.dense_solve_cuda import (  # noqa: E402
    fbstab_dense_solve_plain)
from fbstab_tpu_torch.ops.mpc_solve_cuda import (  # noqa: E402
    fbstab_mpc_solve_plain, solve_opts)
from fbstab_tpu_torch.options import Options  # noqa: E402

HARNESS = Path(__file__).resolve().parent / "torch_host_replay.cpp"
ALPHA = 0.95


class SolveOpts64(ctypes.Structure):
    """`_build.SolveOpts` with double in place of float."""
    _fields_ = [(n, ctypes.c_double if t is ctypes.c_float else t)
                for n, t in _build.SolveOpts._fields_]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the replay")
    out = tmp_path_factory.mktemp("replay") / "libfbstab_replay64.so"
    subprocess.run([cxx, "-std=c++20", "-pthread", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(_build.SRC_DIR), "-o",
                    str(out), str(HARNESS)], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(out))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for ws in (lib.fb_riccati_ws_floats, lib.fb_solve_ws_floats,
               lib.fb_subproblem_ws_floats):
        ws.argtypes = [I] * 5
        ws.restype = ctypes.c_longlong
    for smem in (lib.fb_solve_smem_bytes, lib.fb_subproblem_smem_bytes):
        smem.argtypes = [I] * 4
        smem.restype = ctypes.c_longlong
    lib.fb_riccati_step.argtypes = [I] * 6 + [D, D] + [P] * 17
    lib.fb_mpc_solve.argtypes = [I] * 6 + [SolveOpts64] + [P] * 25
    lib.fb_dense_ws_floats.argtypes = [I] * 3
    lib.fb_dense_ws_floats.restype = ctypes.c_longlong
    lib.fb_dense_solve.argtypes = [I] * 4 + [SolveOpts64] + [P] * 19
    lib.fb_mpc_subproblem.argtypes = [I] * 6 + [SolveOpts64] + [P] * 32
    lib.fb_assoc_combine.argtypes = [I] * 3 + [P] * 16
    lib.fb_df_probe.argtypes = [I] * 2 + [P] * 8
    lib.fb_mxu_probe.argtypes = [I] * 5 + [D] + [P] * 3
    for fn in (lib.fb_replay_set_team, lib.fb_replay_set_stages):
        fn.argtypes = [I]
        fn.restype = None
    from fbstab_tpu_torch.ops.refine_residual_cuda import ResidualArgs
    lib.fb_refine_residual.argtypes = [I] * 5 + [ResidualArgs, P]
    return lib


@contextlib.contextmanager
def on_team(lib, T, stages=True):
    """Replays the kernels on a team of T host threads inside the block,
    staging their operands or (stages=False) in place."""
    lib.fb_replay_set_team(T)
    lib.fb_replay_set_stages(int(stages))
    try:
        yield
    finally:
        lib.fb_replay_set_team(1)
        lib.fb_replay_set_stages(1)


def _replay_solve(lib, data, options, lowmem=False):
    """The replayed K2 from zero initial guesses on the instance-major
    (batch-first) arrays, in the standard or (lowmem) the recompute-factors
    mode: (z, v, eflag, newton, prox, res)."""
    N, nx, nu, nc = tm.mpc_dims(data)
    B, N1 = data.x0.shape[0], N + 1
    f64 = dict(dtype=torch.float64)
    z0 = torch.zeros(B, N1 * (nx + nu), **f64)
    l0 = torch.zeros(B, N1 * nx, **f64)
    v0 = torch.zeros(B, N1 * nc, **f64)
    ins = [a.contiguous() for a in (
        data.q, data.r, data.c, data.x0, data.d, data.Q, data.R, data.S,
        data.A, data.B, data.E, data.L, z0, l0, v0)]
    z, l0b, v, y = (torch.empty(B, a.shape[1], **f64)
                    for a in (z0, l0, v0, v0))
    eflag, newton, prox = (torch.empty(B, dtype=torch.int32)
                           for _ in range(3))
    res, res0 = torch.empty(B, **f64), torch.empty(B, **f64)
    ws = torch.empty(B, lib.fb_solve_ws_floats(N, nx, nu, nc, lowmem),
                     **f64)
    outs = (z, l0b, v, y, eflag, res, newton, prox, res0, ws)
    assert lib.fb_mpc_solve(N, nx, nu, nc, B, lowmem,
                            solve_opts(options, SolveOpts64),
                            *[a.data_ptr() for a in ins],
                            *[a.data_ptr() for a in outs]) == 0
    return z, v, eflag, newton, prox, res


def _headline_equilibrated():
    data = torch_data(headline_arrays(64), torch.float64)
    return apply_mpc_scaling(data, ruiz_mpc_scaling(data))


SOLVE_CASES = {
    "mixed_abs_tol_1e-8": (lambda: torch_data(mixed_batch(), torch.float64),
                           lambda: Options(abs_tol=1e-8)),
    "mixed_single_precision": (
        lambda: torch_data(mixed_batch(), torch.float64),
        Options.single_precision),
    "servo_certificate": (
        lambda: torch_data(plant_arrays(
            "servo_motor", 10, 2,
            x0s=[[0.0, 0.0, 0.0, 0.0], [0.1, 0.0, 0.0, 0.0]]),
            torch.float64),
        lambda: Options(abs_tol=1e-8)),
    "spacecraft": (
        lambda: torch_data(plant_arrays("spacecraft_relative_motion", 12, 2),
                           torch.float64),
        lambda: Options(abs_tol=1e-8)),
    "headline_equilibrated": (_headline_equilibrated,
                              Options.single_precision),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_replayed_solver_takes_the_plain_solvers_decisions(lib, case):
    make_data, make_options = SOLVE_CASES[case]
    _check_replayed_solver(lib, make_data(), make_options())


@pytest.mark.parametrize("case,T", [("mixed_abs_tol_1e-8", 8),
                                    ("mixed_single_precision", 4),
                                    ("servo_certificate", 8),
                                    ("spacecraft", 32)])
def test_replayed_solver_on_a_team_takes_the_plain_solvers_decisions(
        lib, case, T):
    """K2's device code on a team of T host threads: the split of every
    pass over the team, its syncs and its reductions (summed in another
    order than the team of one's, so float64 rounding alone separates the
    two) still give the plain solver's decisions on every lane."""
    make_data, make_options = SOLVE_CASES[case]
    with on_team(lib, T):
        _check_replayed_solver(lib, make_data(), make_options())


def _check_replayed_solver(lib, data, opts, lowmem=False):
    z, v, eflag, newton, prox, res = _replay_solve(lib, data, opts, lowmem)
    B = data.x0.shape[0]
    N, nx, nu, nc = tm.mpc_dims(data)
    zeros = lambda n: torch.zeros(B, n, dtype=torch.float64)
    xp, cp = fbstab_mpc_solve_plain(data, zeros((N + 1) * (nx + nu)),
                                    zeros((N + 1) * nx), zeros((N + 1) * nc),
                                    opts)
    for name, got, want in (("eflag", eflag, cp.eflag),
                            ("newton_iters", newton, cp.newton_iters),
                            ("prox_iters", prox, cp.prox_iters)):
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=name)
    zp = xp.z.numpy()
    np.testing.assert_allclose(z.numpy(), zp, rtol=1e-9,
                               atol=1e-9 * (1 + np.abs(zp).max()))
    vp = xp.v.numpy()
    np.testing.assert_allclose(v.numpy(), vp, rtol=1e-9,
                               atol=1e-9 * (1 + np.abs(vp).max()))
    np.testing.assert_allclose(
        res.numpy(), cp.residual.numpy(), rtol=0,
        atol=1e-9 * (1 + cp.initial_residual.max().item()))


def _replay_step(lib, td, ins, T=1, stages=True, lowmem=False):
    """The replayed K1 on the instance-major (batch-first) arrays, on a
    team of T host threads that stages or works in place, in the storing
    or (lowmem) the recompute-factors mode: (dz, dl)."""
    N, nx, nu, nc = tm.mpc_dims(td)
    B = td.Q.shape[0]
    f64 = dict(dtype=torch.float64)
    args = [a.contiguous() for a in (td.Q, td.R, td.S, td.A, td.B, td.E,
                                     td.L, *ins[:-1])]
    dz = torch.empty(B, (N + 1) * (nx + nu), **f64)
    dl = torch.empty(B, (N + 1) * nx, **f64)
    with on_team(lib, T, stages):
        ws = torch.full((B, lib.fb_riccati_ws_floats(N, nx, nu, nc, lowmem)),
                        float("nan"), **f64)
        assert lib.fb_riccati_step(
            N, nx, nu, nc, B, lowmem, ALPHA, 1.0 - ALPHA, ins[-1].data_ptr(),
            *[a.data_ptr() for a in args], dz.data_ptr(), dl.data_ptr(),
            ws.data_ptr()) == 0
    return dz, dl


# The teams K1's device code is replayed on: the team of one, teams of 2 to
# 32 threads that stage each stage's operands, and a team of 32 that works
# in place (K1 at stages too large for a block's shared memory).
K1_TEAMS = {"1": (1, True), "2": (2, True), "4": (4, True), "8": (8, True),
            "32": (32, True), "32_in_place": (32, False)}
# K5's: the team of one, teams of 2 to 32 that stage (the card's teams
# do), and a team of 8 in place, the team of one's path.
K5_TEAMS = {"1": (1, True), "2": (2, True), "8": (8, True),
            "32": (32, True), "8_in_place": (8, False)}


def _step_case(plant, N, B):
    """A plant's (or the gate corner's) data at horizon N, B lanes, and
    the Newton-step inputs: per-lane sigma, random iterates around the
    complementarity corner."""
    arrays = (headline_arrays(B, N, 32, 24, 48) if plant == "gate_corner"
              else plant_arrays(plant, N, B))
    N, nx, nu, nc, nz, nl, nv = dims(arrays)
    rng = np.random.default_rng(N)
    v = np.abs(rng.standard_normal((B, nv)))
    y = rng.standard_normal((B, nv))
    vbar = v + 0.1 * rng.standard_normal((B, nv))
    rz, rl, rv = (rng.standard_normal((B, n)) for n in (nz, nl, nv))
    sigma = 10.0 ** rng.uniform(-4, -1, B)
    td = torch_data(arrays, torch.float64)
    return td, [torch.tensor(a) for a in (v, y, vbar, rz, rl, rv, sigma)]


@pytest.mark.parametrize("team", list(K1_TEAMS))
@pytest.mark.parametrize("plant,N,B", [
    ("double_integrator", 8, 4),
    ("servo_motor", 5, 2),
    ("copolymerization_reactor", 6, 2),
    # A tier-3 shape (beyond K2's and K4's caps): the JAX package's gate
    # corner nx = 32, nu = 24, nc = 48, the bench's generator.
    ("gate_corner", 2, 2),
])
def test_replayed_newton_step_matches_plain_step(lib, plant, N, B, team):
    """Per-lane sigma, random iterates around the complementarity corner:
    the plain step within 1e-10, and on a team of T > 1 host threads (the
    kernel's split of every stage) dz and dl bit for bit the team of one's,
    since every factor and step entry is computed by one thread in the team
    of one's order."""
    td, ins = _step_case(plant, N, B)
    T, stages = K1_TEAMS[team]
    dz, dl = _replay_step(lib, td, ins, T, stages)
    pz, pl, *_ = tm._fused_step_impl(td, *ins, ALPHA)
    for name, got, want in (("dz", dz, pz), ("dl", dl, pl)):
        w = want.numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * (1 + np.abs(w).max()),
                                   err_msg=name)
    if T > 1:
        oz, ol = _replay_step(lib, td, ins)
        assert torch.equal(dz, oz) and torch.equal(dl, ol)


@pytest.mark.parametrize("team", ["1", "8", "32", "32_in_place"])
@pytest.mark.parametrize("plant,N,B", [
    ("copolymerization_reactor", 6, 2),
    ("spacecraft_relative_motion", 9, 2),
    ("gate_corner", 2, 1),
])
def test_replayed_lowmem_step_is_bit_equal_to_the_storing_step(
        lib, plant, N, B, team):
    """The recompute-factors instantiation of riccati.cuh (Store false:
    only Lc kept, each stage's M, SM, SG, AM and P recomputed from it in
    the vector passes) gives the storing instantiation's dz and dl bit for
    bit, on the team of one and on teams that stage or work in place, at
    the copolymerization reactor's, the spacecraft plant's and the gate
    corner's stage dims. The scratch starts as NaN, so a recomputed factor
    read from anywhere but the stage block would show."""
    td, ins = _step_case(plant, N, B)
    T, stages = K1_TEAMS[team]
    dz, dl = _replay_step(lib, td, ins, T, stages)
    lz, ll = _replay_step(lib, td, ins, T, stages, lowmem=True)
    assert torch.isfinite(dz).all() and torch.isfinite(dl).all()
    assert torch.equal(lz, dz) and torch.equal(ll, dl)


@pytest.mark.parametrize("case", ["mixed_single_precision", "spacecraft"])
def test_replayed_lowmem_solver_takes_the_plain_solvers_decisions(lib, case):
    """K2's recompute-factors instantiation, replayed: the plain
    solver's decisions on every lane, and the standard instantiation's
    iterates bit for bit."""
    make_data, make_options = SOLVE_CASES[case]
    data, opts = make_data(), make_options()
    _check_replayed_solver(lib, data, opts, lowmem=True)
    got = _replay_solve(lib, data, opts, lowmem=True)
    want = _replay_solve(lib, data, opts)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _replay_dense(lib, data, options, T=1, stages=True):
    """The replayed K3 from zero initial guesses on the instance-major
    (batch-first) arrays, on a team of T host threads that stages or works
    in place: (z, l, v, eflag, newton, prox, res)."""
    B, n = data.f.shape
    nl, q = data.h.shape[1], data.b.shape[1]
    f64 = dict(dtype=torch.float64)
    guess = [torch.zeros(B, k, **f64) for k in (n, nl, q)]
    ins = [a.contiguous() for a in (*data, *guess)]
    z, l, v, y = (torch.empty(B, k, **f64) for k in (n, nl, q, q))
    eflag, newton, prox = (torch.empty(B, dtype=torch.int32)
                           for _ in range(3))
    res, res0 = torch.empty(B, **f64), torch.empty(B, **f64)
    ws = torch.empty(B, lib.fb_dense_ws_floats(n, q, nl), **f64)
    outs = (z, l, v, y, eflag, res, newton, prox, res0, ws)
    with on_team(lib, T, stages):
        assert lib.fb_dense_solve(n, q, nl, B,
                                  solve_opts(options, SolveOpts64),
                                  *[a.data_ptr() for a in ins],
                                  *[a.data_ptr() for a in outs]) == 0
    return z, l, v, eflag, newton, prox, res


def _dense_equilibrated(B, n=32, q=64, nl=0):
    data = torch_dense_data(dense_arrays(B, n, q, nl), torch.float64)
    return apply_dense_scaling(data, ruiz_dense_scaling(data))


DENSE_CASES = {
    "mixed_nl0_abs_tol_1e-8": (
        lambda: torch_dense_data(dense_mixed_batch(0), torch.float64),
        lambda: Options(abs_tol=1e-8)),
    "mixed_nl2_abs_tol_1e-8": (
        lambda: torch_dense_data(dense_mixed_batch(2), torch.float64),
        lambda: Options(abs_tol=1e-8)),
    "mixed_nl2_single_precision": (
        lambda: torch_dense_data(dense_mixed_batch(2), torch.float64),
        Options.single_precision),
    "bench_equilibrated": (lambda: _dense_equilibrated(64),
                           Options.single_precision),
    # The JAX package's dense gate (n = 64, q = 128) with Gaussian equality
    # rows: at its corner nl = n, beyond DENSE_DIMS_CAP, the rows fix z and
    # float32 solves (K3 and its plain version alike) part from float64 on
    # ill-conditioned lanes; in float64 the device code takes the plain
    # solver's steps there and at nl = n / 2, DENSE_DIMS_CAP's corner.
    "gate_corner_equilibrated": (lambda: _dense_equilibrated(8, 64, 128, 64),
                                 Options.single_precision),
    "gate_half_equality_equilibrated": (
        lambda: _dense_equilibrated(8, 64, 128, 32), Options.single_precision),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_replayed_dense_solver_takes_the_plain_solvers_decisions(lib, case):
    make_data, make_options = DENSE_CASES[case]
    _check_replayed_dense(lib, make_data(), make_options())


@pytest.mark.parametrize("case,T,stages", [
    ("mixed_nl2_abs_tol_1e-8", 32, False),
    ("gate_half_equality_equilibrated", 8, True)])
def test_replayed_dense_solver_on_a_team_takes_the_plain_solvers_decisions(
        lib, case, T, stages):
    """K3's device code on a team of T host threads, staging H, A, G and
    the Newton-step scratch or in place: the split of the rows, of E's and
    S's entries and of W's rows, the team's Choleskys and solves, and its
    reductions (summed in another order than the team of one's) still give
    the plain solver's decisions on every lane."""
    make_data, make_options = DENSE_CASES[case]
    _check_replayed_dense(lib, make_data(), make_options(), T, stages)


def _check_replayed_dense(lib, data, opts, T=1, stages=True):
    z, l, v, eflag, newton, prox, res = _replay_dense(lib, data, opts, T,
                                                      stages)
    B, n = data.f.shape
    nl, q = data.h.shape[1], data.b.shape[1]
    guess = [torch.zeros(B, k, dtype=torch.float64) for k in (n, nl, q)]
    xp, cp = fbstab_dense_solve_plain(data, *guess, opts)
    for name, got, want in (("eflag", eflag, cp.eflag),
                            ("newton_iters", newton, cp.newton_iters),
                            ("prox_iters", prox, cp.prox_iters)):
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=name)
    for name, got, want in (("z", z, xp.z), ("l", l, xp.l), ("v", v, xp.v)):
        w = want.numpy()
        scale = 1.0 + np.abs(w)
        np.testing.assert_allclose(got.numpy() / scale, w / scale, atol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(
        res.numpy(), cp.residual.numpy(), rtol=0,
        atol=1e-9 * (1 + cp.initial_residual.max().item()))


def _replayed_subproblem(lib):
    """One outer iteration on the replayed K4 (instance-major arrays),
    with the signature of ops.mpc_subproblem_cuda.mpc_subproblem_fused."""
    def subproblem(prep, xbar, itol_prev, dxn_prev, newton0, done, options):
        data = prep.data
        N, nx, nu, nc = tm.mpc_dims(data)
        B = xbar.z.shape[0]
        f64 = dict(dtype=torch.float64)
        i32 = dict(dtype=torch.int32)
        ins = [a.contiguous() for a in (
            data.q, data.r, data.c, data.x0, data.d, data.Q, data.R, data.S,
            data.A, data.B, data.E, data.L, *xbar)]
        ins += [itol_prev.contiguous(), dxn_prev.contiguous(),
                newton0.to(**i32).contiguous(), done.to(**i32).contiguous()]
        xi = [torch.empty(B, a.shape[1], **f64) for a in xbar]
        Eo, Ek, itol, dxn = (torch.empty(B, **f64) for _ in range(4))
        newton, lfail, success = (torch.empty(B, **i32) for _ in range(3))
        lowmem = int(prep.lowmem)
        ws = torch.empty(
            B, lib.fb_subproblem_ws_floats(N, nx, nu, nc, lowmem), **f64)
        outs = (*xi, Eo, newton, lfail, Ek, success, itol, dxn, ws)
        assert lib.fb_mpc_subproblem(N, nx, nu, nc, B, lowmem,
                                     solve_opts(options, SolveOpts64),
                                     *[a.data_ptr() for a in ins],
                                     *[a.data_ptr() for a in outs]) == 0
        return (tm.Variable(*xi), Eo, newton, lfail > 0, Ek, success > 0,
                itol, dxn)
    return subproblem


SUBPROBLEM_CASES = {
    "mixed_abs_tol_1e-8": (lambda: torch_data(mixed_batch(), torch.float64),
                           lambda: Options(abs_tol=1e-8)),
    "mixed_single_precision": (
        lambda: torch_data(mixed_batch(), torch.float64),
        Options.single_precision),
    "copoly_n4_abs_tol_1e-8": (
        lambda: torch_data(copoly_arrays(3, 4), torch.float64),
        lambda: Options(abs_tol=1e-8)),
}


@pytest.mark.parametrize("case", list(SUBPROBLEM_CASES))
def test_subfused_loop_on_replayed_k4_takes_the_plain_solvers_decisions(
        lib, case):
    make_data, make_options = SUBPROBLEM_CASES[case]
    _check_subfused_on_replay(lib, make_data(), make_options())


@pytest.mark.parametrize("case,T", [("mixed_single_precision", 4),
                                    ("copoly_n4_abs_tol_1e-8", 32)])
def test_subfused_loop_on_replayed_k4_team_takes_the_plain_solvers_decisions(
        lib, case, T):
    """K4's device code on a team of T host threads (K4's own 32 at the
    copolymerization reactor's stage dims) under the host outer loop."""
    make_data, make_options = SUBPROBLEM_CASES[case]
    with on_team(lib, T):
        _check_subfused_on_replay(lib, make_data(), make_options())


@pytest.mark.parametrize("case,T", [("mixed_single_precision", 1),
                                    ("copoly_n4_abs_tol_1e-8", 1),
                                    ("copoly_n4_abs_tol_1e-8", 32)])
def test_subfused_loop_on_replayed_lowmem_k4_takes_the_plain_solvers_decisions(
        lib, case, T):
    """K4's recompute-factors instantiation under the host outer loop
    (lowmem=True, as the JAX package's `_make_subproblem_kernel(lowmem=
    True)`), on the team of one and on K4's warp: the plain solver's
    decisions on every lane."""
    make_data, make_options = SUBPROBLEM_CASES[case]
    with on_team(lib, T):
        _check_subfused_on_replay(lib, make_data(), make_options(),
                                  lowmem=True)


def _check_subfused_on_replay(lib, data, opts, lowmem=False):
    N, nx, nu, nc = tm.mpc_dims(data)
    B = data.x0.shape[0]
    zeros = lambda n: torch.zeros(B, n, dtype=torch.float64)
    guess = (zeros((N + 1) * (nx + nu)), zeros((N + 1) * nx),
             zeros((N + 1) * nc))
    xs, cs = fbstab_mpc_solve_subfused(data, *guess, opts,
                                       subproblem=_replayed_subproblem(lib),
                                       lowmem=lowmem)
    xp, cp = fbstab_mpc_solve_plain(data, *guess, opts)
    for name in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(),
                                      getattr(cp, name).numpy(),
                                      err_msg=name)
    for name, got, want in (("z", xs.z, xp.z), ("v", xs.v, xp.v)):
        w = want.numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * (1 + np.abs(w).max()),
                                   err_msg=name)
    np.testing.assert_allclose(
        cs.residual.numpy(), cp.residual.numpy(), rtol=0,
        atol=1e-9 * (1 + cp.initial_residual.max().item()))


# The most dynamic shared memory a block of an H100 can opt in to
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB).
H100_SMEM_OPTIN = 232448


@pytest.mark.parametrize("dims", [(30, 8, 3, 6), (40, 8, 3, 12),
                                  (80, 18, 5, 10), (6, 2, 1, 6),
                                  (12, 6, 3, 12), (10, 24, 8, 8),
                                  (160, 32, 24, 48)])
def test_layout_helpers_match_the_device_code(lib, dims):
    """The layout functions that K1's, K2's and K4's launches size their
    scratch and shared memory with (csrc/riccati.cuh, csrc/mpc_solve.cuh,
    here compiled from the same headers; the headline, the two boxes, the
    double integrator, the servo, a K2 corner and the JAX package's gate
    corner): the three kernels keep K1's Riccati factors in device memory
    and K1's stage block in shared memory, one per team (four teams to a
    block of K2, one to K4's), or beside the factors for a team that works
    in place; K2 five primal-dual points beside the factors and K4 three.
    The recompute-factors layout drops N1 (nx^2 + nu nx + nu^2) +
    N (nx^2 + nx nu) floats of factors and nothing else. At the gate
    corner a team's stage block is 48.7 KB, beyond the 48 KB a block gets
    by default; four of them (K2's block) still fit what an H100's block
    can opt in to, so K2 and K4 stage at every shape of the JAX package's
    envelope."""
    N, nx, nu, nc = dims
    N1 = N + 1
    point = N1 * (2 * nx + nu + 2 * nc)
    k2_smem, k4_smem = (lib.fb_solve_smem_bytes(*dims),
                        lib.fb_subproblem_smem_bytes(*dims))
    stage = k4_smem // 4
    assert k4_smem == 4 * stage and k2_smem == 4 * k4_smem
    dropped = N1 * (nx * nx + nu * nx + nu * nu) + N * (nx * nx + nx * nu)
    for lowmem in (0, 1):
        with on_team(lib, 8):                     # teams that stage
            factors = lib.fb_riccati_ws_floats(*dims, lowmem)
            assert lib.fb_solve_ws_floats(*dims, lowmem) == (
                factors + 5 * point)
            assert lib.fb_subproblem_ws_floats(*dims, lowmem) == (
                factors + 3 * point)
        with on_team(lib, 8, stages=False):       # teams in place
            assert lib.fb_riccati_ws_floats(*dims, lowmem) == factors + stage
            assert lib.fb_solve_ws_floats(*dims, lowmem) == (
                factors + stage + 5 * point)
            assert lib.fb_subproblem_ws_floats(*dims, lowmem) == (
                factors + stage + 3 * point)
        if lowmem:
            assert factors == store - dropped
        else:
            store = factors
    assert k2_smem <= H100_SMEM_OPTIN
    if dims == (160, 32, 24, 48):
        assert stage * 4 == 49856 and k4_smem > 48 * 1024


def _replay_combine(lib, left, right, T=1, stages=True):
    """The replayed K5 on instance-major spans, on a team of T host threads
    that stages or works in place."""
    M, B, n, _ = left.P11.shape
    out = SpanElement(*(torch.empty(a.shape, dtype=torch.float64)
                        for a in left))
    ins = (*left, *right)
    strides = (ctypes.c_longlong * 10)(*(a.stride(0) for a in ins))
    with on_team(lib, T, stages):
        assert lib.fb_assoc_combine(n, M, B, strides,
                                    *[a.data_ptr() for a in ins],
                                    *[a.data_ptr() for a in out]) == 0
    return out


@pytest.mark.parametrize("team", list(K5_TEAMS))
@pytest.mark.parametrize("M,n,B", [(3, 4, 5), (2, 18, 3)])
def test_replayed_combine_matches_plain_combine(lib, M, n, B, team):
    """The plain combine within 1e-10, and on a team of T > 1 host threads
    (the kernel's split of the factor, the solves and the products) the
    team of one's bits, since every output entry is computed by one thread
    in the team of one's order. The left operands are every other element
    of a stack of 2M, as a scan level hands them to the kernel."""
    left, right = span_arrays(M, n, B)
    im = lambda a: torch.tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    wide = SpanElement(*(torch.cat([im(a), -im(a)], 1).reshape(
        (2 * M,) + im(a).shape[1:]) for a in left))
    left = SpanElement(*(a[0::2] for a in wide))
    right = SpanElement(*(im(a) for a in right))
    T, stages = K5_TEAMS[team]
    out = _replay_combine(lib, left, right, T, stages)
    want = combine_im_plain(left, right)
    for name, got, w in zip(SpanElement._fields, out, want):
        w = w.numpy()
        lane_max = np.abs(w).max((0,) + tuple(range(2, w.ndim)),
                                 keepdims=True)
        scale = 1 + lane_max
        np.testing.assert_allclose(got.numpy() / scale, w / scale,
                                   atol=1e-10, err_msg=name)
    if T > 1:
        one = _replay_combine(lib, left, right)
        assert all(torch.equal(a, b) for a, b in zip(out, one))


def test_replayed_df_transforms_are_exact_and_bit_equal_to_plain(lib):
    """doublefloat.cuh's two_sum, two_prod and compensated dot in float32
    on the P3 probe's inputs (magnitudes spread up to 2^30): exact against
    float64, and bit for bit ops/doublefloat.py's plain version."""
    from fbstab_tpu_torch.ops.df_probe_cuda import (
        df_probe_plain, exactness, probe_inputs)

    a, b = probe_inputs(device="cpu")
    R, C = a.shape
    outs = [torch.empty(R, C) for _ in range(4)] + [
        torch.empty(1, C) for _ in range(2)]
    assert lib.fb_df_probe(R, C, a.data_ptr(), b.data_ptr(),
                           *[o.data_ptr() for o in outs]) == 0
    v = exactness(a, b, outs)
    assert v["two_sum_exact"] and v["two_prod_exact"]
    assert v["dot_rel_err"] < 1e-3 * v["f32_dot_rel_err"]
    for got, want in zip(outs, df_probe_plain(a, b)):
        assert torch.equal(got, want)


# (plant, the data's form, host team, staging): the spacecraft's 6-state
# stages take the kernel's team of 8, the reactor's 18-state stages a warp;
# the unscaled forms take the norm in the data's own units (the expanded
# plant, batch stride 0, is the final check's norm),
# the index_select'ed sub-batch a partial chunk's step; on the dense data
# the order of every sum shows in the margin's lo part.
RESIDUAL_CASES = {
    "spacecraft-scaled": ("spacecraft", "scaled", 8, True),
    "spacecraft-unscaled-point": ("spacecraft", "plain", 1, True),
    "spacecraft-expanded": ("spacecraft", "expanded", 8, True),
    "spacecraft-subbatch": ("spacecraft", "subbatch", 8, True),
    "copoly-scaled": ("copoly", "scaled", 32, True),
    "copoly-unscaled-in-place": ("copoly", "plain", 32, False),
    "copoly-expanded": ("copoly", "expanded", 32, True),
    "copoly-subbatch": ("copoly", "subbatch", 32, True),
    "dense-data": ("dense", "plain", 32, True),
}


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_replayed_refine_residual_is_bit_equal_to_plain(lib, case):
    """The refinement's residual (csrc/refine_residual.cuh) replayed in
    float32 against models/refine.py's eager composition on the CPU: the
    margin's pair and the four float32 KKT blocks bit for bit, the norm
    within 1e-6 relative (its sum of squares runs in another order); the
    norm alone (no blocks) the same norm. The launch goes through the
    wrapper's checks on the replay library."""
    from fbstab_tpu_torch.models.refine import mpc_residual_df_plain
    from fbstab_tpu_torch.ops.refine_residual_cuda import (
        launch_refine_residual)
    plant, form, T, stages = RESIDUAL_CASES[case]
    data, point, scal = residual_case(plant, form, 6)
    for blocks in (True, False):
        want = mpc_residual_df_plain(data, *point, ALPHA, scal, blocks)
        with on_team(lib, T, stages):
            got = launch_refine_residual(lib, data, *point, ALPHA, scal,
                                         blocks, stream=None)
        if blocks:
            for name, g, w in zip(("y", "y_lo", "rzx", "rzu", "rl", "rv"),
                                  (*got[0], *got[1]), (*want[0], *want[1])):
                assert torch.equal(g.view(torch.int32),
                                   w.view(torch.int32)), name
        else:
            assert got[0] is None and got[1] is None
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


# Host teams for P1: up to 32 threads; the kernels' teams of 3, 6 and 9
# (the candidates at n = 18) among them.
P1_TEAMS = (1, 2, 3, 4, 6, 8, 9, 32)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("B", [40, 128])
@pytest.mark.parametrize("n", [5, 18, 32])
@pytest.mark.parametrize("form", ["perlane", "shared"])
def test_replayed_probe_matches_plain_probe(lib, form, n, B, T):
    """P1's CUDA-core forms (csrc/mxu_probe.cuh) replayed in float64 on
    three stages: within 1e-12 of the plain version (relative to its
    largest entry), and on every team of more than one host thread (each
    holding ceil(n / T) rows; at n = 5 the last thread of a team of 2, 4
    or 8 holds a row beyond n) the team of one's bits, since every row's
    sum is taken by one thread in the team of one's order. n = 5 is a
    stage that the rows a thread holds do not divide, n = 18 the probe's,
    n = 32 the cap; B = 40 leaves a ragged lane chunk."""
    from fbstab_tpu_torch.ops import mxu_probe_cuda as p1

    N1 = 3
    Mp, Ms, w0 = p1.probe_inputs(N1, n, B, device="cpu",
                                 dtype=torch.float64)
    M, plain = ((Mp, p1.perlane_plain) if form == "perlane"
                else (Ms, p1.shared_plain))
    scale = p1.scale_of(n)
    want = plain(M, w0, T, scale)
    one = None
    for team in P1_TEAMS:
        got = torch.full_like(w0, float("nan"))
        with on_team(lib, team):
            assert lib.fb_mxu_probe(0 if form == "perlane" else 1, N1, n, B,
                                    T, scale, M.data_ptr(), w0.data_ptr(),
                                    got.data_ptr()) == 0
        if one is None:
            one = got
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0,
                atol=1e-12 * want.abs().max().item())
        else:
            assert torch.equal(got, one), team


def _tf32(x):
    """float64 rounded to TF32 as cvt.rna.tf32.f32 rounds: 10 mantissa
    bits after the leading one, to nearest, ties away from zero."""
    m, e = np.frexp(x)
    return np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2048.0 + 0.5), e - 11)


def _tc_plain(Ms, w0, T, scale):
    """tc_shared's function in float64: M and w rounded to TF32 before
    every application, the sum exact, then the scale."""
    N1, n = Ms.shape[:2]
    M, w = _tf32(Ms), w0.reshape(N1, n, -1)
    for _ in range(T):
        w = np.einsum("sij,sjb->sib", M, _tf32(w)) * scale
    return w.reshape(N1 * n, -1)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("B", [40, 128])
@pytest.mark.parametrize("n", [5, 18, 32])
def test_replayed_tc_probe_matches_tf32_plain_probe(lib, n, B, T):
    """P1's tensor-core form (csrc/mxu_probe.cuh, p1_tc_warp) replayed in
    float64 on three stages: each warp on 32 host threads holding the
    kernel's fragments, its MMA in software from the hardware's fragment
    layouts (both operands rounded to TF32, float64 sums), within 1e-12 of
    a numpy version that rounds M and w to TF32 every application
    (relative to its largest entry). A fragment map that the contraction
    order does not carry (pi dropped, A's registers swapped) moves entries
    by O(1). n = 5 and 18 pad the last n-tile, n = 32 fills four; B = 40
    leaves a ragged tile of lanes."""
    from fbstab_tpu_torch.ops import mxu_probe_cuda as p1

    N1 = 3
    _, Ms, w0 = p1.probe_inputs(N1, n, B, device="cpu", dtype=torch.float64)
    scale = p1.scale_of(n)
    want = _tc_plain(Ms.numpy(), w0.numpy(), T, scale)
    got = torch.full_like(w0, float("nan"))
    assert lib.fb_mxu_probe(2, N1, n, B, T, scale, Ms.data_ptr(),
                            w0.data_ptr(), got.data_ptr()) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())

"""PyTorch port: the sparse QP class (models/sparse_qp.py), its host LDL'
(utils/sparse_ldl.py on the port's own native/sparse_ldl.c) and
solve_sparse_qp_diff, held against fbstab_tpu in float64 on the CPU.

The cases of tests/test_sparse_solve.py run through both packages on the
same numpy inputs: every lane must give the JAX package's exit flag,
Newton and proximal counts, and iterates (z, l, v, y) within ITER_TOL =
1e-9, absolute and relative to the entry (assert_allclose's rtol = atol =
ITER_TOL: the infeasibility certificates reach 7e7, where 1e-9 is below
one ulp). Both packages must build the same pattern (CSC of K, the
RCM order, nnz(L), the scatter maps) and the same value arrays. The port's
C kernel is held bit for bit to its NumPy backend and to the JAX package's
SparseLDL on the matrices of tests/test_native_ldl.py and
tests/test_sparse_ldl.py, with the zero-pivot and malformed-pattern
contracts. The gradients of solve_sparse_qp_diff are held to jax.grad of
JAX's on tests/test_diff.py's sparse problem (rtol 1e-6, atol 1e-8 at
sigma_vjp = 1e-6, as tests/test_torch_diff.py holds the dense and MPC
layers) and to central differences. JAX is imported inside the parity
tests only, so the `cuda` tests at the end run on the card without it.
"""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import require_cuda, torch_options  # noqa: E402

from fbstab_tpu_torch import diff as tdiff  # noqa: E402
from fbstab_tpu_torch.core.algorithm import fbstab_solve  # noqa: E402
from fbstab_tpu_torch.core.variable import Variable  # noqa: E402
from fbstab_tpu_torch.interop import sparse_data_from_arrays  # noqa: E402
from fbstab_tpu_torch.models import sparse_qp as ts  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402
from fbstab_tpu_torch.utils import native_ldl  # noqa: E402
from fbstab_tpu_torch.utils.sparse_ldl import SparseLDL  # noqa: E402

F64 = torch.float64
ITER_TOL = 1e-9
ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("Hx", "f", "Gx", "h", "Ax", "b")


# ------------------------------------------------------------------
# Problems (tests/test_sparse_solve.py's), as dense numpy matrices.
# ------------------------------------------------------------------

def _qp(H, f, A, b, G=None, h=None):
    nz = len(f)
    G = np.zeros((0, nz)) if G is None else G
    h = np.zeros((0,)) if h is None else h
    return {k: np.asarray(v, float) for k, v in
            dict(H=H, f=f, G=G, h=h, A=A, b=b).items()}


FEASIBLE = _qp(H=[[3.0, 1.0], [1.0, 1.0]], f=[10.0, 5.0],
               A=[[-1.0, 0.0], [0.0, 1.0]], b=[0.0, 0.0])


def _random_sparse_qp(rng, nz=12, nl=3, nv=8):
    M = rng.standard_normal((nz, nz)) * (rng.random((nz, nz)) < 0.3)
    H = M @ M.T + 0.1 * np.eye(nz)
    H = np.where(np.abs(H) < 0.05, 0.0, H)
    H = (H + H.T) / 2 + 0.2 * np.eye(nz)
    f = rng.standard_normal(nz)
    G = rng.standard_normal((nl, nz)) * (rng.random((nl, nz)) < 0.4)
    h = rng.standard_normal(nl) * 0.3
    A = rng.standard_normal((nv, nz)) * (rng.random((nv, nz)) < 0.4)
    b = np.abs(rng.standard_normal(nv)) + 0.5
    return dict(H=H, f=f, G=G, h=h, A=A, b=b)


@functools.lru_cache(maxsize=None)
def _random_five():
    """test_matches_dense_path_on_random_sparse_qps's five problems."""
    rng = np.random.default_rng(0)
    return [_random_sparse_qp(rng) for _ in range(5)]


def _mixed_batch():
    """test_batched_mixed_outcomes_and_kkt's problem and its six lanes'
    b (lane 2 primal infeasible through an opposing pair of rows)."""
    rng = np.random.default_rng(1)
    p = _random_sparse_qp(rng, nz=6, nl=0, nv=6)
    p["G"], p["h"] = np.zeros((0, 6)), np.zeros((0,))
    p["A"] = np.vstack([p["A"], p["A"][0:1], -p["A"][0:1]])
    p["b"] = np.concatenate([p["b"], [1.0, 1.0]])
    bB = np.tile(p["b"], (6, 1))
    bB[2, -2:] = -1.0
    return p, bB


SINGLE = {
    "feasible": lambda: (FEASIBLE, 1e-8),
    "feasible_with_eq": lambda: (_qp(
        H=[[4.0, 1.0], [1.0, 2.0]], f=[1.0, 1.0], G=[[1.0, 1.0]], h=[1.0],
        A=[[-1.0, 0.0], [0.0, -1.0]], b=[0.0, 0.0]), 1e-8),
    "degenerate": lambda: (_qp(
        H=[[1.0, 0.0], [0.0, 0.0]], f=[1.0, 0.0],
        A=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
        b=[0.0, 3.0, 3.0, -1.0, -1.0]), 1e-8),
    "infeasible": lambda: (_qp(
        H=[[1.0, 0.0], [0.0, 0.0]], f=[1.0, -1.0],
        A=[[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
        b=[0.0, 3.0, 3.0, -1.0, -1.0]), 1e-8),
    "unbounded": lambda: (_qp(
        H=[[1.0, 0.0], [0.0, 0.0]], f=[1.0, -1.0],
        A=[[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, -1.0]],
        b=[0.0, 3.0, -1.0, -1.0]), 1e-8),
    **{f"random_{i}": (lambda i=i: (_random_five()[i], 1e-9))
       for i in range(5)},
    "pattern_reuse": lambda: (_random_sparse_qp(np.random.default_rng(2)),
                              1e-8),
    "three_call": lambda: (_random_sparse_qp(np.random.default_rng(3), nz=8,
                                             nl=2, nv=5), 1e-8),
    "orderings": lambda: (_random_sparse_qp(np.random.default_rng(4)),
                          1e-8),
}
EXPECT = {"feasible": ExitFlag.SUCCESS, "feasible_with_eq": ExitFlag.SUCCESS,
          "degenerate": ExitFlag.SUCCESS,
          "infeasible": ExitFlag.PRIMAL_INFEASIBLE,
          "unbounded": ExitFlag.DUAL_INFEASIBLE}


# ------------------------------------------------------------------
# The two packages side by side.
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    """The JAX package's sparse class and helpers (imported here only)."""
    import types

    import jax
    import jax.numpy as jnp

    import fbstab_tpu
    from fbstab_tpu.models import sparse_qp as jsp
    from fbstab_tpu.utils import sparse_ldl as jldl
    return types.SimpleNamespace(jax=jax, jnp=jnp, pkg=fbstab_tpu, sp=jsp,
                                 ldl=jldl)


def _jax_pair(jx, p, ordering="rcm"):
    return jx.sp.sparse_qp_data(p["H"], p["f"], p["G"], p["h"], p["A"],
                                p["b"], ordering=ordering)


def _port_pair(p, ordering="rcm"):
    return ts.sparse_qp_data(**{k: v[None] for k, v in p.items()},
                             ordering=ordering, device="cpu")


def _same_pattern(jp, tp):
    """The port builds the JAX package's pattern, map for map."""
    for name in ("Kp", "Ki", "perm", "iperm", "h_src", "h_dst", "a_src1",
                 "a_src2", "a_row", "a_dst", "g_src", "g_dst", "zdiag",
                 "ldiag"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    assert (tp.n, tp.knnz, tp.lnnz) == (jp.n, jp.knnz, jp.lnnz)
    for m in "HGA":
        for f in ("indptr", "indices", "row_ids"):
            np.testing.assert_array_equal(getattr(getattr(tp, m), f),
                                          getattr(getattr(jp, m), f))


def _zeros(pat, B=None):
    lead = () if B is None else (B,)
    return tuple(torch.zeros(*lead, k, dtype=F64)
                 for k in (pat.nz, pat.nl, pat.nv))


def _assert_same(xj, cj, xt, ct, batched=False):
    """Per lane: JAX's exit flag, Newton and proximal counts; iterates
    within ITER_TOL."""
    lane = (lambda a: np.asarray(a)) if batched else (
        lambda a: np.asarray(a)[None])
    tl = (lambda a: a.numpy()) if batched else (lambda a: a.numpy()[None])
    for k in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(tl(getattr(ct, k)),
                                      lane(getattr(cj, k)), err_msg=k)
    for k in ("z", "l", "v", "y"):
        np.testing.assert_allclose(tl(getattr(xt, k)), lane(getattr(xj, k)),
                                   rtol=ITER_TOL, atol=ITER_TOL, err_msg=k)


def _solve_both(jx, p, tol, ordering="rcm"):
    jp, jd = _jax_pair(jx, p, ordering)
    tp, td = _port_pair(p, ordering)
    _same_pattern(jp, tp)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(td, k)[0].numpy(),
                                      np.asarray(getattr(jd, k)), err_msg=k)
    jopts = jx.pkg.Options(abs_tol=tol)
    z = lambda n: jx.jnp.zeros(n)
    xj, cj = jx.sp.solve_sparse_qp(jp, jd, z(jp.nz), z(jp.nl), z(jp.nv),
                                   jopts)
    xt, ct = ts.solve_sparse_qp(tp, td, *_zeros(tp), torch_options(jopts))
    _assert_same(xj, cj, xt, ct)
    return (tp, td, xt, ct), (jp, jd, xj, cj)


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_instance_cases_match_jax(jx, case):
    """solve_sparse_qp on tests/test_sparse_solve.py's single-instance
    problems: the reference's flags and counts, iterates within 1e-9;
    the case-specific contracts of that file on the port's result."""
    p, tol = SINGLE[case]()
    (tp, td, xt, ct), _ = _solve_both(jx, p, tol)
    if case in EXPECT:
        assert int(ct.eflag) == EXPECT[case]
    if case == "feasible":
        np.testing.assert_allclose(xt.z.numpy(), [0.0, -5.0], atol=1e-8)
        np.testing.assert_allclose(xt.v.numpy(), [5.0, 0.0], atol=1e-8)
    if case == "feasible_with_eq":
        np.testing.assert_allclose(xt.z.numpy(), [0.25, 0.75], atol=1e-8)
    if case == "degenerate":
        z, v, y = xt.z.numpy(), xt.v.numpy(), xt.y.numpy()
        assert abs(z[0] - 1.0) <= 1e-8 and 1.0 - 1e-8 <= z[1] <= 3.0 + 1e-8
        r1 = p["H"] @ z + p["f"] + p["A"].T @ v
        assert np.linalg.norm(r1) + np.linalg.norm(np.minimum(y, v)) <= 1e-6
    if case.startswith("random"):
        # The dense path on the same QP (the port's lockstep dense solve).
        from fbstab_tpu_torch.models.dense_qp import (
            dense_qp_data, solve_dense_qp)
        dd = dense_qp_data(**{k: v[None] for k, v in p.items()},
                           device="cpu")
        xd, cd = solve_dense_qp(dd, *_zeros(tp), Options(abs_tol=1e-9))
        assert int(cd.eflag) == int(ct.eflag) == ExitFlag.SUCCESS
        for k in ("z", "l", "v"):
            np.testing.assert_allclose(getattr(xd, k).numpy(),
                                       getattr(xt, k).numpy(), atol=1e-6)
    if case == "pattern_reuse":
        # Same structure, new values: no new analysis, a new solution.
        d2 = ts.pattern_values(tp, 2.0 * p["H"][None], p["f"][None] + 1.0,
                               p["G"][None], p["h"][None], p["A"][None],
                               p["b"][None] + 0.5, device="cpu")
        jp, jd2 = _jax_pair(jx, p)
        jd2 = jx.sp.pattern_values(jp, 2.0 * p["H"], p["f"] + 1.0, p["G"],
                                   p["h"], p["A"], p["b"] + 0.5)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(d2, k)[0].numpy(),
                                          np.asarray(getattr(jd2, k)))
        x2, c2 = ts.solve_sparse_qp(tp, d2, *_zeros(tp), Options(
            abs_tol=1e-8))
        z = lambda n: jx.jnp.zeros(n)
        xj2, cj2 = jx.sp.solve_sparse_qp(jp, jd2, z(jp.nz), z(jp.nl),
                                         z(jp.nv), jx.pkg.Options(
                                             abs_tol=1e-8))
        _assert_same(xj2, cj2, x2, c2)
        assert int(c2.eflag) == ExitFlag.SUCCESS
        assert not np.allclose(x2.z.numpy(), xt.z.numpy())
    if case == "three_call":
        # factor / factor_ok / newton_solve (two round trips a step) give
        # the fused step's iterates.
        def three_call(d, x, xbar, sigma, alpha, rz, rl, rv):
            fact = ts.factor(tp, d, x, xbar, sigma, alpha)
            return (ts.newton_solve(tp, d, fact, rz, rl, rv),
                    ts.factor_ok(fact))

        ops3 = tp.ops._replace(newton_step=three_call)
        tp.split.reset()
        x3, c3 = fbstab_solve(ops3, td, *_zeros(tp), Options(abs_tol=1e-8))
        assert tp.split.round_trips == 2 * int(c3.newton_iters)
        assert int(c3.eflag) == int(ct.eflag) == ExitFlag.SUCCESS
        assert int(c3.newton_iters) == int(ct.newton_iters)
        np.testing.assert_allclose(x3.z.numpy(), xt.z.numpy(), atol=1e-12)
    if case == "orderings":
        # RCM and natural factor different patterns; each matches JAX's
        # own, and both reach the same solution.
        assert not np.array_equal(tp.perm, np.arange(tp.n))
        (tn, _, xn, cn), _ = _solve_both(jx, p, tol, ordering="natural")
        np.testing.assert_array_equal(tn.perm, np.arange(tn.n))
        assert int(cn.eflag) == int(ct.eflag) == ExitFlag.SUCCESS
        np.testing.assert_allclose(xn.z.numpy(), xt.z.numpy(), atol=1e-8)


def test_batched_mixed_outcomes_match_jax(jx):
    """One batch over a shared pattern, lane 2 primal infeasible: the
    port's batch against JAX's jitted vmapped batch, lane by lane, and
    the KKT residual of the first SUCCESS lanes."""
    p, bB = _mixed_batch()
    jp, jd = _jax_pair(jx, p)
    B = bB.shape[0]
    jB = jx.jax.tree.map(lambda a: jx.jnp.stack([a] * B), jd)._replace(
        b=jx.jnp.asarray(bB))
    jopts = jx.pkg.Options(abs_tol=1e-8)
    z = lambda n: jx.jnp.zeros((B, n))
    xj, cj = jx.jax.jit(lambda d, a, b_, c: jx.sp.solve_sparse_qp_batch(
        jp, d, a, b_, c, jopts))(jB, z(jp.nz), z(jp.nl), z(jp.nv))
    tp, _ = _port_pair(p)
    tB = sparse_data_from_arrays(device="cpu", **{
        k: np.asarray(getattr(jB, k)) for k in FIELDS})
    xt, ct = ts.solve_sparse_qp_batch(tp, tB, *_zeros(tp, B),
                                      torch_options(jopts))
    _assert_same(xj, cj, xt, ct, batched=True)
    eflags = ct.eflag.numpy()
    assert eflags[2] == ExitFlag.PRIMAL_INFEASIBLE
    assert np.all(np.delete(eflags, 2) == ExitFlag.SUCCESS)
    for i in (0, 1):
        r = p["H"] @ xt.z[i].numpy() + p["f"] + p["A"].T @ xt.v[i].numpy()
        assert np.max(np.abs(r)) < 1e-7


def test_facade_warmstart_and_validation_match_jax(jx):
    """FBstabSparse: a cold solve and a solve warmstarted from it (no
    proximal iteration) as the JAX facade's, and the shape check."""
    jp, jd = _jax_pair(jx, FEASIBLE)
    js = jx.sp.FBstabSparse(jp, jx.pkg.Options(abs_tol=1e-8))
    jx1, jo1 = js.solve(jd)
    jx2, jo2 = js.solve(jd, x0=jx1)
    tp, td = _port_pair(FEASIBLE)
    s = ts.FBstabSparse(tp, Options(abs_tol=1e-8), device="cpu")
    x1, o1 = s.solve(td)
    x2, o2 = s.solve(td, x0=x1)
    _assert_same(jx1, jo1, Variable(*(a[0] for a in x1)), o1)
    _assert_same(jx2, jo2, Variable(*(a[0] for a in x2)), o2)
    assert int(o2.eflag) == ExitFlag.SUCCESS and int(o2.prox_iters) == 0
    np.testing.assert_allclose(x2.z.numpy(), x1.z.numpy(), atol=1e-10)
    with pytest.raises(ValueError, match="f has shape"):
        s.solve(td._replace(f=torch.zeros(1, 3, dtype=F64)))


def test_facade_final_summary_reaches_the_stream():
    """Display.FINAL prints the reference's closing table to the
    facade's stream."""
    import dataclasses

    from fbstab_tpu_torch.options import Display
    from fbstab_tpu_torch.utils.printing import OutputStream

    class Capture(OutputStream):
        def __init__(self):
            self.buf = []

        def print(self, msg):
            self.buf.append(msg)

    tp, td = _port_pair(FEASIBLE)
    sink = Capture()
    s = ts.FBstabSparse(tp, device="cpu", stream=sink)
    s.update_options(dataclasses.replace(Options(abs_tol=1e-8),
                                         display_level=Display.FINAL))
    s.solve(td)
    text = "".join(sink.buf)
    assert "Optimization completed!  Exit code: Success" in text
    assert "|rz|" in text


def test_mpc_benchmark_through_sparse_path_matches_jax(jx):
    """The double integrator (N = 10) materialized into its sparse form:
    the port's sparse solve as JAX's, the port's Riccati solve on the MPC
    data within 1e-7, and modest fill."""
    from test_mpc_solve import materialize
    from torch_parity import plant_arrays, torch_data

    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp

    arrays = plant_arrays("double_integrator", 10, 1)
    H, f, G, h, A, b = materialize(_MpcView(arrays))
    p = dict(H=H, f=f, G=G, h=h, A=A, b=b)
    (tp, _, xs, cs), _ = _solve_both(jx, p, 1e-8)
    md = torch_data(arrays, F64)
    xr, cr = solve_mpc_qp(md, *_zeros(tp), Options(abs_tol=1e-8))
    assert int(cr.eflag) == int(cs.eflag) == ExitFlag.SUCCESS
    np.testing.assert_allclose(xr.z.numpy(), xs.z.numpy(), atol=1e-7)
    np.testing.assert_allclose(xr.v.numpy(), xs.v.numpy(), atol=1e-7)
    assert tp.lnnz < 0.2 * (tp.n * (tp.n + 1)) // 2


class _MpcView:
    """Lane 0 of port-shaped MPC arrays, read as the JAX package's
    unbatched MpcQPData (what tests/test_mpc_solve.py's materialize
    takes)."""

    def __init__(self, arrays):
        for k, v in arrays.items():
            setattr(self, k, np.asarray(v[0]))


def test_mpc_sparse_bridge_matches_jax(jx):
    """mpc_sparse_pattern / mpc_sparse_values: the JAX package's pattern
    and values on tests/test_sparse_solve.py's random MPC (key 3, N = 6),
    products equal to the materialized matrices, the solve as JAX's and
    within 1e-6 of the port's Riccati solve, fill O(N)."""
    from test_mpc_solve import materialize, random_mpc
    from torch_parity import torch_data

    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp

    jd_mpc = random_mpc(jx.jax.random.key(3), N=6, nx=3, nu=2, nc=4)
    arrays = {k: np.asarray(getattr(jd_mpc, k))[None]
              for k in jd_mpc._fields}
    jp = jx.sp.mpc_sparse_pattern(6, 3, 2, 4)
    jv = jx.sp.mpc_sparse_values(jd_mpc)
    tp = ts.mpc_sparse_pattern(6, 3, 2, 4)
    _same_pattern(jp, tp)
    md = torch_data(arrays, F64)
    tv = ts.mpc_sparse_values(md)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tv, k)[0].numpy(),
                                      np.asarray(getattr(jv, k)), err_msg=k)
    H, f, G, h, A, b = materialize(jd_mpc)
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, tp.nz)))
    for gemv, M in ((tp.ops.gemvH, H), (tp.ops.gemvG, G),
                    (tp.ops.gemvA, A)):
        np.testing.assert_allclose(gemv(tv, x)[0].numpy(), M @ x[0].numpy(),
                                   atol=1e-12)
    for gemv, M in ((tp.ops.gemvGT, G), (tp.ops.gemvAT, A)):
        y = torch.tensor(np.random.default_rng(1).standard_normal(
            (1, M.shape[0])))
        np.testing.assert_allclose(gemv(tv, y)[0].numpy(),
                                   M.T @ y[0].numpy(), atol=1e-12)
    jopts = jx.pkg.Options(abs_tol=1e-9)
    z = lambda n: jx.jnp.zeros(n)
    xj, cj = jx.sp.solve_sparse_qp(jp, jv, z(jp.nz), z(jp.nl), z(jp.nv),
                                   jopts)
    xs, cs = ts.solve_sparse_qp(tp, tv, *_zeros(tp), torch_options(jopts))
    _assert_same(xj, cj, xs, cs)
    xr, cr = solve_mpc_qp(md, *_zeros(tp), Options(abs_tol=1e-9))
    assert int(cs.eflag) == int(cr.eflag) == ExitFlag.SUCCESS
    np.testing.assert_allclose(xs.z.numpy(), xr.z.numpy(), atol=1e-6)
    assert ts.mpc_sparse_pattern(12, 3, 2, 4).lnnz < 2.6 * tp.lnnz
    assert ts.mpc_sparse_pattern(6, 3, 2, 4) is tp


def test_nan_data_fails_cleanly_lane_by_lane(jx):
    """NaN in H: a non-SUCCESS flag (the JAX package's), not a crash or a
    NaN marked SUCCESS; in a batch, only that lane fails."""
    jp, jd = _jax_pair(jx, FEASIBLE)
    bad = jd._replace(Hx=jd.Hx.at[0].set(jx.jnp.nan))
    z = lambda n: jx.jnp.zeros(n)
    _, cj = jx.sp.solve_sparse_qp(jp, bad, z(2), z(0), z(2),
                                  jx.pkg.Options(abs_tol=1e-8))
    tp, td = _port_pair(FEASIBLE)
    two = ts.SparseQPData(*(a.repeat(2, 1) for a in td))
    two = two._replace(Hx=two.Hx.clone())
    two.Hx[1, 0] = float("nan")
    x, c = ts.solve_sparse_qp_batch(tp, two, *_zeros(tp, 2),
                                    Options(abs_tol=1e-8))
    assert int(c.eflag[1]) == int(cj.eflag) != ExitFlag.SUCCESS
    assert int(c.eflag[1]) == ExitFlag.LINEAR_SOLVER_FAILED
    assert int(c.eflag[0]) == ExitFlag.SUCCESS
    np.testing.assert_allclose(x.z[0].numpy(), [0.0, -5.0], atol=1e-8)


def test_failed_lane_returns_nan_and_not_ok():
    """The host step on a zero pivot: ok False and NaN for that lane
    only, the other lane's step finite."""
    tp, _ = _port_pair(FEASIBLE)
    Kv = np.zeros((2, tp.knnz))
    Kv[0, tp.zdiag] = 1.0
    x = np.ones((2, tp.n))
    ok = tp._host_factor_solve(Kv, x)
    assert ok.tolist() == [True, False]
    assert np.all(np.isnan(x[1])) and np.all(np.isfinite(x[0]))


# ------------------------------------------------------------------
# The host LDL': the C kernel, its NumPy backend and the JAX package's.
# ------------------------------------------------------------------

def _random_qd_csc(n, rng, density=0.15):
    """tests/test_native_ldl.py's random quasi-definite matrix."""
    M = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    M = (M + M.T) / 2 + np.diag(10.0 + rng.random(n))
    return (M,) + _upper_csc(M)


def _upper_csc(K):
    Ap, Ai, Ax = [0], [], []
    for j in range(K.shape[0]):
        for i in range(j + 1):
            if K[i, j] != 0.0 or i == j:
                Ai.append(i)
                Ax.append(K[i, j])
        Ap.append(len(Ai))
    return (np.asarray(Ap, np.int64), np.asarray(Ai, np.int64),
            np.asarray(Ax, float))


def _kkt():
    """tests/test_native_ldl.py's quasi-definite KKT matrix."""
    rng = np.random.default_rng(7)
    nz, nl, sigma = 6, 4, 1e-2
    H = rng.standard_normal((nz, nz))
    H = H @ H.T
    G = rng.standard_normal((nl, nz))
    K = np.zeros((nz + nl, nz + nl))
    K[:nz, :nz] = H + sigma * np.eye(nz)
    K[:nz, nz:] = G.T
    K[nz:, :nz] = G
    K[nz:, nz:] = -sigma * np.eye(nl)
    return (K,) + _upper_csc(K)


def _qdldl_example():
    """tests/test_sparse_ldl.py's 10 x 10 quasi-definite example."""
    Ap = np.asarray([0, 1, 2, 4, 5, 6, 8, 10, 12, 14, 17], np.int64)
    Ai = np.asarray([0, 1, 1, 2, 3, 4, 1, 5, 0, 6, 3, 7, 6, 8, 1, 2, 9],
                    np.int64)
    Ax = np.asarray([1.0, 0.460641, -0.121189, 0.417928, 0.177828, 0.1,
                     -0.0290058, -1.0, 0.350321, -0.441092, -0.0845395,
                     -0.316228, 0.178663, -0.299077, 0.182452, -1.56506,
                     -0.1])
    K = np.zeros((10, 10))
    for j in range(10):
        K[Ai[Ap[j]:Ap[j + 1]], j] = Ax[Ap[j]:Ap[j + 1]]
    return K + np.triu(K, 1).T, Ap, Ai, Ax


def _ldl_matrices():
    rng = np.random.default_rng(3)
    mats = {f"random_{n}": _random_qd_csc(n, rng) for n in (5, 23, 80)}
    mats["kkt"] = _kkt()
    mats["qdldl_example"] = _qdldl_example()
    return mats


LDL_MATRICES = _ldl_matrices()


def test_c_source_is_the_reference_below_its_header():
    ours = (ROOT / "fbstab_tpu_torch/native/sparse_ldl.c").read_text()
    ref = (ROOT / "fbstab_tpu/native/sparse_ldl.c").read_text()
    head, sep, body = ours.partition("/* Sparse quasi-definite LDL'")
    assert sep and "fbstab_tpu/native/sparse_ldl.c" in head
    assert sep + body == ref


def test_library_builds_into_the_ports_build_dir():
    path = native_ldl.library_path()
    assert path.parent == ROOT / "fbstab_tpu_torch" / "_build"
    native_ldl.load()
    assert path.exists()
    assert not (ROOT / "fbstab_tpu_torch" / "native" / "_sparse_ldl.so"
                ).exists()


@pytest.mark.parametrize("name", sorted(LDL_MATRICES))
def test_native_matches_numpy_backend_and_jax_bit_for_bit(jx, name):
    """Factors and solutions of the C kernel equal the NumPy backend's and
    the JAX package's SparseLDL's bit for bit; the solve meets 1e-12."""
    K, Ap, Ai, Ax = LDL_MATRICES[name]
    n = K.shape[0]
    sn = SparseLDL(n, Ap, Ai, backend="native")
    sp = SparseLDL(n, Ap, Ai, backend="python")
    sj = jx.ldl.SparseLDL(n, Ap, Ai)
    assert sn.backend == "native" and sp.backend == "python"
    b = np.random.default_rng(1).standard_normal(n)
    xs = []
    for s in (sn, sp, sj):
        s.factor(Ax)
        x = b.copy()
        s.solve(x)
        xs.append(x)
    for attr in ("parent", "Lp", "Li", "Lx", "D", "Dinv"):
        for s in (sp, sj):
            np.testing.assert_array_equal(getattr(s, attr),
                                          getattr(sn, attr), err_msg=attr)
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])
    assert np.linalg.norm(K @ xs[0] - b) <= 1e-12


def test_native_batch_factor_solve_matches_numpy_backend():
    rng = np.random.default_rng(5)
    n, B = 40, 8
    _, Ap, Ai, Ax = _random_qd_csc(n, rng)
    AxB = np.tile(Ax, (B, 1)) * (1.0 + 0.01 * rng.random((B, Ax.size)))
    rhs = rng.standard_normal((B, n))
    xn, xp = rhs.copy(), rhs.copy()
    assert SparseLDL(n, Ap, Ai, backend="native").factor_solve_batch(
        AxB, xn) == 0
    assert SparseLDL(n, Ap, Ai, backend="python").factor_solve_batch(
        AxB, xp) == 0
    np.testing.assert_array_equal(xn, xp)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_zero_pivot_contract(backend):
    with pytest.raises(ZeroDivisionError, match="column 0"):
        SparseLDL(1, [0, 1], [0], backend=backend).factor(np.array([0.0]))
    with pytest.raises(ZeroDivisionError):
        SparseLDL(2, [0, 1, 2], [0, 1], backend=backend).factor([1.0, 0.0])
    # Batched: the bad instance reports its column, others still solve.
    rng = np.random.default_rng(9)
    M, Ap, Ai, Ax = _random_qd_csc(10, rng, density=0.0)
    AxB = np.stack([Ax, Ax])
    AxB[1, :] = 0.0
    rhs = rng.standard_normal((2, 10))
    x = rhs.copy()
    assert SparseLDL(10, Ap, Ai, backend=backend).factor_solve_batch(
        AxB, x) == 1
    assert np.allclose(np.diag(M) * x[0], rhs[0], atol=1e-12)
    np.testing.assert_array_equal(x[1], rhs[1])


@pytest.mark.parametrize("backend", ["native", "python"])
def test_malformed_pattern_and_sizes_rejected(backend):
    with pytest.raises(ValueError, match="column 1"):
        SparseLDL(2, [0, 1, 2], [0, 0], backend=backend)
    with pytest.raises(ValueError):
        SparseLDL(2, [0, 1, 1], [0], backend=backend)
    with pytest.raises(ValueError):
        SparseLDL(2, [0, 1, 3], [0, 0], backend=backend)     # short Ai
    s = SparseLDL(2, [0, 1, 3], [0, 0, 1], backend=backend)
    with pytest.raises(RuntimeError):
        s.solve(np.zeros(2))                                 # not factored
    s.factor(np.array([2.0, 0.5, 3.0]))
    with pytest.raises(ValueError):
        s.solve(np.zeros(1))
    with pytest.raises(ValueError):
        s.factor(np.zeros(2))
    with pytest.raises(ValueError):
        s.factor_solve_batch(np.ones((6, 3)), np.ones((2, 2)))
    # factor_solve_batch leaves the last instance's factor loaded.
    xB = np.ones((2, 2))
    assert s.factor_solve_batch(np.tile([2.0, 0.5, 3.0], (2, 1)), xB) == 0
    x = np.ones(2)
    s.solve(x)
    np.testing.assert_array_equal(x, xB[1])


def test_pattern_reuse_across_factorizations():
    """tests/test_sparse_ldl.py's analyze-once, factor-twice case."""
    ldl = SparseLDL(3, [0, 1, 2, 4], [0, 1, 0, 2])
    for scale in (1.0, 3.0):
        vals = np.array([2.0, -1.0, 0.5, -2.0]) * scale
        ldl.factor(vals)
        b = np.array([1.0, 2.0, 3.0])
        x = b.copy()
        ldl.solve(x)
        A = np.array([[vals[0], 0, vals[2]], [0, vals[1], 0],
                      [vals[2], 0, vals[3]]])
        np.testing.assert_allclose(A @ x, b, atol=1e-13)


def test_no_silent_numpy_fallback(monkeypatch, tmp_path):
    """Where no C compiler builds the source, "auto" raises (the JAX
    package would turn to NumPy), and so does a SparsePattern."""
    monkeypatch.setattr(native_ldl, "_lib", None)
    monkeypatch.setattr(native_ldl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_ldl, "COMPILERS", ("no-such-cc",))
    with pytest.raises(RuntimeError, match="cannot build"):
        SparseLDL(2, [0, 1, 2], [0, 1])
    with pytest.raises(RuntimeError, match="cannot build"):
        _port_pair(FEASIBLE)
    assert SparseLDL(2, [0, 1, 2], [0, 1], backend="python").backend == \
        "python"
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------------------
# The differentiable sparse solve.
# ------------------------------------------------------------------

SIGMA_PARITY = 1e-6
JOPTS_DIFF = dict(abs_tol=1e-11)     # tests/test_diff.py's OPTS


def _diff_problem():
    """tests/test_diff.py's sparse problem (its _dense_problem(seed=3)
    with small off-diagonals of H and small entries of A dropped)."""
    rng = np.random.default_rng(3)
    nz, nl, nv = 5, 2, 4
    M = rng.standard_normal((nz, nz))
    H = M @ M.T + 0.5 * np.eye(nz)
    f = rng.standard_normal(nz)
    G = rng.standard_normal((nl, nz))
    h = rng.standard_normal(nl) * 0.2
    A = rng.standard_normal((nv, nz))
    b = rng.standard_normal(nv) * 0.5 + 1.0
    H = np.where((np.abs(H) < 0.3) & ~np.eye(nz, dtype=bool), 0.0, H)
    A = np.where(np.abs(A) < 0.2, 0.0, A)
    return dict(H=H, f=f, G=G, h=h, A=A, b=b)


def _port_diff_grads(tp, td, sigma_vjp=SIGMA_PARITY):
    fields = [a.clone().requires_grad_() for a in td]
    z, l, v = ts_diff(tp, ts.SparseQPData(*fields), sigma_vjp)
    (0.5 * (z * z).sum() + l.sum()).backward()
    return {k: f.grad[0].numpy() for k, f in zip(FIELDS, fields)}, (z, l, v)


def ts_diff(tp, data, sigma_vjp):
    return tdiff.solve_sparse_qp_diff(tp, data, *_zeros(tp),
                                      Options(**JOPTS_DIFF), sigma_vjp)


def test_sparse_diff_gradients_match_jax(jx):
    """Gradients of 0.5 |z|^2 + sum(l) with respect to all six value
    arrays, against jax.grad of the JAX package's solve_sparse_qp_diff
    (jitted once) at sigma_vjp = 1e-6: rtol 1e-6, atol 1e-8."""
    from fbstab_tpu import diff as jdiff
    p = _diff_problem()
    jp, jd = _jax_pair(jx, p)
    z0 = (jx.jnp.zeros(5), jx.jnp.zeros(2), jx.jnp.zeros(4))
    jopts = jx.pkg.Options(**JOPTS_DIFF)

    def loss(d):
        z, l, v = jdiff.solve_sparse_qp_diff(jp, d, *z0, jopts, SIGMA_PARITY)
        return 0.5 * jx.jnp.sum(z ** 2) + jx.jnp.sum(l), (z, l, v)

    g, out = jx.jax.jit(jx.jax.grad(loss, has_aux=True))(jd)
    tp, td = _port_pair(p)
    got, (z, l, v) = _port_diff_grads(tp, td)
    for a, want in zip((z, l, v), out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(want),
                                   atol=ITER_TOL)
    for k in FIELDS:
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], np.asarray(getattr(g, k)),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_sparse_diff_matches_central_differences():
    """The port's gradient (default sigma_vjp) against central
    differences of the port's own solve, tests/test_diff.py's tolerance
    (rtol 5e-4 or atol 1e-4), three entries of each field."""
    p = _diff_problem()
    tp, td = _port_pair(p)
    got, _ = _port_diff_grads(tp, td, sigma_vjp=None)
    rng = np.random.default_rng(4)
    eps = 1e-6

    def loss(d):
        x, _ = ts.solve_sparse_qp(tp, d, *_zeros(tp), Options(**JOPTS_DIFF))
        return float(0.5 * (x.z * x.z).sum() + x.l.sum())

    for k in FIELDS:
        for _ in range(3):
            j = int(rng.integers(0, getattr(td, k).shape[1]))

            def bump(s):
                a = getattr(td, k).clone()
                a[0, j] += s
                return td._replace(**{k: a})

            fd = (loss(bump(eps)) - loss(bump(-eps))) / (2 * eps)
            av = got[k][j]
            adiff = abs(av - fd)
            assert (adiff / max(1e-6, abs(av), abs(fd)) < 5e-4
                    or adiff < 1e-4), (k, j, av, fd)


# ------------------------------------------------------------------
# On the card (marked `cuda`; skipped without a CUDA device).
# ------------------------------------------------------------------

def _mixed_case():
    p, bB = _mixed_batch()
    tp, td = _port_pair(p)
    return tp, ts.SparseQPData(*(a.repeat(6, 1) for a in td))._replace(
        b=torch.tensor(bB))


def _mpc_bridge_case(B=64):
    """The headline MPC batch (workloads.build_batch, seed 0) in float64
    through mpc_sparse_pattern: on the card, lanes 17 and 25 ended on the
    stall test at ~1e-6 while the products summed with atomics."""
    from fbstab_tpu_torch.workloads import HEADLINE, build_batch
    mpc = build_batch(B, **HEADLINE, device="cpu", dtype=F64)
    return (ts.mpc_sparse_pattern(*(HEADLINE[k] for k in ("N", "nx", "nu",
                                                          "nc"))),
            ts.mpc_sparse_values(mpc))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "mpc_bridge"])
def test_cuda_sparse_batch_equals_cpu_batch(case):
    """A batch with its values on the card (products and K's assembly
    there, the LDL' on the host) gives the CPU batch's flags and counts,
    iterates within 1e-10: the mixed-outcome batch, and the headline MPC
    batch through the sparse bridge (B = 64)."""
    require_cuda()
    tp, cpu = _mixed_case() if case == "mixed" else _mpc_bridge_case()
    B = cpu.f.shape[0]
    gpu = ts.SparseQPData(*(a.cuda() for a in cpu))
    opts = Options(abs_tol=1e-9 if case == "mpc_bridge" else 1e-8)
    xc, cc = ts.solve_sparse_qp_batch(tp, cpu, *_zeros(tp, B), opts)
    xg, cg = ts.solve_sparse_qp_batch(
        tp, gpu, *(g.cuda() for g in _zeros(tp, B)), opts)
    for k in ("eflag", "newton_iters", "prox_iters"):
        assert torch.equal(getattr(cg, k).cpu(), getattr(cc, k)), k
    for k in ("z", "l", "v", "y"):
        np.testing.assert_allclose(getattr(xg, k).cpu().numpy(),
                                   getattr(xc, k).numpy(), rtol=0,
                                   atol=1e-10, err_msg=k)


@pytest.mark.cuda
def test_cuda_facade_solves_the_feasible_case():
    """FBstabSparse on the card (its default device) solves the
    reference's feasible QP."""
    require_cuda()
    pat, data = ts.sparse_qp_data(**{k: v[None] for k, v in
                                     FEASIBLE.items()})
    assert data.f.is_cuda
    x, out = ts.FBstabSparse(pat, Options(abs_tol=1e-8)).solve(data)
    assert int(out.eflag) == ExitFlag.SUCCESS
    np.testing.assert_allclose(x.z[0].cpu().numpy(), [0.0, -5.0], atol=1e-8)
    np.testing.assert_allclose(x.v[0].cpu().numpy(), [5.0, 0.0], atol=1e-8)

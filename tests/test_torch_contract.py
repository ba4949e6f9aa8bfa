"""PyTorch port: the float32 contract stack. The small ops (PFB, the
double-float transforms) match the JAX package bitwise in float32, Ruiz
scaling gives exactly the reference's power-of-two diagonals, the
refinement walk window takes the reference's decisions branch by branch,
and `solve_mpc_qp_batch(..., Options.single_precision())` in float32 on the
CPU meets the reference's unrolled contract pin (host float64 residual
<= 3e-6, tests/test_contract.py) on every lane."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fbstab_tpu.models import refine as jref  # noqa: E402
from fbstab_tpu.models import scaling as jscal  # noqa: E402
from fbstab_tpu.ops import doublefloat as jdf  # noqa: E402
from fbstab_tpu.ops import pfb as jpfb  # noqa: E402
from torch_parity import (  # noqa: E402
    dims, f64_residual, headline_arrays, jax_data, perturbed_x0,
    plant_arrays, torch_data)

from fbstab_tpu_torch.models import refine as tref  # noqa: E402
from fbstab_tpu_torch.models import scaling as tscal  # noqa: E402
from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch  # noqa: E402
from fbstab_tpu_torch.ops import doublefloat as tdf  # noqa: E402
from fbstab_tpu_torch.ops import pfb as tpfb  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402

ALPHA = 0.95


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pfb_inputs():
    rng = np.random.default_rng(11)
    a, b = _f32(rng, 64), _f32(rng, 64)
    a[:4] = 0.0                       # the degenerate corner r < 1e-13
    b[:4] = 0.0
    a[4:8], b[4:8] = np.abs(a[4:8]), np.abs(b[4:8])   # interior branch
    return a, b


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("op", ["pfb", "pfb_gradient", "pfb_weights"])
def test_pfb_ops_bitwise_f32(op):
    a, b = _pfb_inputs()
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if op == "pfb":
        _same(tpfb.pfb(ta, tb, ALPHA), jpfb.pfb(ja, jb, ALPHA))
    elif op == "pfb_gradient":
        for g, w in zip(tpfb.pfb_gradient(ta, tb, ALPHA),
                        jpfb.pfb_gradient(ja, jb, ALPHA)):
            _same(g, w)
    else:
        vbar = np.roll(b, 3)
        for g, w in zip(
                tpfb.pfb_weights(ta, tb, torch.tensor(vbar), 3e-4, ALPHA),
                jpfb.pfb_weights(ja, jb, jnp.asarray(vbar), 3e-4, ALPHA)):
            _same(g, w)


@pytest.mark.parametrize("op", ["two_sum", "two_prod", "df_add", "df_mul",
                                "df_matvec", "df_matvec_T", "df_sqrt"])
def test_doublefloat_transforms_bitwise_f32(op):
    rng = np.random.default_rng(5)
    x = (_f32(rng, 6, 7, scale=1e3), _f32(rng, 6, 7, scale=1e-4))
    y = (_f32(rng, 6, 7), _f32(rng, 6, 7, scale=1e-7))
    M = _f32(rng, 6, 5, 7)
    tt = lambda p: tuple(torch.tensor(a) for a in p)
    jj = lambda p: tuple(jnp.asarray(a) for a in p)
    if op == "two_sum":
        got, want = tdf.two_sum(*tt(x)), jdf.two_sum(*jj(x))
    elif op == "two_prod":
        got, want = tdf.two_prod(*tt(x)), jdf.two_prod(*jj(x))
    elif op == "df_add":
        got, want = tdf.df_add(tt(x), tt(y)), jdf.df_add(jj(x), jj(y))
    elif op == "df_mul":
        got, want = tdf.df_mul(tt(x), tt(y)), jdf.df_mul(jj(x), jj(y))
    elif op == "df_matvec":
        got = tdf.df_matvec(torch.tensor(M), tt(x))
        want = jdf.df_matvec(jnp.asarray(M), jj(x))
    elif op == "df_matvec_T":
        x5 = tuple(a[:, :5] for a in x)
        got = tdf.df_matvec_T(torch.tensor(M), tt(x5))
        want = jdf.df_matvec_T(jnp.asarray(M), jj(x5))
    else:
        sq = (np.abs(x[0]), np.abs(x[1]))
        got, want = tdf.df_sqrt(tt(sq)), jdf.df_sqrt(jj(sq))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("case", ["servo", "spacecraft", "headline"])
def test_ruiz_scaling_pow2_diagonals_equal_reference(case):
    if case == "servo":
        arrays = plant_arrays("servo_motor", 6, 2)
    elif case == "spacecraft":
        arrays = plant_arrays("spacecraft_relative_motion", 5, 2)
    else:
        arrays = headline_arrays(3, N=5)
    jd = jax_data(arrays, jnp.float32)
    ref = jax.vmap(jscal.ruiz_mpc_scaling)(jd)
    td = torch_data(arrays, torch.float32)
    got = tscal.ruiz_mpc_scaling(td)
    for f in ("dx", "du", "de", "kc"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        _same(g, w)
        assert np.all(np.log2(g) == np.round(np.log2(g))), f
    sref = jax.vmap(jscal.apply_mpc_scaling)(jd, ref)
    sgot = tscal.apply_mpc_scaling(td, got)
    for f in sref._fields:
        _same(getattr(sgot, f).numpy(), np.asarray(getattr(sref, f)))


def _walk_carry(B, rng):
    state = tuple((_f32(rng, B, 3), _f32(rng, B, 3)) for _ in range(2))
    rhs = tuple(_f32(rng, B, 3) for _ in range(2))
    return state, rhs


def test_walk_update_matches_reference_branch_by_branch():
    """Six lanes, one per branch of the walk window, stepped together for
    ten steps through both helpers: improve, walk, return to best
    (walk budget exhausted), reject with 8x sigma, second wind after the
    sigma cap, dead lane."""
    B, T = 6, 10
    rng = np.random.default_rng(3)
    base = np.float32(1e-4)
    # Per step, per lane: trial residual relative to the entry residual.
    res_seq = np.ones((T, B), np.float32)
    res_seq[:, 0] = 0.5 ** np.arange(1, T + 1)            # improve
    res_seq[:, 1] = [2.0, 1.5, 0.8, 3.0, 0.5, 6.0, 0.3, 0.2, 0.1, 0.05]
    res_seq[:, 2] = 1.5                                     # walk, return
    res_seq[:, 3] = 50.0                                    # reject
    res_seq[:, 4] = [50.0] * 6 + [0.9, 0.8, 0.7, 0.6]       # second wind
    res_seq[:, 5] = np.nan                                  # dead
    ok_seq = np.ones((T, B), bool)
    ok_seq[2:4, 3] = False                                  # failed solves
    cur, rhs_c = _walk_carry(B, rng)
    carry = dict(cur=cur, bst=cur, rhs_c=rhs_c, rhs_b=rhs_c,
                 res_best=np.full(B, base, np.float32),
                 live=np.ones(B, bool),
                 t=np.ones(B, np.float32),
                 sig=np.array([1e-5, 1e-5, 1e-5, 1e-5, 5e-2, 8e-2],
                              np.float32),
                 since=np.zeros(B, np.int32))
    jc = {k: jax.tree.map(jnp.asarray, v) for k, v in carry.items()}
    tc = {k: jax.tree.map(torch.tensor, v) for k, v in carry.items()}
    order = ("cur", "bst", "rhs_c", "rhs_b", "res_best", "live", "t", "sig",
             "since")
    seen = set()
    for k in range(T):
        state_p, rhs_p = _walk_carry(B, rng)
        res_p = (res_seq[k] * base).astype(np.float32)
        jout = jref._walk_update(
            B, jc["live"], jnp.asarray(ok_seq[k]), jnp.asarray(res_p),
            jc["res_best"], jc["since"], jc["t"], jc["sig"],
            jax.tree.map(jnp.asarray, state_p), jc["cur"], jc["bst"],
            jax.tree.map(jnp.asarray, rhs_p), jc["rhs_c"], jc["rhs_b"])
        tout = tref._walk_update(
            B, tc["live"], torch.tensor(ok_seq[k]), torch.tensor(res_p),
            tc["res_best"], tc["since"], tc["t"], tc["sig"],
            jax.tree.map(torch.tensor, state_p), tc["cur"], tc["bst"],
            jax.tree.map(torch.tensor, rhs_p), tc["rhs_c"], tc["rhs_b"])
        jc, tc = dict(zip(order, jout)), dict(zip(order, tout))
        for name in order:
            for g, w in zip(jax.tree.leaves(tc[name]),
                            jax.tree.leaves(jc[name])):
                _same(g.numpy(), w)
        seen |= {("walk", i) for i in np.flatnonzero(
            np.asarray(jc["since"]) > 0)}
        seen |= {("wind", i) for i in np.flatnonzero(
            (np.asarray(jc["t"]) == 1.0) & (np.asarray(jc["sig"]) >= 8e-2))}
    assert ("walk", 1) in seen and ("walk", 2) in seen
    assert np.asarray(jc["sig"])[3] == np.float32(8e-2)     # escalated
    assert not bool(np.asarray(jc["live"])[5])              # dead lane
    assert bool(np.asarray(jc["live"])[0])


@pytest.mark.parametrize("plant,N,pert", [
    ("double_integrator", 20, 0.05),
    ("servo_motor", 25, 0.05),
])
def test_contract_path_f32_meets_unrolled_pin(plant, N, pert):
    """The whole float32 product path on the CPU: equilibration, the
    lockstep solve, failed-lane retry, double-float refinement. Every lane
    of a perturbed batch of 8 meets 3e-6 in host float64 (the JAX
    package's unrolled pin; its compiled loop floors higher on XLA:CPU)."""
    arrays = perturbed_x0(plant_arrays(plant, N, 8), pert)
    N_, nx, nu, nc, nz, nl, nv = dims(arrays)
    td = torch_data(arrays, torch.float32)
    z = lambda n: torch.zeros(8, n, dtype=torch.float32)
    x, core = solve_mpc_qp_batch(td, z(nz), z(nl), z(nv),
                                 Options.single_precision())
    assert isinstance(x, tref.VariableDF)
    assert core.eflag.tolist() == [int(ExitFlag.SUCCESS)] * 8
    sol = x.to_float64()
    res64 = f64_residual(arrays, sol.z.numpy(), sol.l.numpy(),
                         sol.v.numpy(), ALPHA)
    assert np.all(res64 <= 3e-6), res64
    # The reported residual is the double-float value at the same point.
    np.testing.assert_allclose(core.residual.numpy(), res64, rtol=0.05,
                               atol=1e-9)
    assert int(core.refine_steps.min()) >= 1

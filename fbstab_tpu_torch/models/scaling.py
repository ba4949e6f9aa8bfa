"""Ruiz equilibration of batched MPC and dense data for float32
conditioning (counterpart of `fbstab_tpu/models/scaling.py`).

A per-stage diagonal scaling x(s) = Dx_s x'(s), u(s) = Du_s u'(s), with
the dynamics row block s scaled by Dx_s^{-1}, keeps the Riccati structure
(the -I blocks of G) exactly:

    A'_s = Dx_{s+1}^{-1} A_s Dx_s      B'_s = Dx_{s+1}^{-1} B_s Du_s
    c'_s = Dx_{s+1}^{-1} c_s           x0'  = Dx_0^{-1} x0
    Q'_s = kc Dx_s Q_s Dx_s            R'_s = kc Du_s R_s Du_s
    S'_s = kc Du_s S_s Dx_s            q'_s = kc Dx_s q_s,  r' likewise
    E'_s = De_s E_s Dx_s               L'_s = De_s L_s Du_s
    d'_s = De_s d_s

Solution maps: z = Dz z'; l = Dx^{-1} l' / kc; v = De v' / kc;
y = De^{-1} y'. Every diagonal is rounded to a power of two, so scaling and
unscaling are exact floating-point transforms.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from fbstab_tpu_torch.core.residuals import (
    penalized_natural_residual,
    residual_norm,
)
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.models.dense_qp import DENSE_OPS, DenseQPData
from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, MpcQPData
from fbstab_tpu_torch.solver_out import ExitFlag

RUIZ_ITERS = 8


class MpcScaling(NamedTuple):
    """Batched per-stage diagonal scalings."""

    dx: torch.Tensor   # (B, N+1, nx)
    du: torch.Tensor   # (B, N+1, nu)
    de: torch.Tensor   # (B, N+1, nc)
    kc: torch.Tensor   # (B,) cost scaling


def _safe(n):
    return torch.where(n > 0, n, torch.ones_like(n))


def _scaled_blocks_mpc(d: MpcQPData, dx, du, de):
    Qs = dx[..., :, None] * d.Q * dx[..., None, :]
    Ss = du[..., :, None] * d.S * dx[..., None, :]
    Rs = du[..., :, None] * d.R * du[..., None, :]
    As = d.A * dx[:, :-1, None, :] / dx[:, 1:, :, None]
    Bs = d.B * du[:, :-1, None, :] / dx[:, 1:, :, None]
    Es = de[..., :, None] * d.E * dx[..., None, :]
    Ls = de[..., :, None] * d.L * du[..., None, :]
    return Qs, Ss, Rs, As, Bs, Es, Ls


def _pow2(a):
    """Rounds to the nearest power of two (in the log domain)."""
    return torch.exp2(torch.round(torch.log2(a)))


def ruiz_mpc_scaling(d: MpcQPData, iters: int = RUIZ_ITERS) -> MpcScaling:
    """The Ruiz diagonals of every lane: iterate d <- d/sqrt(inf-norm of
    the scaled row/column), state columns floored at 1 by the dynamics'
    -I entries, then a scalar cost scaling kc. Depends on every field
    except x0 and c."""
    B = d.Q.shape[0]
    N1, nx = d.Q.shape[1], d.Q.shape[-1]
    nu, nc = d.R.shape[-1], d.E.shape[-2]
    kw = dict(dtype=d.Q.dtype, device=d.Q.device)
    dx = torch.ones(B, N1, nx, **kw)
    du = torch.ones(B, N1, nu, **kw)
    de = torch.ones(B, N1, nc, **kw)
    amax = lambda a, ax: a.abs().amax(ax)

    for _ in range(iters):
        Qs, Ss, Rs, As, Bs, Es, Ls = _scaled_blocks_mpc(d, dx, du, de)
        # x(s, j) column: Q rows, S rows, E rows, the dynamics block s+1
        # (A_s) and the -I entry (always 1).
        colx = torch.maximum(amax(Qs, -2), amax(Es, -2))
        if nu > 0:
            colx = torch.maximum(colx, amax(Ss, -2))
        colx = torch.cat([torch.maximum(colx[:, :-1], amax(As, -2)),
                          colx[:, -1:]], 1)
        colx = torch.clamp(colx, min=1.0)
        # u(s, j) column: R rows, S' rows, L rows, B_s.
        colu = torch.maximum(amax(Rs, -2), amax(Ss, -1))
        colu = torch.maximum(colu, amax(Ls, -2))
        colu = torch.cat([torch.maximum(colu[:, :-1], amax(Bs, -2)),
                          colu[:, -1:]], 1)
        # Inequality rows, including the offset d (see the JAX module).
        rowe = torch.maximum(amax(Es, -1), amax(Ls, -1))
        rowe = torch.maximum(rowe, (de * d.d).abs())

        upd = lambda cur, nrm: cur * torch.rsqrt(_safe(nrm))
        dx, du, de = upd(dx, colx), upd(du, colu), upd(de, rowe)

    dx, du, de = _pow2(dx), _pow2(du), _pow2(de)

    Qs, Ss, Rs, _, _, _, _ = _scaled_blocks_mpc(d, dx, du, de)
    lane_max = lambda a: a.abs().reshape(B, -1).amax(-1)
    cost_mag = torch.maximum(lane_max(Qs), lane_max(Rs))
    cost_mag = torch.maximum(cost_mag, lane_max(Ss))
    cost_mag = torch.maximum(cost_mag, lane_max(dx * d.q))
    cost_mag = torch.maximum(cost_mag, lane_max(du * d.r))
    kc = _pow2(1.0 / torch.clamp(_safe(cost_mag), 1e-8, 1e8))
    return MpcScaling(dx=dx, du=du, de=de, kc=kc)


def apply_mpc_scaling(d: MpcQPData, s: MpcScaling) -> MpcQPData:
    """Applies the scaling diagonals to the data (exact pow2 transform)."""
    Qs, Ss, Rs, As, Bs, Es, Ls = _scaled_blocks_mpc(d, s.dx, s.du, s.de)
    k3 = s.kc[:, None, None]
    k4 = s.kc[:, None, None, None]
    return MpcQPData(
        Q=k4 * Qs, R=k4 * Rs, S=k4 * Ss,
        q=k3 * s.dx * d.q, r=k3 * s.du * d.r,
        A=As, B=Bs, c=d.c / s.dx[:, 1:],
        E=Es, L=Ls, d=s.de * d.d,
        x0=d.x0 / s.dx[:, 0])


def equilibrate_mpc(d: MpcQPData, iters: int = RUIZ_ITERS
                    ) -> tuple[MpcQPData, MpcScaling]:
    """Ruiz equilibration of a batch of MPC QPs: ruiz_mpc_scaling +
    apply_mpc_scaling (the JAX package's is one instance, vmapped for
    batches)."""
    s = ruiz_mpc_scaling(d, iters)
    return apply_mpc_scaling(d, s), s


def mpc_scale_factors(s: MpcScaling):
    """Flat per-coordinate unscale multipliers (dz, lf, vf, de):
    z = dz z', l = lf l', v = vf v', y = y'/de."""
    B = s.kc.shape[0]
    dzf = torch.cat([s.dx, s.du], -1).reshape(B, -1)
    kc = s.kc[:, None]
    lf = 1.0 / (s.dx.reshape(B, -1) * kc)
    de = s.de.reshape(B, -1)
    return dzf, lf, de / kc, de


def scale_mpc_variable(x: Variable, s: MpcScaling) -> Variable:
    """Original -> scaled coordinates (for warmstarts)."""
    dzf, lf, vf, de = mpc_scale_factors(s)
    return Variable(z=x.z / dzf, l=x.l / lf, v=x.v / vf, y=x.y * de)


def unscale_mpc_variable(x: Variable, s: MpcScaling) -> Variable:
    """Scaled -> original coordinates."""
    dzf, lf, vf, de = mpc_scale_factors(s)
    return Variable(z=x.z * dzf, l=x.l * lf, v=x.v * vf, y=x.y / de)


def df_scale(p, f):
    """A double-float pair times power-of-two factors (exact)."""
    return (p[0] * f, p[1] * f)


def unscale_mpc_variable_df(xdf, s: MpcScaling):
    """Exact unscaling of a refined VariableDF (pow2 diagonals)."""
    dzf, lf, vf, de = mpc_scale_factors(s)
    return type(xdf)(z=df_scale(xdf.z, dzf), l=df_scale(xdf.l, lf),
                     v=df_scale(xdf.v, vf), y=df_scale(xdf.y, 1.0 / de))


# ------------------------------------------------------------------
# Dense QP equilibration (Ruiz on the KKT blocks; G rows scale freely):
# z = dz z', l = dl l' / kc, v = de v' / kc, y = y' / de.
# ------------------------------------------------------------------

class DenseScaling(NamedTuple):
    """Batched dense diagonal scalings."""

    dz: torch.Tensor   # (B, n)
    dl: torch.Tensor   # (B, nl)
    de: torch.Tensor   # (B, q)
    kc: torch.Tensor   # (B,) cost scaling


def _scaled_blocks_dense(d, dz, dl, de):
    Hs = dz[:, :, None] * d.H * dz[:, None, :]
    Gs = dl[:, :, None] * d.G * dz[:, None, :]
    As = de[:, :, None] * d.A * dz[:, None, :]
    return Hs, Gs, As


def ruiz_dense_scaling(d: DenseQPData, iters: int = RUIZ_ITERS
                       ) -> DenseScaling:
    """The Ruiz diagonals of every lane of a batched DenseQPData, rounded
    to powers of two, then a scalar cost scaling kc per lane."""
    B, n = d.H.shape[0], d.H.shape[-1]
    nl, nv = d.G.shape[-2], d.A.shape[-2]
    kw = dict(dtype=d.H.dtype, device=d.H.device)
    dz = torch.ones(B, n, **kw)
    dl = torch.ones(B, nl, **kw)
    de = torch.ones(B, nv, **kw)
    amax = lambda a, ax: a.abs().amax(ax)

    for _ in range(iters):
        Hs, Gs, As = _scaled_blocks_dense(d, dz, dl, de)
        colz = amax(Hs, -2)
        if nl > 0:
            colz = torch.maximum(colz, amax(Gs, -2))
        colz = torch.maximum(colz, amax(As, -2))
        rowl = amax(Gs, -1) if nl > 0 else torch.zeros(B, 0, **kw)
        rowe = torch.maximum(amax(As, -1), (de * d.b).abs())
        upd = lambda cur, nrm: cur * torch.rsqrt(_safe(nrm))
        dz, dl, de = upd(dz, colz), upd(dl, rowl), upd(de, rowe)

    dz, dl, de = _pow2(dz), _pow2(dl), _pow2(de)

    Hs, _, _ = _scaled_blocks_dense(d, dz, dl, de)
    lane_max = lambda a: a.abs().reshape(B, -1).amax(-1)
    cost_mag = torch.maximum(lane_max(Hs), lane_max(dz * d.f))
    kc = _pow2(1.0 / torch.clamp(_safe(cost_mag), 1e-8, 1e8))
    return DenseScaling(dz=dz, dl=dl, de=de, kc=kc)


def apply_dense_scaling(d: DenseQPData, s: DenseScaling) -> DenseQPData:
    """Applies the scaling diagonals to the data (exact pow2 transform)."""
    Hs, Gs, As = _scaled_blocks_dense(d, s.dz, s.dl, s.de)
    kc = s.kc[:, None]
    return DenseQPData(H=kc[..., None] * Hs, f=kc * s.dz * d.f, G=Gs,
                       h=s.dl * d.h, A=As, b=s.de * d.b)


def equilibrate_dense(d: DenseQPData, iters: int = RUIZ_ITERS
                      ) -> tuple[DenseQPData, DenseScaling]:
    """Ruiz equilibration of a batch of dense QPs: ruiz_dense_scaling +
    apply_dense_scaling."""
    s = ruiz_dense_scaling(d, iters)
    return apply_dense_scaling(d, s), s


def dense_scale_factors(s: DenseScaling):
    """Flat per-coordinate unscale multipliers (dz, lf, vf, de):
    z = dz z', l = lf l', v = vf v', y = y'/de."""
    kc = s.kc[:, None]
    return s.dz, s.dl / kc, s.de / kc, s.de


def scale_dense_variable(x: Variable, s: DenseScaling) -> Variable:
    """Original -> scaled coordinates (for warmstarts)."""
    dzf, lf, vf, de = dense_scale_factors(s)
    return Variable(z=x.z / dzf, l=x.l / lf, v=x.v / vf, y=x.y * de)


def unscale_dense_variable(x: Variable, s: DenseScaling) -> Variable:
    """Scaled -> original coordinates."""
    dzf, lf, vf, de = dense_scale_factors(s)
    return Variable(z=x.z * dzf, l=x.l * lf, v=x.v * vf, y=x.y / de)


def unscale_dense_variable_df(xdf, s: DenseScaling):
    """Exact unscaling of a refined VariableDF (pow2 diagonals)."""
    dzf, lf, vf, de = dense_scale_factors(s)
    return type(xdf)(z=df_scale(xdf.z, dzf), l=df_scale(xdf.l, lf),
                     v=df_scale(xdf.v, vf), y=df_scale(xdf.y, 1.0 / de))


def scaling_engaged(options, dtype) -> bool:
    return bool(options.equilibrate) and dtype == torch.float32


def solve_scaled_mpc(raw_solve, data, z0, l0, v0, options, scal=None,
                     skip_residual_rewrite=False):
    """Batched MPC solve through the equilibrated problem.

    raw_solve(data, z0, l0, v0) -> (Variable, CoreOut). When scaling is
    engaged (options.equilibrate and float32) the data and the warmstart
    are scaled, the solution unscaled, and (unless skip_residual_rewrite,
    for callers that refine and re-report anyway) the residual rewritten
    in original units. Exit flags and iteration counts are the scaled
    solve's."""
    opts = options.validated()
    if not scaling_engaged(opts, z0.dtype):
        return raw_solve(data, z0, l0, v0)
    if scal is None:
        scal = ruiz_mpc_scaling(data)
    sdata = apply_mpc_scaling(data, scal)
    g = scale_mpc_variable(
        Variable(z=z0, l=l0, v=v0, y=torch.zeros_like(v0)), scal)
    x, core = raw_solve(sdata, g.z, g.l, g.v)
    x = unscale_mpc_variable(x, scal)
    if skip_residual_rewrite:
        return x, core
    res = residual_norm(penalized_natural_residual(MPC_OPS, data, x,
                                                   opts.alpha))
    return x, core._replace(residual=res, raw_residual=res)


def solve_scaled_dense(raw_solve, data, z0, l0, v0, options, scal=None,
                       skip_residual_rewrite=False):
    """Dense analog of solve_scaled_mpc."""
    opts = options.validated()
    if not scaling_engaged(opts, z0.dtype):
        return raw_solve(data, z0, l0, v0)
    if scal is None:
        scal = ruiz_dense_scaling(data)
    sdata = apply_dense_scaling(data, scal)
    g = scale_dense_variable(
        Variable(z=z0, l=l0, v=v0, y=torch.zeros_like(v0)), scal)
    x, core = raw_solve(sdata, g.z, g.l, g.v)
    x = unscale_dense_variable(x, scal)
    if skip_residual_rewrite:
        return x, core
    res = residual_norm(penalized_natural_residual(DENSE_OPS, data, x,
                                                   opts.alpha))
    return x, core._replace(residual=res, raw_residual=res)


def retry_options(opts):
    """4x larger proximal sigma and a bigger outer budget for the retry of
    LINEAR_SOLVER_FAILED lanes."""
    return dataclasses.replace(
        opts, sigma0=min(opts.sigma0 * 4.0, 1e-2),
        max_prox_iters=max(opts.max_prox_iters, 60),
        max_newton_iters=max(opts.max_newton_iters, 400)).validated()


def merge_failed_retry(x1, core1, x2, core2):
    """The retry's results on the lanes that failed in pass 1; iteration
    counters accumulate there."""
    m = core1.eflag == int(ExitFlag.LINEAR_SOLVER_FAILED)
    x = type(x1)(*(torch.where(m[:, None], a2, a1)
                   for a2, a1 in zip(x2, x1)))
    core = core1._replace(
        eflag=torch.where(m, core2.eflag, core1.eflag),
        residual=torch.where(m, core2.residual, core1.residual),
        raw_residual=torch.where(m, core2.raw_residual, core1.raw_residual),
        newton_iters=core1.newton_iters
        + torch.where(m, core2.newton_iters, 0),
        prox_iters=core1.prox_iters + torch.where(m, core2.prox_iters, 0))
    return x, core

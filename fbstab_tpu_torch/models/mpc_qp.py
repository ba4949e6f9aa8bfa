"""MPC (linear-quadratic optimal control) QP class, batched in PyTorch.

Counterpart of `fbstab_tpu/models/mpc_qp.py` (reference mpc_data.{h,cc},
riccati_linear_solver.{h,cc}, fbstab_mpc.{h,cc}). The QP is

    min.  sum_i 1/2 [x(i); u(i)]' [Q(i) S(i)'; S(i) R(i)] [x(i); u(i)]
                 + q(i)'x(i) + r(i)'u(i)
    s.t.  x(i+1) = A(i) x(i) + B(i) u(i) + c(i),   x(0) = x0,
          E(i) x(i) + L(i) u(i) + d(i) <= 0,

with nz = (N+1)(nx+nu), nl = (N+1)nx, nv = (N+1)nc and the stage-major
flat layout z = [x(0); u(0); ...; x(N); u(N)].

Every tensor carries a leading batch axis B: stage matrices are
(B, N+1, n, m), flat vectors (B, n). The Riccati recursion is a Python
loop over stages, each step batched over B: the plain version of the
CUDA Newton-step kernel (ops/riccati_cuda.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from fbstab_tpu_torch.core.algorithm import (
    CoreOut, fbstab_solve, fbstab_solve_batch)
from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.device import resolve_device
from fbstab_tpu_torch.ops.pfb import pfb_weights
from fbstab_tpu_torch.ops.smallchol import cholesky, solve_triangular_small
from fbstab_tpu_torch.options import Display, Options
from fbstab_tpu_torch.solver_out import ExitFlag, SolverOut
from fbstab_tpu_torch.telemetry import count, span

_tri = solve_triangular_small


class MpcQPData(NamedTuple):
    """Batched stacked-array MPC data (reference: MpcData, mpc_data.h:43).
    Stage counts: Q,R,S,q,r,E,L,d have N+1 entries; A,B,c have N."""

    Q: torch.Tensor   # (B, N+1, nx, nx)
    R: torch.Tensor   # (B, N+1, nu, nu)
    S: torch.Tensor   # (B, N+1, nu, nx)
    q: torch.Tensor   # (B, N+1, nx)
    r: torch.Tensor   # (B, N+1, nu)
    A: torch.Tensor   # (B, N, nx, nx)
    B: torch.Tensor   # (B, N, nx, nu)
    c: torch.Tensor   # (B, N, nx)
    E: torch.Tensor   # (B, N+1, nc, nx)
    L: torch.Tensor   # (B, N+1, nc, nu)
    d: torch.Tensor   # (B, N+1, nc)
    x0: torch.Tensor  # (B, nx)


def mpc_dims(d: MpcQPData) -> tuple[int, int, int, int]:
    """(N, nx, nu, nc) from the trailing array shapes."""
    return d.A.shape[-3], d.A.shape[-1], d.B.shape[-1], d.E.shape[-2]


def mpc_qp_data(Q, R, S, q, r, A, B, c, E, L, d, x0,
                dtype=torch.float64, device=None) -> MpcQPData:
    """Builds batched MpcQPData from array-likes with a common leading batch
    axis, validating the per-instance shapes (mpc_data.cc:291-363). With
    no `device` the data goes where Q lies if it is a tensor, else on the
    card (device.resolve_device)."""
    device = resolve_device(device, like=Q)

    def tensor(a):
        if isinstance(a, torch.Tensor):
            return a.to(dtype=dtype, device=device)
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    arrs = {k: tensor(v) for k, v in dict(
        Q=Q, R=R, S=S, q=q, r=r, A=A, B=B, c=c, E=E, L=L, d=d,
        x0=x0).items()}
    data = MpcQPData(**arrs)
    N, nx, nu, nc = mpc_dims(data)
    if N <= 0:
        raise ValueError("Horizon length must be at least 1.")
    if data.x0.ndim != 2:
        raise ValueError("mpc_qp_data: the arrays need a leading batch "
                         "axis; use batch_data for one instance.")
    Bq = data.x0.shape[0]
    expect = dict(
        Q=(N + 1, nx, nx), R=(N + 1, nu, nu), S=(N + 1, nu, nx),
        q=(N + 1, nx), r=(N + 1, nu),
        A=(N, nx, nx), B=(N, nx, nu), c=(N, nx),
        E=(N + 1, nc, nx), L=(N + 1, nc, nu), d=(N + 1, nc), x0=(nx,))
    for name, want in expect.items():
        got = tuple(getattr(data, name).shape)
        if got != (Bq,) + want:
            raise ValueError(f"mpc_qp_data: {name} has shape {got}, "
                             f"expected {(Bq,) + want}.")
    return data


def batch_data(data: MpcQPData, B: int) -> MpcQPData:
    """Replicates a batch of one instance into B lanes (copies)."""
    return MpcQPData(*(a.expand((B,) + a.shape[1:]).contiguous()
                       for a in data))


# ------------------------------------------------------------------
# Matrix-free data operators (reference: mpc_data.cc:17-289), batched.
# ------------------------------------------------------------------

def _mv(M, x):
    """Per-stage M @ x: M (B, S, n, m), x (B, S, m) -> (B, S, n)."""
    return torch.matmul(M, x[..., None])[..., 0]


def _mtv(M, x):
    """Per-stage M' @ x: M (B, S, n, m), x (B, S, n) -> (B, S, m)."""
    return torch.matmul(M.transpose(-1, -2), x[..., None])[..., 0]


def _split_z(d: MpcQPData, z):
    """(B, nz) -> stagewise ((B, N+1, nx), (B, N+1, nu))."""
    N, nx, nu, _ = mpc_dims(d)
    s = z.reshape(z.shape[0], N + 1, nx + nu)
    return s[..., :nx], s[..., nx:]


def _gemvH(d: MpcQPData, x):
    """y(i) = [Q S'; S R] [x(i); u(i)] (mpc_data.cc:17-65)."""
    vx, vu = _split_z(d, x)
    yx = _mv(d.Q, vx) + _mtv(d.S, vu)
    yu = _mv(d.S, vx) + _mv(d.R, vu)
    return torch.cat([yx, yu], -1).reshape(x.shape[0], -1)


def _gemvA(d: MpcQPData, x):
    """y(i) = E(i) x(i) + L(i) u(i) (mpc_data.cc:67-105)."""
    vx, vu = _split_z(d, x)
    return (_mv(d.E, vx) + _mv(d.L, vu)).reshape(x.shape[0], -1)


def _gemvG(d: MpcQPData, x):
    """y(0) = -x(0); y(i) = A(i-1) x(i-1) + B(i-1) u(i-1) - x(i)
    (mpc_data.cc:107-151)."""
    vx, vu = _split_z(d, x)
    tail = _mv(d.A, vx[:, :-1]) + _mv(d.B, vu[:, :-1]) - vx[:, 1:]
    return torch.cat([-vx[:, :1], tail], 1).reshape(x.shape[0], -1)


def _gemvGT(d: MpcQPData, l):
    """x(i) = -l(i) + A(i)' l(i+1) [i<N]; u(i) = B(i)' l(i+1) [i<N]
    (mpc_data.cc:153-199)."""
    N, nx, nu, _ = mpc_dims(d)
    Bq = l.shape[0]
    v = l.reshape(Bq, N + 1, nx)
    atv = _mtv(d.A, v[:, 1:])
    btv = _mtv(d.B, v[:, 1:])
    yx = -v + torch.cat([atv, torch.zeros_like(v[:, :1])], 1)
    yu = torch.cat([btv, btv.new_zeros(Bq, 1, nu)], 1)
    return torch.cat([yx, yu], -1).reshape(Bq, -1)


def _gemvAT(d: MpcQPData, vflat):
    """x(i) = E(i)' v(i); u(i) = L(i)' v(i) (mpc_data.cc:201-238)."""
    N, nx, nu, nc = mpc_dims(d)
    Bq = vflat.shape[0]
    v = vflat.reshape(Bq, N + 1, nc)
    return torch.cat([_mtv(d.E, v), _mtv(d.L, v)], -1).reshape(Bq, -1)


def _f_vec(d: MpcQPData):
    """f = [(q(i); r(i))]_i (mpc_data.cc:240-259)."""
    return torch.cat([d.q, d.r], -1).reshape(d.q.shape[0], -1)


def _h_vec(d: MpcQPData):
    """h = -[x0; c(0); ...; c(N-1)] (mpc_data.cc:261-274)."""
    return -torch.cat([d.x0[:, None, :], d.c], 1).reshape(d.x0.shape[0], -1)


def _b_vec(d: MpcQPData):
    """b = -[d(i)]_i (mpc_data.cc:276-289)."""
    return -d.d.reshape(d.d.shape[0], -1)


def _forcing_norm(d: MpcQPData):
    """Per-lane ||(f, h, b)||_2 (mpc_data.h:100-108)."""
    sq = lambda a: (a * a).reshape(a.shape[0], -1).sum(-1)
    return torch.sqrt(sq(d.q) + sq(d.r) + sq(d.d) + sq(d.x0) + sq(d.c))


# ------------------------------------------------------------------
# Riccati-recursion Newton step (riccati_linear_solver.cc:77-344): the
# plain version of the CUDA kernel K1.
# ------------------------------------------------------------------

class RiccatiFactorization(NamedTuple):
    """Per-stage factors (riccati_linear_solver.h:109-141), batched."""

    L: torch.Tensor      # (B, N+1, nx, nx) chol of the Riccati matrix Pi
    M: torch.Tensor      # (B, N+1, nx, nx) chol(Qhat + inv(L L'))
    SM: torch.Tensor     # (B, N+1, nu, nx) Shat inv(M)'
    SG: torch.Tensor     # (B, N+1, nu, nu) chol(Rhat - SM SM')
    AM: torch.Tensor     # (B, N, nx, nx)   A inv(M)'
    P: torch.Tensor      # (B, N, nx, nu)   (AM SM' - B) inv(SG)'
    gamma: torch.Tensor  # (B, nv)
    mus: torch.Tensor    # (B, nv)


def _lane_sigma(sigma, like):
    """sigma as a python scalar or a (B, 1, ...) tensor broadcasting
    against `like`'s trailing dims."""
    if isinstance(sigma, torch.Tensor) and sigma.ndim == 1:
        return sigma.reshape((-1,) + (1,) * (like.ndim - 1))
    return sigma


def _stage_hessians(d: MpcQPData, Gam, sigma):
    """Qhat = Q + sigma I + E'GE, Rhat = R + sigma I + L'GL,
    Shat = S + L'GE (riccati_linear_solver.cc:101-123)."""
    N, nx, nu, nc = mpc_dims(d)
    dtype, dev = d.Q.dtype, d.Q.device
    Ix = torch.eye(nx, dtype=dtype, device=dev)
    Iu = torch.eye(nu, dtype=dtype, device=dev)
    Gs = Gam.reshape(Gam.shape[0], N + 1, nc)
    GE = Gs[..., None] * d.E
    GL = Gs[..., None] * d.L
    sig = _lane_sigma(sigma, d.Q)
    Et, Lt = d.E.transpose(-1, -2), d.L.transpose(-1, -2)
    Qh = d.Q + sig * Ix + torch.matmul(Et, GE)
    Rh = d.R + sig * Iu + torch.matmul(Lt, GL)
    Sh = d.S + torch.matmul(Lt, GE)
    return Qh, Rh, Sh


def _riccati_factor_yv(d: MpcQPData, y, v, vbar, sigma, alpha
                       ) -> RiccatiFactorization:
    """Weights, stage Hessians and the forward Riccati matrix recursion
    (riccati_linear_solver.cc:77-210). sigma: scalar or per-lane (B,)."""
    N, nx, nu, nc = mpc_dims(d)
    Bq = v.shape[0]
    dtype, dev = d.Q.dtype, d.Q.device
    Ix = torch.eye(nx, dtype=dtype, device=dev).expand(Bq, nx, nx)

    gamma, mus, Gam = pfb_weights(y, v, vbar, _lane_sigma(sigma, v), alpha)
    Qh, Rh, Sh = _stage_hessians(d, Gam, sigma)
    sig3 = _lane_sigma(sigma, Ix)

    def cho_inverse(Lf):
        t = _tri(Lf, Ix, lower=True)
        return _tri(Lf.transpose(-1, -2), t, lower=False)

    def stage_factor(Lf, i):
        # M = chol(Qhat + inv(L L')); SM = Shat inv(M)';
        # SG = chol(Rhat - SM SM')  (cc:145-151, 160-168).
        M = cholesky(Qh[:, i] + cho_inverse(Lf))
        SM = _tri(M, Sh[:, i].transpose(-1, -2), lower=True
                  ).transpose(-1, -2)
        SG = cholesky(Rh[:, i] - SM @ SM.transpose(-1, -2))
        return M, SM, SG

    # Base case L(0) = chol(sigma I) = sqrt(sigma) I (cc:127).
    Lf = torch.sqrt(torch.as_tensor(sig3, dtype=dtype, device=dev)) * Ix
    Ls, Ms, SMs, SGs, AMs, Ps = [], [], [], [], [], []
    for i in range(N):
        M, SM, SG = stage_factor(Lf, i)
        # AM = A inv(M)' (cc:153-159); P = (AM SM' - B) inv(SG)'
        # (cc:170-179); L(i+1) = chol(sigma I + P P' + AM AM') (cc:181-188).
        AM = _tri(M, d.A[:, i].transpose(-1, -2), lower=True
                  ).transpose(-1, -2)
        P = _tri(SG, (AM @ SM.transpose(-1, -2) - d.B[:, i]
                      ).transpose(-1, -2), lower=True).transpose(-1, -2)
        L_next = cholesky(sig3 * Ix + P @ P.transpose(-1, -2)
                          + AM @ AM.transpose(-1, -2))
        Ls.append(Lf)
        Ms.append(M)
        SMs.append(SM)
        SGs.append(SG)
        AMs.append(AM)
        Ps.append(P)
        Lf = L_next
    # Terminal stage i = N (cc:191-209).
    M, SM, SG = stage_factor(Lf, N)
    Ls.append(Lf)
    Ms.append(M)
    SMs.append(SM)
    SGs.append(SG)
    st = lambda xs: torch.stack(xs, 1)
    return RiccatiFactorization(
        L=st(Ls), M=st(Ms), SM=st(SMs), SG=st(SGs), AM=st(AMs), P=st(Ps),
        gamma=gamma, mus=mus)


def _riccati_factor_ok(fact: RiccatiFactorization):
    """Per-lane: every stage Cholesky succeeded (no NaN on the factor
    diagonals; riccati_linear_solver.cc:131-136)."""
    diag_ok = lambda F: torch.isfinite(
        torch.diagonal(F, dim1=-2, dim2=-1)).reshape(F.shape[0], -1).all(-1)
    return diag_ok(fact.M) & diag_ok(fact.SG) & diag_ok(fact.L)


def _riccati_solve(d: MpcQPData, fact: RiccatiFactorization, rz, rl, rv
                   ) -> Variable:
    """Forward/backward vector recursions + dual recovery
    (riccati_linear_solver.cc:212-344)."""
    N, nx, nu, nc = mpc_dims(d)
    Bq = rz.shape[0]

    def cho_solve(Lf, b):
        return _tri(Lf.transpose(-1, -2), _tri(Lf, b, lower=True),
                    lower=False)

    mv = lambda M, x: (M @ x[..., None])[..., 0]
    mtv = lambda M, x: (M.transpose(-1, -2) @ x[..., None])[..., 0]

    # r1 = rz - A'(rv ./ mus), r2 = -rl (cc:230-236).
    r1 = rz - _gemvAT(d, rv / fact.mus)
    r1s = r1.reshape(Bq, N + 1, nx + nu)
    rx, ru = r1s[..., :nx], r1s[..., nx:]
    r2 = (-rl).reshape(Bq, N + 1, nx)
    F = fact

    # Forward recursion for theta / h (cc:239-262).
    th = [r2[:, 0]]
    h = [cho_solve(F.L[:, 0], th[0]) - rx[:, 0]]
    for i in range(N):
        tx = _tri(F.M[:, i], h[i], lower=True)
        tu = _tri(F.SG[:, i], mv(F.SM[:, i], tx) + ru[:, i], lower=True)
        th_n = mv(F.P[:, i], tu) + mv(F.AM[:, i], tx) + r2[:, i + 1]
        th.append(th_n)
        h.append(cho_solve(F.L[:, i + 1], th_n) - rx[:, i + 1])

    # Backward recursion base case, stage N (cc:266-293).
    txN = _tri(F.M[:, N], h[N], lower=True)
    uN = cho_solve(F.SG[:, N], mv(F.SM[:, N], txN) + ru[:, N])
    xN = -_tri(F.M[:, N].transpose(-1, -2), txN + mtv(F.SM[:, N], uN),
               lower=False)
    lN = -cho_solve(F.L[:, N], xN + th[N])

    # Main backward loop i = N-1..0 carrying l(i+1) (cc:297-327).
    xs, us, ls = [xN], [uN], [lN]
    l_next = lN
    for i in range(N - 1, -1, -1):
        tx = _tri(F.M[:, i], h[i], lower=True)
        ui = _tri(F.SG[:, i], mv(F.SM[:, i], tx) + ru[:, i], lower=True)
        ui = _tri(F.SG[:, i].transpose(-1, -2), ui + mtv(F.P[:, i], l_next),
                  lower=False)
        xi = -_tri(F.M[:, i].transpose(-1, -2),
                   tx + mtv(F.SM[:, i], ui) + mtv(F.AM[:, i], l_next),
                   lower=False)
        li = -cho_solve(F.L[:, i], th[i] + xi)
        xs.append(xi)
        us.append(ui)
        ls.append(li)
        l_next = li
    xs, us, ls = xs[::-1], us[::-1], ls[::-1]

    dz = torch.cat([torch.stack(xs, 1), torch.stack(us, 1)], -1
                   ).reshape(Bq, -1)
    dl = torch.stack(ls, 1).reshape(Bq, -1)

    # Dual recovery (cc:329-342): dv = (rv + gamma A dz) ./ mus,
    # dy = b - A dz.
    Adz = _gemvA(d, dz)
    dv = (rv + fact.gamma * Adz) / fact.mus
    dy = _b_vec(d) - Adz
    return Variable(z=dz, l=dl, v=dv, y=dy)


def exact_f32_matmul(t: torch.Tensor) -> None:
    """Plain-path float32 products on the card run in full float32: TF32
    keeps ~3 decimal digits and would break parity with the kernels."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _fused_step_impl(d, v, y, vbar, rz, rl, rv, sigma, alpha):
    """Plain batched Newton step: returns (dz, dl, dv, dy, ok) with ok the
    per-lane factor check (NaN-free factor diagonals)."""
    exact_f32_matmul(v)
    fact = _riccati_factor_yv(d, y, v, vbar, sigma, alpha)
    ok = _riccati_factor_ok(fact)
    dx = _riccati_solve(d, fact, rz, rl, rv)
    return dx.z, dx.l, dx.v, dx.y, ok


# ------------------------------------------------------------------
# Kernel dispatch. Every float32 batch on the card takes K1 as its Newton
# step. Tier 1 is the fused solver K2, tier 2 the host outer loop on the
# per-subproblem kernel K4 (models/mpc_subfused.py), tier 3 the lockstep
# solver with K1 as the Newton step. The tiers follow the shape classes the
# JAX package runs its fused kernels on (a copy of its gate arithmetic
# below): K2 where its `_fused_solve_eligible` gives a mode, K4 where its
# `_subfused_eligible` does, tier 3 only where it runs its scan. Inside the
# two boxes SOLVE_DIMS_CAP and SUBPROBLEM_DIMS_CAP, the shapes each kernel
# was first held against its plain version at on an H100 (K2: the headline
# N=30 nx=8 nu=3 nc=6 and the three small audited plants, up to N=40 nx=6
# nc=12; K4: the copolymerization reactor N=80 nx=18 nu=5 nc=10), a batch
# keeps the tier it took there, where the JAX package would choose the
# other kernel.
#
# What the card's resources decide is not the tier but how a kernel runs:
# a block of K2 or K4 stages each team's stage block in shared memory where
# the block can hold it (opting in to more than 48 KB), and its teams work
# in place otherwise (csrc/mpc_solve.cu, csrc/mpc_subproblem.cu); and a
# launch of K1, K2 or K4 takes the recompute-factors mode where the batch's
# storing scratch would fill more than a quarter of the card's memory
# (riccati_mode). A launch whose scratch the card cannot give raises
# KernelResourceError; nothing falls back to another tier.
# ------------------------------------------------------------------

SOLVE_DIMS_CAP = dict(N=40, nx=8, nu=3, nc=12)
SUBPROBLEM_DIMS_CAP = dict(N=80, nx=18, nu=5, nc=10)

# The JAX package's shape classes (fbstab_tpu/models/mpc_qp.py:476-535,
# :814-872), copied: the per-tile VMEM model of its Pallas kernels and its
# caps. Here they name the shapes the reference runs a fused kernel on;
# they model no resource of the card.
_VMEM_STD_BUDGET_MB = 64.0
_VMEM_LOWMEM_BUDGET_MB = 90.0
_DIMS_CAP = dict(nx=32, nu=24, nc=48, N=160)
_FULL_SOLVE_ROWS_CAP = 1024
_SUBFUSED_SPILL_FACTOR = 1.4
_SUBFUSED_BUDGET_MB = 112.0


def _state_rows(N, nx, nu, nc) -> int:
    return (N + 1) * (2 * nx + nu + 2 * nc)


def _fused_vmem_mb(N, nx, nu, nc, tile_b=128, lowmem=False) -> float:
    """The JAX package's working-set model (MB) of its fused kernels per
    tile of 128 lanes."""
    N1, b = N + 1, 4 * max(tile_b, 128) / 1e6
    mats = (N1 * nx * nx + N1 * nu * nu + N1 * nu * nx + N * nx * nx
            + N * nx * nu + N1 * nc * nx + N1 * nc * nu)
    vecs_in = N1 * nx + N1 * nu + N * nx + nx + N1 * nc
    guesses = N1 * (2 * nx + nu + nc)
    outs = N1 * (nx + nu) + N1 * nx + 2 * N1 * nc + 5
    scr_vec = (3 * N1 * nx + N1 * nu + 4 * N1 * nc
               + N1 * nx + N1 * nu + 2 * N1 * nx + 1)
    scr_mat = N1 * nx * nx
    if not lowmem:
        scr_mat += N1 * nx * nx + N1 * nu * nx + N1 * nu * nu
    return b * (mats + vecs_in + guesses + outs + scr_vec + scr_mat)


def _kernel_mode(N, nx, nu, nc):
    """'std' | 'lowmem' | None: the JAX package's fused-kernel variant."""
    if not (nx <= _DIMS_CAP["nx"] and nu <= _DIMS_CAP["nu"]
            and nc <= _DIMS_CAP["nc"] and N <= _DIMS_CAP["N"]):
        return None
    if _fused_vmem_mb(N, nx, nu, nc) <= _VMEM_STD_BUDGET_MB:
        return "std"
    if _fused_vmem_mb(N, nx, nu, nc, lowmem=True) <= _VMEM_LOWMEM_BUDGET_MB:
        return "lowmem"
    return None


def fused_solve_mode(dims):
    """The JAX package's `_fused_solve_eligible` on shapes alone: its
    kernel mode where it runs the full-solve kernel (K2), else None."""
    if _state_rows(*dims) > _FULL_SOLVE_ROWS_CAP:
        return None
    return _kernel_mode(*dims)


def subfused_mode(dims):
    """The JAX package's `_subfused_eligible` on shapes alone: its kernel
    mode where it runs the per-subproblem kernel (K4), else None."""
    if _state_rows(*dims) <= _FULL_SOLVE_ROWS_CAP:
        return None
    mode = _kernel_mode(*dims)
    if mode is None:
        return None
    mb = _fused_vmem_mb(*dims, lowmem=(mode == "lowmem"))
    return None if mb * _SUBFUSED_SPILL_FACTOR > _SUBFUSED_BUDGET_MB else mode


def _cuda_f32(t: torch.Tensor) -> bool:
    return t.is_cuda and t.dtype == torch.float32


def _in_box(dims, cap) -> bool:
    return all(d <= cap[k] for k, d in zip(("N", "nx", "nu", "nc"), dims))


def mpc_solve_tier(dims, dtype, device) -> int:
    """The tier `solve_mpc_qp_batch` sends a batch of stage dims (N, nx,
    nu, nc) in `dtype` on `device` to with riccati="scan": 1 (K2), 2 (the
    host outer loop on K4) or 3 (the lockstep solver). Float32 batches on
    the card: the box's tier inside SOLVE_DIMS_CAP or SUBPROBLEM_DIMS_CAP,
    else K2 where the JAX package runs its full-solve kernel, K4 where it
    runs its per-subproblem kernel, tier 3 where it runs its scan."""
    dims = tuple(dims)
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return 3
    for tier, cap in ((1, SOLVE_DIMS_CAP), (2, SUBPROBLEM_DIMS_CAP)):
        if _in_box(dims, cap):
            return tier
    if fused_solve_mode(dims) is not None:
        return 1
    if subfused_mode(dims) is not None:
        return 2
    return 3


# The share of the card's memory beyond which the storing scratch of a
# batch sends K1, K2 and K4 to the recompute-factors mode.
LOWMEM_MEMORY_SHARE = 0.25


def riccati_mode(dims, B, device, total_memory=None,
                 store_floats=None) -> str:
    """'std' or 'lowmem': the mode a launch of K1, K2 or K4 takes for a
    batch of B instances of stage dims (N, nx, nu, nc) on `device`.
    lowmem (the recompute-factors Riccati, bit for bit the storing one)
    where the batch's storing scratch, B * store_floats * 4 bytes, exceeds
    LOWMEM_MEMORY_SHARE of the card's memory. By default `total_memory` is
    the device's own and `store_floats` K1's storing scratch per instance
    as the kernel library sizes it (fb_riccati_ws_floats).

    This departs from the JAX package's `_kernel_mode`, which picks lowmem
    from a model of a tile's VMEM on the TPU, a budget the card does not
    have: there what runs out is the card's memory, and the batch, not the
    tile, fills it. Off the card there is no kernel and the mode is std."""
    if total_memory is None:
        from fbstab_tpu_torch.ops._build import device_memory_bytes
        total_memory = device_memory_bytes(torch.device(device))
        if total_memory is None:
            return "std"
    if store_floats is None:
        from fbstab_tpu_torch.ops._build import load_library
        store_floats = load_library().fb_riccati_ws_floats(*dims, 0)
    need = B * store_floats * 4
    return "lowmem" if need > LOWMEM_MEMORY_SHARE * total_memory else "std"


def mpc_newton_step(d, v, y, vbar, rz, rl, rv, sigma, alpha):
    """The Newton-step dispatch (`_make_fused_step` in the JAX package):
    the CUDA kernel K1 for float32 batches on the card, in the mode of
    riccati_mode, with ok = finite (dz, dl); the plain recursion everywhere
    else, with ok = finite factor diagonals. Returns (dz, dl, dv, dy, ok)."""
    if _cuda_f32(v):
        from fbstab_tpu_torch.ops.riccati_cuda import (
            riccati_newton_step_batched)
        lowmem = riccati_mode(mpc_dims(d), v.shape[0], v.device) == "lowmem"
        dz, dl, dv, dy = riccati_newton_step_batched(
            d, v, y, vbar, rz, rl, rv, sigma, alpha, lowmem=lowmem)
        ok = torch.isfinite(dz).all(1) & torch.isfinite(dl).all(1)
        return dz, dl, dv, dy, ok
    return _fused_step_impl(d, v, y, vbar, rz, rl, rv, sigma, alpha)


def _newton_step_op(step):
    def newton_step(d, x: Variable, xbar: Variable, sigma, alpha, rz, rl,
                    rv):
        dz, dl, dv, dy, ok = step(d, x.v, x.y, xbar.v, rz, rl, rv, sigma,
                                  alpha)
        return Variable(z=dz, l=dl, v=dv, y=dy), ok
    return newton_step


MPC_OPS = ProblemOps(
    gemvH=_gemvH, gemvA=_gemvA, gemvG=_gemvG, gemvAT=_gemvAT, gemvGT=_gemvGT,
    f_vec=_f_vec, h_vec=_h_vec, b_vec=_b_vec, forcing_norm=_forcing_norm,
    newton_step=_newton_step_op(mpc_newton_step),
)
# The MPC class with the plain Newton step on every device: the plain
# version of K2 runs on it, so that nothing of it is a kernel.
MPC_PLAIN_OPS = MPC_OPS._replace(newton_step=_newton_step_op(_fused_step_impl))


# ------------------------------------------------------------------
# Parallel-in-horizon (associative-scan) Riccati Newton step
# (ops/assoc_riccati.py): O(log N) depth per step for long horizons. It
# solves the same system as _riccati_solve in another order of operations,
# so iterate paths can differ at roundoff. On the card each scan level is
# one launch of K5.
# ------------------------------------------------------------------

# The single-instance riccati="auto" takes the associative step from these
# horizons on. On the CPU: the JAX package's CPU crossover (float64, double
# integrator). On CUDA: the crossover measured on an H100 80GB HBM3 at
# 700 W in float32 on the double integrator (`chip_smoke.py
# --assoc-crossover`, the two solves in turns, best of 7; PERF.md), with
# the combine a warp per (pair, instance) on instance-major spans; scan /
# assoc in ms in two runs:
#     N = 240    489 /  805    498 /  779
#     N = 360    865 / 1170    831 / 1122
#     N = 480   1252 / 1655   1069 / 1010
#     N = 600   1400 / 1578   1349 / 1575
#     N = 720   1520 / 1162   1481 / 1099
#     N = 960   1923 / 1402   1933 / 1348
# Both paths are host-bound; the associative step wins from N = 720 on in
# both runs.
ASSOC_MIN_HORIZON = 192
ASSOC_MIN_HORIZON_CUDA = 720


def assoc_step_inputs(d, v, y, vbar, rz, rl, rv, sigma, alpha):
    """The inputs of the associative solve for one batched Newton step,
    batch-first: the PFB weights (gamma, mus), and the stage Hessians, A,
    B, r1 = rz - A'(rv ./ mus) and rl, in the argument order of
    ops.assoc_riccati.assoc_kkt_solve_im (sigma last)."""
    N, nx, nu, nc = mpc_dims(d)
    Bq = v.shape[0]
    gamma, mus, Gam = pfb_weights(y, v, vbar, _lane_sigma(sigma, v), alpha)
    Qh, Rh, Sh = _stage_hessians(d, Gam, sigma)
    r1 = (rz - _gemvAT(d, rv / mus)).reshape(Bq, N + 1, nx + nu)
    args = (Qh, Rh, Sh, d.A, d.B, r1[..., :nx], r1[..., nx:],
            rl.reshape(Bq, N + 1, nx), sigma)
    return gamma, mus, args


def _assoc_step_batched(d, v, y, vbar, rz, rl, rv, sigma, alpha):
    """Batched associative-Riccati Newton step (`_assoc_step_batched` in
    the JAX package, whose span algebra is batch-last; here it is
    instance-major). sigma: scalar or per-lane (B,). Returns (dz, dl, dv,
    dy, ok) with ok = finite (dz, dl)."""
    from fbstab_tpu_torch.ops.assoc_riccati import assoc_kkt_solve_im

    Bq = v.shape[0]
    exact_f32_matmul(v)
    gamma, mus, args = assoc_step_inputs(d, v, y, vbar, rz, rl, rv, sigma,
                                         alpha)
    xs, us, lams = assoc_kkt_solve_im(*args)
    dz = torch.cat([xs, us], -1).reshape(Bq, -1)
    dl = lams.reshape(Bq, -1)
    Adz = _gemvA(d, dz)
    dv = (rv + gamma * Adz) / mus
    dy = _b_vec(d) - Adz
    ok = torch.isfinite(dz).all(1) & torch.isfinite(dl).all(1)
    return dz, dl, dv, dy, ok


MPC_OPS_ASSOC = MPC_OPS._replace(
    newton_step=_newton_step_op(_assoc_step_batched))


def _pick_mpc_ops(data: MpcQPData, riccati: str) -> ProblemOps:
    if riccati == "scan":
        return MPC_OPS
    if riccati == "assoc":
        return MPC_OPS_ASSOC
    if riccati != "auto":
        raise ValueError(
            f"riccati must be 'auto', 'scan' or 'assoc', got {riccati!r}")
    N = mpc_dims(data)[0]
    thresh = ASSOC_MIN_HORIZON_CUDA if data.Q.is_cuda else ASSOC_MIN_HORIZON
    return MPC_OPS_ASSOC if N >= thresh else MPC_OPS


def _auto_batch_riccati(data: MpcQPData, dtype, device) -> str:
    """riccati="auto" for batches: float32 batches on the card stay on the
    sequential scan (its tiers are the fused kernels), as the JAX package
    keeps TPU float32 batches; elsewhere the associative step from
    ASSOC_MIN_HORIZON on, the JAX package's policy off the TPU."""
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        return "scan"
    return "assoc" if mpc_dims(data)[0] >= ASSOC_MIN_HORIZON else "scan"


# ------------------------------------------------------------------
# Entry points.
# ------------------------------------------------------------------

def beyond_envelope_noeq(data: MpcQPData, dtype, backend=None) -> bool:
    """The JAX package runs TPU float32 batches beyond its kernel envelope
    unequilibrated, a policy measured on the TPU only; off the TPU it
    never fires. The port runs on the CPU and on CUDA, so it never
    fires here either."""
    return False


def gate_mpc_options(data: MpcQPData, dtype, options: Options) -> Options:
    """Applies the beyond-envelope no-equilibration policy (a no-op off
    the TPU, see beyond_envelope_noeq) to validated options."""
    o = options.validated()
    if o.equilibrate and beyond_envelope_noeq(data, dtype):
        o = dataclasses.replace(o, equilibrate=False)
    return o


def solve_mpc_qp(data: MpcQPData, z0, l0, v0, options: Options = Options(),
                 riccati: str = "auto"):
    """Single-instance MPC solve (the JAX package's `solve_mpc_qp`): the
    FBstab core on one QP, given as MpcQPData with a batch of one and
    guesses z0 (nz,), l0 (nl,), v0 (nv,). Returns lane 0's (Variable,
    CoreOut), unbatched. No equilibration or refinement, as in the JAX
    package.

    riccati: "auto" (the associative step from ASSOC_MIN_HORIZON on the
    CPU, ASSOC_MIN_HORIZON_CUDA on the card), "scan" or "assoc". Both solve
    the same Newton system; iterate paths agree to roundoff only."""
    if data.x0.shape[0] != 1:
        raise ValueError(f"solve_mpc_qp takes one instance (a batch of one), "
                         f"got a batch of {data.x0.shape[0]}")
    ops = _pick_mpc_ops(data, riccati)
    exact_f32_matmul(z0)
    return fbstab_solve(ops, data, z0, l0, v0, options)


def _solve_mpc_qp_batch_raw(data: MpcQPData, z0, l0, v0, options: Options,
                            riccati: str = "scan"):
    """riccati="scan" runs the tier of mpc_solve_tier: 1, the fused CUDA
    solver (K2); 2, the host outer loop on the per-subproblem kernel (K4);
    3, the batched lockstep solver, whose Newton step is K1 on the card in
    float32 and the plain recursion elsewhere; each kernel in the mode of
    riccati_mode. riccati="assoc" runs the
    lockstep solver on the associative Riccati step (K5 on the card)."""
    with span("fbstab.solve", z0):
        if riccati == "assoc":
            exact_f32_matmul(z0)
            return fbstab_solve_batch(MPC_OPS_ASSOC, data, z0, l0, v0, options)
        dims = mpc_dims(data)
        tier = mpc_solve_tier(dims, z0.dtype, z0.device)
        lowmem = tier < 3 and riccati_mode(dims, z0.shape[0],
                                           z0.device) == "lowmem"
        if tier == 1:
            from fbstab_tpu_torch.ops.mpc_solve_cuda import (
                fbstab_mpc_solve_fused)
            return fbstab_mpc_solve_fused(data, z0, l0, v0, options,
                                          lowmem=lowmem)
        if tier == 2:
            from fbstab_tpu_torch.models.mpc_subfused import (
                fbstab_mpc_solve_subfused)
            return fbstab_mpc_solve_subfused(data, z0, l0, v0, options,
                                             lowmem=lowmem)
        exact_f32_matmul(z0)
        return fbstab_solve_batch(MPC_OPS, data, z0, l0, v0, options)


def solve_mpc_qp_batch(data: MpcQPData, z0, l0, v0,
                       options: Options = Options(), riccati: str = "auto",
                       scaling=None):
    """Batched MPC solve; every data array and guess has a leading batch
    axis. Returns (Variable or VariableDF, CoreOut).

    float32 product path (`Options.single_precision()`): Ruiz
    equilibration (models/scaling.py), the solve, a re-solve of the lanes
    that exit LINEAR_SOLVER_FAILED with a 4x sigma, then double-float
    refinement to `refine_target` (models/refine.py), whose result is a
    VariableDF pair and whose `residual` is the double-float-verified
    value in original units.

    riccati: "scan" (the sequential stage recursion on the tiers of
    _solve_mpc_qp_batch_raw), "assoc" (the lockstep solver on the
    associative Riccati step) or "auto" (_auto_batch_riccati). The
    refinement's corrections take the sequential step either way, as in
    the JAX package.
    scaling: optional precomputed batched MpcScaling for `data`.
    The parameters come in the JAX package's order."""
    if riccati not in ("auto", "scan", "assoc"):
        raise ValueError(f"riccati must be 'auto', 'scan' or 'assoc', got "
                         f"{riccati!r}")
    with span("fbstab.mpc_batch", z0):
        if riccati == "auto":
            riccati = _auto_batch_riccati(data, z0.dtype, z0.device)
        opts = options.validated()
        from fbstab_tpu_torch.models.refine import (
            refine_engaged, refine_solution_mpc)
        from fbstab_tpu_torch.models.scaling import (
            merge_failed_retry, retry_options, ruiz_mpc_scaling,
            scaling_engaged, solve_scaled_mpc)

        if scaling is None:
            opts = gate_mpc_options(data, z0.dtype, opts)

        scal = scaling
        if scal is None and scaling_engaged(opts, z0.dtype):
            with span("fbstab.scaling"):
                scal = ruiz_mpc_scaling(data)

        will_refine = refine_engaged(opts, z0.dtype)

        def scaled_solve(o, z, l, v):
            return solve_scaled_mpc(
                lambda dd, zz, ll, vv: _solve_mpc_qp_batch_raw(
                    dd, zz, ll, vv, o, riccati), data, z, l, v, o,
                scal=scal, skip_residual_rewrite=will_refine)

        x, core = scaled_solve(opts, z0, l0, v0)
        if opts.retry_failed and z0.dtype == torch.float32:
            with span("fbstab.retry"):
                fail = core.eflag == int(ExitFlag.LINEAR_SOLVER_FAILED)
                with span("fbstab.sync.retry_any"):
                    count("host_sync.retry_any")
                    failed = int(fail.sum())
                if failed:
                    count("retry.lanes", failed)
                    # Failed lanes restart from the caller's guess; the
                    # others re-enter at their solution and exit at once.
                    m = fail[:, None]
                    x2, core2 = scaled_solve(
                        retry_options(opts), torch.where(m, z0, x.z),
                        torch.where(m, l0, x.l), torch.where(m, v0, x.v))
                    x, core = merge_failed_retry(x, core, x2, core2)
        if will_refine:
            return refine_solution_mpc(data, x, core, opts, scal=scal)
        return x, core


# ------------------------------------------------------------------
# Facade (reference: FBstabMpc, fbstab_mpc.h:56).
# ------------------------------------------------------------------

def facade_solve(ops, batch_solve, data, z0, l0, v0, options: Options,
                 stream):
    """The single-instance facades' solve of a batch of one: `batch_solve`,
    the class's batched dispatch (the fused kernels on the card, with the
    LINEAR_SOLVER_FAILED retry), unless Display.ITER or ITER_DETAILED asks
    for the iteration tables. Those the lockstep core on `ops` prints to
    `stream`, as the JAX facades do, when neither equilibration nor
    refinement is engaged (the product path prints no tables)."""
    from fbstab_tpu_torch.models.refine import refine_engaged
    from fbstab_tpu_torch.models.scaling import scaling_engaged
    if (options.display_level >= Display.ITER
            and not (scaling_engaged(options, z0.dtype)
                     or refine_engaged(options, z0.dtype))):
        exact_f32_matmul(z0)
        return fbstab_solve_batch(ops, data, z0, l0, v0, options, stream)
    return batch_solve(data, z0, l0, v0, options)


def facade_out(core, elapsed: float) -> SolverOut:
    """Lane 0 of a batch-of-one CoreOut as the facades' SolverOut."""
    lane = lambda a: a[0] if isinstance(a, torch.Tensor) else a
    return SolverOut(
        eflag=lane(core.eflag), residual=lane(core.residual),
        newton_iters=lane(core.newton_iters),
        prox_iters=lane(core.prox_iters),
        solve_time=torch.tensor(elapsed),
        initial_residual=lane(core.initial_residual),
        raw_residual=lane(core.raw_residual),
        refine_steps=lane(core.refine_steps))


def facade_print_final(ops, data, x, out: SolverOut, options: Options,
                       stream) -> None:
    """The facades' Display.FINAL summary (fbstab_algorithm-impl.h:
    491-541): the blockwise penalized natural residual at the returned
    point (the float32 view of a refined one) and the combined
    tolerance."""
    if options.display_level < Display.FINAL:
        return
    from fbstab_tpu_torch.core.residuals import (
        penalized_natural_residual, residual_block_norms)
    from fbstab_tpu_torch.models.refine import VariableDF
    from fbstab_tpu_torch.utils.printing import print_final
    if isinstance(x, VariableDF):
        x = x.hi()
    bn = residual_block_norms(penalized_natural_residual(
        ops, data, x, options.alpha))
    combo = float(options.abs_tol + options.rel_tol
                  * (1.0 + ops.forcing_norm(data)[0]))
    print_final(out, options, stream=stream,
                block_norms=tuple(b[0] for b in bn), combo_tol=combo)


class FBstabMpc:
    """Allocate-once/solve-many facade for one MPC QP at a time; it runs a
    batch of one through the batched functions above (facade_solve). It
    solves on the card unless given device="cpu" (keyword-only: the
    positional parameters are the JAX facade's, `stream` sixth).

    stream: the OutputStream (utils/printing.py) that receives the
    Display.ITER / ITER_DETAILED tables and the FINAL summary; None
    prints them to stdout."""

    def __init__(self, N: int, nx: int, nu: int, nc: int,
                 dtype=torch.float64, stream=None, *, device=None):
        if N <= 0 or nx <= 0 or nu <= 0 or nc <= 0:
            raise ValueError("FBstabMpc requires N, nx, nu, nc > 0.")
        self._stream = stream
        self.N, self.nx, self.nu, self.nc = N, nx, nu, nc
        self.nz = (N + 1) * (nx + nu)
        self.nl = (N + 1) * nx
        self.nv = (N + 1) * nc
        self.dtype = dtype
        self.device = resolve_device(device)
        self._options = Options.default()

    def update_options(self, options: Options) -> None:
        """Reference: FBstabMpc::UpdateOptions (fbstab_mpc.cc:95-99)."""
        self._options = options.validated()

    def set_stream(self, stream) -> None:
        """Injects the OutputStream that receives all solver output: the
        iteration tables and the FINAL summary (the reference's
        Solve(qp, &x, os) hook, tools/output_stream.h:15-38)."""
        self._stream = stream

    @property
    def options(self) -> Options:
        return self._options

    @staticmethod
    def default_options() -> Options:
        return Options.default()

    @staticmethod
    def reliable_options() -> Options:
        return Options.reliable()

    def solve(self, data: MpcQPData, x0: Optional[Variable] = None,
              stream=None) -> tuple[Variable, SolverOut]:
        """Solves one QP given as batched data with B = 1, from the
        warmstart x0 (the origin if omitted). Returns lane 0's result.
        `stream` overrides the FINAL summary's sink for this call
        (set_stream also takes the iteration tables)."""
        N, nx, nu, nc = self.N, self.nx, self.nu, self.nc
        if mpc_dims(data) != (N, nx, nu, nc) or data.x0.shape[0] != 1:
            raise ValueError(
                f"FBstabMpc.solve: expected one instance of dims "
                f"{(N, nx, nu, nc)}, got dims {mpc_dims(data)} and batch "
                f"{data.x0.shape[0]}.")
        dev = data.Q.device
        if dev.type != self.device.type:
            raise ValueError(f"FBstabMpc.solve: the data lies on {dev}, "
                             f"the solver was made for {self.device}.")
        zeros = lambda n: torch.zeros(1, n, dtype=self.dtype, device=dev)
        if x0 is None:
            x0 = Variable(z=zeros(self.nz), l=zeros(self.nl),
                          v=zeros(self.nv), y=zeros(self.nv))
        t0 = time.perf_counter()
        x, core = facade_solve(MPC_OPS, solve_mpc_qp_batch, data, x0.z,
                               x0.l, x0.v, self._options, self._stream)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = facade_out(core, time.perf_counter() - t0)
        facade_print_final(MPC_OPS, data, x, out, self._options,
                            stream or self._stream)
        return x, out


__all__ = [
    "CoreOut", "FBstabMpc", "MPC_OPS", "MPC_OPS_ASSOC", "MpcQPData",
    "batch_data", "mpc_dims", "mpc_qp_data", "solve_mpc_qp",
    "solve_mpc_qp_batch",
]

"""Dense QP class, batched in PyTorch.

Counterpart of `fbstab_tpu/models/dense_qp.py` (reference
dense_data.{h,cc}, dense_cholesky_solver.{h,cc}, fbstab_dense.{h,cc}).
The QP is

    min.  1/2 z'Hz + f'z   s.t.  Gz = h,  Az <= b,

with nz = n variables, nl equality and nv = q inequality constraints.
Every tensor carries a leading batch axis B: H (B, n, n), f (B, n),
G (B, nl, n), h (B, nl), A (B, q, n), b (B, q); nl = 0 is allowed.

The Newton system K = [E G'; G -sigma I] is symmetric quasi-definite, so
its block factorization needs no pivoting:

    E = H + sigma I + A' diag(gamma ./ mus) A = Le Le'     (Cholesky)
    S = sigma I + W'W,  W = Le^{-1} G'          = Ls Ls'     (Cholesky)

(dense_cholesky_solver.cc:32-127). A failed factorization leaves NaN on a
factor diagonal (ops/smallchol.py), and the lane exits
LINEAR_SOLVER_FAILED. This plain step serves the lockstep solver
everywhere; on the card, float32 batches within DENSE_DIMS_CAP run the
fused CUDA solver K3 instead (ops/dense_solve_cuda.py).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from fbstab_tpu_torch.core.algorithm import (
    CoreOut, fbstab_solve, fbstab_solve_batch)
from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.device import resolve_device
from fbstab_tpu_torch.models.mpc_qp import (
    _lane_sigma, exact_f32_matmul, facade_out, facade_print_final,
    facade_solve)
from fbstab_tpu_torch.ops.pfb import pfb_weights
from fbstab_tpu_torch.ops.smallchol import cholesky, solve_triangular_small
from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import ExitFlag, SolverOut

_tri = solve_triangular_small


class DenseQPData(NamedTuple):
    """Batched dense QP data (reference: FBstabDense::ProblemData,
    fbstab_dense.h:55-64)."""

    H: torch.Tensor  # (B, n, n) PSD Hessian
    f: torch.Tensor  # (B, n)
    G: torch.Tensor  # (B, nl, n)
    h: torch.Tensor  # (B, nl)
    A: torch.Tensor  # (B, q, n)
    b: torch.Tensor  # (B, q)


def dense_dims(d: DenseQPData) -> tuple[int, int, int]:
    """(n, q, nl) from the trailing array shapes."""
    return d.H.shape[-1], d.A.shape[-2], d.G.shape[-2]


def dense_qp_data(H, f, G=None, h=None, A=None, b=None,
                  dtype=torch.float64, device=None) -> DenseQPData:
    """Builds batched DenseQPData from array-likes with a common leading
    batch axis, validating the per-instance shapes. Missing equality blocks
    become size-0 arrays (nl = 0). With no `device` the data goes where H
    lies if it is a tensor, else on the card (device.resolve_device)."""
    device = resolve_device(device, like=H)

    def tensor(a):
        if isinstance(a, torch.Tensor):
            return a.to(dtype=dtype, device=device)
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    if A is None or b is None:
        raise ValueError("dense_qp_data: A and b are required.")
    H = tensor(H)
    if H.ndim != 3:
        raise ValueError("dense_qp_data: the arrays need a leading batch "
                         f"axis; H has shape {tuple(H.shape)}.")
    Bq, n = H.shape[0], H.shape[-1]
    if G is None:
        G = torch.zeros(Bq, 0, n, dtype=dtype, device=device)
        h = torch.zeros(Bq, 0, dtype=dtype, device=device)
    data = DenseQPData(H=H, f=tensor(f), G=tensor(G), h=tensor(h),
                       A=tensor(A), b=tensor(b))
    nl = data.G.shape[1] if data.G.ndim == 3 else -1
    q = data.A.shape[1] if data.A.ndim == 3 else -1
    expect = dict(H=(n, n), f=(n,), G=(nl, n), h=(nl,), A=(q, n), b=(q,))
    for name, want in expect.items():
        got = tuple(getattr(data, name).shape)
        if got != (Bq,) + want:
            raise ValueError(f"dense_qp_data: {name} has shape {got}, "
                             f"expected {(Bq,) + want}.")
    return data


# ------------------------------------------------------------------
# Data operators (reference: dense_data.cc:12-41), batched products.
# ------------------------------------------------------------------

def _mv(M, x):
    return torch.matmul(M, x[..., None])[..., 0]


def _mtv(M, x):
    return torch.matmul(M.transpose(-1, -2), x[..., None])[..., 0]


def _gemvH(d: DenseQPData, x):
    return _mv(d.H, x)


def _gemvA(d: DenseQPData, x):
    return _mv(d.A, x)


def _gemvG(d: DenseQPData, x):
    return _mv(d.G, x)


def _gemvAT(d: DenseQPData, v):
    return _mtv(d.A, v)


def _gemvGT(d: DenseQPData, l):
    return _mtv(d.G, l)


def _forcing_norm(d: DenseQPData):
    """Per-lane ||(f, h, b)||_2 (dense_data.h:72-73)."""
    sq = lambda a: (a * a).sum(-1)
    return torch.sqrt(sq(d.f) + sq(d.h) + sq(d.b))


# ------------------------------------------------------------------
# Newton-step solver (reference: dense_cholesky_solver.cc:32-127).
# ------------------------------------------------------------------

class DenseFactorization(NamedTuple):
    Le: torch.Tensor     # (B, n, n) lower Cholesky factor of E
    W: torch.Tensor      # (B, n, nl) = Le^{-1} G'
    Ls: torch.Tensor     # (B, nl, nl) lower Cholesky factor of S
    gamma: torch.Tensor  # (B, q)
    mus: torch.Tensor    # (B, q)


def _factor(d: DenseQPData, x: Variable, xbar: Variable, sigma, alpha
            ) -> DenseFactorization:
    """Forms and factors the Newton system, paper (28)/(29)
    (dense_cholesky_solver.cc:32-79). sigma: scalar or per-lane (B,)."""
    n, _, nl = dense_dims(d)
    kw = dict(dtype=d.H.dtype, device=d.H.device)
    gamma, mus, Gamma = pfb_weights(x.y, x.v, xbar.v,
                                    _lane_sigma(sigma, x.v), alpha)
    sig3 = _lane_sigma(sigma, d.H)
    At = d.A.transpose(-1, -2)
    E = d.H + sig3 * torch.eye(n, **kw) + At @ (Gamma[..., None] * d.A)
    Le = cholesky(E)
    W = _tri(Le, d.G.transpose(-1, -2), lower=True)
    S = sig3 * torch.eye(nl, **kw) + W.transpose(-1, -2) @ W
    Ls = cholesky(S)
    return DenseFactorization(Le=Le, W=W, Ls=Ls, gamma=gamma, mus=mus)


def _factor_ok(fact: DenseFactorization):
    """Per-lane: both Cholesky factorizations succeeded (no NaN on the
    factor diagonals; dense_cholesky_solver.cc:72-78)."""
    diag_ok = lambda F: torch.isfinite(
        torch.diagonal(F, dim1=-2, dim2=-1)).all(-1)
    return diag_ok(fact.Le) & diag_ok(fact.Ls)


def _newton_solve(d: DenseQPData, fact: DenseFactorization, rz, rl, rv
                  ) -> Variable:
    """Solves the Newton system given the factorization
    (dense_cholesky_solver.cc:81-127):

        [E  G'] [dz] = [rz - A'(rv ./ mus)]
        [G -sI] [dl]   [-rl]
        diag(mus) dv = rv + diag(gamma) A dz,   dy = b - A dz

    by block elimination: u = Le^{-1} r1; (W'W + sI) dl = W'u - r2;
    E dz = r1 - G' dl."""
    r1 = rz - _mtv(d.A, rv / fact.mus)
    r2 = -rl
    u = _tri(fact.Le, r1, lower=True)
    rhs_l = _mtv(fact.W, u) - r2
    dl = _tri(fact.Ls.transpose(-1, -2), _tri(fact.Ls, rhs_l, lower=True),
              lower=False)
    rhs_z = r1 - _mtv(d.G, dl)
    dz = _tri(fact.Le.transpose(-1, -2), _tri(fact.Le, rhs_z, lower=True),
              lower=False)
    Adz = _mv(d.A, dz)
    dv = (rv + fact.gamma * Adz) / fact.mus
    dy = d.b - Adz
    return Variable(z=dz, l=dl, v=dv, y=dy)


def _newton_step(d: DenseQPData, x: Variable, xbar: Variable, sigma, alpha,
                 rz, rl, rv):
    """The plain Newton step: (dx, ok) with ok the factor check."""
    exact_f32_matmul(x.v)
    fact = _factor(d, x, xbar, sigma, alpha)
    return _newton_solve(d, fact, rz, rl, rv), _factor_ok(fact)


DENSE_OPS = ProblemOps(
    gemvH=_gemvH, gemvA=_gemvA, gemvG=_gemvG, gemvAT=_gemvAT, gemvGT=_gemvGT,
    f_vec=lambda d: d.f, h_vec=lambda d: d.h, b_vec=lambda d: d.b,
    forcing_norm=_forcing_norm, newton_step=_newton_step,
)


# ------------------------------------------------------------------
# Kernel dispatch. Tier 1 is the fused CUDA solver K3 for float32 batches
# on the card within DENSE_DIMS_CAP; everything else (tier 3) runs the
# lockstep solver on the plain step. The TPU-only FBSTAB_PALLAS switch is
# not ported.
#
# The cap is the box, inside the JAX package's gate (n <= 64, q <= 128,
# nl <= 64), whose corner K3 passes against its plain version with
# Gaussian equality rows and where it is the faster of the two
# (`chip_smoke.py --k3-envelope`, B = 256, on an H100 80GB HBM3 at 700 W;
# chip_smoke.py checks the corner on every run). With a warp per
# instance, K3 passes at n = 64, q = 128 with nl = 0 and nl = 32, in 4.2
# and 9.2 ms against the plain version's 90.3 and 149.6 ms; at nl = n
# (n = 32, nl = 32 and the gate's corner n = 64, nl = 64) the rows fix z
# and the two float32 solvers part in Newton counts on ill-conditioned
# lanes (in float64 the replayed device code takes the plain solver's
# decisions there, tests/test_torch_device_code.py), so nl stops at 32.
# ------------------------------------------------------------------

DENSE_DIMS_CAP = dict(n=64, q=128, nl=32)


def solve_dense_qp(data: DenseQPData, z0, l0, v0,
                   options: Options = Options()):
    """Single-instance dense solve (the JAX package's `solve_dense_qp`):
    the FBstab core on one QP, given as DenseQPData with a batch of one and
    guesses z0 (nz,), l0 (nl,), v0 (nv,). Returns lane 0's (Variable,
    CoreOut), unbatched. No equilibration or refinement, as in the JAX
    package."""
    exact_f32_matmul(z0)
    return fbstab_solve(DENSE_OPS, data, z0, l0, v0, options)


def _solve_dense_qp_batch_raw(data: DenseQPData, z0, l0, v0,
                              options: Options):
    n, q, nl = dense_dims(data)
    cap = DENSE_DIMS_CAP
    if (z0.is_cuda and z0.dtype == torch.float32 and n <= cap["n"]
            and q <= cap["q"] and nl <= cap["nl"]):
        from fbstab_tpu_torch.ops.dense_solve_cuda import (
            fbstab_dense_solve_fused)
        return fbstab_dense_solve_fused(data, z0, l0, v0, options)
    exact_f32_matmul(z0)
    return fbstab_solve_batch(DENSE_OPS, data, z0, l0, v0, options)


def solve_dense_qp_batch(data: DenseQPData, z0, l0, v0,
                         options: Options = Options(), scaling=None):
    """Batched dense solve; every data array and guess has a leading batch
    axis. Returns (Variable or VariableDF, CoreOut).

    float32 product path (`Options.single_precision()`): Ruiz
    equilibration, the solve (K3 on the card), a re-solve of the
    LINEAR_SOLVER_FAILED lanes with a 4x sigma, then double-float
    refinement to `refine_target`, as in solve_mpc_qp_batch.

    scaling: optional precomputed batched DenseScaling for `data`,
    shared by the solve, the retry and the refinement."""
    opts = options.validated()
    from fbstab_tpu_torch.models.refine import (
        refine_engaged, refine_solution_dense)
    from fbstab_tpu_torch.models.scaling import (
        merge_failed_retry, retry_options, ruiz_dense_scaling,
        scaling_engaged, solve_scaled_dense)

    scal = scaling
    if scal is None and scaling_engaged(opts, z0.dtype):
        scal = ruiz_dense_scaling(data)
    will_refine = refine_engaged(opts, z0.dtype)

    def scaled_solve(o, z, l, v):
        return solve_scaled_dense(
            lambda dd, zz, ll, vv: _solve_dense_qp_batch_raw(
                dd, zz, ll, vv, o), data, z, l, v, o, scal=scal,
            skip_residual_rewrite=will_refine)

    x, core = scaled_solve(opts, z0, l0, v0)
    if opts.retry_failed and z0.dtype == torch.float32:
        fail = core.eflag == int(ExitFlag.LINEAR_SOLVER_FAILED)
        if bool(fail.any()):
            m = fail[:, None]
            x2, core2 = scaled_solve(
                retry_options(opts), torch.where(m, z0, x.z),
                torch.where(m, l0, x.l), torch.where(m, v0, x.v))
            x, core = merge_failed_retry(x, core, x2, core2)
    if will_refine:
        return refine_solution_dense(data, x, core, opts, scal=scal)
    return x, core


# ------------------------------------------------------------------
# Facade (reference: FBstabDense, fbstab_dense.h:50).
# ------------------------------------------------------------------

class FBstabDense:
    """Allocate-once/solve-many facade for one dense QP at a time; it runs
    a batch of one through the batched functions above (as FBstabMpc
    does, mpc_qp.facade_solve), on the card unless given device="cpu"
    (keyword-only: the positional parameters are the JAX facade's,
    `stream` fifth).

    stream: the OutputStream (utils/printing.py) that receives the
    Display.ITER / ITER_DETAILED tables and the FINAL summary; None
    prints them to stdout."""

    def __init__(self, nz: int, nl: int, nv: int, dtype=torch.float64,
                 stream=None, *, device=None):
        if nz <= 0 or nv <= 0 or nl < 0:
            raise ValueError("FBstabDense requires nz > 0, nv > 0, nl >= 0.")
        self._stream = stream
        self.nz, self.nl, self.nv = nz, nl, nv
        self.dtype = dtype
        self.device = resolve_device(device)
        self._options = Options.default()

    def update_options(self, options: Options) -> None:
        """Reference: FBstabDense::UpdateOptions (fbstab_dense.cc:44-48)."""
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

    def solve(self, data: DenseQPData, x0: Optional[Variable] = None,
              stream=None) -> tuple[Variable, SolverOut]:
        """Solves one QP given as batched data with B = 1, from the
        warmstart x0 (the origin if omitted); the returned Variable
        replaces it (fbstab_algorithm.h:129-142). Returns lane 0's
        result. `stream` overrides the FINAL summary's sink for this call
        (set_stream also takes the iteration tables)."""
        self._validate(data)
        dev = data.H.device
        zeros = lambda n: torch.zeros(1, n, dtype=self.dtype, device=dev)
        if x0 is None:
            x0 = Variable(z=zeros(self.nz), l=zeros(self.nl),
                          v=zeros(self.nv), y=zeros(self.nv))
        t0 = time.perf_counter()
        x, core = facade_solve(DENSE_OPS, solve_dense_qp_batch, data, x0.z,
                               x0.l, x0.v, self._options, self._stream)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = facade_out(core, time.perf_counter() - t0)
        facade_print_final(DENSE_OPS, data, x, out, self._options,
                           stream or self._stream)
        return x, out

    def _validate(self, data: DenseQPData) -> None:
        nz, nl, nv = self.nz, self.nl, self.nv
        want = dict(H=(1, nz, nz), f=(1, nz), G=(1, nl, nz), h=(1, nl),
                    A=(1, nv, nz), b=(1, nv))
        for name, shape in want.items():
            got = tuple(getattr(data, name).shape)
            if got != shape:
                raise ValueError(f"FBstabDense.solve: {name} has shape "
                                 f"{got}, expected {shape}.")
        if data.H.device.type != self.device.type:
            raise ValueError(f"FBstabDense.solve: the data lies on "
                             f"{data.H.device}, the solver was made for "
                             f"{self.device}.")


__all__ = [
    "CoreOut", "DENSE_OPS", "DenseQPData", "FBstabDense", "dense_dims",
    "dense_qp_data", "solve_dense_qp", "solve_dense_qp_batch",
]

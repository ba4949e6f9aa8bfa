"""Differentiable QP solving: implicit differentiation through FBstab
(counterpart of `fbstab_tpu/diff.py`).

The solution map theta -> x*(theta) of a convex QP is differentiated by
the implicit function theorem applied to the solver's own optimality
system, the penalized Fischer-Burmeister residual

    F(x, theta) = ( Hz + f + G'l + A'v,  h - Gz,  pfb(b - Az, v) ) = 0,

whose Jacobian dF/dx is the solver's Newton matrix J_sigma at x = xbar = x*
up to the O(sigma) proximal term. The backward pass therefore reuses the
QP class's own batched Newton step: one step per batch, which for the MPC
class on the card in float32 is one launch of the Riccati kernel K1
(models/mpc_qp.py, `mpc_newton_step`), and the plain recursion in float64
or on the CPU. The transpose system J_sigma' w = cot is the same condensed
quasi-definite system with the signs of the l block flipped:

    dx = newton_step(x*, x*, rz = z_cot, rl = -l_cot, rv = -gamma v_cot)
    wz = dx.z,  wl = -dx.l,  y_cot = dx.v

and the data cotangent is the vector-Jacobian product of the residual map
theta -> (rz, rl, b - Az) at (-wz, -wl, y_cot), taken by torch.autograd
through the class's own products, so every data field gets its gradient.
Forward mode (`make_jvp_solver`) solves the same Newton system with the
residual map's JVP on the right-hand side; the map is affine in theta, so
that JVP is F(theta_dot) - F(0).

Both modes are one `torch.autograd.Function` whose inputs are the data's
fields, flattened: autograd sees only tensors passed at the top level.
Gradients with respect to the warmstart are None (the solution does not
depend on it). Gradients are meaningful where the solve succeeds; at
degenerate points they are the particular subgradient of the PFB
C-differential the solver uses, and stay finite.

For the sparse QP class the backward's Newton step is one batched round
trip to the host LDL' (models/sparse_qp.py), factor and solve fused.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.models.mpc_qp import exact_f32_matmul
from fbstab_tpu_torch.ops.pfb import pfb_weights
from fbstab_tpu_torch.options import Options


def _residual_map(ops: ProblemOps, z, l, v):
    """theta -> (rz, rl, b - Az) at the fixed point (z, l, v)."""
    def residual_map(d):
        rz = (ops.gemvH(d, z) + ops.f_vec(d) + ops.gemvGT(d, l)
              + ops.gemvAT(d, v))
        rl = ops.h_vec(d) - ops.gemvG(d, z)
        ylin = ops.b_vec(d) - ops.gemvA(d, z)
        return rz, rl, ylin
    return residual_map


def _at_solution(ops: ProblemOps, alpha, sigma, data, z, l, v):
    """x* with its margin, and the PFB weight gamma at it (the Newton
    matrix's, x = xbar)."""
    y = ops.b_vec(data) - ops.gemvA(data, z)
    gamma = pfb_weights(y, v, v, sigma, alpha)[0]
    return Variable(z=z, l=l, v=v, y=y), gamma


def _implicit_bwd(ops: ProblemOps, alpha, sigma_vjp, data, z, l, v, cot):
    """Batched backward pass: theta_cot = -(dF/dtheta)' J^{-T} cot through
    the class's own Newton step (see the module docstring). Returns one
    cotangent per field of `data`."""
    z_cot, l_cot, v_cot = cot
    exact_f32_matmul(z)
    with torch.no_grad():
        xstar, gamma = _at_solution(ops, alpha, sigma_vjp, data, z, l, v)
        dx, _ = ops.newton_step(data, xstar, xstar, sigma_vjp, alpha,
                                z_cot, -l_cot, -(gamma * v_cot))
    # gamma * wv = -dx.v exactly (the dual recovery of the Newton step), so
    # dx.v carries the pfb row's cotangent through dy/dtheta = db - dA z
    # with the guarded C-differential, not an autodiff of pfb's sqrt.
    wz, wl, y_cot = dx.z, -dx.l, dx.v
    with torch.enable_grad():
        fields = [a.detach().requires_grad_() for a in data]
        outs = _residual_map(ops, z, l, v)(type(data)(*fields))
        grads = torch.autograd.grad(outs, fields, (-wz, -wl, y_cot),
                                    allow_unused=True)
    return tuple(torch.zeros_like(f) if g is None else g
                 for g, f in zip(grads, fields))


def _implicit_jvp(ops: ProblemOps, alpha, sigma, data, z, l, v, data_dot):
    """Batched tangent rule: x_dot = J_sigma^{-1} (-dF/dtheta theta_dot),
    the pfb row's tangent gamma * (db - dA z). Returns (z, l, v) tangents."""
    exact_f32_matmul(z)
    # The residual map is affine in theta at fixed (z, l, v): each term is
    # a data field, a product of one with the fixed point, or a structural
    # constant (the -I blocks of the MPC class's G). So its JVP is
    # F(theta_dot) - F(0), exactly, and free of the nested forward-mode AD
    # that torch does not support inside a jvp rule.
    with torch.no_grad():
        F = _residual_map(ops, z, l, v)
        zero = type(data_dot)(*(torch.zeros_like(a) for a in data_dot))
        rz_d, rl_d, yl_d = (a - b for a, b in zip(F(data_dot), F(zero)))
        xstar, gamma = _at_solution(ops, alpha, sigma, data, z, l, v)
        dx, _ = ops.newton_step(data, xstar, xstar, sigma, alpha, -rz_d,
                                -rl_d, -(gamma * yl_d))
    return dx.z, dx.l, dx.v


def _primal(x):
    """(z, l, v) of a solve's result; the float32 view of a refined
    (VariableDF) point, whose lo parts sit below the gradient noise."""
    from fbstab_tpu_torch.models.refine import VariableDF
    if isinstance(x, VariableDF):
        x = x.hi()
    return x.z, x.l, x.v


def _implicit_function(ops: ProblemOps, forward, alpha, sigma):
    """A torch.autograd.Function (data_type, z0, l0, v0, *fields) ->
    (z, l, v), batched, whose forward is forward(data, z0, l0, v0), whose
    backward is _implicit_bwd (reverse mode) and whose jvp is
    _implicit_jvp (forward mode)."""

    class ImplicitSolve(torch.autograd.Function):
        @staticmethod
        def forward(data_type, z0, l0, v0, *fields):
            with torch.no_grad():
                x, _ = forward(data_type(*fields), z0, l0, v0)
            return _primal(x)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.data_type = inputs[0]
            ctx.save_for_backward(*output, *inputs[4:])
            ctx.save_for_forward(*output, *inputs[4:])

        @staticmethod
        @once_differentiable
        def backward(ctx, z_cot, l_cot, v_cot):
            z, l, v, *fields = ctx.saved_tensors
            theta_cot = _implicit_bwd(ops, alpha, sigma,
                                      ctx.data_type(*fields), z, l, v,
                                      (z_cot, l_cot, v_cot))
            return (None, None, None, None, *theta_cot)

        @staticmethod
        def jvp(ctx, _type_dot, _z0_dot, _l0_dot, _v0_dot, *field_dots):
            z, l, v, *fields = ctx.saved_tensors
            dots = [torch.zeros_like(f) if t is None else t
                    for f, t in zip(fields, field_dots)]
            return _implicit_jvp(ops, alpha, sigma, ctx.data_type(*fields),
                                 z, l, v, ctx.data_type(*dots))

    return ImplicitSolve


def _single(batched):
    """The single-instance convention of the port (`solve_mpc_qp`): data
    with a batch of one, unbatched guesses, lane 0's result unbatched."""
    def solve(data, z0, l0, v0):
        z, l, v = batched(data, z0[None], l0[None], v0[None])
        return z[0], l[0], v[0]
    return solve


def _applied(fn):
    def solve(data, z0, l0, v0):
        return fn.apply(type(data), z0, l0, v0, *data)
    return solve


def _core_forward(ops: ProblemOps, options: Options):
    def forward(data, z0, l0, v0):
        exact_f32_matmul(z0)
        return fbstab_solve_batch(ops, data, z0, l0, v0, options)
    return forward


@functools.lru_cache(maxsize=64)
def make_differentiable_solver(ops: ProblemOps, options: Options = Options(),
                               sigma_vjp: float = 1e-9):
    """A function (data, z0, l0, v0) -> (z, l, v) that solves one QP and
    supports reverse-mode differentiation with respect to every field of
    `data` by implicit differentiation. `data` holds a batch of one, the
    guesses and results are unbatched (the port's single-instance
    convention, as `solve_mpc_qp`). Use sigma_vjp ~ 1e-5 for float32
    data. One autograd Function is kept per (ops, options, sigma_vjp)."""
    # The solve saturates out-of-range options; the backward Newton
    # matrix must use the same alpha the solution's PFB weights had.
    options = options.validated()
    fn = _implicit_function(ops, _core_forward(ops, options),
                            options.alpha, sigma_vjp)
    return _single(_applied(fn))


@functools.lru_cache(maxsize=64)
def make_differentiable_batch_solver(ops: ProblemOps, batch_solve,
                                     options: Options = Options(),
                                     sigma_vjp: float = 1e-9):
    """Batch-level differentiable solve (data and guesses with a leading
    batch axis): the forward pass runs `batch_solve(data, z0, l0, v0,
    options)` (e.g. solve_mpc_qp_batch: the fused kernel K2 and the
    refinement on the card in float32), the backward pass is one batched
    implicit Newton step (K1 on the card in float32)."""
    options = options.validated()

    def forward(data, z0, l0, v0):
        return batch_solve(data, z0, l0, v0, options)

    return _applied(_implicit_function(ops, forward, options.alpha,
                                       sigma_vjp))


def solve_mpc_qp_batch_diff(data, z0, l0, v0, options: Options = Options(),
                            sigma_vjp: Optional[float] = None):
    """Differentiable batched MPC solve: forward through the
    solve_mpc_qp_batch dispatch, backward through one batched implicit
    Riccati step."""
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, solve_mpc_qp_batch
    sig = _default_sig(sigma_vjp, z0.dtype)
    return make_differentiable_batch_solver(
        MPC_OPS, solve_mpc_qp_batch, options, sig)(data, z0, l0, v0)


def make_jvp_solver(ops: ProblemOps, options: Options = Options(),
                    sigma_vjp: float = 1e-9):
    """Forward-mode counterpart of make_differentiable_solver (same
    single-instance convention): the solve supports torch.func.jvp and
    torch.autograd.forward_ad with respect to `data`, the tangent rule
    solving the same Newton system forward, x_dot = J_sigma^{-1}
    (-dF/dtheta theta_dot). JAX cannot put custom_jvp and custom_vjp on
    one function; a torch.autograd.Function carries both, so this is
    make_differentiable_solver's function itself."""
    return make_differentiable_solver(ops, options, sigma_vjp)


def mpc_feedback_gain(data, options: Options = Options(),
                      sigma_vjp: Optional[float] = None):
    """The implicit MPC feedback law's local gain K = d u0* / d x0 (nu,
    nx) at the solution of one MPC QP (`data` with a batch of one). The
    solve is the core's, from the origin; the nx tangents, one per state
    dimension, are nx lanes of one batched Newton step (one K1 launch on
    the card in float32), where the JAX package takes jacfwd."""
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, batch_data, mpc_dims
    N, nx, nu, nc = mpc_dims(data)
    kw = dict(dtype=data.x0.dtype, device=data.x0.device)
    sig = _default_sig(sigma_vjp, data.x0.dtype)
    opts = options.validated()
    zeros = lambda n: torch.zeros(1, n, **kw)
    x, _ = _core_forward(MPC_OPS, opts)(
        data, zeros((N + 1) * (nx + nu)), zeros((N + 1) * nx),
        zeros((N + 1) * nc))
    lanes = lambda a: a.expand(nx, *a.shape[1:])
    data_dot = type(data)(*(torch.zeros_like(lanes(a)) for a in data))
    data_dot = data_dot._replace(x0=torch.eye(nx, **kw))
    dz, _, _ = _implicit_jvp(MPC_OPS, opts.alpha, sig, batch_data(data, nx),
                             lanes(x.z), lanes(x.l), lanes(x.v), data_dot)
    return dz[:, nx:nx + nu].T


def solve_dense_qp_diff(data, z0, l0, v0, options: Options = Options(),
                        sigma_vjp: Optional[float] = None):
    """Differentiable dense solve of one QP (a batch of one, unbatched
    guesses): (z, l, v) with gradients for every field of DenseQPData
    (H, f, G, h, A, b)."""
    from fbstab_tpu_torch.models.dense_qp import DENSE_OPS
    sig = _default_sig(sigma_vjp, z0.dtype)
    return make_differentiable_solver(DENSE_OPS, options, sig)(
        data, z0, l0, v0)


def solve_mpc_qp_diff(data, z0, l0, v0, options: Options = Options(),
                      sigma_vjp: Optional[float] = None):
    """Differentiable MPC solve of one QP (the differentiable MPC layer):
    gradients for every stage sequence of MpcQPData and the initial
    state x0; the backward pass is one Riccati Newton step."""
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS
    sig = _default_sig(sigma_vjp, z0.dtype)
    return make_differentiable_solver(MPC_OPS, options, sig)(
        data, z0, l0, v0)


def solve_sparse_qp_diff(pattern, data, z0, l0, v0,
                         options: Options = Options(),
                         sigma_vjp: Optional[float] = None):
    """Differentiable sparse solve of one QP (a batch of one, unbatched
    guesses) on `pattern` (a SparsePattern): (z, l, v) with gradients for
    the CSR value arrays and vectors of SparseQPData (Hx, f, Gx, h, Ax,
    b); the backward pass is one host LDL' round trip."""
    sig = _default_sig(sigma_vjp, z0.dtype)
    return make_differentiable_solver(pattern.ops, options, sig)(
        data, z0, l0, v0)


def _default_sig(sigma_vjp, dtype) -> float:
    if sigma_vjp is not None:
        return float(sigma_vjp)
    return 1e-5 if dtype == torch.float32 else 1e-9

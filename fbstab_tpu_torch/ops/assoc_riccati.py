"""Parallel-in-horizon (associative-scan) Riccati Newton-step solver,
instance-major (counterpart of `fbstab_tpu/ops/assoc_riccati.py`, its
`assoc_kkt_solve_bl`).

It solves the sigma-regularized LQ saddle system of the sequential
Riccati recursion (models/mpc_qp.py::_riccati_solve) in O(log N) depth:

1. per stage, u_i is eliminated in closed form, leaving a quadratic span
   element F_i(x_i, x_{i+1}); the terminal stage gives one with zero
   b-blocks;
2. a suffix associative scan combines adjacent spans by minimizing over
   the shared boundary state (one call of K5, ops/assoc_combine_cuda.py,
   per level on the card); the suffix combination from stage i is the
   value function V_i(x) = 1/2 x'J x + p'x;
3. the states follow x_{i+1} = Phi_i x_i + c_i, rolled out by a prefix
   associative scan of affine maps, then u and lambda are recovered
   stage-batched.

The solve takes and returns batch-first arrays, (B, N+1, ...), and works
stage-stacked with the batch second, (S, B, n, m) matrices and (S, B, n)
vectors, from the stage elements through the scans to the rollout: one
layout change at the entry and one at the exit, none per level, and each
(stage, instance) block contiguous for K5. The JAX package keeps the batch
last ((S, n, m, B)); `stage_elements_im` is the first part of its
`_assoc_kkt_solve_bl`. The same algebraic solution as the sequential
recursion in another order of operations, so the two agree to roundoff.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch.ops.assoc_combine_cuda import (
    COMBINE_MAX_N, SpanElement, _mv, _T, combine_im, combine_im_plain,
    psolve_im)


def _map(f, *trees):
    """f over the matching tensors of tuples (or NamedTuples)."""
    t0 = trees[0]
    out = [f(*leaves) for leaves in zip(*trees)]
    return type(t0)(*out) if hasattr(t0, "_fields") else tuple(out)


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of the associative `fn` along axis 0 of every tensor
    of the tuple `elems`, with the recursion of `jax.lax.associative_scan`:
    combine adjacent pairs, scan the reduced sequence, fill the even
    positions, interleave. With `reverse` the sequence is flipped first and
    the result flipped back, so `fn(a, b)` then receives the later element
    as `a`. Every level is one call of `fn` over all its pairs, on views
    of every other element (no copy); empty slices are not combined."""
    if reverse:
        elems = _map(lambda a: torch.flip(a, (0,)), elems)

    def scan(el):
        n = el[0].shape[0]
        if n < 2:
            return el
        odd = scan(fn(_map(lambda a: a[0:n - 1:2], el),
                      _map(lambda a: a[1::2], el)))
        rest = _map(lambda a: a[2::2], el)
        first = odd if n % 2 else _map(lambda a: a[:-1], odd)
        even = fn(first, rest) if rest[0].shape[0] else rest
        even = _map(lambda a, e: torch.cat([a[:1], e]), el, even)

        def interleave(e, o):
            out = e.new_empty((n,) + tuple(e.shape[1:]))
            out[0::2] = e
            out[1::2] = o
            return out
        return _map(interleave, even, odd)

    out = scan(elems)
    if reverse:
        out = _map(lambda a: torch.flip(a, (0,)), out)
    return out


def _combine_level(left: SpanElement, right: SpanElement) -> SpanElement:
    """The combine of one scan level: K5 for float32 on the card (n <=
    COMBINE_MAX_N), the plain algebra otherwise (as the JAX package sends
    only float32 TPU batches to its Pallas kernel)."""
    x = left.P11
    if x.is_cuda and x.dtype == torch.float32 and x.shape[-1] <= COMBINE_MAX_N:
        return combine_im(left, right)
    return combine_im_plain(left, right)


def _lane(sigma, like, shape):
    """1 / sigma for a scalar or a per-lane (B,) sigma, the latter reshaped
    to `shape` (its batch axis -1) to broadcast against instance-major
    arrays."""
    inv = 1.0 / torch.as_tensor(sigma, dtype=like.dtype, device=like.device)
    return inv if inv.ndim == 0 else inv.reshape(shape)


def stage_elements_im(Qh, Rh, Sh, A, B, r1x, r1u, rl, sigma):
    """The N stage elements and the terminal one, (N+1, B, ...): stage i
    eliminates u_i from its cost plus the sigma-relaxed dynamics penalty
    linking x_i to x_{i+1} (u-Hessian K_u = Rh + B'B / sigma); the terminal
    element eliminates u_N from the stage-N cost alone. Takes the solve's
    arrays stage-stacked, (N+1, B, ...) and (N, B, ...). Returns (elems,
    aux), aux = (Ku, D, g, KiS, Kir) for the recovery of u."""
    N1, Bb, nx = Qh.shape[0], Qh.shape[1], Qh.shape[2]
    N = N1 - 1
    dtype, dev = Qh.dtype, Qh.device
    sb4 = _lane(sigma, Qh, (1, -1, 1, 1))
    sb3 = _lane(sigma, Qh, (1, -1, 1))
    Qs, Rs, Ss = Qh[:-1], Rh[:-1], Sh[:-1]
    ct = rl[1:]
    BT, AT = _T(B), _T(A)
    Ku = Rs + sb4 * (BT @ B)
    D = Ss + sb4 * (BT @ A)
    g = sb3 * _mv(BT, ct) - r1u[:-1]

    KiD = psolve_im(Ku, D)
    KiBT = psolve_im(Ku, BT)
    Kig = psolve_im(Ku, g)

    DT = _T(D)
    P11 = Qs + sb4 * (AT @ A) - DT @ KiD
    P12 = -sb4 * AT + sb4 * (DT @ KiBT)
    Ix = torch.eye(nx, dtype=dtype, device=dev)
    P22 = sb4 * Ix - (sb4 * sb4) * (B @ KiBT)
    p1 = -r1x[:-1] + sb3 * _mv(AT, ct) - _mv(DT, Kig)
    p2 = -sb3 * ct + sb3 * _mv(B, Kig)

    KiS = psolve_im(Rh[N], Sh[N])
    Kir = psolve_im(Rh[N], r1u[N])
    P11N = Qh[N] - _T(Sh[N]) @ KiS
    p1N = -r1x[N] + _mv(_T(Sh[N]), Kir)
    zm = torch.zeros((1, Bb, nx, nx), dtype=dtype, device=dev)
    zv = torch.zeros((1, Bb, nx), dtype=dtype, device=dev)
    elems = SpanElement(
        P11=torch.cat([P11, P11N[None]]), P12=torch.cat([P12, zm]),
        P22=torch.cat([P22, zm]), p1=torch.cat([p1, p1N[None]]),
        p2=torch.cat([p2, zv]))
    return elems, (Ku, D, g, KiS, Kir)


def suffix_values(elems: SpanElement, combine=None) -> SpanElement:
    """The suffix combinations S_i = e_i o e_{i+1} o ... o e_N, whose P11
    and p1 are the value functions V_i. With reverse the scan hands the
    later span first, so the operands are swapped to keep left = earlier.
    `combine` is one scan level (default: K5 on the card in float32)."""
    combine = combine or _combine_level
    return associative_scan(lambda a, b: combine(b, a), elems, reverse=True)


def stage_major(a):
    """(B, S, ...) <-> (S, B, ...), a view."""
    return a.transpose(0, 1)


def assoc_kkt_solve_im(Qh, Rh, Sh, A, B, r1x, r1u, rl, sigma):
    """Parallel solve of the regularized LQ saddle system, batch first.

    Qh, Rh, Sh (B, N+1, nx|nu, .): the barrier-augmented Hessian blocks;
    A, B (B, N, nx, .); r1x, r1u (B, N+1, .) the stationarity residual; rl
    (B, N+1, nx) the equality residual; sigma a scalar or per-lane (B,).
    Returns (xs, us, lams), each (B, N+1, .)."""
    Qh, Rh, Sh, A, B, r1x, r1u, rl = map(
        stage_major, (Qh, Rh, Sh, A, B, r1x, r1u, rl))
    N, nx = Qh.shape[0] - 1, Qh.shape[2]
    dtype, dev = Qh.dtype, Qh.device
    sb3 = _lane(sigma, Qh, (1, -1, 1))
    sbm, sbv = _lane(sigma, Qh, (-1, 1, 1)), _lane(sigma, Qh, (-1, 1))
    elems, (Ku, D, g, KiS, Kir) = stage_elements_im(
        Qh, Rh, Sh, A, B, r1x, r1u, rl, sigma)
    suff = suffix_values(elems)
    J, p = suff.P11, suff.p1

    # ---- x0 and the forward rollout ----
    Ix0 = torch.eye(nx, dtype=dtype, device=dev)
    x0 = psolve_im(sbm * Ix0 + J[0], sbv * rl[0] - p[0])
    Kf = elems.P22[:N] + J[1:]
    Phi = psolve_im(Kf, -_T(elems.P12[:N]))
    c = psolve_im(Kf, -(elems.p2[:N] + p[1:]))

    def aff_op(f, s):
        # Composition of affine maps, the earlier one applied first.
        return (s[0] @ f[0], _mv(s[0], f[1]) + s[1])

    Ms, cs = associative_scan(aff_op, (Phi, c))
    xs = torch.cat([x0[None], _mv(Ms, x0) + cs])

    # ---- recovery of u and lambda ----
    rhs_u = _mv(D, xs[:-1]) - sb3 * _mv(_T(B), xs[1:]) + g
    us_head = -psolve_im(Ku, rhs_u)
    uN = Kir - _mv(KiS, xs[N])
    us = torch.cat([us_head, uN[None]])
    lam0 = sbv * (rl[0] - xs[0])
    lam_tail = sb3 * (rl[1:] + _mv(A, xs[:-1]) + _mv(B, us[:-1]) - xs[1:])
    lams = torch.cat([lam0[None], lam_tail])
    return stage_major(xs), stage_major(us), stage_major(lams)

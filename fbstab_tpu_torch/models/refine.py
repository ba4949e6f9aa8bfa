"""Mixed-precision iterative refinement of float32 MPC and dense solves
(counterpart of `fbstab_tpu/models/refine.py`).

Each step evaluates the penalized-FB KKT residual in double-float
arithmetic (ops/doublefloat.py), solves the correction in float32 (MPC:
through the solver's Newton-step dispatch, the CUDA kernel K1 on the card,
`mpc_qp.mpc_newton_step`; dense: the plain dense step), and carries the
iterate as a double-float pair, so neither the float32 residual floor nor
the float32 representation of the point limits the result. The loop exits
early per chunk of lanes once the original-units residual of every live
lane is under `Options.refine_target`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fbstab_tpu_torch.core.variable import Variable, tree_map
from fbstab_tpu_torch.models import dense_qp as _dense
from fbstab_tpu_torch.models.dense_qp import DenseQPData
from fbstab_tpu_torch.models.mpc_qp import (
    MpcQPData,
    mpc_dims,
    mpc_newton_step,
)
from fbstab_tpu_torch.ops.doublefloat import (
    df,
    df_add,
    df_matvec,
    df_matvec_T,
    df_max0,
    df_min,
    df_mul,
    df_mul_f,
    df_neg,
    df_sqrt,
    df_sub,
    df_to,
)
from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import ExitFlag
from fbstab_tpu_torch.telemetry import count, span


class VariableDF(NamedTuple):
    """A primal-dual point in double-float precision: each field is a
    (hi, lo) pair of float32 tensors; `hi` alone is the float32 rounding."""

    z: tuple
    l: tuple
    v: tuple
    y: tuple

    def hi(self) -> Variable:
        return Variable(z=self.z[0], l=self.l[0], v=self.v[0], y=self.y[0])

    def to_float64(self) -> Variable:
        """hi + lo, exactly, as float64 tensors."""
        up = lambda p: p[0].double() + p[1].double()
        return Variable(z=up(self.z), l=up(self.l), v=up(self.v),
                        y=up(self.y))


def _stages(a, N1, n):
    """(B, N1*n) -> (B, N1, n)."""
    return a.reshape(a.shape[0], N1, n)


def _flat(p, N1xn):
    return (p[0].reshape(p[0].shape[0], N1xn),
            p[1].reshape(p[1].shape[0], N1xn))


def _cat1(p, q):
    return tree_map(lambda a, b: torch.cat([a, b], 1), p, q)


def _const(x: float, like):
    """A Python constant rounded once to `like`'s dtype."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _mpc_kkt_residual_df(d: MpcQPData, zx, zu, l, v, y, alpha):
    """Penalized-FB KKT residual blocks in double-float, stage-shaped:
    rz = f + Hz + G'l + A'v, rl = h - Gz, rv = pfb(y, v)
    (full_residual.cc:49-74 at xbar = x)."""
    hx = df_add(df_matvec(d.Q, zx), df_matvec_T(d.S, zu))
    hu = df_add(df_matvec(d.S, zx), df_matvec(d.R, zu))

    # G'l: x(i) = -l(i) + A(i)' l(i+1); u(i) = B(i)' l(i+1).
    l_next = tree_map(lambda a: a[:, 1:], l)
    atl = df_matvec_T(d.A, l_next)
    btl = df_matvec_T(d.B, l_next)
    zpad = lambda p: tree_map(
        lambda a: torch.cat([a, torch.zeros_like(a[:, :1])], 1), p)
    gx = df_add(df_neg(l), zpad(atl))
    gu = zpad(btl)

    ax = df_matvec_T(d.E, v)
    au = df_matvec_T(d.L, v)

    rzx = df_add(df_add(df(d.q), hx), df_add(gx, ax))
    rzu = df_add(df_add(df(d.r), hu), df_add(gu, au))

    # rl = h - G z with h = -(x0, c), (Gz)(0) = -x(0),
    # (Gz)(i) = A x(i-1) + B u(i-1) - x(i).
    zx_head = tree_map(lambda a: a[:, :1], zx)
    zx_prev = tree_map(lambda a: a[:, :-1], zx)
    zu_prev = tree_map(lambda a: a[:, :-1], zu)
    zx_next = tree_map(lambda a: a[:, 1:], zx)
    g_tail = df_sub(df_add(df_matvec(d.A, zx_prev),
                           df_matvec(d.B, zu_prev)), zx_next)
    gz = _cat1(df_neg(zx_head), g_tail)
    hvec = df(-torch.cat([d.x0[:, None, :], d.c], 1))
    rl = df_sub(hvec, gz)

    # rv = alpha*(y + v - sqrt(y^2 + v^2)) + (1-alpha)*max(0,y)*max(0,v).
    s = df_sqrt(df_add(df_mul(y, y), df_mul(v, v)))
    fb = df_sub(df_add(y, v), s)
    pen = df_mul(df_max0(y), df_max0(v))
    rv = df_add(df_mul_f(fb, _const(alpha, d.q)),
                df_mul_f(pen, _const(1.0 - alpha, d.q)))
    return rzx, rzu, rl, rv


def _mpc_pnr_norm_df(d: MpcQPData, zx, zu, l, v, y, alpha):
    """Penalized natural residual norm from the double-float point; the
    sum of squares runs over the accurate hi parts."""
    rzx, rzu, rl, _ = _mpc_kkt_residual_df(d, zx, zu, l, v, y, alpha)
    nr = df_min(y, v)
    pen = df_mul(df_max0(y), df_max0(v))
    rv = df_add(df_mul_f(nr, _const(alpha, d.q)),
                df_mul_f(pen, _const(1.0 - alpha, d.q)))
    sq = lambda p: (df_to(p) ** 2).sum((1, 2))
    return torch.sqrt(sq(rzx) + sq(rzu) + sq(rl) + sq(rv))


def _margin(d: MpcQPData, zx, zu):
    """y = b - A z in double-float (full_variable.cc:47-53)."""
    return df_sub(df(-d.d), df_add(df_matvec(d.E, zx), df_matvec(d.L, zu)))


def _pnr_df_at_mpc(data: MpcQPData, sol, alpha):
    """Double-float penalized natural residual at a point in original
    coordinates (VariableDF pairs or a plain Variable), with the margin
    rebuilt from the data."""
    N, nx, nu, nc = mpc_dims(data)
    N1 = N + 1
    as_pair = lambda a: a if isinstance(a, tuple) else df(a)
    z = as_pair(sol.z)
    B = z[0].shape[0]
    zst = tree_map(lambda a: a.reshape(B, N1, nx + nu), z)
    zx = tree_map(lambda a: a[..., :nx], zst)
    zu = tree_map(lambda a: a[..., nx:], zst)
    l = tree_map(lambda a: a.reshape(B, N1, nx), as_pair(sol.l))
    v = tree_map(lambda a: a.reshape(B, N1, nc), as_pair(sol.v))
    y = _margin(data, zx, zu)
    return _mpc_pnr_norm_df(data, zx, zu, l, v, y, alpha)


def refine_mpc_batch(data: MpcQPData, x: Variable,
                     options: Options = Options(), steps: int = 3
                     ) -> tuple[VariableDF, torch.Tensor]:
    """Polishes a batched float32 MPC solution for a fixed number of
    steps (the JAX package's unrolled `refine_mpc_batch`: no walk window,
    no early exit). Each correction is one call of the Newton-step
    dispatch at sigma0 (K1 on the card in float32); a lane whose step is
    not finite keeps its point. Returns (VariableDF refined point,
    (steps + 1, B) penalized natural residual history)."""
    opts = options.validated()
    N, nx, nu, nc = mpc_dims(data)
    N1 = N + 1
    B = x.z.shape[0]
    alpha = opts.alpha
    zs = x.z.reshape(B, N1, nx + nu)
    zx, zu = df(zs[..., :nx]), df(zs[..., nx:])
    l = df(_stages(x.l, N1, nx))
    v = df(_stages(x.v, N1, nc))
    y = _margin(data, zx, zu)
    history = [_mpc_pnr_norm_df(data, zx, zu, l, v, y, alpha)]
    for _ in range(steps):
        rzx, rzu, rl, rv = (df_to(b) for b in _mpc_kkt_residual_df(
            data, zx, zu, l, v, y, alpha))
        vh = df_to(v).reshape(B, -1)
        dz, dl, dv, _, ok = mpc_newton_step(
            data, vh, df_to(y).reshape(B, -1), vh,
            -torch.cat([rzx, rzu], -1).reshape(B, -1), -rl.reshape(B, -1),
            -rv.reshape(B, -1), opts.sigma0, alpha)
        okm = ok[:, None, None]
        addf = lambda p, c: df_add(
            p, df(torch.where(okm, c, torch.zeros_like(c))))
        dzs = dz.reshape(B, N1, nx + nu)
        zx = addf(zx, dzs[..., :nx])
        zu = addf(zu, dzs[..., nx:])
        l = addf(l, _stages(dl, N1, nx))
        v = df_max0(addf(v, _stages(dv, N1, nc)))
        y = _margin(data, zx, zu)
        history.append(_mpc_pnr_norm_df(data, zx, zu, l, v, y, alpha))
    zshape = (B, N1 * (nx + nu))
    refined = VariableDF(
        z=(torch.cat([zx[0], zu[0]], -1).reshape(zshape),
           torch.cat([zx[1], zu[1]], -1).reshape(zshape)),
        l=_flat(l, N1 * nx), v=_flat(v, N1 * nc), y=_flat(y, N1 * nc))
    return refined, torch.stack(history)


def refine_engaged(options: Options, dtype) -> bool:
    """Refinement polishes float32 solves only."""
    return options.refine_steps > 0 and dtype == torch.float32


def _mpc_norms(alpha, scal, zx, zu, l, v, y, rzx, rzu, rl):
    """Original-units penalized natural residual norm from loop-coordinate
    double-float blocks (exact pow2 row unscalings when `scal` is given;
    the pfb row re-evaluated at the unscaled (y, v))."""
    if scal is not None:
        from fbstab_tpu_torch.models.scaling import df_scale
        kc3 = scal.kc[:, None, None]
        v = df_scale(v, scal.de / kc3)
        y = df_scale(y, 1.0 / scal.de)
        rzx = df_scale(rzx, 1.0 / (kc3 * scal.dx))
        rzu = df_scale(rzu, 1.0 / (kc3 * scal.du))
        rl = df_scale(rl, scal.dx)
    a = _const(alpha, zx[0])
    nr = df_min(y, v)
    pen = df_mul(df_max0(y), df_max0(v))
    rv = df_add(df_mul_f(nr, a), df_mul_f(pen, 1.0 - a))
    sq = lambda p: (df_to(p) ** 2).sum((1, 2))
    return torch.sqrt(sq(rzx) + sq(rzu) + sq(rl) + sq(rv))


def _mpc_refine_entry(data: MpcQPData, x: Variable, options: Options,
                      scal=None):
    """Loop-entry double-float state, KKT blocks and original-units
    residual for the refinement loop."""
    opts = options.validated()
    N, nx, nu, nc = mpc_dims(data)
    N1 = N + 1
    B = x.z.shape[0]
    zs = x.z.reshape(B, N1, nx + nu)
    zx0 = df(zs[..., :nx])
    zu0 = df(zs[..., nx:])
    l0 = df(_stages(x.l, N1, nx))
    v0 = df(_stages(x.v, N1, nc))
    y0 = _margin(data, zx0, zu0)
    blocks0 = _mpc_kkt_residual_df(data, zx0, zu0, l0, v0, y0, opts.alpha)
    res0 = _mpc_norms(opts.alpha, scal, zx0, zu0, l0, v0, y0, *blocks0[:3])
    return (zx0, zu0, l0, v0, y0), blocks0, res0


# Bounded non-monotone acceptance window: a trial within WALK_BAND of the
# best residual may advance the CURRENT point for up to WALK_STEPS
# consecutive non-improving steps; the answer always comes from the
# separately tracked BEST point.
WALK_BAND = 8.0
WALK_STEPS = 6


def _walk_update(B, live, ok, res_p, res_best, since, t, sig,
                 state_p, cur, bst, rhs_p, rhs_c, rhs_b):
    """Step acceptance for the refinement loop: improved / bounded walk /
    reject-and-escalate, and the CURRENT/BEST state selection. state and
    rhs are nested tuples of (B, ...) tensors. Returns
    (cur, bst, rhs_c, rhs_b, res_best, live, t, sig, since)."""
    finite = live & ok & torch.isfinite(res_p)
    improved = finite & (res_p < res_best)
    walk = (finite & ~improved & (res_p < WALK_BAND * res_best)
            & (since < WALK_STEPS) & (t >= 1.0))
    advance = improved | walk
    rejected = live & ~advance

    def sel(m):
        def pick(pn, po):
            return tree_map(lambda a, b: torch.where(
                m.reshape((B,) + (1,) * (a.ndim - 1)), a, b), pn, po)
        return pick

    cur = sel(advance)(state_p, sel(rejected)(bst, cur))
    rhs_c = sel(advance)(rhs_p, sel(rejected)(rhs_b, rhs_c))
    bst = sel(improved)(state_p, bst)
    rhs_b = sel(improved)(rhs_p, rhs_b)
    res_best = torch.where(improved, res_p, res_best)
    since = torch.where(improved | rejected, torch.zeros_like(since),
                        torch.where(walk, since + 1, since))
    wind = rejected & (sig < 8e-2)
    t = torch.where(improved | wind, torch.ones_like(t),
                    torch.where(walk, t, t * 0.5))
    sig = torch.where(rejected, torch.clamp(sig * 8.0, max=8e-2), sig)
    live = live & (t >= 1.0 / 64.0)
    return cur, bst, rhs_c, rhs_b, res_best, live, t, sig, since


def _refine_mpc_step(data, carry, opts: Options, scal):
    """One MPC refinement iteration on every lane of `carry`."""
    N, nx, nu, nc = mpc_dims(data)
    N1 = N + 1
    cur, bst, rhs_c, rhs_b, res_best, live, t, sig, since = carry
    zx, zu, l, v, y = cur
    B = zx[0].shape[0]
    dtype = zx[0].dtype
    rzx, rzu, rl, rv = rhs_c
    rz_flat = torch.cat([rzx, rzu], -1).reshape(B, -1)
    vh = df_to(v).reshape(B, -1)
    yh = df_to(y).reshape(B, -1)
    with span("fbstab.refine.k1"):
        dz, dl, dv, _, ok = mpc_newton_step(
            data, vh, yh, vh, -rz_flat, -rl.reshape(B, -1),
            -rv.reshape(B, -1), sig, opts.alpha)
    # Damped step; the walk window decides what the lane keeps.
    tm = (t * (live & ok).to(dtype))[:, None, None]
    dzs = dz.reshape(B, N1, nx + nu)
    addf = lambda p, c: df_add(p, df(tm * c))
    zx_p = addf(zx, dzs[..., :nx])
    zu_p = addf(zu, dzs[..., nx:])
    l_p = addf(l, _stages(dl, N1, nx))
    v_p = df_max0(addf(v, _stages(dv, N1, nc)))
    with span("fbstab.refine.residual"):
        y_p = _margin(data, zx_p, zu_p)
        blocks_p = _mpc_kkt_residual_df(data, zx_p, zu_p, l_p, v_p, y_p,
                                        opts.alpha)
        res_p = _mpc_norms(opts.alpha, scal, zx_p, zu_p, l_p, v_p, y_p,
                           *blocks_p[:3])
        rhs_p = tuple(df_to(b) for b in blocks_p)
    return _walk_update(B, live, ok, res_p, res_best, since, t, sig,
                        (zx_p, zu_p, l_p, v_p, y_p), cur, bst, rhs_p, rhs_c,
                        rhs_b)


def _take(tree, idx):
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _put(tree, idx, sub):
    def put(a, s):
        out = a.clone()
        out[idx] = s
        return out
    return tree_map(put, tree, sub)


def _refine_loop(step, data, state0, rhs0, res0, options: Options, good,
                 scal, chunk: int | None):
    """Early-exit refinement loop in loop coordinates (the Ruiz-scaled
    problem when `scal` is given), with the exit test in original units;
    step(data, carry, opts, scal) is one iteration of the QP class.

    chunk: lanes exit in consecutive chunks of this size (None: one
    batch-global exit). A chunk keeps stepping while i < refine_steps and
    any of its live lanes is above the target; its lanes freeze once it
    stops, exactly as the JAX package's per-chunk while loops do. Only the
    lanes of running chunks are computed.
    Returns (best state in loop coordinates, res, per-lane steps)."""
    opts = options.validated()
    B = res0.shape[0]
    dtype, dev = res0.dtype, res0.device
    sigma = opts.refine_sigma or opts.sigma0
    ck = B if chunk is None else chunk
    C = B // ck

    carry = (state0, state0, rhs0, rhs0, res0, good,
             torch.ones(B, dtype=dtype, device=dev),
             torch.full((B,), sigma, dtype=dtype, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    steps = torch.zeros(C, dtype=torch.int32, device=dev)
    for _ in range(opts.refine_steps):
        res_best, live = carry[4], carry[5]
        with span("fbstab.sync.refine_exit"):
            pending = torch.where(live, res_best, torch.zeros_like(res_best))
            run_chunk = pending.reshape(C, ck).amax(1) > opts.refine_target
            # One read: the chunks still running (the exit test) and the
            # live lanes above the target (the useful share of the step).
            count("host_sync.refine_exit")
            running, above = torch.stack((
                run_chunk.sum(),
                (pending > opts.refine_target).sum())).tolist()
            if running == 0:
                break
        steps = steps + run_chunk.to(torch.int32)
        count("refine.steps")
        count("refine.lanes_pending", above)
        if running == C:
            count("refine.lanes_stepped", B)
            with span("fbstab.refine.step"):
                carry = step(data, carry, opts, scal)
        else:
            with span("fbstab.refine.gather"):
                count("host_sync.refine_gather")
                idx = run_chunk.repeat_interleave(ck).nonzero()[:, 0]
                sub_scal = None if scal is None else _take(scal, idx)
                sub_data, sub_carry = _take(data, idx), _take(carry, idx)
            count("refine.lanes_stepped", idx.shape[0])
            with span("fbstab.refine.step"):
                sub = step(sub_data, sub_carry, opts, sub_scal)
            with span("fbstab.refine.gather"):
                carry = _put(carry, idx, sub)
    return carry[1], carry[4], steps.repeat_interleave(ck)


def _refine_mpc_loop(data: MpcQPData, state0, rhs0, res0, options: Options,
                     good, scal=None, chunk: int | None = None):
    """The MPC refinement loop (_refine_loop). Returns (VariableDF in loop
    coordinates, res, per-lane steps)."""
    N, nx, nu, nc = mpc_dims(data)
    N1 = N + 1
    B = res0.shape[0]
    (zx, zu, l, v, y), res, steps = _refine_loop(
        _refine_mpc_step, data, state0, rhs0, res0, options, good, scal,
        chunk)
    zshape = (B, N1 * (nx + nu))
    refined = VariableDF(
        z=(torch.cat([zx[0], zu[0]], -1).reshape(zshape),
           torch.cat([zx[1], zu[1]], -1).reshape(zshape)),
        l=_flat(l, N1 * nx), v=_flat(v, N1 * nc), y=_flat(y, N1 * nc))
    return refined, res, steps


def _splice_df(refined: VariableDF, x: Variable, good) -> VariableDF:
    """The refined point on `good` lanes; the solver's own point (lo = 0)
    elsewhere, so infeasibility certificates pass through untouched."""
    g = good[:, None]
    pick = lambda p, raw: (torch.where(g, p[0], raw),
                           torch.where(g, p[1], torch.zeros_like(raw)))
    return VariableDF(z=pick(refined.z, x.z), l=pick(refined.l, x.l),
                      v=pick(refined.v, x.v), y=pick(refined.y, x.y))


# Per-chunk early exit granularity (measured per class in the JAX
# package; see fbstab_tpu/models/refine.py): 128 lanes for small-stage MPC,
# 256 for large-stage MPC (>= _LARGE_ROWS state rows per lane).
REFINE_CHUNK_SMALL = 128
REFINE_CHUNK_LARGE = 256
_LARGE_ROWS = 2048


def _refine_chunk(rows: int | None) -> int:
    if rows is None or rows >= _LARGE_ROWS:
        return REFINE_CHUNK_LARGE
    return REFINE_CHUNK_SMALL


def _chunked_refine(loop_fn, B, rows=None):
    """Runs loop_fn(chunk) with the per-chunk early exit of the JAX
    package's lax.map over fixed-size chunks; one batch-global exit when
    the batch does not split evenly."""
    ck = _refine_chunk(rows)
    if B <= ck or B % ck != 0:
        return loop_fn(None)
    return loop_fn(ck)


def _finish_refine(refined, x, core, good, res0, res, steps):
    """Refined point on lanes that are good AND improved, the raw point
    elsewhere; `residual` is the double-float value at the returned point
    and `raw_residual` the pre-refinement one, on every lane."""
    use = good & (res <= res0)
    sol = _splice_df(refined, x, use)
    rdt = core.residual.dtype
    reported = torch.where(use, res.to(rdt), res0.to(rdt))
    return sol, core._replace(residual=reported, raw_residual=res0.to(rdt),
                              refine_steps=steps)


def refine_solution_mpc(data: MpcQPData, x: Variable, core,
                        options: Options, scal=None):
    """Polishes the SUCCESS lanes of a batched float32 MPC solve and
    rewrites the CoreOut (see _finish_refine). With Options.equilibrate
    the corrections run on the Ruiz-equilibrated problem (pass the
    solve's own MpcScaling as `scal` to skip recomputing it)."""
    with span("fbstab.refine", x.z):
        opts = options.validated()
        good = core.eflag == int(ExitFlag.SUCCESS)
        B = x.z.shape[0]
        N, nx, nu, nc = mpc_dims(data)
        rows = (N + 1) * (nx + nu + nx + 2 * nc)
        if opts.equilibrate:
            from fbstab_tpu_torch.models.scaling import (
                apply_mpc_scaling, ruiz_mpc_scaling, scale_mpc_variable,
                unscale_mpc_variable_df)
            with span("fbstab.scaling"):
                if scal is None:
                    scal = ruiz_mpc_scaling(data)
                sdata = apply_mpc_scaling(data, scal)
                xs = scale_mpc_variable(x, scal)
            with span("fbstab.refine.entry"):
                state0, blocks0, res0 = _mpc_refine_entry(sdata, xs, opts,
                                                          scal)
                rhs0 = tuple(df_to(b) for b in blocks0)
            refined_s, res, steps = _chunked_refine(
                lambda ck: _refine_mpc_loop(sdata, state0, rhs0, res0, opts,
                                            good, scal, ck), B, rows=rows)
            with span("fbstab.scaling"):
                refined = unscale_mpc_variable_df(refined_s, scal)
        else:
            with span("fbstab.refine.entry"):
                state0, blocks0, res0 = _mpc_refine_entry(data, x, opts)
                rhs0 = tuple(df_to(b) for b in blocks0)
            refined, res, steps = _chunked_refine(
                lambda ck: _refine_mpc_loop(data, state0, rhs0, res0, opts,
                                            good, None, ck), B, rows=rows)
        with span("fbstab.refine.final"):
            res = _pnr_df_at_mpc(data, refined, opts.alpha)
            return _finish_refine(refined, x, core, good, res0, res, steps)


# ------------------------------------------------------------------
# Dense QP refinement (same scheme; explicit-matrix compensated matvecs,
# corrections through the plain dense Newton step of models/dense_qp.py,
# which the JAX package also leaves to XLA rather than a kernel).
# ------------------------------------------------------------------

def _dense_kkt_residual_df(d: DenseQPData, z, l, v, y, alpha):
    """Penalized-FB KKT residual blocks in double-float (full_residual.cc:
    49-74 at xbar = x): rz = f + Hz + G'l + A'v, rl = h - Gz,
    rv = pfb(y, v)."""
    rz = df_add(df_add(df(d.f), df_matvec(d.H, z)),
                df_add(df_matvec_T(d.G, l), df_matvec_T(d.A, v)))
    rl = df_sub(df(d.h), df_matvec(d.G, z))
    s = df_sqrt(df_add(df_mul(y, y), df_mul(v, v)))
    fb = df_sub(df_add(y, v), s)
    pen = df_mul(df_max0(y), df_max0(v))
    a = _const(alpha, d.f)
    rv = df_add(df_mul_f(fb, a), df_mul_f(pen, 1.0 - a))
    return rz, rl, rv


def _dense_pnr_norm_df(d: DenseQPData, z, l, v, y, alpha):
    """Penalized natural residual norm from the double-float point."""
    rz, rl, _ = _dense_kkt_residual_df(d, z, l, v, y, alpha)
    nr = df_min(y, v)
    pen = df_mul(df_max0(y), df_max0(v))
    a = _const(alpha, d.f)
    rv = df_add(df_mul_f(nr, a), df_mul_f(pen, 1.0 - a))
    sq = lambda p: (df_to(p) ** 2).sum(-1)
    return torch.sqrt(sq(rz) + sq(rl) + sq(rv))


def _dense_margin(d: DenseQPData, z):
    """y = b - A z in double-float."""
    return df_sub(df(d.b), df_matvec(d.A, z))


def _dense_correction(d: DenseQPData, z, l, v, y, rz, rl, rv, sigma, alpha):
    """One float32 correction solve from the (single-float) KKT blocks:
    returns (dz, dl, dv, ok)."""
    xx = Variable(z=z, l=l, v=v, y=y)
    fact = _dense._factor(d, xx, xx, sigma, alpha)
    dx = _dense._newton_solve(d, fact, -rz, -rl, -rv)
    return dx.z, dx.l, dx.v, _dense._factor_ok(fact)


def refine_dense_batch(data: DenseQPData, x: Variable,
                       options: Options = Options(), steps: int = 3):
    """Polishes a batched float32 dense solution for a fixed number of
    steps (no walk window, no early exit). Returns (VariableDF refined
    point, (steps + 1, B) penalized natural residual history)."""
    opts = options.validated()
    alpha = opts.alpha
    z, l, v = df(x.z), df(x.l), df(x.v)
    y = _dense_margin(data, z)
    history = [_dense_pnr_norm_df(data, z, l, v, y, alpha)]
    for _ in range(steps):
        rz, rl, rv = _dense_kkt_residual_df(data, z, l, v, y, alpha)
        dz, dl, dv, ok = _dense_correction(
            data, df_to(z), df_to(l), df_to(v), df_to(y), df_to(rz),
            df_to(rl), df_to(rv), opts.sigma0, alpha)
        guard = lambda c: torch.where(ok[:, None], c, torch.zeros_like(c))
        z = df_add(z, df(guard(dz)))
        l = df_add(l, df(guard(dl)))
        v = df_max0(df_add(v, df(guard(dv))))
        y = _dense_margin(data, z)
        history.append(_dense_pnr_norm_df(data, z, l, v, y, alpha))
    return VariableDF(z=z, l=l, v=v, y=y), torch.stack(history)


def _dense_norms(alpha, scal, z, l, v, y, rz, rl):
    """Original-units penalized natural residual norm from dense
    loop-coordinate double-float blocks (see _mpc_norms)."""
    if scal is not None:
        from fbstab_tpu_torch.models.scaling import df_scale
        kc2 = scal.kc[:, None]
        v = df_scale(v, scal.de / kc2)
        y = df_scale(y, 1.0 / scal.de)
        rz = df_scale(rz, 1.0 / (kc2 * scal.dz))
        rl = df_scale(rl, 1.0 / scal.dl)
    a = _const(alpha, z[0])
    nr = df_min(y, v)
    pen = df_mul(df_max0(y), df_max0(v))
    rv = df_add(df_mul_f(nr, a), df_mul_f(pen, 1.0 - a))
    sq = lambda p: (df_to(p) ** 2).sum(-1)
    return torch.sqrt(sq(rz) + sq(rl) + sq(rv))


def _dense_refine_entry(data: DenseQPData, x: Variable, options: Options,
                        scal=None):
    """Loop-entry double-float state, KKT blocks and original-units
    residual for the dense refinement loop."""
    alpha = options.validated().alpha
    z0, l0, v0 = df(x.z), df(x.l), df(x.v)
    y0 = _dense_margin(data, z0)
    blocks0 = _dense_kkt_residual_df(data, z0, l0, v0, y0, alpha)
    res0 = _dense_norms(alpha, scal, z0, l0, v0, y0, *blocks0[:2])
    return (z0, l0, v0, y0), blocks0, res0


def _refine_dense_step(data: DenseQPData, carry, opts: Options, scal):
    """One dense refinement iteration on every lane of `carry`."""
    cur, bst, rhs_c, rhs_b, res_best, live, t, sig, since = carry
    z, l, v, y = cur
    B = z[0].shape[0]
    rz, rl, rv = rhs_c
    dz, dl, dv, ok = _dense_correction(
        data, df_to(z), df_to(l), df_to(v), df_to(y), rz, rl, rv, sig,
        opts.alpha)
    tm = (t * (live & ok).to(z[0].dtype))[:, None]
    z_p = df_add(z, df(tm * dz))
    l_p = df_add(l, df(tm * dl))
    v_p = df_max0(df_add(v, df(tm * dv)))
    y_p = _dense_margin(data, z_p)
    blocks_p = _dense_kkt_residual_df(data, z_p, l_p, v_p, y_p, opts.alpha)
    res_p = _dense_norms(opts.alpha, scal, z_p, l_p, v_p, y_p,
                         *blocks_p[:2])
    rhs_p = tuple(df_to(b) for b in blocks_p)
    return _walk_update(B, live, ok, res_p, res_best, since, t, sig,
                        (z_p, l_p, v_p, y_p), cur, bst, rhs_p, rhs_c, rhs_b)


def _refine_dense_loop(data: DenseQPData, state0, rhs0, res0,
                       options: Options, good, scal=None,
                       chunk: int | None = None):
    """The dense refinement loop (_refine_loop). Returns (VariableDF in
    loop coordinates, res, per-lane steps)."""
    (z, l, v, y), res, steps = _refine_loop(
        _refine_dense_step, data, state0, rhs0, res0, options, good, scal,
        chunk)
    return VariableDF(z=z, l=l, v=v, y=y), res, steps


def _pnr_df_at_dense(data: DenseQPData, sol, alpha):
    """Double-float penalized natural residual at a point in original
    coordinates (VariableDF pairs or a plain Variable)."""
    as_pair = lambda a: a if isinstance(a, tuple) else df(a)
    z = as_pair(sol.z)
    y = _dense_margin(data, z)
    return _dense_pnr_norm_df(data, z, as_pair(sol.l), as_pair(sol.v), y,
                              alpha)


def refine_solution_dense(data: DenseQPData, x: Variable, core,
                          options: Options, scal=None):
    """Dense analog of refine_solution_mpc (per-chunk exit over chunks of
    REFINE_CHUNK_LARGE lanes)."""
    opts = options.validated()
    good = core.eflag == int(ExitFlag.SUCCESS)
    B = x.z.shape[0]
    if opts.equilibrate:
        from fbstab_tpu_torch.models.scaling import (
            apply_dense_scaling, ruiz_dense_scaling, scale_dense_variable,
            unscale_dense_variable_df)
        if scal is None:
            scal = ruiz_dense_scaling(data)
        sdata = apply_dense_scaling(data, scal)
        xs = scale_dense_variable(x, scal)
        state0, blocks0, res0 = _dense_refine_entry(sdata, xs, opts, scal)
        rhs0 = tuple(df_to(b) for b in blocks0)
        refined_s, res, steps = _chunked_refine(
            lambda ck: _refine_dense_loop(sdata, state0, rhs0, res0, opts,
                                          good, scal, ck), B)
        refined = unscale_dense_variable_df(refined_s, scal)
    else:
        state0, blocks0, res0 = _dense_refine_entry(data, x, opts)
        rhs0 = tuple(df_to(b) for b in blocks0)
        refined, res, steps = _chunked_refine(
            lambda ck: _refine_dense_loop(data, state0, rhs0, res0, opts,
                                          good, None, ck), B)
    res = _pnr_df_at_dense(data, refined, opts.alpha)
    return _finish_refine(refined, x, core, good, res0, res, steps)

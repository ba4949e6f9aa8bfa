"""Two-phase (and N-stage) adaptive batch solving (counterpart of
`fbstab_tpu/parallel/adaptive.py`).

A batched solve is lockstep per launch: one call returns when its slowest
lane does, and the Newton-iteration count of a batch has a long tail. The
adaptive wrappers run phase 1 with a small Newton budget, gather the lanes
that did not converge, and re-solve only those, warmstarted from where
they stopped, with a reliable-leaning budget (the reference's warmstart
contract, fbstab_algorithm.h:129-142). Every stage runs through the class
dispatcher (`solve_mpc_qp_batch` / `solve_dense_qp_batch`), so on the card
each stage is one launch of the fused kernel (K2 or K3).

Per-lane semantics, as in the JAX package:
  * the lanes retried are those that exit MAXITERATIONS or
    LINEAR_SOLVER_FAILED; SUCCESS and infeasibility verdicts are final;
  * a stage gathers its lanes in index order (`nonzero`), padded with
    index 0 up to the stage's fixed size; padding is dropped at scatter;
  * iteration counters accumulate across stages, and `initial_residual`
    stays the phase-1 value at the caller's guess;
  * with the fallback on, a full-batch reliable pass runs when the number
    of stragglers entering the LAST stage exceeds its capacity (the JAX
    behaviour, kept as it is; ROADMAP section 3);
  * refinement is deferred to after the merge, and the Ruiz scaling is
    computed once and threaded through every stage.

PyTorch runs eagerly, so the straggler count is read on the host after
each stage: the "device" variants differ from the host variant in their
fixed stage sizes and the fallback, not in avoiding that read.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from fbstab_tpu_torch.core.variable import tree_map
from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import ExitFlag


def reliable_leaning(options: Options) -> Options:
    """Phase-2 profile: the caller's tolerances with the reference's
    Reliable-profile robustness levers (fbstab_algorithm-impl.h:61-74):
    monotone linesearch, slower backtracking, bigger budgets."""
    o = options.validated()
    return dataclasses.replace(
        o,
        sigma0=max(o.sigma0, 1e-4),
        sigma_max=max(o.sigma_max, 1e-2),
        beta=max(o.beta, 0.9),
        max_linesearch_iters=max(o.max_linesearch_iters, 40),
        max_newton_iters=max(o.max_newton_iters, 200),
        nonmonotone_linesearch=False,
    )


def retry_mask(core):
    """The lanes a later stage re-solves: MAXITERATIONS or
    LINEAR_SOLVER_FAILED exits."""
    return ((core.eflag == int(ExitFlag.MAXITERATIONS))
            | (core.eflag == int(ExitFlag.LINEAR_SOLVER_FAILED)))


def _take(tree, idx):
    return tree_map(lambda a: a[idx], tree)


def _is_lane(a) -> bool:
    return isinstance(a, torch.Tensor) and a.ndim > 0


def _scatter(full, part, real, k):
    """full with rows `real` replaced by part[:k]; per-lane leaves only
    (a scalar leaf merges as the max over the two)."""
    def upd(a, b):
        if not _is_lane(a):
            return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
        out = a.clone()
        out[real] = b[:k]
        return out
    return tree_map(upd, full, part)


def _gather_index(mask, size):
    """The first `size` indices where mask is set, in order, padded with
    index 0 (jnp.nonzero(mask, size=size, fill_value=0))."""
    nz = mask.nonzero()[:, 0][:size]
    idx = torch.zeros(size, dtype=torch.long, device=mask.device)
    idx[:nz.shape[0]] = nz
    return idx


def solve_batch_adaptive(solve_batch: Callable, data, z0, l0, v0,
                         options: Options,
                         phase1_newton_iters: int = 16,
                         pad_multiple: int = 128,
                         phase2_options: Optional[Options] = None,
                         refine_fn: Optional[Callable] = None):
    """Two-phase batched solve through a class dispatcher (host variant:
    phase 2 is sized to the straggler count, rounded up to pad_multiple).

    solve_batch: (data, z0, l0, v0, options) -> (Variable, CoreOut), e.g.
    `solve_mpc_qp_batch` or `solve_dense_qp_batch`. Stragglers get
    `phase2_options` (reliable-leaning by default). Refinement
    (options.refine_steps on float32) runs after both phases, through
    `refine_fn`."""
    opts1 = dataclasses.replace(
        options.validated(), max_newton_iters=phase1_newton_iters,
        refine_steps=0)
    opts2 = (phase2_options.validated() if phase2_options is not None
             else reliable_leaning(options))
    opts2 = dataclasses.replace(opts2, refine_steps=0)

    def finish(x, core):
        opts = options.validated()
        from fbstab_tpu_torch.models.refine import refine_engaged
        if refine_fn is not None and refine_engaged(opts, z0.dtype):
            return refine_fn(data, x, core, opts)
        return x, core

    x1, core1 = solve_batch(data, z0, l0, v0, opts1)
    retry = retry_mask(core1)
    k = int(retry.sum())
    if k == 0:
        return finish(x1, core1)
    B = core1.eflag.shape[0]
    kp = min(-(-k // pad_multiple) * pad_multiple, B) if pad_multiple > 1 \
        else k
    idx = _gather_index(retry, kp)
    sub_x = _take(x1, idx)
    x2, core2 = solve_batch(_take(data, idx), sub_x.z, sub_x.l, sub_x.v,
                            opts2)
    real = idx[:k]
    x = _scatter(x1, x2, real, k)
    core = _scatter(core1, core2, real, k)
    newton = core.newton_iters.clone()
    newton[real] += core1.newton_iters[real]
    prox = core.prox_iters.clone()
    prox[real] += core1.prox_iters[real]
    core = core._replace(newton_iters=newton, prox_iters=prox,
                         initial_residual=core1.initial_residual)
    return finish(x, core)


def _stage_options(opts: Options, budget: int | None,
                   profile) -> Options:
    """Options for one schedule stage: 'same' keeps the caller's profile
    (with the stage Newton budget), 'reliable' applies the
    reliable-leaning levers, an Options instance is taken as it is.
    Refinement is always deferred to after the merge."""
    if profile == "reliable":
        o = reliable_leaning(opts)
    elif profile == "same":
        o = opts
    elif isinstance(profile, Options):
        o = profile.validated()
    else:
        raise ValueError(f"stage profile must be 'same', 'reliable' or "
                         f"an Options instance, got {profile!r}")
    if budget is not None:
        o = dataclasses.replace(o, max_newton_iters=budget)
    return dataclasses.replace(o, refine_steps=0)


def solve_batch_adaptive_schedule(solve_batch, refine_fn, data, z0, l0,
                                  v0, options: Options, stages,
                                  make_scaling=None, scaling=None,
                                  fallback: bool = True):
    """N-stage adaptive solve with fixed stage sizes.

    stages: list of (newton_budget, capacity, profile). Stage 0 runs the
    whole batch (capacity ignored); each later stage gathers up to
    `capacity` lanes that exit MAXITERATIONS or LINEAR_SOLVER_FAILED,
    re-solves them warmstarted from their current iterate under the
    stage profile ('same', 'reliable' or an Options), and scatters the
    results back. budget=None keeps the profile's own max_newton_iters.
    With `fallback`, a straggler count entering the last stage above its
    capacity triggers a full-batch reliable pass from the merged iterates
    (converged lanes re-enter at their solution and exit at once).

    make_scaling / scaling: the batched Ruiz constructor
    (ruiz_mpc_scaling / ruiz_dense_scaling) or a precomputed batched
    scaling; it is computed once and threaded through every stage, the
    fallback and the refinement."""
    opts = options.validated()
    from fbstab_tpu_torch.models.scaling import scaling_engaged
    scal = scaling
    if (scal is None and make_scaling is not None
            and scaling_engaged(opts, z0.dtype)):
        scal = make_scaling(data)
    skw = {} if scal is None else {"scaling": scal}

    b0, _, prof0 = stages[0]
    x, core = solve_batch(data, z0, l0, v0,
                          _stage_options(opts, b0, prof0), **skw)
    B = core.eflag.shape[0]
    initial_residual = core.initial_residual

    count, cap_last = None, None
    for budget, cap, prof in stages[1:]:
        o = _stage_options(opts, budget, prof)
        retry = retry_mask(core)
        count = int(retry.sum())
        P = min(cap, B)
        cap_last = P
        if count == 0:
            continue     # nothing to scatter: the stage would change nothing
        idx = _gather_index(retry, P)
        sx = _take(x, idx)
        skw_s = {} if scal is None else {"scaling": _take(scal, idx)}
        xs, cs = solve_batch(_take(data, idx), sx.z, sx.l, sx.v, o, **skw_s)
        k = min(count, P)
        real = idx[:k]
        prev_n = core.newton_iters
        prev_p = core.prox_iters
        x = _scatter(x, xs, real, k)
        core = _scatter(core, cs, real, k)
        newton = core.newton_iters.clone()
        newton[real] += prev_n[real]
        prox = core.prox_iters.clone()
        prox[real] += prev_p[real]
        core = core._replace(newton_iters=newton, prox_iters=prox,
                             initial_residual=initial_residual)

    if fallback and count is not None and count > cap_last:
        xf, coref = solve_batch(data, x.z, x.l, x.v,
                                _stage_options(opts, None, "reliable"),
                                **skw)
        still = retry_mask(core)

        def pick(a, b):
            if not _is_lane(a):
                return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
            m = still.reshape((B,) + (1,) * (a.ndim - 1))
            return torch.where(m, a, b)
        xm = tree_map(pick, xf, x)
        cm = tree_map(pick, coref, core)
        x, core = xm, cm._replace(
            newton_iters=torch.where(
                still, core.newton_iters + coref.newton_iters,
                cm.newton_iters),
            prox_iters=torch.where(
                still, core.prox_iters + coref.prox_iters, cm.prox_iters),
            initial_residual=initial_residual)

    from fbstab_tpu_torch.models.refine import refine_engaged
    if refine_fn is not None and refine_engaged(opts, z0.dtype):
        return refine_fn(data, x, core, opts, scal=scal)
    return x, core


def solve_batch_adaptive_device(solve_batch, refine_fn, data, z0, l0, v0,
                                options: Options,
                                phase1_newton_iters: int = 16,
                                phase2_size: int | None = None,
                                phase2_options: Optional[Options] = None,
                                make_scaling=None,
                                phase2_fallback: bool = True,
                                scaling=None):
    """Two-phase adaptive solve with a fixed phase-2 size: phase 1 with a
    Newton budget of `phase1_newton_iters`, then up to `phase2_size`
    stragglers (default B // 8) re-solved with a reliable-leaning profile
    (or `phase2_options`), and the capacity-overflow fallback unless
    `phase2_fallback` is off (then overflow lanes keep their phase-1
    MAXITERATIONS exit). See solve_batch_adaptive_schedule."""
    B = z0.shape[0]
    P = phase2_size if phase2_size is not None else max(B // 8, 1)
    prof2 = phase2_options if phase2_options is not None else "reliable"
    return solve_batch_adaptive_schedule(
        solve_batch, refine_fn, data, z0, l0, v0, options,
        stages=[(phase1_newton_iters, None, "same"), (None, P, prof2)],
        make_scaling=make_scaling, scaling=scaling,
        fallback=phase2_fallback)


def _mpc_parts(data, z0, options, kwargs, riccati):
    from fbstab_tpu_torch.models.mpc_qp import (
        gate_mpc_options, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.refine import refine_solution_mpc
    from fbstab_tpu_torch.models.scaling import ruiz_mpc_scaling
    kwargs.setdefault("make_scaling", ruiz_mpc_scaling)
    # An explicit scaling= bypasses the gate, as in solve_mpc_qp_batch.
    o = (options.validated() if kwargs.get("scaling") is not None
         else gate_mpc_options(data, z0.dtype, options))
    return (functools.partial(solve_mpc_qp_batch, riccati=riccati),
            refine_solution_mpc, o)


def _dense_parts(kwargs):
    from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch
    from fbstab_tpu_torch.models.refine import refine_solution_dense
    from fbstab_tpu_torch.models.scaling import ruiz_dense_scaling
    kwargs.setdefault("make_scaling", ruiz_dense_scaling)
    return solve_dense_qp_batch, refine_solution_dense


def solve_mpc_qp_batch_adaptive_device(data, z0, l0, v0, options: Options,
                                       riccati: str = "auto", **kwargs):
    """Two-phase adaptive MPC batch solve with a fixed phase-2 size;
    `riccati` threads through to solve_mpc_qp_batch for every stage."""
    solve, refine, o = _mpc_parts(data, z0, options, kwargs, riccati)
    return solve_batch_adaptive_device(solve, refine, data, z0, l0, v0, o,
                                       **kwargs)


def solve_mpc_qp_batch_adaptive_schedule(data, z0, l0, v0,
                                         options: Options, stages,
                                         riccati: str = "auto", **kwargs):
    """N-stage adaptive MPC batch solve (see
    solve_batch_adaptive_schedule for the stage tuples)."""
    solve, refine, o = _mpc_parts(data, z0, options, kwargs, riccati)
    return solve_batch_adaptive_schedule(solve, refine, data, z0, l0, v0,
                                         o, stages, **kwargs)


def solve_mpc_qp_batch_adaptive(data, z0, l0, v0, options: Options,
                                **kwargs):
    """Two-phase adaptive MPC batch solve, host variant, gated like the
    fixed-size wrappers."""
    from fbstab_tpu_torch.models.mpc_qp import (
        gate_mpc_options, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.refine import refine_solution_mpc
    return solve_batch_adaptive(
        solve_mpc_qp_batch, data, z0, l0, v0,
        gate_mpc_options(data, z0.dtype, options),
        refine_fn=refine_solution_mpc, **kwargs)


def solve_dense_qp_batch_adaptive_device(data, z0, l0, v0,
                                         options: Options, **kwargs):
    """Two-phase adaptive dense batch solve with a fixed phase-2 size."""
    solve, refine = _dense_parts(kwargs)
    return solve_batch_adaptive_device(solve, refine, data, z0, l0, v0,
                                       options, **kwargs)


def solve_dense_qp_batch_adaptive_schedule(data, z0, l0, v0,
                                           options: Options, stages,
                                           **kwargs):
    """N-stage adaptive dense batch solve."""
    solve, refine = _dense_parts(kwargs)
    return solve_batch_adaptive_schedule(solve, refine, data, z0, l0, v0,
                                         options, stages, **kwargs)


def solve_dense_qp_batch_adaptive(data, z0, l0, v0, options: Options,
                                  **kwargs):
    """Two-phase adaptive dense batch solve, host variant."""
    from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch
    from fbstab_tpu_torch.models.refine import refine_solution_dense
    return solve_batch_adaptive(solve_dense_qp_batch, data, z0, l0, v0,
                                options, refine_fn=refine_solution_dense,
                                **kwargs)

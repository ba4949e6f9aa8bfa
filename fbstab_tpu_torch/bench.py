"""The port's bench: the counterpart of the JAX package's `bench.py`.

    python -m fbstab_tpu_torch.bench [mode] [arg]

Modes and default sizes on the card, as in bench.py (`arg` overrides the
batch size B, for `longhorizon` the horizon N, for `mxu` the number of
applications T; `adaptive mixed [B]` is the mixed-difficulty variant):

  (none)       the headline: the adaptive two-phase MPC solve at B = 8192
               (phase1 = 16, P2 = B // 8), its float64 contract check, the
               performance model, the segments and the plant audit
  refine       the raw float32 solve against the refined one, B = 8192
  adaptive     the adaptive against the one-shot solve, B = 8192
  adaptive mixed  the same on a mixed-difficulty batch (5% hard lanes),
               raw float32 tier
  dense        batched dense QPs, B = 4096, n = 32, q = 64
  copoly       the copolymerization reactor (N = 80) at B = 2048, tier 2
  longhorizon  single-instance scan against assoc, double integrator,
               N = 480
  plants       the four reference plants' contract audit, B = 128
  warmstart    the receding-horizon sweep, B = 8192 for 8 steps
  million      B = 8192 scenarios for 128 steps (1,048,576 warmstarted QPs)
  mxu          the stage-matvec probe (P1), T = 200
  diff         the differentiable MPC layer: the gradient of 0.5 |z|^2
               with respect to every data field through
               solve_mpc_qp_batch_diff (forward K2 and the refinement,
               backward one K1 launch), B = 1024 (64 on the CPU, in
               float64 there, as bench.py)
  sparse       batched sparse QPs (nz = 400, nl = 40, nv = 200, banded H)
               through solve_sparse_qp_batch in float64, B = 32: CSR
               products on the device, each Newton step's KKT systems
               factored on the host (native LDL'), against the dense
               single-instance solve_dense_qp looped over the B lanes
  sharded      the headline batch (B = 8192; 256 on the CPU) through
               solve_mpc_qp_batch and through sharded_mpc_solver_fused
               on a mesh of one rank (NCCL on the card, gloo on the CPU):
               the sharding layer's per-device efficiency

Each mode prints exactly one JSON line on stdout with bench.py's metric
name and the keys metric, value, unit and vs_baseline, and a diagnostic
line on stderr. `vs_baseline` is null: bench.py divides by a per-chip
target set for a TPU, and the card's own baseline is not set yet; `diff`,
`sparse` and `sharded` report bench.py's own ratios there (the gradient's
time over the forward solve's; the dense loop's time over the sparse
batch's; the efficiency over 0.85). Times are host clocks around
synchronized calls after a warm call. An unknown mode exits 2.

Every function runs on the card unless given device="cpu" (the tests'
tiny sizes), and raises without a CUDA device. Nothing here imports JAX
or the JAX package's bench.py.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from fbstab_tpu_torch.device import resolve_device
from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import ExitFlag
from fbstab_tpu_torch.workloads import (
    HEADLINE, build_batch, build_copoly, build_dense, dense_zeros,
    mpc_f64_residual, timed, zeros_guess)

CONTRACT = 1e-6


def _clock(fn):
    """(fn(), seconds) on the host clock around synchronized work."""
    out, ms = timed(fn)
    return out, ms / 1e3


def _best(fn, reps=3):
    """One warm call, then `reps` timed calls fn(i), i = 1 .. reps.
    Returns (min seconds, last result, all times)."""
    out = fn(0)
    times = []
    for i in range(1, reps + 1):
        out, t = _clock(lambda: fn(i))
        times.append(t)
    return min(times), out, times


def _where(dev):
    return (f"cuda ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else dev.type)


def _record(metric, value, unit, **extra):
    return dict(metric=metric, value=value, unit=unit, vs_baseline=None,
                **extra)


def _success(core):
    return float((core.eflag == int(ExitFlag.SUCCESS)).float().mean())


def _headline(B, dev):
    data = build_batch(B, **HEADLINE, device=dev)
    return data, zeros_guess(data)


def _fresh_x0(data, i):
    return data._replace(x0=data.x0 * (1.0 + 1e-6 * i))


# ------------------------------------------------------------------
# The plant audit.
# ------------------------------------------------------------------

def plant_contract_ok(nominal_success: bool, nominal_res64: float,
                      perturbed_frac_le_1e6: float, any_good: bool) -> bool:
    """bench.py's per-plant gate: the nominal lane (the reference's own
    test instance) solves to <= 1e-6 and every perturbed SUCCESS lane
    meets 1e-6 too."""
    return (bool(nominal_success) and float(nominal_res64) <= CONTRACT
            and bool(any_good) and float(perturbed_frac_le_1e6) >= 1.0)


PLANTS = (("double_integrator", 20, 0.05), ("servo_motor", 25, 0.05),
          ("spacecraft_relative_motion", 40, 0.001),
          ("copolymerization_reactor", 80, 0.05))


def plants_contract_check(B=None, device=None, verbose=True):
    """The reference's four plants through the float32 product path, each
    at B lanes with x0 perturbed around the nominal (lane 0), checked in
    float64 on the host against the 1e-6 contract (bench.py's
    plants_contract_check)."""
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.workloads import build_plant

    dev = resolve_device(device)
    if B is None:
        B = 8 if dev.type == "cpu" else 128
    opts = Options.single_precision()
    worst, per_plant, all_ok = 0.0, {}, True
    for name, N, pert in PLANTS:
        # Lane 0 is the reference's own instance.
        data = build_plant(name, N, B, pert, dev)
        x, core = solve_mpc_qp_batch(data, *zeros_guess(data), opts)
        good = (core.eflag == int(ExitFlag.SUCCESS)).cpu().numpy()
        res64 = mpc_f64_residual(data, x, opts.alpha)
        mx = float(res64[good].max()) if good.any() else float("nan")
        frac_good = (float(np.mean(res64[good] <= CONTRACT)) if good.any()
                     else 0.0)
        ok = plant_contract_ok(bool(good[0]), float(res64[0]), frac_good,
                               bool(good.any()))
        worst = max(worst, float(res64[0]))
        all_ok = all_ok and ok
        raw = core.raw_residual.cpu().numpy()
        per_plant[name] = {
            "nominal_res64": float(res64[0]),
            "success_frac": round(float(good.mean()), 4),
            "perturbed_res64_max": mx,
            "perturbed_frac_le_1e6": round(frac_good, 4),
            "contract_ok": ok,
            "raw_med": (float(np.median(raw[good])) if good.any()
                        else float("nan")),
        }
        if verbose:
            print(f"bench[plants]: {name} nominal res64={res64[0]:.2e} "
                  f"success={good.mean():.3f} perturbed max={mx:.2e} "
                  f"raw med={per_plant[name]['raw_med']:.2e}",
                  file=sys.stderr)
    return {"res64_max": worst, "contract_met": all_ok,
            "per_plant": per_plant}


# ------------------------------------------------------------------
# The headline's segments.
# ------------------------------------------------------------------

def measure_segments(data, z0, l0, v0, opts, phase1, P2, t_full, reps=3):
    """bench.py's per-segment budget of the two-phase headline, read from
    the wrapper's own run: solve_batch_adaptive_device is called with
    clocked copies of its scaling, solve and refine callables, so the
    segments time the stages the headline runs and the wrapper stays the
    one place that knows the phase logic. After a warm call each segment
    is the best of `reps` runs, less the null dispatch (a synchronized
    no-op): the Ruiz scaling, phase 1 (the whole batch under the phase-1
    budget), the phase-2 gather and re-solve of up to P2 stragglers (from
    the end of phase 1 to the end of phase 2; 0 when phase 1 leaves
    none), and the refinement. explained_pct is the share of the
    headline's time `t_full` (s) the segments account for; the rest is
    the merge and the fallback check. retry_count: the stragglers phase 1
    leaves."""
    import time

    from fbstab_tpu_torch.models.mpc_qp import (
        gate_mpc_options, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.refine import refine_solution_mpc
    from fbstab_tpu_torch.models.scaling import ruiz_mpc_scaling
    from fbstab_tpu_torch.parallel.adaptive import (
        retry_mask, solve_batch_adaptive_device)

    o = gate_mpc_options(data, z0.dtype, opts)

    def one_run():
        seg, ends, cores = {}, [], []

        def clocked(key, fn):
            def call(*a, **k):
                out, seg[key] = _clock(lambda: fn(*a, **k))
                return out
            return call

        def solve(*a, **k):
            out, t = _clock(lambda: solve_mpc_qp_batch(*a, **k))
            ends.append(time.perf_counter())
            cores.append(out[1])
            seg.setdefault("phase1", t)
            return out

        solve_batch_adaptive_device(
            solve, clocked("refine", refine_solution_mpc), data, z0, l0, v0,
            o, phase1_newton_iters=phase1, phase2_size=P2,
            make_scaling=clocked("ruiz", ruiz_mpc_scaling))
        seg["phase2"] = ends[1] - ends[0] if len(ends) > 1 else None
        return seg, int(retry_mask(cores[0]).sum())

    t_null, _, _ = _best(lambda i: data.x0 * 1.0, reps)
    runs = [one_run() for _ in range(reps + 1)][1:]
    # A stage that did not run (no stragglers, refinement or scaling not
    # engaged) counts 0.
    net = {k: min((r[0][k] - t_null for r in runs
                   if r[0].get(k) is not None), default=0.0)
           for k in ("ruiz", "phase1", "phase2", "refine")}
    seg = {"null_dispatch_ms": round(t_null * 1e3, 3),
           "ruiz_ms": round(net["ruiz"] * 1e3, 1),
           "phase1_ms": round(net["phase1"] * 1e3, 1),
           "phase2_gather_ms": round(net["phase2"] * 1e3, 1),
           "refine_ms": round(net["refine"] * 1e3, 1)}
    explained = t_null + sum(net.values())
    seg["explained_pct"] = round(100.0 * explained / max(t_full, 1e-9), 1)
    seg["retry_count"] = runs[-1][1]
    return seg


# ------------------------------------------------------------------
# The modes.
# ------------------------------------------------------------------

def run_main(B=None, device=None):
    """The headline (bench.py main): the device-side two-phase adaptive
    solve on the scenario-MPC batch, float64 contract check, performance
    model, segments and plant audit."""
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)
    from fbstab_tpu_torch.perf_model import (
        WARP, executed_refine_steps, mean_refine_steps, mpc_perf_model)

    dev = resolve_device(device)
    if B is None:
        B = 256 if dev.type == "cpu" else 8192
    opts = Options.single_precision()
    data, (z0, l0, v0) = _headline(B, dev)
    phase1, P2 = 16, max(B // 8, 128)

    def solve(i):
        return solve_mpc_qp_batch_adaptive_device(
            _fresh_x0(data, i), z0, l0, v0, opts,
            phase1_newton_iters=phase1, phase2_size=P2)

    t, (x, core), times = _best(solve, reps=3)
    # Instances that run in lockstep: a warp of K2's teams on the card.
    width = WARP
    if dev.type == "cuda":
        from fbstab_tpu_torch.ops._build import kernel_info, load_library
        width = kernel_info(load_library().fb_mpc_solve_info,
                            *HEADLINE.values(), 0)["teams_per_block"]
    success = _success(core)
    # x solves the last timed call's problem, x0 scaled by 1 + 3e-6.
    res64 = mpc_f64_residual(_fresh_x0(data, 3), x, opts.alpha)
    frac = float(np.mean(res64 <= CONTRACT))
    pm = mpc_perf_model(B, *HEADLINE.values(),
                        core.newton_iters.cpu().numpy(), t,
                        mean_refine_steps(core), two_phase=(phase1, P2),
                        width=width)
    pm["max_refine_steps"] = executed_refine_steps(core)
    pm["two_phase"] = {"phase1_newton_iters": phase1, "phase2_size": P2}
    pm["segments"] = measure_segments(data, z0, l0, v0, opts, phase1, P2,
                                      t)
    plants = plants_contract_check(device=dev)
    diag = (f"bench: device={_where(dev)} B={B} success={success:.3f} "
            f"times={['%.3f' % s for s in times]} res64 "
            f"med={np.median(res64):.2e} max={res64.max():.2e} "
            f"frac<=1e-6={frac:.4f}")
    return _record("mpc_qps_per_chip", round(B / t, 1), "QPs/s",
                   success_frac=round(success, 4),
                   residual_f64_max=float(res64.max()),
                   residual_f64_frac_le_1e6=frac, perf_model=pm,
                   plants=plants), diag


def run_refine(B=None, steps=None, device=None):
    """The refinement increment: the raw float32 solve (refine_steps=0)
    against the contract-grade default, both checked in float64."""
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.perf_model import executed_refine_steps

    dev = resolve_device(device)
    if B is None:
        B = 128 if dev.type == "cpu" else 8192
    opts = Options.single_precision()
    if steps is not None:
        opts = dataclasses.replace(opts, refine_steps=steps)
    opts_raw = dataclasses.replace(opts, refine_steps=0)
    data, guess = _headline(B, dev)
    t_raw, (x, _), _ = _best(
        lambda i: solve_mpc_qp_batch(data, *guess, opts_raw))
    t_ref, (xr, corer), _ = _best(
        lambda i: solve_mpc_qp_batch(data, *guess, opts))
    res64 = mpc_f64_residual(data, xr, opts.alpha)
    raw64 = mpc_f64_residual(data, x, opts.alpha)
    frac = float(np.mean(res64 <= CONTRACT))
    diag = (f"bench[refine]: device={_where(dev)} B={B} "
            f"steps_executed={executed_refine_steps(corer)} "
            f"t_raw={t_raw:.3f}s t_refined={t_ref:.3f}s "
            f"raw med_res={np.median(raw64):.2e} frac<=1e-6={frac:.3f} "
            f"med_res={np.median(res64):.2e} max_res={res64.max():.2e}")
    return _record(
        "mpc_refined_1e6_qps_per_chip", round(B / t_ref, 1), "QPs/s",
        residual_f64_max=float(res64.max()), residual_f64_frac_le_1e6=frac,
        refine_overhead_pct=round(100.0 * (t_ref - t_raw) / max(t_raw, 1e-9),
                                  1)), diag


def run_adaptive(B=None, phase1=16, device=None):
    """The device-side two-phase adaptive solve against the one-shot solve
    on the headline batch, contract defaults."""
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)

    dev = resolve_device(device)
    if B is None:
        B = 256 if dev.type == "cpu" else 8192
    opts = Options.single_precision()
    data, guess = _headline(B, dev)
    t_one, _, _ = _best(lambda i: solve_mpc_qp_batch(
        _fresh_x0(data, i), *guess, opts))
    t_ada, (_, ca), _ = _best(lambda i: solve_mpc_qp_batch_adaptive_device(
        _fresh_x0(data, i), *guess, opts, phase1_newton_iters=phase1,
        phase2_size=max(B // 8, 128)))
    diag = (f"bench[adaptive]: device={_where(dev)} B={B} one-shot "
            f"{B / t_one:.0f} QPs/s vs adaptive(phase1={phase1}) "
            f"{B / t_ada:.0f} QPs/s (x{t_one / t_ada:.2f}); adaptive "
            f"success={_success(ca):.3f}")
    return _record("mpc_adaptive_qps_per_chip", round(B / t_ada, 1), "QPs/s",
                   speedup_vs_one_shot=round(t_one / t_ada, 3)), diag


def run_adaptive_mixed(B=None, device=None):
    """The two-phase adaptive solve on a mixed-difficulty batch (5% of
    lanes with a 6x initial state and a tighter input box) against the
    one-shot solve, on the raw float32 tier (no refinement, equilibration
    or retry)."""
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)

    dev = resolve_device(device)
    if B is None:
        B = 256 if dev.type == "cpu" else 8192
    data, guess = _headline(B, dev)
    hard = torch.tensor(np.random.default_rng(5).random(B) < 0.05,
                        device=dev)
    x0, d = data.x0.clone(), data.d.clone()
    x0[hard] *= 6.0
    d[hard] = -0.35
    data = data._replace(x0=x0, d=d)
    opts = dataclasses.replace(Options.single_precision(), refine_steps=0,
                               equilibrate=False, retry_failed=False)
    p2 = dataclasses.replace(opts, max_newton_iters=400, max_prox_iters=60)
    fns = {
        "one_shot": lambda dd: solve_mpc_qp_batch(dd, *guess, opts),
        "adaptive": lambda dd: solve_mpc_qp_batch_adaptive_device(
            dd, *guess, opts, phase1_newton_iters=25,
            phase2_size=max(B // 8, 128), phase2_options=p2),
    }
    stats, lines = {}, []
    for name, fn in fns.items():
        t, (_, core), _ = _best(lambda i: fn(_fresh_x0(data, i)))
        ni = core.newton_iters.cpu().numpy()
        stats[name] = dict(
            qps=B / t, success=_success(core),
            ni_p50=float(np.percentile(ni, 50)),
            ni_p99=float(np.percentile(ni, 99)), ni_max=int(ni.max()))
        lines.append(f"bench[adaptive mixed]: {name} qps={B / t:.0f} "
                     f"success={stats[name]['success']:.4f} ni "
                     f"p50={stats[name]['ni_p50']:.0f} "
                     f"p99={stats[name]['ni_p99']:.0f} max={ni.max()}")
    qps = stats["adaptive"]["qps"]
    return _record("mpc_adaptive_mixed_qps_per_chip", round(qps, 1),
                   "QPs/s (mixed-difficulty batch)",
                   speedup_vs_one_shot=round(qps / stats["one_shot"]["qps"],
                                             3),
                   one_shot=stats["one_shot"],
                   adaptive=stats["adaptive"]), "\n".join(lines)


def run_dense(B=None, device=None):
    """Batched dense QPs (BASELINE config 3: n = 32, q = 64)."""
    from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch

    dev = resolve_device(device)
    if B is None:
        B = 256 if dev.type == "cpu" else 4096
    opts = Options.single_precision()
    data = build_dense(B, 32, 64, 0, dev)
    guess = dense_zeros(data)
    t, (_, core), times = _best(lambda i: solve_dense_qp_batch(
        data._replace(f=data.f * (1.0 + 1e-6 * i)), *guess, opts))
    diag = (f"bench[dense]: device={_where(dev)} B={B} "
            f"success={_success(core):.3f} "
            f"times={['%.3f' % s for s in times]}")
    return _record("dense_qps_per_chip", round(B / t, 1), "QPs/s"), diag


def run_copoly(B=None, device=None):
    """The copolymerization reactor (nx = 18, nu = 5, nc = 10, N = 80), the
    reference's largest OCP, through tier 2 (K4) on the card."""
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch

    dev = resolve_device(device)
    if B is None:
        B = 16 if dev.type == "cpu" else 2048
    opts = Options.single_precision()
    data = build_copoly(B, dev)
    guess = zeros_guess(data)
    t, (_, core), times = _best(lambda i: solve_mpc_qp_batch(
        _fresh_x0(data, i), *guess, opts))
    diag = (f"bench[copoly]: device={_where(dev)} B={B} "
            f"success={_success(core):.3f} "
            f"times={['%.3f' % s for s in times]}")
    return _record("copoly_qps_per_chip", round(B / t, 1), "QPs/s"), diag


def run_longhorizon(N=None, device=None):
    """Single-instance latency at a long horizon: the associative Riccati
    against the sequential scan (best of five after a warm call)."""
    from fbstab_tpu_torch.models.mpc_qp import mpc_dims, solve_mpc_qp
    from fbstab_tpu_torch.models.ocp_fixtures import double_integrator

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if N is None:
        N = 120 if on_cpu else 480
    dtype = torch.float64 if on_cpu else torch.float32
    opts = Options(abs_tol=1e-8) if on_cpu else Options.single_precision()
    data, _ = double_integrator(N, dtype=dtype, device=dev)
    _, nx, nu, nc = mpc_dims(data)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    guess = (zeros((N + 1) * (nx + nu)), zeros((N + 1) * nx),
             zeros((N + 1) * nc))
    lat = {}
    for mode in ("scan", "assoc"):
        t, (_, core), _ = _best(lambda i: solve_mpc_qp(
            data._replace(x0=data.x0 + 1e-6 * i), *guess, opts,
            riccati=mode), reps=5)
        if int(core.eflag) != int(ExitFlag.SUCCESS):
            raise RuntimeError(f"longhorizon {mode}: eflag "
                               f"{int(core.eflag)}")
        lat[mode] = t
    speedup = lat["scan"] / lat["assoc"]
    diag = (f"bench[longhorizon]: device={_where(dev)} N={N} "
            f"scan={lat['scan'] * 1e3:.1f}ms "
            f"assoc={lat['assoc'] * 1e3:.1f}ms")
    return _record("longhorizon_assoc_speedup", round(speedup, 2),
                   f"x vs sequential scan (N={N})"), diag


def run_plants(B=None, device=None):
    """The standalone per-plant contract audit."""
    dev = resolve_device(device)
    summary = plants_contract_check(B, dev)
    return _record(
        "plants_contract_res64_max", summary["res64_max"],
        "f64-verified residual on the reference's own test instances "
        "(target <= 1e-6)", contract_met=summary["contract_met"],
        per_plant=summary["per_plant"]), (
        f"bench[plants]: device={_where(dev)} "
        f"contract_met={summary['contract_met']}")


def _sweep(B, steps, warm_steps, dev):
    """The receding-horizon sweep of bench.py warmstart / million: B
    scenarios of the headline batch over its shared plant (lane 0), `steps`
    control steps with shifted warmstarts, timed after a warm sweep of
    `warm_steps`. Returns (seconds, ClosedLoopResult)."""
    from fbstab_tpu_torch.models.mpc_qp import MpcQPData
    from fbstab_tpu_torch.models.receding_horizon import simulate_batch

    opts = Options.single_precision()
    dataB, _ = _headline(B, dev)
    shared = MpcQPData(*(a[:1] for a in dataB))
    simulate_batch(shared, warm_steps, dataB.x0, opts)
    x0p = dataB.x0 * 1.0001
    res, t = _clock(lambda: simulate_batch(shared, steps, x0p, opts))
    return t, res


def run_warmstart(B=None, steps=8, device=None):
    """The receding-horizon sweep (BASELINE config 2): B scenarios for
    `steps` control steps with shifted warmstarts."""
    dev = resolve_device(device)
    if B is None:
        B = 256 if dev.type == "cpu" else 8192
    t, res = _sweep(B, steps, steps, dev)
    success = _success(res)
    diag = (f"bench[warmstart]: device={_where(dev)} B={B} steps={steps} "
            f"success={success:.3f} t={t:.2f}s")
    return _record("mpc_warmstart_qps_per_chip", round(B * steps / t, 1),
                   "QPs/s"), diag


def run_million(B=None, steps=None, device=None):
    """BASELINE config 5's volume on one card: B = 8192 scenarios for 128
    steps, 1,048,576 warmstarted QPs through the receding-horizon loop.
    The port compiles nothing per sweep length, so the warm sweep is two
    steps (the kernels are built and loaded by then)."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if B is None:
        B = 64 if on_cpu else 8192
    if steps is None:
        steps = 4 if on_cpu else 128
    t, res = _sweep(B, steps, 2, dev)
    ni = res.newton_iters.cpu().numpy()
    diag = (f"bench[million]: device={_where(dev)} B={B} steps={steps} "
            f"total={B * steps} success={_success(res):.3f} t={t:.2f}s "
            f"newton_iters mean={ni.mean():.2f} step0={ni[:, 0].mean():.1f} "
            f"max={ni.max()}")
    return _record("mpc_million_qps_per_chip", round(B * steps / t, 1),
                   "QPs/s"), diag


def mxu_forms():
    """The probe's three kernels under bench.py's names, with the matrix
    each takes: (name, kernel, "perlane" | "shared")."""
    from fbstab_tpu_torch.ops import mxu_probe_cuda as P
    return (("vpu_perlane", P.cuda_perlane, "perlane"),
            ("vpu_shared", P.cuda_shared, "shared"),
            ("mxu_shared", P.tc_shared, "shared"))


def run_mxu(T=None, device=None):
    """The stage-matvec probe (P1): T applications of w_s <- M_s w_s / (n /
    0.9) in three forms on the card's three kernels, each timed as the
    best of five host-clocked calls after a warm one, over T N1, in ns per
    stage-matvec. The shared forms' outputs are compared as bench.py does
    (at T = 200 both are zero: the iterate underflows; chip_smoke.py holds
    each form against its plain version at T = 1 and 8)."""
    from fbstab_tpu_torch.ops import mxu_probe_cuda as P

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    N1 = 9 if on_cpu else P.N1
    if T is None:
        T = 2 if on_cpu else P.T_DEFAULT
    n = P.N_STAGE
    scale = P.scale_of(n)
    Mp, Ms, w0 = P.probe_inputs(N1, n, P.LANES, dev)
    ns, outs = {}, {}
    for name, kernel, kind in mxu_forms():
        M = Mp if kind == "perlane" else Ms
        t, outs[name], _ = _best(lambda i: kernel(M, w0, T, scale),
                                 reps=5)
        ns[name] = t / (T * N1) * 1e9
    o_v, o_m = outs["vpu_shared"], outs["mxu_shared"]
    err = float((o_v - o_m).abs().max() / (o_v.abs().max() + 1e-30))
    where = ("the card's kernels: vpu_perlane_ns = cuda_perlane, "
             "vpu_shared_ns = cuda_shared (CUDA cores), mxu_shared_ns = "
             "tc_shared (TF32 mma.sync)" if not on_cpu
             else "the plain PyTorch versions on the CPU")
    diag = (f"bench[mxu]: device={_where(dev)} per stage-matvec "
            f"vpu_perlane={ns['vpu_perlane']:.1f}ns "
            f"vpu_shared={ns['vpu_shared']:.1f}ns "
            f"mxu_shared={ns['mxu_shared']:.1f}ns (T={T}, N1={N1}, n={n}) "
            f"parity rel err={err:.2e}")
    speed = ns["vpu_shared"] / ns["mxu_shared"]
    return _record(
        "mxu_vs_vpu_shared_stage_matvec", round(speed, 4),
        f"x matrix-unit speedup over the shared vector form, on {where}",
        vpu_perlane_ns=round(ns["vpu_perlane"], 1),
        vpu_shared_ns=round(ns["vpu_shared"], 1),
        mxu_shared_ns=round(ns["mxu_shared"], 1)), diag


def run_diff(B=None, device=None):
    """bench.py diff: the differentiable MPC layer's gradient (solve and
    backward) of a scalar loss of the batched solution with respect to
    every data field, against the forward batched solve alone. On the
    card float32 under Options.single_precision() with sigma_vjp = 1e-5;
    on the CPU float64 under Options() with 1e-9, as bench.py."""
    from fbstab_tpu_torch.diff import solve_mpc_qp_batch_diff
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if B is None:
        B = 64 if on_cpu else 1024
    dtype = torch.float64 if on_cpu else torch.float32
    opts = Options() if on_cpu else Options.single_precision()
    sig = 1e-9 if on_cpu else 1e-5
    base = build_batch(B, **HEADLINE, device=dev, dtype=dtype)
    guess = zeros_guess(base)

    def grad(i):
        data = _fresh_x0(base, i)
        data = type(data)(*(a.clone().requires_grad_() for a in data))
        z, _, _ = solve_mpc_qp_batch_diff(data, *guess, opts, sig)
        (0.5 * (z * z).sum()).backward()
        return data.x0.grad

    t_fwd, _, _ = _best(lambda i: solve_mpc_qp_batch(
        _fresh_x0(base, i), *guess, opts))
    t_grad, g, _ = _best(grad)
    finite = bool(torch.isfinite(g).all())
    diag = (f"bench[diff]: device={_where(dev)} B={B} {dtype} "
            f"fwd={t_fwd:.3f}s grad={t_grad:.3f}s (solve+backward) "
            f"x0 gradient finite={finite}")
    rec = _record("mpc_grads_per_chip", round(B / t_grad, 1), "grads/s",
                  fwd_s=t_fwd, grad_s=t_grad)
    rec["vs_baseline"] = round(t_grad / max(t_fwd, 1e-9), 3)
    return rec, diag


def run_sparse(B=None, nz=None, nl=None, nv=None, device=None):
    """bench.py sparse: the batched sparse solve (float64, Options(abs_tol
    = 1e-8)) of bench.py's banded problem, timed on a fresh b after a warm
    call, against the dense single-instance solve of each lane in turn;
    vs_baseline is bench.py's ratio, the dense time over the sparse."""
    from fbstab_tpu_torch.models.dense_qp import dense_qp_data, solve_dense_qp
    from fbstab_tpu_torch.models.sparse_qp import solve_sparse_qp_batch
    from fbstab_tpu_torch.workloads import SPARSE, sparse_arrays, sparse_batch

    dev = resolve_device(device)
    B = 32 if B is None else B
    nz, nl, nv = (SPARSE[k] if a is None else a
                  for k, a in (("nz", nz), ("nl", nl), ("nv", nv)))
    opts = Options(abs_tol=1e-8)
    kw = dict(dtype=torch.float64, device=dev)
    pat, dB = sparse_batch(B, dev, nz, nl, nv)
    guess = (torch.zeros(B, nz, **kw), torch.zeros(B, nl, **kw),
             torch.zeros(B, nv, **kw))
    solve_sparse_qp_batch(pat, dB, *guess, opts)
    pat.split.reset()
    (_, core), t_sparse = _clock(lambda: solve_sparse_qp_batch(
        pat, dB._replace(b=dB.b * 1.0001), *guess, opts))
    split = dataclasses.asdict(pat.split)
    nf = int((core.eflag != int(ExitFlag.SUCCESS)).sum())

    a = sparse_arrays(nz, nl, nv)
    dd = dense_qp_data(**{k: v[None] for k, v in a.items()}, **kw)
    one = tuple(g[0] for g in guess)
    solve_dense_qp(dd, *one, opts)

    def dense_loop():
        for i in range(B):
            _, c = solve_dense_qp(dd._replace(f=dd.f * (1.0 + 1e-4 * i)),
                                  *one, opts)
            c.residual.item()

    _, t_dense = _clock(dense_loop)
    diag = (f"bench[sparse]: device={_where(dev)} nz={nz} nl={nl} nv={nv} "
            f"lnnz={pat.lnnz} B={B} fails={nf} sparse={t_sparse:.2f}s "
            f"dense={t_dense:.2f}s (round trips {split['round_trips']}, "
            f"host LDL' {split['host_s']:.3f}s, copies "
            f"{split['copy_s']:.3f}s, device wait {split['wait_s']:.3f}s)")
    rec = _record("sparse_qps_host", round(B / t_sparse, 1), "QPs/s",
                  lnnz=pat.lnnz, fails=nf, sparse_s=t_sparse,
                  dense_s=t_dense, split=split)
    rec["vs_baseline"] = round(t_dense / t_sparse, 3)
    return rec, diag


def run_sharded(B=None, device=None):
    """bench.py sharded: the per-device overhead of the sharding layer.
    The headline batch (float32, Options.single_precision()) through the
    direct solve_mpc_qp_batch and through sharded_mpc_solver_fused on a
    mesh of one rank (tile_b None: the same production dispatch on the
    shard, with the two all-reduces of the statistics), each one warm
    call (which also builds NCCL's communicator) and the best of 3.
    Instances are independent and the statistics are the only
    collectives, so a device's work is the same at any mesh size: the
    ratio t_direct / t_sharded is what bench.py reports as the per-chip
    efficiency, and vs_baseline is bench.py's own, the ratio over 0.85.
    Runs alone (a world of one); a world it starts, it ends."""
    import torch.distributed as dist

    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.parallel.sharded import (
        make_mesh, shard_batch, sharded_mpc_solver_fused)
    from fbstab_tpu_torch.perf_model import mean_refine_steps

    dev = resolve_device(device)
    if B is None:
        B = 256 if dev.type == "cpu" else 8192
    opts = Options.single_precision()
    data, guess = _headline(B, dev)
    started = not (dist.is_available() and dist.is_initialized())
    mesh = make_mesh(device=dev)
    try:
        if mesh.size() != 1:
            raise RuntimeError(f"bench sharded runs on a mesh of one rank, "
                               f"not {mesh.size()}")
        sharded = sharded_mpc_solver_fused(mesh, opts)
        args = shard_batch(mesh, (data, *guess))
        t_d, (_, core_d), _ = _best(
            lambda i: solve_mpc_qp_batch(data, *guess, opts))
        t_s, (_, core_s, stats), _ = _best(lambda i: sharded(*args))
        backend = str(dist.get_backend())
    finally:
        if started:
            dist.destroy_process_group()
    eff = t_d / t_s
    # Executed refinement steps on each side: the refinement's early exit
    # depends on the data, so a numerics difference between the two
    # would show here first.
    rs_d, rs_s = mean_refine_steps(core_d), mean_refine_steps(core_s)
    diag = (f"bench[sharded]: device={_where(dev)} backend={backend} B={B} "
            f"direct {t_d:.3f}s vs sharded {t_s:.3f}s -> per-device "
            f"efficiency {eff:.3f}; success {int(stats.num_success)}/{B}; "
            f"refine_steps direct={rs_d:.2f} sharded={rs_s:.2f}")
    rec = _record("sharding_per_chip_efficiency", round(eff, 4), "ratio",
                  direct_s=t_d, sharded_s=t_s)
    rec["vs_baseline"] = round(eff / 0.85, 3)
    return rec, diag


MODES = {
    "refine": run_refine, "adaptive": run_adaptive, "dense": run_dense,
    "copoly": run_copoly, "longhorizon": run_longhorizon,
    "plants": run_plants, "warmstart": run_warmstart,
    "million": run_million, "mxu": run_mxu, "diff": run_diff,
    "sparse": run_sparse, "sharded": run_sharded,
}


def main(argv=None, device=None) -> int:
    """Runs the mode named in argv (sys.argv[1:] by default), prints its
    JSON line on stdout and its diagnostic on stderr; returns the exit
    code (2 for an unknown mode)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] not in MODES:
        print(f"bench: unknown mode {argv[0]!r}; valid modes: "
              + ", ".join(sorted(MODES)), file=sys.stderr)
        return 2
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if not argv:
        record, diag = run_main(device=dev)
    elif argv[0] == "adaptive" and argv[1:2] == ["mixed"]:
        record, diag = run_adaptive_mixed(
            int(argv[2]) if len(argv) > 2 else None, device=dev)
    else:
        args = [int(argv[1])] if len(argv) > 1 else []
        record, diag = MODES[argv[0]](*args, device=dev)
    print(diag, file=sys.stderr)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

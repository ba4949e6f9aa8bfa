"""Builds the port's CUDA kernels and drives its main paths on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-envelope
    python3 chip_smoke.py --assoc-crossover

Phases, each printing one line (two for a kernel comparison) and each
fatal on failure:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: nvcc compiles fbstab_tpu_torch/csrc/*.cu, one process per
     source (time, registers);
  3. K1 (Riccati Newton step) against its plain version at the headline
     (B = 8192), the copolymerization reactor (B = 2048), a tier-3 shape
     at the JAX package's gate corner (N = 10, nx = 32, nu = 24, nc = 48,
     B = 64) and a shape beyond what a block's shared memory holds
     (N = 2, nx = 112, nu = 8, nc = 16, B = 64), on iterates from a few
     plain Newton steps, with its design line at each (as K2's below);
  4. K2 (fused MPC solver) against its plain version on the equilibrated
     headline problem (B = 1024), with its design line: threads per team,
     teams per block, registers, spill bytes, dynamic shared bytes,
     resident blocks per SM;
  5. K3 (fused dense solver) against its plain version on the equilibrated
     bench.py dense problem (seed 1, n = 32, q = 64, nl = 0) at B = 1024
     and at the dense path's B = 4096, on an equality-constrained batch
     (n = 16, q = 32, nl = 8) and at the corner of DENSE_DIMS_CAP, with
     Gaussian equality rows, with its design line;
  6. K4 (the per-subproblem kernel) against its plain version, each under
     the host outer loop of models/mpc_subfused.py, on the equilibrated
     copolymerization reactor (N = 80, B = 256), with its design line;
  7. K5 (the scan-level combine of the associative Riccati) against its
     plain version on every level of the suffix scan of one Newton step at
     the copolymerization reactor's dims (B = 256), with the float64 plain
     version as the yardstick of float32 rounding, and its design line;
  8. P1, the stage-matvec probe: the bench's mxu mode (N1 = 81, n = 18,
     B = 128, T = 200), then its three kernels against their plain versions
     at T = 1 and 8, with times (the wrapper's, as `ms`, and on the device
     from CUDA graph replays, as `device_ms`), library calls and bounds at
     T = 200 and
     each one's design line (threads per team, rows and lanes a thread,
     or n-tiles and lanes a warp, registers, spill bytes, shared bytes,
     blocks per SM, waves); every form also at n = 5 and 32 (B = 40);
  9. P3, the double-float probe: the probe tool's run, bit equality with
     the plain version, exactness against float64, the wrapper's time
     (`ms`) and the kernel's device time apart from the host (CUDA graph
     replays, `device_ms`) beside the card's launch floor (`floor_ms`),
     and the same source built with plain
     operators (does nvcc contract them?);
 10. the MPC refinement's double-float residual (one launch an evaluation)
     against its plain version, models/refine.py's eager composition, on
     the copoly cells' shape (N = 80, B = 2048) and cold_b8192's
     (spacecraft, N = 40, B = 8192): a step's form (per-lane Ruiz-scaled
     data, the blocks and the loop's norm), y's pair and the four blocks
     bit for bit, the norm within 1e-6 relative, and the final check's
     (the expanded plant, batch stride 0, the norm alone), with times,
     bounds and its design line;
 11. the one-shot MPC path, solve_mpc_qp_batch(...,
     Options.single_precision()), at B = 8192, N = 30, nx = 8, nu = 3,
     nc = 6 (the bench.build_batch generator, seed 0), checked in float64
     on the host against the 1e-6 contract, with the kernels' launches;
 12. the dense path, solve_dense_qp_batch(..., Options.single_precision())
     at B = 4096, n = 32, q = 64, as `bench.py dense` runs it;
 13. the adaptive MPC headline, solve_mpc_qp_batch_adaptive_device(...,
     phase1_newton_iters=16, phase2_size=max(B // 8, 128)) at B = 8192,
     as bench.py's headline calls it, with the bench's segments;
 14. the warmstart sweep: the receding-horizon loop on the headline
     plant, B = 8192 scenarios for 8 steps (`bench.py warmstart`);
 15. the plant audit: the four reference plants at B = 128 with perturbed
     x0 (the bench's plants_contract_check), the copolymerization reactor
     (N = 80) through tier 2 (K4);
 16. the copoly path, solve_mpc_qp_batch(..., Options.single_precision())
     at B = 2048, as `bench.py copoly` runs it, through tier 2;
 17. the JAX package's kernel envelope (`envelope`): (a) the spacecraft
     plant at N = 160 (_DIMS_CAP's horizon), B = 8192, through
     solve_mpc_qp_batch(..., Options.single_precision()) with a Newton
     budget of 400 (the plant needs ~250 steps a lane there) on tier 2
     (K4; Ruiz, the retry, refinement on K1), every SUCCESS lane at the
     1e-6 contract in float64, QPs/s, launches and peak memory, then its
     first 1024 lanes' scaled solve on K4 (K4 alone launched) and on
     tier 3 in turns (K4 must solve no fewer lanes), and on K4 under the
     default budget (its exit flags);
     (b) the double integrator at N = 120 and the copolymerization reactor
     at N = 85, B = 2048, each on K4 at the contract; (c) K1 (copoly,
     B = 256), K2 (N = 10, nx = 24, nu = 8, nc = 8, B = 256) and K4 (copoly
     under the host loop, B = 256) in the recompute-factors mode, launched
     through their functions with lowmem=True: bit for bit their storing
     launches, held to their plain versions, std and lowmem timed in
     turns, with design lines; (d) K2 against its plain version at
     (N, nx, nu, nc) = (10, 24, 8, 8), B = 1024, and (4, 32, 24, 48),
     B = 256, K4 at (17, 32, 24, 48), B = 64, with design lines, and K2 at
     B = 2^22 copoly lanes raising KernelResourceError before any launch;
 18. the long-horizon phase: the single-instance solve_mpc_qp on the double
     integrator in float32 with riccati="scan" and "assoc", in turns, at
     N = 120, 240 and 480 (`bench.py longhorizon`'s N), best of 5 each;
 19. the batched assoc phase: solve_mpc_qp_batch(..., riccati="assoc") on
     the copoly batch at B = 256;
 20. the differentiable layer: the gradient of 0.5 |z|^2 with respect to
     every data field through solve_mpc_qp_batch_diff at B = 1024 on the
     headline data, float32 under Options.single_precision() with
     sigma_vjp = 1e-5 (forward K2 and the refinement's K1, backward one K1
     launch), held against the same backward on the plain Newton step and
     against a float64 solve and backward on the card's plain path;
 21. the feedback gain: mpc_feedback_gain on lane 0 of phase 20's
     headline data and on the first lane with the most first inputs
     inside their box (a row of K is zero where that input saturates), in
     float32 (its nx tangents one K1 launch), against float64 on the card
     and central differences of the float64 solve;
 22. the batch facades: FBstabMpcBatch at B = 8192 (a call, a call on the
     next step's data with the carried shifted warmstart, an adaptive
     call), each at the 1e-6 contract on every lane with BatchStats equal
     to the host's reduction; refine_mpc_batch (three unrolled steps) on
     the raw headline solution; FBstabDenseBatch at B = 4096 on the dense
     mode's data with its FINAL summary through an OutputStream;
 23. the sparse QP class (CSR products on the card, each Newton step's
     KKT systems factored on the host by the C LDL'), in float64 under
     Options(abs_tol = 1e-8): `bench.py sparse`'s batch (nz = 400,
     nl = 40, nv = 200, B = 32) through solve_sparse_qp_batch, held to
     1e-6 in host float64 on every SUCCESS lane and to solve_dense_qp on
     three lanes (z within SPARSE_Z_TOL), with the round trips' split
     (host LDL', copies, the wait for the device) and the device's idle
     share under torch.profiler; the MPC bridge (mpc_sparse_pattern,
     mpc_sparse_values) on the headline batch in float64 at B = 256
     against solve_mpc_qp_batch (the same flags, z within
     SPARSE_MPC_Z_TOL); the differentiable sparse solve at B = 8 (the
     gradient of 0.5 |z|^2 + sum(l) with respect to every value array at
     sigma_vjp = 1e-6) against the same backward on the CPU, within
     SPARSE_GRAD_TOL of each field's largest gradient. The path launches
     none of the port's kernels, and its launch counts are read (0).
 24. the batch sharded over torch.distributed (parallel/sharded.py,
     parallel/ragged.py) on a mesh of one rank, a world of one on NCCL, at
     the headline's full width (Options.single_precision()):
     sharded_mpc_solver_fused at B = 8192 against the direct
     solve_mpc_qp_batch (the same flags and Newton counts, z within
     Z_TOL, the bit-equal lanes counted), sharded_mpc_solver_adaptive at
     B = 8192 (phase 1 of 16, phase-2 size 1024), each at the 1e-6
     contract on every lane; sharded_mpc_solver (the lockstep core, a K1
     launch a Newton step) at B = 1024 and sharded_dense_solver (no
     kernel, as in JAX) on the dense mode's data at B = 4096, at the
     contract on SUCCESS lanes; solve_mpc_ragged at B = 8191 with
     tile_b = 128 (8191 rows back, the padding out of the counts);
     dryrun_multichip(1); bench sharded's efficiency. BatchStats equal
     the host's reduction on every path; the process group ends with the
     phase.

The next-to-last line is a JSON object describing each kernel (with its
`design`: for K1-K5 a team of T threads per instance, or per pair and
instance for K5, on instance-major data; for P1's CUDA-core forms a team
per stage and lanes with its register tile, for its tensor-core form a
warp per stage and 16 lanes; K1's row also holds each K1
shape's numbers under `shapes`, K3's its two batches'), the last line
{"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.

With --k3-envelope it runs phases 1 and 2, then holds K3 against its plain
version at B = 256 at each ENVELOPE shape within the JAX package's dense
gate, none fatal: the survey DENSE_DIMS_CAP is chosen from. With
--assoc-crossover it runs phases 1 and 2, then the long-horizon phase at
N = ASSOC_CROSSOVER_NS, best of 7, and prints the smallest N from which
the single-instance assoc solve is the faster at every larger N: the
value of ASSOC_MIN_HORIZON_CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from fbstab_tpu_torch.perf_model import (
    PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound, combine_flops, dense_residual_flops,
    dense_step_flops, mpc_solve_bound, nbytes, riccati_flops, solve_flops,
    stage_matvec_flops)
from fbstab_tpu_torch.workloads import (
    COPOLY, DENSE, HEADLINE, build_batch, build_copoly, build_dense,
    build_plant, card, cuda_ms, dense_f64_residual, dense_zeros, graph_ms,
    launch_floor_ms, mpc_f64_residual, newton_step_args, timed, zeros_guess)

K1_TOL = 1e-3      # max |dK - dP| / (1 + max |dP|) per lane, dz and dl
# Fused solver (K2, K3) against its plain version, both in float32.
Z_TOL = 1e-3       # |z_K - z_P|_inf <= Z_TOL (1 + |z_P|_inf)
EFLAG_FRAC = 0.99
NEWTON_BAND = 2
# float32 knife edges: the inner stall guard (3 steps without a 1e-3
# relative gain) and the tolerance tests flip on last-bit differences, so
# a few lanes of a float32 batch take a different Newton count in two
# correct implementations (on an H100 80GB HBM3 at 700 W, beyond +-2 on
# 6.25% of lanes at B = 128 and 4.2% at B = 1024 for K2). The per-lane
# decisions are pinned in float64 instead: tests/test_torch_device_code.py
# replays the kernels' device code on the CPU and requires the plain
# solver's exit flag, Newton and proximal counts on every lane.
NEWTON_FRAC = 0.90
NEWTON_MEAN = 0.5     # |mean newton_iters kernel - plain|
CONTRACT = 1e-6
# K5 against its plain version, both float32, per output and level:
# max |K5 - plain| / (1 + max |plain|) per lane. The combine tree's
# matrices reach condition numbers of ~1/sigma^2, so float32 rounding alone
# moves the plain version this far from its float64 run (printed beside).
K5_TOL = 1e-3
# --k3-envelope: the shapes (n, q, nl) within the JAX package's dense gate
# (n <= 64, q <= 128, nl <= 64) at which K3 is surveyed against its plain
# version; DENSE_DIMS_CAP is the largest box whose corner passes.
# The sparse phase (21), float64: z against the dense solve of the same
# lane (abs_tol 1e-8 on a problem with H >= I), the sparse MPC bridge's z
# against the Riccati solve (tests/test_sparse_solve.py's 1e-6), and the
# card's gradients against the CPU's, |g_card - g_cpu| <= SPARSE_GRAD_TOL
# (1 + max |g_cpu|) per field (the card's atomic sums move the last bits;
# at sigma_vjp = 1e-6 the backward keeps ~1e-9 of that).
SPARSE_Z_TOL = 1e-7
SPARSE_MPC_Z_TOL = 1e-6
SPARSE_GRAD_TOL = 1e-6
ENVELOPE = ((32, 64, 0), (32, 64, 16), (32, 64, 32), (48, 96, 0),
            (48, 96, 24), (64, 128, 0), (64, 128, 32), (64, 128, 64))
# --assoc-crossover: the horizons of the double integrator at which the
# single-instance scan and assoc solves are timed.
ASSOC_CROSSOVER_NS = (240, 360, 480, 600, 720, 960)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# ------------------------------------------------------------------
# Phases.
# ------------------------------------------------------------------

def phase_device():
    try:
        name = card()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    kind = torch.cuda.get_device_name(0)
    print(name)
    print(f"device: torch sees {kind} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, kind


def phase_build():
    from fbstab_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    log = log.read_text() if log.exists() else ""
    # P1's CUDA-core forms are compiled for every n up to the cap: only
    # the probe's n = 18 is printed here.
    usage = [ln for src in sorted(p.name for p in _build.SRC_DIR.glob("*.cu"))
             for entry in (P1_ENTRIES if src == "mxu_probe.cu" else (None,))
             for ln in _build.ptxas_lines(src, log, entry)]
    print(f"build: {secs:.1f} s ({_build.library_path().name}); ptxas: "
          + " | ".join(usage))


def mpc_entry(kernel, team=False):
    """For design_line: the mangled-name prefix of the instantiation of an
    MPC kernel (K1, K2, K4) that a launch at (N, nx, nu, nc, lowmem) takes:
    K1's team, whether it stages, whether it stores the factors."""
    def entry(info, dims):
        return (f"{kernel}I" + (f"Li{info['team']}E" if team else "")
                + f"Lb{int(info['smem_bytes'] > 0)}ELb{int(not dims[-1])}E")
    return entry


def design_line(name, source, info_fn, dims, per="instance", entry=None):
    """Prints a kernel's launch shape at `dims` (its C info function) and
    its ptxas lines (with `entry`, a function of the launch shape and dims,
    those of the instantiation the launch takes); returns the row's
    `design`. A team runs one `per`."""
    from fbstab_tpu_torch.ops import _build

    lib = _build.load_library()
    info = _build.kernel_info(getattr(lib, info_fn), *dims)
    which = entry(info, dims) if entry else None
    print(f"{name} design: a team of {info['team']} threads per {per}, "
          f"{info['teams_per_block']} teams per block; "
          f"{info['registers']} registers and {info['local_bytes']} local "
          f"bytes per thread; {info['smem_bytes']} bytes of dynamic shared "
          f"memory per block"
          + ("" if info["smem_bytes"] else " (the team works in place)")
          + f"; {info['blocks_per_sm']} resident blocks per "
          f"SM | ptxas: " + " | ".join(_build.ptxas_lines(source,
                                                          entry=which)))
    return (f"team of {info['team']} per {per}, instance-major"
            + ("" if info["smem_bytes"] else ", stage block in device memory"))


# P1's kernels in the build log at the probe's n = 18 (tc_shared: NT = 3
# n-tiles of 8), by form.
P1_ENTRIES = ("stage_matvec_teamILi18ELb1E", "stage_matvec_teamILi18ELb0E",
              "stage_matvec_tcILi3E")


def p1_design_line(form, n, N1, B):
    """Prints P1's launch at n for N1 stages of B lanes (fb_mxu_probe_info)
    and its ptxas lines at n = 18; returns the row's `design`."""
    from fbstab_tpu_torch.ops import _build

    lib = _build.load_library()
    info = _build.kernel_info(lib.fb_mxu_probe_info, form, n, N1, B,
                              fields=_build.MXU_INFO_FIELDS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = info["blocks_per_sm"] * sms
    if form == 2:
        design = (f"a warp per (stage, {info['lanes']} lanes), "
                  f"{info['rows']} n-tiles of TF32 mma.sync m16n8k8, w in "
                  f"registers for all T (no shared memory, no sync)")
    else:
        design = (f"team of {info['team']} per (stage, {info['lanes']} "
                  f"lane{'s' if info['lanes'] > 1 else ''}), "
                  f"{info['rows']} x {info['lanes']} register tile a thread, "
                  f"one __syncwarp per application")
    name = ("cuda_perlane", "cuda_shared", "tc_shared")[form]
    print(f"P1 {name} design (n={n} N1={N1} B={B}): {design}; "
          f"{info['teams_per_block']} teams per block; {info['registers']} "
          f"registers and {info['local_bytes']} local bytes per thread; "
          f"{info['smem_bytes']} bytes of shared memory per block; "
          f"{info['blocks_per_sm']} resident blocks per SM; "
          f"{info['blocks']} blocks, {resident} resident at once on {sms} "
          f"SMs ({-(-info['blocks'] // resident)} wave) | "
          f"ptxas: " + " | ".join(_build.ptxas_lines(
              "mxu_probe.cu", entry=P1_ENTRIES[form])))
    return design


# K1's shapes on the card: the headline (phase 3's timed shape, K1's
# launches on the one-shot, adaptive and warmstart paths), the
# copolymerization reactor at the copoly path's batch (its refinement's
# K1), a tier-3 shape beyond K2's and K4's caps at the JAX package's gate
# corner, whose stage block (49.9 KB) needs more shared memory than a
# block gets by default, each held to K1_TOL; and a shape whose stage
# block no block can hold (nx = 112), where the team works in place. At
# nx = 112 float32 rounding alone can move the plain version ~7e-4 from
# its float64 run (tests/test_torch_riccati.py's inputs), so there K1 is
# held to K1_TOL or three times that distance, whichever is larger
# (rounding=True).
K1_SHAPES = (("headline", 8192, HEADLINE, False),
             ("copoly", 2048, COPOLY, False),
             ("gate corner", 64, dict(N=10, nx=32, nu=24, nc=48), False),
             ("in place", 64, dict(N=2, nx=112, nu=8, nc=16), True))


def phase_k1(device):
    """K1 against its plain version at each K1_SHAPES shape, on the
    equilibrated batch at the iterate of a few plain Newton steps, with
    the float64 plain step on the same inputs as the yardstick of float32
    rounding, its times, bound and design line there."""
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops.riccati_cuda import (
        riccati_newton_step_batched as k1, riccati_newton_step_plain as p1)
    from fbstab_tpu_torch.options import Options

    rows = {}
    rel = lambda k, p: ((k.double() - p).abs().amax(1)
                        / (1 + p.abs().amax(1))).max().item()
    for tag, B, dims, rounding in K1_SHAPES:
        data = (build_copoly(B, device) if dims is COPOLY
                else build_batch(B, **dims, device=device))
        data = apply_mpc_scaling(data, ruiz_mpc_scaling(data))
        args = newton_step_args(data, Options.single_precision())
        kz, kl, _, _ = k1(*args)
        pz, pl, _, _ = p1(*args)
        wz, wl, _, _ = p1(type(data)(*(a.double() for a in data)),
                          *(a.double() for a in args[1:7]), *args[7:])
        err = max(rel(kz, pz), rel(kl, pl))
        p64 = max(rel(pz, wz), rel(pl, wl))
        tol = max(K1_TOL, 3 * p64) if rounding else K1_TOL
        max_abs = max((kz - pz).abs().max().item(),
                      (kl - pl).abs().max().item())
        ms = cuda_ms(lambda: k1(*args), 5)
        plain_ms = cuda_ms(lambda: p1(*args), 3)
        d = data
        bound_ms, bound_by = bound(
            B * riccati_flops(**dims),
            nbytes(d.Q, d.R, d.S, d.A, d.B, d.E, d.L, *args[1:7], kz, kl))
        print(f"K1: {tag} B={B} N={dims['N']} nx={dims['nx']} "
              f"nu={dims['nu']} nc={dims['nc']} max rel err {err:.3e} "
              f"(tol {tol:.3e}); float32 plain vs float64 plain {p64:.3e}; "
              f"max abs err "
              f"{max_abs:.3e} | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        design = design_line("K1", "riccati.cu", "fb_riccati_info",
                             (*dims.values(), 0),
                             entry=mpc_entry("riccati_step_kernel", True))
        if not (np.isfinite(err) and err <= tol):
            fail(f"K1 disagrees with its plain version ({tag})")
        rows[f"{tag} B={B}"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, design=design)
    head = dict(rows[f"headline B={K1_SHAPES[0][1]}"])
    return dict(head, library_ms=None, shapes=rows)


def compare_solver(name, kernel, plain, data, guess, opts, tag, reps=(2, 1),
                   fatal=True, warm=True):
    """Holds a fused solver kernel against its plain version on the same
    float32 inputs; prints two lines and, if `fatal`, fails beyond the
    thresholds. Times each with CUDA events over `reps` calls after a warm
    one (warm=False: the comparison call was the warm one), or (reps=None)
    the first calls on the host clock. Returns the kernel's CoreOut, the
    max |z| error, both times and whether it passed."""
    (xk, ck), first_k = timed(lambda: kernel(data, *guess, opts))
    (xp, cp), first_p = timed(lambda: plain(data, *guess, opts))
    same = (ck.eflag == cp.eflag).float().mean().item()
    both = (ck.eflag == 0) & (cp.eflag == 0)
    dn = (ck.newton_iters - cp.newton_iters).abs()[both]
    in_band = (dn <= NEWTON_BAND).float().mean().item()
    zerr = ((xk.z - xp.z).abs().amax(1) / (1 + xp.z.abs().amax(1)))[both]
    max_abs = (xk.z - xp.z).abs()[both].max().item() if both.any() else 0.0
    if reps is None:
        ms, plain_ms = first_k, first_p
    else:
        ms = cuda_ms(lambda: kernel(data, *guess, opts), reps[0], warm)
        plain_ms = cuda_ms(lambda: plain(data, *guess, opts), reps[1], warm)
    B = guess[0].shape[0]
    mk = ck.newton_iters[both].float().mean().item()
    mp = cp.newton_iters[both].float().mean().item()
    ok = (same >= EFLAG_FRAC and bool(both.any()) and in_band >= NEWTON_FRAC
          and abs(mk - mp) <= NEWTON_MEAN and zerr.max().item() <= Z_TOL)
    print(f"{name}: {tag} B={B} eflag equal {same:.4f} (>= {EFLAG_FRAC}); "
          f"both SUCCESS {both.float().mean().item():.4f}; newton |diff| "
          f"max {dn.max().item() if both.any() else 0}, within "
          f"{NEWTON_BAND} on {in_band:.4f} (>= {NEWTON_FRAC}); mean newton "
          f"kernel {mk:.2f} plain {mp:.2f}; z rel err max "
          f"{zerr.max().item() if both.any() else 0:.3e} (tol {Z_TOL}) | "
          f"kernel {ms:.1f} ms, plain {plain_ms:.1f} ms"
          + ("" if reps else " (first calls, host clock)")
          + ("" if ok else " | OUTSIDE THE THRESHOLDS"))
    out = (both & ((ck.newton_iters - cp.newton_iters).abs()
                   > NEWTON_BAND)).nonzero().flatten().tolist()
    print(f"{name}: {tag} {len(out)} lanes beyond +-{NEWTON_BAND} Newton "
          "steps (lane: newton kernel/plain, prox kernel/plain): "
          + ", ".join(f"{b}: {int(ck.newton_iters[b])}/"
                      f"{int(cp.newton_iters[b])}, {int(ck.prox_iters[b])}/"
                      f"{int(cp.prox_iters[b])}" for b in out[:8])
          + (" ..." if len(out) > 8 else ""))
    if fatal and not ok:
        fail(f"{name} disagrees with its plain version ({tag})")
    return ck, max_abs, ms, plain_ms, ok


def phase_k2(B, device):
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops.mpc_solve_cuda import (
        fbstab_mpc_solve_fused, fbstab_mpc_solve_plain)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_batch(B, **HEADLINE, device=device)
    data = apply_mpc_scaling(data, ruiz_mpc_scaling(data))
    guess = zeros_guess(data)
    ck, max_abs, ms, plain_ms, _ = compare_solver(
        "K2", fbstab_mpc_solve_fused, fbstab_mpc_solve_plain, data, guess,
        opts, "equilibrated headline")
    bound_ms, bound_by = mpc_solve_bound(
        B, *HEADLINE.values(), ck.newton_iters.float().mean().item(),
        ck.prox_iters.float().mean().item())
    print(f"K2: bound {bound_ms:.4f} ms ({bound_by}; mean newton "
          f"{ck.newton_iters.float().mean().item():.2f}, one linesearch "
          f"trial each)")
    design = design_line("K2", "mpc_solve.cu", "fb_mpc_solve_info",
                         (*HEADLINE.values(), 0),
                         entry=mpc_entry("mpc_solve_kernel"))
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                design=design)


def k3_compare(B, n, q, nl, device, kernel=None, **kw):
    """K3 (or `kernel`) against its plain version on the equilibrated
    dense batch."""
    from fbstab_tpu_torch.models.scaling import (
        apply_dense_scaling, ruiz_dense_scaling)
    from fbstab_tpu_torch.ops.dense_solve_cuda import (
        fbstab_dense_solve_fused, fbstab_dense_solve_plain)
    from fbstab_tpu_torch.options import Options

    data = build_dense(B, n, q, nl, device)
    data = apply_dense_scaling(data, ruiz_dense_scaling(data))
    guess = dense_zeros(data)
    return data, guess, compare_solver(
        "K3", kernel or fbstab_dense_solve_fused, fbstab_dense_solve_plain,
        data, guess, Options.single_precision(), f"n={n} q={q} nl={nl}",
        **kw)


def phase_k3(device):
    """K3 against its plain version at four shapes: the bench.py dense
    shape (n and q are the cap's) at B = 1024 and at the dense path's
    B = 4096 (its numbers go into the kernel line, B = 1024's under
    `shapes`), an equality-constrained shape and the corner of
    DENSE_DIMS_CAP; with its design line at the bench shape."""
    from fbstab_tpu_torch.models.dense_qp import DENSE_DIMS_CAP as cap

    n, q, nl = DENSE["n"], DENSE["q"], 0
    rows = {}
    for B in (1024, 4096):
        data, guess, (ck, max_abs, ms, plain_ms, _) = k3_compare(
            B, n, q, nl, device)
        newton = ck.newton_iters.float().mean().item()
        flops = B * solve_flops(
            dense_step_flops(n, q, nl), dense_residual_flops(n, q, nl),
            newton, ck.prox_iters.float().mean().item())
        out_bytes = (nbytes(guess[0], guess[1]) + 2 * nbytes(guess[2])
                     + 5 * 4 * B)
        bound_ms, bound_by = bound(flops, nbytes(*data, *guess) + out_bytes)
        print(f"K3: B={B} bound {bound_ms:.4f} ms ({bound_by}; mean newton "
              f"{newton:.2f}, one linesearch trial each)")
        rows[f"B={B}"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    design = design_line("K3", "dense_solve.cu", "fb_dense_solve_info",
                         (n, q, nl))
    k3_compare(256, 16, 32, 8, device)
    k3_compare(256, cap["n"], cap["q"], cap["nl"], device)
    return dict(rows["B=4096"], library_ms=None, design=design, shapes=rows)


def k3_envelope(device):
    """K3 against its plain version at B = 256 at each ENVELOPE shape, one
    timed call each after a warm one, none fatal. The kernel's wrapper
    refuses shapes beyond DENSE_DIMS_CAP, so the survey launches it
    directly."""
    from fbstab_tpu_torch.ops import _build
    from fbstab_tpu_torch.ops.dense_solve_cuda import launch_dense_solve

    lib = _build.load_library()

    def kernel(data, z0, l0, v0, options):
        stream = torch.cuda.current_stream(z0.device).cuda_stream
        return launch_dense_solve(lib, data, z0, l0, v0, options, stream)

    for n, q, nl in ENVELOPE:
        k3_compare(256, n, q, nl, device, kernel=kernel, reps=(1, 1),
                   fatal=False)


def launch_counter():
    """A reader of the kernels' launches since this call, from the port's
    counters (fbstab_tpu_torch/telemetry.py); the recompute-factors
    kernels of K1, K2 and K4 are counted apart (`K1_lowmem`, ...), the
    refinement's residual as `RR`."""
    from fbstab_tpu_torch import telemetry
    names = dict(K1="k1", K2="k2", K3="k3", K4="k4", K5="k5",
                 P1_perlane="mxu_perlane", P1_shared="mxu_shared",
                 P1_tc="mxu_tc", P3="df_probe", K1_lowmem="k1_lowmem",
                 K2_lowmem="k2_lowmem", K4_lowmem="k4_lowmem",
                 RR="refine_residual")
    start = telemetry.counters()

    def since():
        now = telemetry.counters()
        return {name: now.get(f"launch.{key}", 0)
                - start.get(f"launch.{key}", 0)
                for name, key in names.items()}
    return since


def drive(fn, reps=3):
    """One warm call, then `reps` timed calls (host clock around
    synchronized calls). Returns (last result, times in s)."""
    times = []
    for i in range(reps + 1):
        out, ms = timed(fn)
        if i:
            times.append(ms / 1e3)
    return out, times


def check_contract(tag, x, core, res64, guess, every_lane):
    good = (core.eflag == 0).cpu().numpy()
    sol = x.to_float64()
    finite = all(bool(torch.isfinite(a).all()) for a in sol)
    if not (finite and tuple(sol.z.shape) == tuple(guess[0].shape)):
        fail(f"{tag} returned non-finite values or the wrong shape")
    ok = res64 <= CONTRACT
    if good.mean() < 0.99 or not bool(np.all(ok if every_lane
                                              else ok[good])):
        fail(f"{tag} misses the contract")
    return good


# The refinement residual's shapes: the copoly cells' batch and
# cold_b8192's (plant, N, B).
RR_SHAPES = (("copoly", "copolymerization_reactor", 80, 2048),
             ("spacecraft", "spacecraft_relative_motion", 40, 8192))


def _df_point(data, seed=0):
    """A double-float point (zx, zu, l, v) on data's device: hi N(0, 1)
    (v >= 0), lo within 2^-25 of hi."""
    from fbstab_tpu_torch.models.mpc_qp import mpc_dims
    N, nx, nu, nc = mpc_dims(data)
    B, dev = data.x0.shape[0], data.x0.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def pair(n, nonneg=False):
        hi = torch.randn(B, N + 1, n, generator=g, device=dev)
        hi = hi.clamp(min=0.0) if nonneg else hi
        return hi, hi * (torch.rand(hi.shape, generator=g, device=dev)
                         - 0.5) * 2.0 ** -24
    return pair(nx), pair(nu), pair(nx), pair(nc, nonneg=True)


def phase_refine_residual(device):
    """The refinement's residual kernel against its plain version at each
    RR_SHAPES shape, in a step's form (Ruiz-scaled data, blocks, the
    norm in original units) and the final check's (the expanded plant,
    the norm alone, in the data's units): bit-equal blocks, the norm within
    1e-6 relative, the largest absolute error of the blocks (the step) and
    of the norm, the kernel's time (20 calls back to back, CUDA events)
    and its device time alone (a CUDA graph of 20 launches), the plain
    composition's time, the bound and the design line."""
    from fbstab_tpu_torch.models.mpc_qp import MpcQPData, mpc_dims
    from fbstab_tpu_torch.models.refine import mpc_residual_df_plain
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops.refine_residual_cuda import refine_residual
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.perf_model import (
        PEAK_F32_NO_FMA, mpc_data_floats, refine_residual_flops)

    alpha = Options.single_precision().validated().alpha
    rows = {}
    for tag, plant, N, B in RR_SHAPES:
        one = build_plant(plant, N, 1, 0.0, device)
        raw = MpcQPData(*(a.expand((B,) + a.shape[1:]) for a in one)
                        )._replace(x0=build_plant(plant, N, B, 0.05,
                                                  device).x0)
        scal = ruiz_mpc_scaling(raw)
        dims = mpc_dims(raw)
        design = design_line("refine residual", "refine_residual.cu",
                             "fb_refine_residual_info", dims[1:], per="lane")
        point = _df_point(raw)
        pt_floats = sum(t.numel() for p in point for t in p)
        for form, data, sc, blocks, lanes in (
                ("step", apply_mpc_scaling(raw, scal), scal, True, B),
                ("final", raw, None, False, 1)):
            run = lambda: refine_residual(data, *point, alpha, sc, blocks)
            got = run()
            want = mpc_residual_df_plain(data, *point, alpha, sc, blocks)
            pairs = (list(zip((*got[0], *got[1]), (*want[0], *want[1])))
                     if blocks else [])
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in pairs)
            max_abs = max(((g.double() - w.double()).abs().max().item()
                           for g, w in pairs), default=None)
            norm_err = (got[2].double() - want[2].double()).abs()
            norm_abs = norm_err.max().item()
            rel = (norm_err / want[2].double().abs()).max().item()
            ms = cuda_ms(run, 20)
            device_ms = graph_ms(run)
            plain_ms = cuda_ms(lambda: mpc_residual_df_plain(
                data, *point, alpha, sc, blocks), 3)
            out_floats = (sum(t.numel() for t in (*got[0], *got[1]))
                          if blocks else 0) + B
            bound_ms, bound_by = bound(
                B * refine_residual_flops(*dims),
                4 * (lanes * mpc_data_floats(*dims) + pt_floats + out_floats
                     + (sum(t.numel() for t in sc) if sc else 0)),
                peak=PEAK_F32_NO_FMA)
            print(f"refine residual: {tag} {form} B={B} N={N} blocks "
                  f"bit-equal {same} (max abs err {max_abs}), norm max abs "
                  f"err {norm_abs:.3e}, max rel err {rel:.3e} | kernel "
                  f"{ms:.4f} ms (on the device {device_ms:.4f} ms), plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not (same and rel <= 1e-6):
                fail(f"the refinement residual disagrees with its plain "
                     f"version ({tag} {form})")
            rows[f"{tag} {form} B={B}"] = dict(
                max_abs_err=max_abs, norm_abs_err=norm_abs,
                norm_rel_err=rel, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                design=design)
    head = dict(rows[f"copoly step B={RR_SHAPES[0][3]}"])
    return dict(head, library_ms=None, shapes=rows)


def phase_main(B, device):
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_batch(B, **HEADLINE, device=device)
    guess = zeros_guess(data)
    counts = launch_counter()
    (x, core), times = drive(
        lambda: solve_mpc_qp_batch(data, *guess, opts))
    n = counts()
    res64 = mpc_f64_residual(data, x, opts.alpha)
    good = check_contract("one-shot MPC path", x, core, res64, guess, True)
    qps = B / min(times)
    print(f"main: B={B} QPs/s {qps:.1f} (best of "
          f"{[round(t, 4) for t in times]} s) success_frac "
          f"{good.mean():.4f} residual_f64_max {res64.max():.3e} "
          f"residual_f64_frac_le_1e6 {np.mean(res64 <= CONTRACT):.4f} "
          f"refine_steps max {int(core.refine_steps.max())} | launches K2 "
          f"{n['K2']} K1 {n['K1']}")
    mpc_breakdown(data, *guess, opts)
    if n["K2"] < 1 or n["K1"] < 1:
        fail("one-shot MPC path did not launch K1 and K2")
    return qps, n


def mpc_breakdown(data, z0, l0, v0, opts):
    """One more one-shot call, timed stage by stage: Ruiz scaling, the
    scaled solve (K2), the refinement loop (K1 and the double-float
    residuals)."""
    from fbstab_tpu_torch.models.mpc_qp import _solve_mpc_qp_batch_raw
    from fbstab_tpu_torch.models.refine import refine_solution_mpc
    from fbstab_tpu_torch.models.scaling import (
        ruiz_mpc_scaling, solve_scaled_mpc)

    o = opts.validated()
    scal, t_ruiz = timed(lambda: ruiz_mpc_scaling(data))
    (x, core), t_solve = timed(lambda: solve_scaled_mpc(
        lambda d, z, l, v: _solve_mpc_qp_batch_raw(d, z, l, v, o), data,
        z0, l0, v0, o, scal=scal, skip_residual_rewrite=True))
    n1 = launch_counter()
    _, t_ref = timed(lambda: refine_solution_mpc(data, x, core, o,
                                                 scal=scal))
    fails = int((core.eflag == 6).sum())
    print(f"main breakdown (ms): ruiz {t_ruiz:.1f} | scaled solve (K2) "
          f"{t_solve:.1f} | refine {t_ref:.1f} "
          f"({n1()['K1']} K1 launches) | "
          f"LINEAR_SOLVER_FAILED lanes before retry {fails}")


def phase_dense_main(B, device):
    from fbstab_tpu_torch.models.dense_qp import (
        _solve_dense_qp_batch_raw, solve_dense_qp_batch)
    from fbstab_tpu_torch.models.refine import refine_solution_dense
    from fbstab_tpu_torch.models.scaling import (
        ruiz_dense_scaling, solve_scaled_dense)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_dense(B, DENSE["n"], DENSE["q"], 0, device)
    guess = dense_zeros(data)
    counts = launch_counter()
    (x, core), times = drive(
        lambda: solve_dense_qp_batch(data, *guess, opts))
    n = counts()
    res64 = dense_f64_residual(data, x, opts.alpha)
    good = check_contract("dense path", x, core, res64, guess, False)
    print(f"dense: B={B} n={DENSE['n']} q={DENSE['q']} QPs/s "
          f"{B / min(times):.1f} (best of {[round(t, 4) for t in times]} s)"
          f" success_frac {good.mean():.4f} residual_f64_max_success "
          f"{res64[good].max():.3e} refine_steps max "
          f"{int(core.refine_steps.max())} | launches K3 {n['K3']}")
    o = opts.validated()
    scal, t_ruiz = timed(lambda: ruiz_dense_scaling(data))
    (xs, cs), t_solve = timed(lambda: solve_scaled_dense(
        lambda d, z, l, v: _solve_dense_qp_batch_raw(d, z, l, v, o), data,
        *guess, o, scal=scal, skip_residual_rewrite=True))
    _, t_ref = timed(lambda: refine_solution_dense(data, xs, cs, o,
                                                   scal=scal))
    print(f"dense breakdown (ms): ruiz {t_ruiz:.1f} | scaled solve (K3) "
          f"{t_solve:.1f} | refine {t_ref:.1f} | LINEAR_SOLVER_FAILED "
          f"lanes before retry {int((cs.eflag == 6).sum())}")
    if n["K3"] < 1:
        fail("dense path did not launch K3")
    return n


def phase_adaptive(B, device, oneshot_qps):
    from fbstab_tpu_torch.bench import measure_segments
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)

    opts = Options.single_precision()
    data = build_batch(B, **HEADLINE, device=device)
    guess = zeros_guess(data)
    phase1, P2 = 16, max(B // 8, 128)
    counts = launch_counter()
    (x, core), times = drive(lambda: solve_mpc_qp_batch_adaptive_device(
        data, *guess, opts, phase1_newton_iters=phase1, phase2_size=P2))
    n = counts()
    res64 = mpc_f64_residual(data, x, opts.alpha)
    good = check_contract("adaptive MPC headline", x, core, res64, guess,
                          True)
    print(f"adaptive: B={B} phase1={phase1} P2={P2} QPs/s "
          f"{B / min(times):.1f} (best of {[round(t, 4) for t in times]} s;"
          f" one-shot {oneshot_qps:.1f}) success_frac {good.mean():.4f} "
          f"residual_f64_max {res64.max():.3e} | launches K2 {n['K2']} K1 "
          f"{n['K1']}")

    seg = measure_segments(data, *guess, opts, phase1, P2, min(times))
    print("adaptive breakdown (ms; bench.measure_segments, the wrapper's "
          "own stages through its hooks, best of 3 less the null "
          "dispatch): " + " | ".join(
              f"{k} {v}" for k, v in seg.items())
          + f" | fallback {'fired' if seg['retry_count'] > P2 else 'not fired'}"
          f" (capacity {P2})")
    if n["K2"] < 1 or n["K1"] < 1:
        fail("adaptive MPC headline did not launch K1 and K2")
    return n


def phase_plants(B, device):
    from fbstab_tpu_torch.bench import plants_contract_check

    summary = plants_contract_check(B, device, verbose=False)
    print("plants: B=%d " % B + "; ".join(
        f"{name}: nominal {p['nominal_res64']:.2e} success "
        f"{p['success_frac']:.3f} worst solved {p['perturbed_res64_max']:.2e}"
        for name, p in summary["per_plant"].items()))
    if not summary["contract_met"]:
        fail("plant audit misses the contract")


def phase_k4(B, device):
    """K4 against its plain version, each under the host outer loop, on the
    equilibrated copolymerization reactor. A solve takes seconds, so the
    comparison call is the warm one and one call is timed."""
    from fbstab_tpu_torch.models.mpc_subfused import (
        fbstab_mpc_solve_subfused)
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops.mpc_subproblem_cuda import (
        mpc_subproblem_plain)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_copoly(B, device)
    data = apply_mpc_scaling(data, ruiz_mpc_scaling(data))
    guess = zeros_guess(data)
    n0 = launch_counter()
    ck, max_abs, ms, plain_ms, _ = compare_solver(
        "K4", fbstab_mpc_solve_subfused,
        lambda *a: fbstab_mpc_solve_subfused(
            *a, subproblem=mpc_subproblem_plain),
        data, guess, opts, f"equilibrated copoly N={COPOLY['N']}",
        reps=(1, 1), warm=False)
    launches = n0()["K4"] // 2   # per solve
    # Each launch reads the data and the center and writes the iterate.
    bound_ms, bound_by = mpc_solve_bound(
        B, *COPOLY.values(), ck.newton_iters.float().mean().item(),
        ck.prox_iters.float().mean().item(), launches=launches)
    print(f"K4: bound {bound_ms:.4f} ms ({bound_by}; {launches} launches "
          f"per solve, mean newton {ck.newton_iters.float().mean().item():.2f}"
          f", one linesearch trial each)")
    design = design_line("K4", "mpc_subproblem.cu", "fb_mpc_subproblem_info",
                         (*COPOLY.values(), 0),
                         entry=mpc_entry("mpc_subproblem_kernel"))
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                design=design)


def phase_k5(B, device):
    """K5 against its plain version on every level of the suffix scan of
    one Newton step at the copolymerization reactor's dims, on iterates
    from a few plain proximal Newton steps, each level's operands as the
    scan hands them (views of every other element). The float64 plain
    version on the same inputs shows how far float32 rounding alone moves
    the plain one."""
    from fbstab_tpu_torch.models.mpc_qp import assoc_step_inputs
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops.assoc_combine_cuda import (
        SpanElement, combine_im, combine_im_plain)
    from fbstab_tpu_torch.ops.assoc_riccati import (
        stage_elements_im, stage_major, suffix_values)
    from fbstab_tpu_torch.options import Options

    data = build_copoly(B, device)
    data = apply_mpc_scaling(data, ruiz_mpc_scaling(data))
    _, _, args = assoc_step_inputs(
        *newton_step_args(data, Options.single_precision()))
    elems, _ = stage_elements_im(*map(stage_major, args[:-1]), args[-1])
    levels = []

    def record(left, right):
        levels.append((left, right))
        return combine_im_plain(left, right)
    suffix_values(elems, combine=record)

    f64 = lambda e: SpanElement(*(a.double() for a in e))
    # Per lane (axis 1): the max over the pairs and the block's entries.
    lanes = lambda a: (0, 2, 3)[:a.ndim - 1]
    rel = lambda g, w: ((g - w).abs().amax(lanes(w))
                        / (1 + w.abs().amax(lanes(w))))
    worst_k5, worst_f32, max_abs = 0.0, 0.0, 0.0
    for left, right in levels:
        got = combine_im(left, right)
        want = combine_im_plain(left, right)
        ref = combine_im_plain(f64(left), f64(right))
        for g, w, w64 in zip(got, want, ref):
            worst_k5 = max(worst_k5, rel(g, w).max().item())
            worst_f32 = max(worst_f32, rel(w.double(), w64).max().item())
            max_abs = max(max_abs, (g - w).abs().max().item())
    left, right = levels[0]                  # the widest level
    M, n = left.P11.shape[0], left.P11.shape[-1]
    ms = cuda_ms(lambda: combine_im(left, right), 5)
    plain_ms = cuda_ms(lambda: combine_im_plain(left, right), 3)
    bound_ms, bound_by = bound(M * B * combine_flops(n),
                               nbytes(*left, *right) + nbytes(*left))
    print(f"K5: copoly n={n} B={B}, {len(levels)} scan levels, widest M={M}:"
          f" max rel err vs plain {worst_k5:.3e} (tol {K5_TOL}); float32 "
          f"plain vs float64 plain {worst_f32:.3e}; max abs err "
          f"{max_abs:.3e} | widest level: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    design = design_line("K5", "assoc_combine.cu", "fb_combine_info", (n,),
                         per="pair and instance")
    if not np.isfinite(worst_k5) or worst_k5 > K5_TOL:
        fail("K5 disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                design=design)


def phase_copoly(B, device):
    """bench.py copoly's call at B = 2048 through tier 2: one call timed
    stage by stage (it is also the warm one), then the timed call whose
    launches are counted, with its peak device memory."""
    from fbstab_tpu_torch.models.mpc_qp import (
        _solve_mpc_qp_batch_raw, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.refine import refine_solution_mpc
    from fbstab_tpu_torch.models.scaling import (
        ruiz_mpc_scaling, solve_scaled_mpc)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_copoly(B, device)
    guess = zeros_guess(data)
    o = opts.validated()
    counts = launch_counter()
    scal, t_ruiz = timed(lambda: ruiz_mpc_scaling(data))
    (xs, cs), t_solve = timed(lambda: solve_scaled_mpc(
        lambda d, z, l, v: _solve_mpc_qp_batch_raw(d, z, l, v, o), data,
        *guess, o, scal=scal, skip_residual_rewrite=True))
    n_solve = counts()
    _, t_ref = timed(lambda: refine_solution_mpc(data, xs, cs, o,
                                                 scal=scal))
    n_all = counts()
    print(f"copoly breakdown (ms): ruiz {t_ruiz:.1f} | tier-2 solve "
          f"{t_solve:.1f} ({n_solve['K4']} K4 launches) | refine "
          f"{t_ref:.1f} ({n_all['K1'] - n_solve['K1']} K1 launches) | "
          f"LINEAR_SOLVER_FAILED lanes before retry "
          f"{int((cs.eflag == 6).sum())}")
    torch.cuda.reset_peak_memory_stats()
    counts = launch_counter()
    (x, core), t = timed(lambda: solve_mpc_qp_batch(data, *guess, opts))
    n = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res64 = mpc_f64_residual(data, x, opts.alpha)
    good = check_contract("copoly path", x, core, res64, guess, False)
    print(f"copoly: B={B} N={COPOLY['N']} QPs/s {B / (t / 1e3):.1f} ("
          f"{t / 1e3:.3f} s) success_frac {good.mean():.4f} "
          f"residual_f64_max_success {res64[good].max():.3e} "
          f"refine_steps max {int(core.refine_steps.max())} | launches K4 "
          f"{n['K4']} K1 {n['K1']} residual {n['RR']} | peak device memory "
          f"{peak:.2f} GiB")
    if n["K4"] < 1:
        fail("copoly path did not launch K4")
    return n


# The envelope phase's shapes. The K2 corners: the first stage dims whose
# four stage blocks need more than the default 48 KB of a block, and the
# JAX package's gate corner at the longest horizon it runs its full-solve
# kernel at; K4 at the gate corner just past that horizon. (name, dims, B).
K2_CORNERS = (("nx=24 nu=8 nc=8", dict(N=10, nx=24, nu=8, nc=8), 1024),
              ("gate corner", dict(N=4, nx=32, nu=24, nc=48), 256))
K4_CORNER = ("gate corner", dict(N=17, nx=32, nu=24, nc=48), 64)
# The slice's path at full width: the spacecraft plant at _DIMS_CAP's
# horizon (bench.py plants' perturbation of x0), B lanes.
ENVELOPE_PATH = ("spacecraft_relative_motion", 160, 0.001)
ENVELOPE_NEWTON = 400


def _mpc_design(name, kernel, dims, lowmem=False):
    """design_line of K1 (kernel "riccati_step_kernel"), K2 or K4 at dims
    (a dict) in a mode."""
    info_fn, source = dict(
        riccati_step_kernel=("fb_riccati_info", "riccati.cu"),
        mpc_solve_kernel=("fb_mpc_solve_info", "mpc_solve.cu"),
        mpc_subproblem_kernel=("fb_mpc_subproblem_info",
                               "mpc_subproblem.cu"))[kernel]
    return design_line(
        name, source, info_fn, (*dims.values(), int(lowmem)),
        entry=mpc_entry(kernel, team=kernel == "riccati_step_kernel"))


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _equilibrated(data):
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    return apply_mpc_scaling(data, ruiz_mpc_scaling(data))


def _turns(fa, fb, reps=1):
    """Times fa and fb in turns (a, b, b, a; CUDA events, `reps` calls
    each, after a warm call of each): the mean ms of each."""
    fa(), fb()
    ta = [cuda_ms(fa, reps, warm=False)]
    tb = [cuda_ms(fb, reps, warm=False), cuda_ms(fb, reps, warm=False)]
    ta.append(cuda_ms(fa, reps, warm=False))
    return sum(ta) / 2, sum(tb) / 2


def envelope_path(device, B, B_turns):
    """(a): solve_mpc_qp_batch on the spacecraft plant at N = 160, B lanes
    (tier 2, K4), under Options.single_precision() with a Newton budget of
    ENVELOPE_NEWTON (the plant needs ~250 Newton steps a lane at N = 160,
    beyond the default 200): one call, timed, its launches counted, with
    its peak device memory; then the batch's first B_turns lanes' scaled
    solve on K4 and on tier 3 in turns (K4, tier 3, tier 3, K4; the first
    K4 call's launches read), and on K4 under the default budget."""
    from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
    from fbstab_tpu_torch.models.mpc_qp import (
        MPC_OPS, _solve_mpc_qp_batch_raw, mpc_dims, mpc_solve_tier,
        riccati_mode, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.scaling import (
        ruiz_mpc_scaling, solve_scaled_mpc)
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.workloads import build_plant

    name, N, pert = ENVELOPE_PATH
    opts = dataclasses.replace(Options.single_precision(),
                               max_newton_iters=ENVELOPE_NEWTON)
    o = opts.validated()
    data = build_plant(name, N, B, pert, device)
    dims = mpc_dims(data)
    guess = zeros_guess(data)
    tier = mpc_solve_tier(dims, torch.float32, device)
    mode = riccati_mode(dims, B, device)
    if tier != 2:
        fail(f"envelope: {name} N={N} routes to tier {tier}, not K4")
    torch.cuda.reset_peak_memory_stats()
    counts = launch_counter()
    (x, core), t = timed(lambda: solve_mpc_qp_batch(data, *guess, opts))
    n = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res64 = mpc_f64_residual(data, x, opts.alpha)
    good = (core.eflag == 0).cpu().numpy()
    sol = x.to_float64()
    if not (all(bool(torch.isfinite(a).all()) for a in sol)
            and tuple(sol.z.shape) == tuple(guess[0].shape)):
        fail("envelope path returned non-finite values or the wrong shape")
    if not bool(np.all(res64[good] <= CONTRACT)):
        fail("envelope path: a SUCCESS lane misses the contract")
    flags = {int(f): int(c) for f, c in zip(*np.unique(
        core.eflag.cpu().numpy(), return_counts=True))}
    print(f"envelope: {name} N={N} B={B} tier {tier}, {mode} mode, Newton "
          f"budget {ENVELOPE_NEWTON}: QPs/s {B / (t / 1e3):.1f} "
          f"({t / 1e3:.3f} s) success_frac {good.mean():.4f} exit flags "
          f"{flags} residual_f64_max_success "
          f"{res64[good].max() if good.any() else float('nan'):.3e} "
          f"residual_f64_max {res64.max():.3e} newton mean "
          f"{core.newton_iters.float().mean().item():.1f} max "
          f"{int(core.newton_iters.max())} refine_steps max "
          f"{int(core.refine_steps.max())} | launches K4 {n['K4']} K2 "
          f"{n['K2']} K1 {n['K1']} | peak device memory {peak:.2f} GiB")
    if n["K4"] < 1 or n["K1"] < 1 or n["K2"]:
        fail("envelope path did not run on K4 and K1")

    # The same lanes' scaled solve through K4 and through tier 3, in turns.
    d1 = type(data)(*(a[:B_turns] for a in data))
    g1 = zeros_guess(d1)
    scal1 = ruiz_mpc_scaling(d1)

    # Tier 3 is the lockstep core on K1 at any shape.
    solvers = {2: lambda d, z, l, v: _solve_mpc_qp_batch_raw(d, z, l, v, o),
               3: lambda d, z, l, v: fbstab_solve_batch(MPC_OPS, d, z, l, v,
                                                        o)}

    def raw(tier_):
        return timed(lambda: solve_scaled_mpc(
            solvers[tier_], d1, *g1, o, scal=scal1,
            skip_residual_rewrite=True))
    counts = launch_counter()
    (_, c4), t4 = raw(2)
    n4 = counts()
    (_, c3), t3 = raw(3)
    t3b, t4b = raw(3)[1], raw(2)[1]
    ms_k4, ms_t3 = (t4 + t4b) / 2, (t3 + t3b) / 2
    succ = {k: (c.eflag == 0).float().mean().item()
            for k, c in ((2, c4), (3, c3))}
    newton = {k: c.newton_iters.float().mean().item()
              for k, c in ((2, c4), (3, c3))}
    print(f"envelope turns: {name} N={N} B={B_turns} scaled solve (host "
          f"clock): K4 (tier 2) {ms_k4:.1f} ms ({n4['K4']} K4 launches, "
          f"{n4['K1']} K1, {n4['K2']} K2) vs tier 3 (lockstep on K1) "
          f"{ms_t3:.1f} ms; success_frac K4 {succ[2]:.4f} tier 3 "
          f"{succ[3]:.4f}; mean newton K4 {newton[2]:.1f} tier 3 "
          f"{newton[3]:.1f}")
    if n4["K4"] < 1 or n4["K1"] or n4["K2"]:
        fail("envelope: the tier-2 solve did not run on K4 alone")
    if succ[2] < succ[3]:
        fail("envelope: K4 solves fewer lanes than tier 3")
    bound_ms, bound_by = mpc_solve_bound(
        B_turns, *dims, newton[2], c4.prox_iters.float().mean().item(),
        launches=n4["K4"])
    print(f"envelope turns: K4 solve bound {bound_ms:.4f} ms ({bound_by})")
    # Why the budget: the same lanes on K4 under the default one.
    od = Options.single_precision().validated()
    (_, cd), td = timed(lambda: solve_scaled_mpc(
        lambda d, z, l, v: _solve_mpc_qp_batch_raw(d, z, l, v, od), d1, *g1,
        od, scal=scal1, skip_residual_rewrite=True))
    flags = {int(f): int(c) for f, c in zip(*np.unique(
        cd.eflag.cpu().numpy(), return_counts=True))}
    print(f"envelope: the same {B_turns} lanes on K4 under the default "
          f"Newton budget {od.max_newton_iters}: exit flags {flags}, mean "
          f"newton {cd.newton_iters.float().mean().item():.1f} "
          f"({td:.1f} ms)")
    return n, dict(B=B, qps=B / (t / 1e3), success_frac=float(good.mean()),
                   B_turns=B_turns, ms=ms_k4, tier3_ms=ms_t3,
                   bound_ms=bound_ms, bound_by=bound_by)


def envelope_plants(device, B):
    """(b): the double integrator at N = 120 and the copolymerization
    reactor at N = 85 through solve_mpc_qp_batch (both tier 2 on K4) at B
    lanes, each at the contract on SUCCESS lanes."""
    from fbstab_tpu_torch.models.mpc_qp import (
        mpc_dims, mpc_solve_tier, riccati_mode, solve_mpc_qp_batch)
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.workloads import build_plant

    opts = Options.single_precision()
    out = {}
    for tag, path, data in (
            ("double integrator N=120", "envelope_double_integrator",
             build_plant("double_integrator", 120, B, 0.05, device)),
            ("copoly N=85", "envelope_copoly",
             build_copoly(B, device, N=85))):
        dims = mpc_dims(data)
        guess = zeros_guess(data)
        solve_mpc_qp_batch(data, *guess, opts)          # warm
        counts = launch_counter()
        (x, core), t = timed(lambda: solve_mpc_qp_batch(data, *guess, opts))
        n = counts()
        res64 = mpc_f64_residual(data, x, opts.alpha)
        good = check_contract(f"envelope {tag}", x, core, res64, guess,
                              False)
        print(f"envelope: {tag} B={B} tier "
              f"{mpc_solve_tier(dims, torch.float32, device)}, "
              f"{riccati_mode(dims, B, device)} mode, QPs/s "
              f"{B / (t / 1e3):.1f} success_frac {good.mean():.4f} "
              f"residual_f64_max_success {res64[good].max():.3e} | "
              f"launches K4 {n['K4']} K2 {n['K2']} K1 {n['K1']}")
        if n["K4"] < 1:
            fail(f"envelope {tag} did not launch K4")
        out[path] = n
    return out


def envelope_lowmem(device):
    """(c): K1, K2 and K4 in the recompute-factors mode against their
    storing launch on the same inputs, bit for bit, and against their plain
    versions; std and lowmem timed in turns. Each lowmem launch that counts
    is a call of the user-facing function with lowmem=True, its counts set
    to 0 just before and read just after."""
    from fbstab_tpu_torch.models.mpc_subfused import (
        fbstab_mpc_solve_subfused)
    from fbstab_tpu_torch.ops.mpc_solve_cuda import (
        fbstab_mpc_solve_fused, fbstab_mpc_solve_plain)
    from fbstab_tpu_torch.ops.mpc_subproblem_cuda import mpc_subproblem_plain
    from fbstab_tpu_torch.ops.riccati_cuda import (
        riccati_newton_step_batched as k1, riccati_newton_step_plain)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    rows, paths = {}, {}
    rel = lambda k, p: ((k.double() - p).abs().amax(1)
                        / (1 + p.abs().amax(1))).max().item()

    # K1 at the copolymerization reactor, B = 256.
    B = 256
    data = _equilibrated(build_copoly(B, device))
    args = newton_step_args(data, opts)
    std = k1(*args)
    counts = launch_counter()
    low = k1(*args, lowmem=True)
    paths["lowmem_k1"] = counts()
    plain = riccati_newton_step_plain(*args)
    err = max(rel(low[0], plain[0]), rel(low[1], plain[1]))
    ms_std, ms_low = _turns(lambda: k1(*args), lambda: k1(*args, lowmem=True),
                            reps=5)
    plain_ms = cuda_ms(lambda: riccati_newton_step_plain(*args), 3)
    d = data
    bound_ms, bound_by = bound(
        B * riccati_flops(**COPOLY),
        nbytes(d.Q, d.R, d.S, d.A, d.B, d.E, d.L, *args[1:7], *low[:2]))
    same = _bit_equal(low[:2], std[:2])
    print(f"K1 lowmem: copoly B={B} bit-equal to the storing step {same}; "
          f"max rel err vs plain {err:.3e} (tol {K1_TOL}) | std "
          f"{ms_std:.3f} ms, lowmem {ms_low:.3f} ms (in turns), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    design = _mpc_design("K1 lowmem", "riccati_step_kernel", COPOLY, True)
    if not same or not err <= K1_TOL:
        fail("K1 lowmem disagrees with the storing step or the plain one")
    rows["K1"] = dict(max_abs_err=max((low[i] - plain[i]).abs().max().item()
                                      for i in range(2)),
                      ms=ms_low, plain_ms=plain_ms, std_ms=ms_std,
                      bound_ms=bound_ms, bound_by=bound_by, design=design)

    # K2 at the first K2 corner, B = 256; K4 on the copolymerization reactor
    # under the host outer loop, B = 256.
    name, dims, _ = K2_CORNERS[0]
    cases = (
        ("K2", "mpc_solve_kernel", dims,
         _equilibrated(build_batch(256, **dims, device=device)),
         lambda dd, g, lm: fbstab_mpc_solve_fused(dd, *g, opts, lowmem=lm),
         fbstab_mpc_solve_plain, f"{name} lowmem", 1),
        ("K4", "mpc_subproblem_kernel", COPOLY, data,
         lambda dd, g, lm: fbstab_mpc_solve_subfused(dd, *g, opts,
                                                     lowmem=lm),
         lambda *a: fbstab_mpc_solve_subfused(
             *a, subproblem=mpc_subproblem_plain),
         f"equilibrated copoly N={COPOLY['N']} lowmem", None))
    for key, kernel, kd, dd, solve, plain_solve, tag, one in cases:
        g = zeros_guess(dd)
        xs, cs = solve(dd, g, False)
        counts = launch_counter()
        xl, cl = solve(dd, g, True)
        paths[f"lowmem_{key.lower()}"] = n = counts()
        same = (_bit_equal(xl, xs) and _bit_equal(
            (cl.eflag, cl.newton_iters, cl.prox_iters, cl.residual),
            (cs.eflag, cs.newton_iters, cs.prox_iters, cs.residual)))
        ck, max_abs, ms, plain_ms, _ = compare_solver(
            f"{key} lowmem", lambda dd_, *a: solve(dd_, a[:3], True),
            plain_solve, dd, g, opts, tag, reps=None)
        ms_std, ms_low = _turns(lambda: solve(dd, g, False),
                                lambda: solve(dd, g, True))
        launches = one or max(n[f"{key}_lowmem"], 1)
        bound_ms, bound_by = mpc_solve_bound(
            dd.x0.shape[0], *kd.values(),
            ck.newton_iters.float().mean().item(),
            ck.prox_iters.float().mean().item(), launches=launches)
        print(f"{key} lowmem: {tag} B={dd.x0.shape[0]} bit-equal to the "
              f"standard launch {same} | std {ms_std:.1f} ms, lowmem "
              f"{ms_low:.1f} ms (in turns), bound {bound_ms:.4f} ms "
              f"({bound_by}) | launches {n[key + '_lowmem']} lowmem, "
              f"{n[key]} standard")
        design = _mpc_design(f"{key} lowmem", kernel, kd, True)
        if not same:
            fail(f"{key} lowmem is not bit-equal to its standard launch")
        if n[f"{key}_lowmem"] < 1 or n[key]:
            fail(f"{key} lowmem path did not launch the lowmem kernel alone")
        rows[key] = dict(max_abs_err=max_abs, ms=ms_low, plain_ms=plain_ms,
                         std_ms=ms_std, bound_ms=bound_ms, bound_by=bound_by,
                         design=design)
    return rows, paths


def envelope_corners(device):
    """(d): K2 against its plain version at the K2 corners and K4 at the
    gate corner, each with its design line; and the named error of a
    launch whose scratch the card cannot give."""
    from fbstab_tpu_torch.models.mpc_subfused import (
        fbstab_mpc_solve_subfused)
    from fbstab_tpu_torch.ops._build import KernelResourceError
    from fbstab_tpu_torch.ops.mpc_solve_cuda import (
        fbstab_mpc_solve_fused, fbstab_mpc_solve_plain)
    from fbstab_tpu_torch.ops.mpc_subproblem_cuda import mpc_subproblem_plain
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    shapes = {}
    corners = [("K2", name, dims, B, fbstab_mpc_solve_fused,
                fbstab_mpc_solve_plain, "mpc_solve_kernel")
               for name, dims, B in K2_CORNERS]
    name, dims, B = K4_CORNER
    corners.append(("K4", name, dims, B, fbstab_mpc_solve_subfused,
                    lambda *a: fbstab_mpc_solve_subfused(
                        *a, subproblem=mpc_subproblem_plain),
                    "mpc_subproblem_kernel"))
    for key, name, dims, B, kernel, plain, entry in corners:
        data = _equilibrated(build_batch(B, **dims, device=device))
        guess = zeros_guess(data)
        n0 = launch_counter()
        ck, max_abs, ms, plain_ms, _ = compare_solver(
            key, kernel, plain, data, guess, opts,
            f"{name} N={dims['N']} nx={dims['nx']} nu={dims['nu']} "
            f"nc={dims['nc']}", reps=None)
        launches = n0()[key] if key == "K4" else 1
        bound_ms, bound_by = mpc_solve_bound(
            B, *dims.values(), ck.newton_iters.float().mean().item(),
            ck.prox_iters.float().mean().item(), launches=launches)
        print(f"{key}: {name} bound {bound_ms:.4f} ms ({bound_by})")
        design = _mpc_design(key, entry, dims)
        shapes[f"{key} {name} B={B}"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, design=design)

    # Scratch beyond the card: 2^22 lanes of the copolymerization reactor
    # (views of one lane, nothing allocated) raise before any launch.
    one = build_copoly(1, device)
    big = 1 << 22
    wide = lambda t: t.expand(big, *t.shape[1:])
    data = type(one)(*(wide(a) for a in one))
    guess = tuple(wide(t) for t in zeros_guess(one))
    try:
        fbstab_mpc_solve_fused(data, *guess, opts)
    except KernelResourceError as e:
        print(f"envelope: K2 at B={big} raises KernelResourceError: {e}")
    else:
        fail("envelope: K2 past the card's memory did not raise")
    return shapes


def phase_envelope(device, B=8192, B_turns=1024, B_plants=2048):
    """Phase 17, the JAX package's kernel envelope on the card: (a) the
    spacecraft path at N = 160 on K4, (b) two more tier-2 plants, (c) the
    recompute-factors launches of K1, K2 and K4 bit for bit their storing
    ones, (d) K2 and K4 at the corners of the envelope. Returns the paths'
    launch counts and the rows for the kernel line."""
    n_path, path_row = envelope_path(device, B, B_turns)
    paths = dict(envelope_spacecraft=n_path)
    paths.update(envelope_plants(device, B_plants))
    lowmem_rows, lowmem_paths = envelope_lowmem(device)
    paths.update(lowmem_paths)
    corners = envelope_corners(device)
    print(json.dumps({"envelope": dict(path=path_row, corners=corners)}))
    return paths, lowmem_rows, dict(path_row, corners=corners)


def phase_longhorizon(device, Ns=(120, 240, 480), reps=5):
    """bench.py longhorizon on the card: solve_mpc_qp on the double
    integrator in float32 with both Riccati steps, in turns (scan, assoc)
    so that both see the same host, best of `reps` after a warm turn, at
    each N; both must succeed. Launches are counted over the last N's
    calls. Returns the counts and the smallest N from which the assoc
    solve was the faster at that N and every larger one (None if at
    none)."""
    from fbstab_tpu_torch.models.mpc_qp import mpc_dims, solve_mpc_qp
    from fbstab_tpu_torch.models.ocp_fixtures import double_integrator
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    parts, assoc_wins = [], []
    for N in Ns:
        data, _ = double_integrator(N, dtype=torch.float32, device=device)
        _, nx, nu, nc = mpc_dims(data)
        z = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
        guess = (z((N + 1) * (nx + nu)), z((N + 1) * nx), z((N + 1) * nc))
        counts = launch_counter()
        times = dict(scan=[], assoc=[])
        for i in range(reps + 1):
            fresh = data._replace(x0=data.x0 + 1e-6 * i)
            for mode in times:
                (x, core), ms = timed(lambda: solve_mpc_qp(
                    fresh, *guess, opts, riccati=mode))
                if int(core.eflag) != 0:
                    fail(f"longhorizon N={N} {mode}: eflag "
                         f"{int(core.eflag)}")
                if i:
                    times[mode].append(ms)
        best = {mode: min(t) for mode, t in times.items()}
        n = counts()
        assoc_wins.append(best["assoc"] < best["scan"])
        parts.append(f"N={N} scan {best['scan']:.1f} ms assoc "
                     f"{best['assoc']:.1f} ms (scan/assoc "
                     f"{best['scan'] / best['assoc']:.3f})")
    print("longhorizon: best of %d, " % reps + "; ".join(parts)
          + f" | launches at N={Ns[-1]}: K5 {n['K5']} K1 {n['K1']}")
    if n["K5"] < 1:
        fail("longhorizon assoc did not launch K5")
    crossover = None
    for N, wins in zip(reversed(Ns), reversed(assoc_wins)):
        if not wins:
            break
        crossover = N
    return n, crossover


def phase_assoc_batch(B, device):
    """solve_mpc_qp_batch(..., riccati="assoc") on the copoly batch."""
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_copoly(B, device)
    guess = zeros_guess(data)
    counts = launch_counter()
    (x, core), t = timed(lambda: solve_mpc_qp_batch(data, *guess, opts,
                                                    riccati="assoc"))
    n = counts()
    res64 = mpc_f64_residual(data, x, opts.alpha)
    good = check_contract("batched assoc", x, core, res64, guess, False)
    print(f"assoc batch: copoly B={B} {t / 1e3:.3f} s ({B / (t / 1e3):.1f} "
          f"QPs/s, one call) success_frac {good.mean():.4f} "
          f"residual_f64_max_success {res64[good].max():.3e} | launches K5 "
          f"{n['K5']} K1 {n['K1']}")
    if n["K5"] < 1:
        fail("batched assoc did not launch K5")
    return n


# P1's CUDA-core forms are compiled for each n, the tensor-core form for
# each number of n-tiles: beside the probe's n = 18 they are held at a
# stage that the rows a thread holds do not divide (one n-tile, mostly
# padding) and at the cap (four full n-tiles), on a ragged lane count.
P1_OTHER_SHAPES = ((5, 40), (32, 40))


def phase_p1(device):
    """P1, the stage-matvec probe: the bench's mxu mode (its path, whose
    launches are counted), then each form against its plain version at
    T = 1 and 8 (the iterate underflows to zero long before the probe's
    T = 200), the times at T = 200, the library calls, the bounds and the
    design line; every form also at P1_OTHER_SHAPES."""
    from fbstab_tpu_torch import bench
    from fbstab_tpu_torch.ops import mxu_probe_cuda as p1

    counts = launch_counter()
    record, diag = bench.run_mxu(device=device)
    n = counts()
    print(f"P1: {diag}")
    T, N1, n_, B = p1.T_DEFAULT, p1.N1, p1.N_STAGE, p1.LANES
    scale = p1.scale_of(n_)
    Mp, Ms, w0 = p1.probe_inputs(N1, n_, B, device)
    mats = dict(perlane=Mp, shared=Ms)
    plain = dict(perlane=p1.perlane_plain, shared=p1.shared_plain)
    rows, ok = {}, True

    def against_plain(kernel, kind, M, w0, n_, scale):
        errs, max_abs, good = [], 0.0, True
        for t in (1, 8):
            got = kernel(M, w0, t, scale)
            want = plain[kind](M, w0, t, scale)
            want64 = plain[kind](M.double(), w0.double(), t, scale)
            peak = want.abs().max().item()
            err = (got - want).abs().max().item() / peak
            gap = (want.double() - want64).abs().max().item() / peak
            tol = (p1.tc_tol(t, n_, gap) if kernel is p1.tc_shared
                   else p1.CUDA_CORE_TOL)
            max_abs = max(max_abs, (got - want).abs().max().item())
            errs.append(f"T={t} {err:.3e} (tol {tol:.3e}; float32 plain vs "
                        f"float64 {gap:.3e})")
            good = good and bool(np.isfinite(err)) and err <= tol
        return errs, max_abs, good

    for form, (name, kernel, kind) in enumerate(bench.mxu_forms()):
        design = p1_design_line(form, n_, N1, B)
        M = mats[kind]
        errs, max_abs, good = against_plain(kernel, kind, M, w0, n_, scale)
        ok = ok and good
        for n_o, B_o in P1_OTHER_SHAPES:
            Mp_o, Ms_o, w0_o = p1.probe_inputs(N1, n_o, B_o, device)
            e_o, _, good = against_plain(
                kernel, kind, Mp_o if kind == "perlane" else Ms_o, w0_o,
                n_o, p1.scale_of(n_o))
            ok = ok and good
            print(f"P1 {name} ({kernel.__name__}) at n={n_o} B={B_o}: "
                  f"vs plain " + "; ".join(e_o))
        ms = cuda_ms(lambda: kernel(M, w0, T, scale), 5)
        device_ms = graph_ms(lambda: kernel(M, w0, T, scale))
        plain_ms = cuda_ms(lambda: plain[kind](M, w0, T, scale), 3)
        flops = stage_matvec_flops(N1, n_, B, T)
        moved = nbytes(M, w0, w0)
        bound_ms, bound_by = bound(
            flops, moved, PEAK_TF32_FLOPS if kernel is p1.tc_shared
            else PEAK_F32_FLOPS)
        f32_bound_ms, _ = bound(flops, moved)
        # The library time: one PyTorch call per application, on M with
        # the scale folded in (einsum per lane, bmm shared).
        Mscaled = M * scale
        w3 = w0.reshape(N1, n_, B)
        call = ((lambda w: torch.einsum("sijb,sjb->sib", Mscaled, w))
                if kind == "perlane" else (lambda w: torch.bmm(Mscaled, w)))

        def chain():
            w = w3
            for _ in range(T):
                w = call(w)
            return w
        lib = {"einsum" if kind == "perlane" else "bmm": chain}
        lib_ms = {}
        for tf32 in (False, True) if kind == "shared" else (False,):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for k, fn in lib.items():
                lib_ms[k + (" tf32" if tf32 else "")] = cuda_ms(fn, 3)
        torch.backends.cuda.matmul.allow_tf32 = False
        library_ms = (lib_ms["bmm tf32"] if kernel is p1.tc_shared
                      else next(iter(lib_ms.values())))
        print(f"P1 {name} ({kernel.__name__}): vs plain "
              + "; ".join(errs) + f" | T={T}: kernel {ms:.4f} ms (5 "
              f"wrapper calls), on the device {device_ms:.4f} ms (CUDA graph "
              f"of 20 launches, 10 replays), "
              f"{record[name + '_ns']} ns per stage-matvec (host clock), "
              f"plain {plain_ms:.3f} ms, library " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in lib_ms.items())
              + f", bound {bound_ms:.4f} ms ({bound_by}"
              + (f"; TF32 tensor peak; {f32_bound_ms:.4f} ms at the float32 "
                 "peak" if kernel is p1.tc_shared else "") + ")")
        rows[kernel.__name__] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, design=design,
            device_ms=device_ms)
    if not ok:
        fail("a P1 form disagrees with its plain version")
    if min(n["P1_perlane"], n["P1_shared"], n["P1_tc"]) < 1:
        fail("the bench's mxu mode did not launch the three P1 kernels")
    return rows, n


def phase_p3(device):
    """P3, the double-float probe: the probe tool's run (its path, whose
    launch is counted), bit equality with the plain version, exactness
    against float64, the wrapper's time (20 calls back to back), the
    kernel's device time apart from the host (20 launches on buffers made
    once, captured into a CUDA graph, replayed 10 times between CUDA
    events) beside the card's launch floor timed the same way, and the
    contraction question: the same
    source built with plain operators, run and its SASS read for FFMA."""
    from fbstab_tpu_torch.ops import df_probe_cuda as p3
    from fbstab_tpu_torch.ops._build import library_path, load_library
    from fbstab_tpu_torch.tools import df_probe as tool

    counts = launch_counter()
    verdict = tool.probe(device)
    n = counts()
    a, b = p3.probe_inputs(device)
    got = p3.df_probe(a, b)
    want = p3.df_probe_plain(a, b)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    max_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
    plain_lib, plain_path = p3.plain_ops_library()
    v_plain = p3.exactness(a, b, p3.launch_df_probe(plain_lib, a, b))
    ffma = p3.sass_ffma_count(library_path())
    ffma_plain = p3.sass_ffma_count(plain_path)
    lib, out = load_library(), p3.df_probe_outputs(a)
    launch = lambda: p3.launch_df_probe(lib, a, b, out)
    ms = cuda_ms(lambda: p3.df_probe(a, b), 20)
    device_ms = graph_ms(launch)
    floor_ms = launch_floor_ms(a.device)
    plain_ms = cuda_ms(lambda: p3.df_probe_plain(a, b), 5)
    R, C = a.shape
    # two_sum 6 and two_prod 17 operations per element, and the dot step's
    # 14 on two_prod's pair.
    bound_ms, bound_by = bound(37 * R * C, nbytes(a, b, *got))
    fmt = lambda v: (f"two_sum exact: {v['two_sum_exact']}  two_prod exact: "
                     f"{v['two_prod_exact']}  dot df rel err: "
                     f"{v['dot_rel_err']:.2e} (plain f32: "
                     f"{v['f32_dot_rel_err']:.2e})")
    print(f"P3: [cuda] {fmt(verdict)} | bit-equal to the plain version: "
          f"{same} | kernel {ms:.4f} ms (20 wrapper calls), on the device "
          f"{device_ms:.4f} ms a launch (CUDA graph of 20 launches, 10 "
          f"replays), launch floor {floor_ms:.4f} ms (a one-element add_ "
          f"the same way), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    print(f"P3 contraction: intrinsics (the library): FFMA in the kernel's "
          f"SASS {ffma}; plain operators with the library's flags: FFMA "
          f"{ffma_plain}, {fmt(v_plain)}")
    if not (same and verdict["two_sum_exact"] and verdict["two_prod_exact"]):
        fail("P3 is not exact or not bit-equal to its plain version")
    if n["P3"] < 1:
        fail("the probe tool did not launch P3")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=device_ms, floor_ms=floor_ms), n


def phase_warmstart(B, device, steps=8):
    """bench.py warmstart's sweep: simulate_batch on the headline plant
    (lane 0 of the batch) for B scenarios and `steps` control steps with
    shifted warmstarts, through the one-shot dispatch (K2, then K1 in the
    refinement). Every step needs success >= 0.99 and the refined residual
    <= 1e-6 on its SUCCESS lanes. Also times the part of a step that
    relays the shared data (the Ruiz diagonals applied to the expanded
    plant, which K2 then reads as it is), which every step repeats."""
    from fbstab_tpu_torch.models.mpc_qp import MpcQPData
    from fbstab_tpu_torch.models.receding_horizon import simulate_batch
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    dataB = build_batch(B, **HEADLINE, device=device)
    shared = MpcQPData(*(a[:1] for a in dataB))
    counts = launch_counter()
    res, t = timed(lambda: simulate_batch(shared, steps, dataB.x0, opts))
    n = counts()
    good = res.eflag == 0
    succ = good.float().mean(0)
    worst = torch.where(good, res.residual,
                        torch.zeros_like(res.residual)).amax(0)
    ni = res.newton_iters.float()
    batch = MpcQPData(*(a.expand((B,) + a.shape[1:]) for a in shared))
    one = ruiz_mpc_scaling(shared)
    scal = type(one)(*(a.expand((B,) + a.shape[1:]) for a in one))
    relay = lambda: [a.contiguous() for a in apply_mpc_scaling(batch, scal)]
    relay()
    _, t_relay = timed(relay)
    print(f"warmstart: B={B} steps={steps} QPs/s {B * steps / (t / 1e3):.1f}"
          f" ({t / 1e3:.3f} s, one call) success per step min "
          f"{succ.min().item():.4f} | refined residual on SUCCESS lanes max "
          f"{worst.max().item():.3e} | mean newton step 0 "
          f"{ni[:, 0].mean().item():.2f}, steps 1-{steps - 1} "
          f"{ni[:, 1:].mean().item():.2f} | launches K2 {n['K2']} K1 "
          f"{n['K1']} | per-step relay of the shared data {t_relay:.2f} ms")
    if succ.min().item() < 0.99 or worst.max().item() > CONTRACT:
        fail("the warmstart sweep misses the contract")
    if n["K2"] < 1 or n["K1"] < 1:
        fail("the warmstart sweep did not launch K1 and K2")
    return n


# The differentiable layer. float32 gradients (sigma_vjp = 1e-5) against
# a float64 solve and backward at the same sigma_vjp on SUCCESS lanes:
# |g32 - g64| <= DIFF_RTOL |g64| + DIFF_ATOL max |g64| per field. That is
# the float32 pin of tests/test_diff.py (rtol 5e-3, atol 5e-4 on gradients
# of order one) with its atol scaled to the field's largest gradient (the
# headline's reach 1e2) and raised to the float32 floor of the backward:
# Gamma = gamma / mus ~ 1 / sigma_vjp = 1e5 on active rows, so the float32
# Newton solve carries ~1e5 x 6e-8 relative error there (on an H100 80GB
# HBM3, 700 W: 1.2e-3 of the field's largest gradient, on q). The pin
# taken literally (absolute atol 5e-4) is printed beside the gate as a
# reading. What the gate must reject (PERF.md): a 1% error in K1's dz,
# and the regularization bias against float64 at its default
# sigma_vjp = 1e-9 (up to 2% of a field's largest gradient). K1's
# backward against the plain Newton step's, both float32:
# max |g_K1 - g_plain| <= DIFF_K1_TOL (1 + max |g_plain|) per field
# (measured 2.2e-3: the same float32 floor, met by two implementations).
DIFF_RTOL, DIFF_ATOL = 5e-3, 2.5e-3
DIFF_K1_TOL = 5e-3
# The feedback gain: float64 against central differences
# (tests/test_diff.py:274-303), float32 against float64:
# max |K32 - K64| <= GAIN_F32_TOL (1 + max |K64|) (on an H100 80GB HBM3,
# 700 W: 1.3e-3 on the lane with all three first inputs inside their box,
# |K| up to 1.68).
GAIN_FD_RTOL, GAIN_FD_ATOL = 1e-4, 1e-6
GAIN_F32_TOL = 5e-3


def _leaves(data):
    """A copy of `data` whose fields are leaves that require grad."""
    return type(data)(*(a.detach().clone().requires_grad_() for a in data))


def diff_grads(solve, data, guess):
    """(gradients by field, z, forward s, backward s, forward launches,
    backward launches) of 0.5 |z|^2 through solve(data, *guess)."""
    leaves = _leaves(data)
    counts = launch_counter()
    (z, _, _), t_fwd = timed(lambda: solve(leaves, *guess))
    n_fwd = counts()
    counts = launch_counter()
    _, t_bwd = timed(lambda: (0.5 * (z * z).sum()).backward())
    n_bwd = counts()
    grads = {k: a.grad for k, a in zip(data._fields, leaves)}
    return grads, z, t_fwd / 1e3, t_bwd / 1e3, n_fwd, n_bwd


def _grad_gap(got, want, good):
    """Per field on the `good` lanes: (violations of |got - want| <=
    DIFF_RTOL |want| + DIFF_ATOL max |want|, max |got - want| / max
    |want|)."""
    viol, rel = {}, {}
    for k, w in want.items():
        a, w = got[k][good].double(), w[good].double()
        scale = w.abs().max().clamp(min=1e-30)
        gap = (a - w).abs()
        viol[k] = int((gap > DIFF_RTOL * w.abs() + DIFF_ATOL * scale).sum())
        rel[k] = (gap.max() / scale).item()
    return viol, rel


def _abs_tol_violations(got, want, good):
    """Per field on the `good` lanes: violations of tests/test_diff.py's
    float32 pin taken literally, |got - want| <= 5e-3 |want| + 5e-4 (a
    reading beside the gate: see DIFF_ATOL)."""
    return {k: int(((got[k][good].double() - w[good].double()).abs()
                    > 5e-3 * w[good].double().abs() + 5e-4).sum())
            for k, w in want.items()}


def phase_diff(B, device):
    from fbstab_tpu_torch.diff import (
        make_differentiable_batch_solver, solve_mpc_qp_batch_diff)
    from fbstab_tpu_torch.models.mpc_qp import (
        MPC_PLAIN_OPS, solve_mpc_qp_batch)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    data = build_batch(B, **HEADLINE, device=device)
    guess = zeros_guess(data)
    solve = lambda d, *g: solve_mpc_qp_batch_diff(d, *g, opts, 1e-5)
    diff_grads(solve, data, guess)          # warm
    g32, _, t_fwd, t_bwd, n_fwd, n_bwd = diff_grads(solve, data, guess)
    (_, core32), _ = timed(lambda: solve_mpc_qp_batch(data, *guess, opts))
    plain = make_differentiable_batch_solver(
        MPC_PLAIN_OPS, solve_mpc_qp_batch, opts, 1e-5)
    gp, _, _, t_bwd_plain, _, _ = diff_grads(plain, data, guess)

    data64 = build_batch(B, **HEADLINE, device=device, dtype=torch.float64)
    guess64 = zeros_guess(data64)
    opts64 = Options(abs_tol=1e-10)
    g64, _, t_fwd64, t_bwd64, _, _ = diff_grads(
        lambda d, *g: solve_mpc_qp_batch_diff(d, *g, opts64, 1e-5), data64,
        guess64)
    (_, core64), _ = timed(lambda: solve_mpc_qp_batch(data64, *guess64,
                                                      opts64))
    good = (core32.eflag == 0) & (core64.eflag == 0)
    finite = all(bool(torch.isfinite(g).all()) for g in g32.values())
    k1_err = {k: ((g32[k] - gp[k]).abs().max()
                  / (1 + gp[k].abs().max())).item() for k in g32}
    viol, rel = _grad_gap(g32, g64, good)
    viol_abs = _abs_tol_violations(g32, g64, good)
    print(json.dumps({"diff": dict(
        B=B, forward_s=t_fwd, backward_s=t_bwd,
        grads_per_s=B / (t_fwd + t_bwd), backward_plain_s=t_bwd_plain,
        forward_f64_s=t_fwd64, backward_f64_s=t_bwd64,
        launches_forward=n_fwd, launches_backward=n_bwd, finite=finite,
        success_lanes_both=int(good.sum()),
        k1_vs_plain_max_rel=max(k1_err.values()), k1_tol=DIFF_K1_TOL,
        f32_vs_f64_violations=viol, f32_vs_f64_max_rel=rel,
        rtol=DIFF_RTOL, atol_times_max=DIFF_ATOL,
        f32_vs_f64_violations_at_test_diff_tol=viol_abs)}))
    if not finite:
        fail("diff: a float32 gradient is not finite")
    if n_fwd["K2"] < 1 or n_bwd["K1"] != 1 or n_bwd["K2"] != 0:
        fail("diff: the forward did not launch K2, or the backward was not "
             "exactly one K1 launch")
    if max(k1_err.values()) > DIFF_K1_TOL:
        fail("diff: K1's backward disagrees with the plain Newton step's")
    if good.float().mean().item() < 0.99 or any(viol.values()):
        fail("diff: float32 gradients miss float64's on SUCCESS lanes")
    return {f"diff_{k}": v for k, v in (("forward", n_fwd),
                                        ("backward", n_bwd))}


def _fd_gain(one64, opts64, eps=1e-6):
    """Central differences of u0*(x0) on a float64 instance: the 2 nx
    perturbed problems as lanes of one lockstep solve of the core (lanes
    are independent, so each is solve_mpc_qp's result)."""
    from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, batch_data
    nx, nu = HEADLINE["nx"], HEADLINE["nu"]
    eye = torch.eye(nx, dtype=torch.float64, device=one64.x0.device)
    x0 = torch.cat([one64.x0 + eps * eye, one64.x0 - eps * eye])
    lanes = batch_data(one64, 2 * nx)._replace(x0=x0)
    x, core = fbstab_solve_batch(MPC_OPS, lanes, *zeros_guess(lanes), opts64)
    if not bool((core.eflag == 0).all()):
        fail("feedback_gain: a finite-difference solve failed")
    u0 = x.z[:, nx:nx + nu]
    return ((u0[:nx] - u0[nx:]) / (2 * eps)).T


def phase_feedback_gain(B, device):
    from fbstab_tpu_torch.core.algorithm import fbstab_solve_batch
    from fbstab_tpu_torch.diff import mpc_feedback_gain
    from fbstab_tpu_torch.models.mpc_qp import (
        MPC_OPS, exact_f32_matmul, solve_mpc_qp_batch)
    from fbstab_tpu_torch.options import Options

    opts, opts64 = Options.single_precision(), Options(abs_tol=1e-11)
    nx, nu = HEADLINE["nx"], HEADLINE["nu"]
    data = build_batch(B, **HEADLINE, device=device)
    data64 = build_batch(B, **HEADLINE, device=device, dtype=torch.float64)
    # Lane 0, and the first lane with the most inputs strictly inside
    # their box at stage 0 (a saturated input has a zero row of K).
    head = type(data64)(*(a[:64] for a in data64))
    x, _ = solve_mpc_qp_batch(head, *zeros_guess(head), opts64)
    inside = (x.z[:, nx:nx + nu].abs() < 1 - 1e-3).sum(1)
    lanes = (0, int(torch.argmax(inside)))
    rows = []
    for lane in lanes:
        pick = lambda d: type(d)(*(a[lane:lane + 1].contiguous() for a in d))
        one, one64 = pick(data), pick(data64)
        exact_f32_matmul(one.x0)
        counts = launch_counter()
        _, core = fbstab_solve_batch(MPC_OPS, one, *zeros_guess(one), opts)
        n_solve = counts()["K1"]
        counts = launch_counter()
        K32, t32 = timed(lambda: mpc_feedback_gain(one, opts))
        gain_counts = counts()
        n_gain = gain_counts["K1"]
        if lane == lanes[0]:
            lane0_counts = gain_counts
        K64, t64 = timed(lambda: mpc_feedback_gain(one64, opts64))
        FD = _fd_gain(one64, opts64)
        fd_ok = bool(torch.all((K64 - FD).abs()
                               <= GAIN_FD_ATOL + GAIN_FD_RTOL * FD.abs()))
        rel32 = ((K32.double() - K64).abs().max()
                 / (1 + K64.abs().max())).item()
        rows.append(dict(
            lane=lane, shape=list(K32.shape),
            inputs_inside=int(inside[lane]),
            f32_solve_eflag=int(core.eflag[0]), f32_ms=t32, f64_ms=t64,
            max_abs_K64=K64.abs().max().item(),
            zero_rows_K64=int((K64.abs().amax(1) < 1e-6).sum()),
            f32_vs_f64_max_rel=rel32, f32_tol=GAIN_F32_TOL,
            f64_vs_fd_max_abs=(K64 - FD).abs().max().item(),
            fd_rtol=GAIN_FD_RTOL, fd_atol=GAIN_FD_ATOL, fd_ok=fd_ok,
            k1_launches_solve=n_solve, k1_launches_gain=n_gain))
        if (tuple(K32.shape) != (nu, nx)
                or not bool(torch.isfinite(K32).all())):
            fail("feedback_gain: not a finite (nu, nx) gain")
        if n_gain != n_solve + 1:
            fail("feedback_gain: the tangents were not one K1 launch")
        if not fd_ok or rel32 > GAIN_F32_TOL:
            fail("feedback_gain: the gain misses float64 or the "
                 "differences")
    print(json.dumps({"feedback_gain": rows}))
    return {"feedback_gain": lane0_counts}


def _host_stats(out):
    """BatchStats as the host computes them from a SolverOut."""
    ef = out.eflag.cpu().numpy()
    res = out.residual.double().cpu().numpy()
    ni = out.newton_iters.cpu().numpy()
    inf = (ef >= 3) & (ef <= 5)
    return dict(num_instances=ef.size, num_success=int((ef == 0).sum()),
                num_infeasible=int(inf.sum()),
                num_failed=int(ef.size - (ef == 0).sum() - inf.sum()),
                max_residual=res.max(), mean_residual=res.mean(),
                total_newton_iters=int(ni.sum()),
                max_newton_iters=int(ni.max()))


def _check_stats(tag, stats, out):
    host = _host_stats(out)
    for k, want in host.items():
        got = getattr(stats, k).item()
        same = (np.isclose(got, want, rtol=1e-5, atol=0)
                if isinstance(want, float) else got == want)
        if not same:
            fail(f"{tag}: BatchStats.{k} {got} != the host's {want}")


def _next_state(data, x):
    """Each lane's next initial state under the first input of its
    solution: x0+ = A(0) x0 + B(0) u0 + c(0)."""
    nx, nu = data.A.shape[-1], data.B.shape[-1]
    z = x.hi().z if hasattr(x, "hi") else x.z
    u0 = z[:, nx:nx + nu].to(data.x0.dtype)
    return (torch.einsum("bij,bj->bi", data.A[:, 0], data.x0)
            + torch.einsum("bij,bj->bi", data.B[:, 0], u0) + data.c[:, 0])


def phase_facade(B, Bd, device):
    import dataclasses

    from fbstab_tpu_torch.models.batch_facade import (
        FBstabDenseBatch, FBstabMpcBatch)
    from fbstab_tpu_torch.options import Display, Options
    from fbstab_tpu_torch.utils.printing import OutputStream

    data = build_batch(B, **HEADLINE, device=device)
    alpha = Options.single_precision().alpha
    rows, paths = [], {}

    def call(tag, solver, d):
        counts = launch_counter()
        x, out, stats = solver.solve(d)
        n = counts()
        res64 = mpc_f64_residual(d, x, alpha)
        _check_stats(tag, stats, out)
        qps = B / out.solve_time.item()
        rows.append(dict(call=tag, B=B, qps=qps, s=out.solve_time.item(),
                         residual_f64_max=float(res64.max()),
                         success=int(stats.num_success),
                         mean_newton=out.newton_iters.float().mean().item(),
                         launches=n))
        if not bool(np.all(res64 <= CONTRACT)):
            fail(f"facade: {tag} misses the 1e-6 contract on some lane")
        if n["K2"] < 1 or n["K1"] < 1:
            fail(f"facade: {tag} did not launch K2 and K1")
        paths[tag] = n
        return x

    mpc = FBstabMpcBatch(B, **HEADLINE, device=device)
    x = call("mpc", mpc, data)
    data2 = data._replace(x0=_next_state(data, x))
    call("mpc_next_step", mpc, data2)
    ada = FBstabMpcBatch(B, **HEADLINE, adaptive=True, device=device)
    call("mpc_adaptive", ada, data)
    paths.update(phase_refine_unrolled(data, device))

    class Capture(OutputStream):
        def __init__(self):
            self.buf = []

        def print(self, msg):
            self.buf.append(msg)

    dense = build_dense(Bd, DENSE["n"], DENSE["q"], 0, device)
    solver = FBstabDenseBatch(Bd, DENSE["n"], 0, DENSE["q"], device=device)
    solver.update_options(dataclasses.replace(
        Options.single_precision(), display_level=Display.FINAL))
    sink = Capture()
    counts = launch_counter()
    xd, outd, statsd = solver.solve(dense, stream=sink)
    n = counts()
    paths["dense"] = n
    _check_stats("dense", statsd, outd)
    good = (outd.eflag == 0).cpu().numpy()
    res64 = dense_f64_residual(dense, xd, alpha)
    text = "".join(sink.buf)
    rows.append(dict(call="dense", B=Bd, qps=Bd / outd.solve_time.item(),
                     s=outd.solve_time.item(), success=int(good.sum()),
                     residual_f64_max_success=float(res64[good].max()),
                     launches=n, summary=text.strip().splitlines()[0]))
    print(json.dumps({"facade": rows}))
    if n["K3"] < 1:
        fail("facade: FBstabDenseBatch did not launch K3")
    if good.mean() < 0.99 or not bool(np.all(res64[good] <= CONTRACT)):
        fail("facade: FBstabDenseBatch misses the contract")
    if f"Batch optimization completed!  {Bd} instances" not in text:
        fail("facade: the FINAL summary did not reach the stream")
    return {f"facade_{k}": v for k, v in paths.items()}


def phase_refine_unrolled(data, device, steps=3):
    """refine_mpc_batch (the unrolled polish, one K1 launch a step) on the
    raw float32 solution of the equilibrated headline problem."""
    import dataclasses

    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.models.refine import refine_mpc_batch
    from fbstab_tpu_torch.models.scaling import (
        equilibrate_mpc, scale_mpc_variable, unscale_mpc_variable_df)
    from fbstab_tpu_torch.options import Options

    opts = Options.single_precision()
    x, _ = solve_mpc_qp_batch(data, *zeros_guess(data),
                              dataclasses.replace(opts, refine_steps=0))
    sdata, scal = equilibrate_mpc(data)
    counts = launch_counter()
    (refined, hist), ms = timed(lambda: refine_mpc_batch(
        sdata, scale_mpc_variable(x, scal), opts, steps=steps))
    n = counts()
    res64 = mpc_f64_residual(data, unscale_mpc_variable_df(refined, scal),
                             opts.alpha)
    print(json.dumps({"refine_mpc_batch": dict(
        B=data.x0.shape[0], steps=steps, ms=ms,
        history_max=[h.max().item() for h in hist],
        residual_f64_raw_max=float(mpc_f64_residual(data, x, opts.alpha)
                                   .max()),
        residual_f64_max=float(res64.max()), launches=n)}))
    if n["K1"] != steps:
        fail("refine_mpc_batch: not one K1 launch a step")
    if not bool(np.all(np.isfinite(res64))):
        fail("refine_mpc_batch: non-finite refined point")
    if not bool(torch.all((hist[-1] <= CONTRACT) & (hist[-1] <= hist[0]))):
        fail("refine_mpc_batch: the polish left a lane above the contract "
             "or above its entry residual")
    if not bool(np.all(res64 <= CONTRACT)):
        fail("refine_mpc_batch: a refined lane misses the contract in "
             "host float64")
    return {"refine_mpc_batch": n}


def phase_sparse(device, B=32, B_mpc=256, B_diff=8):
    import dataclasses
    import functools

    from fbstab_tpu_torch.diff import (
        make_differentiable_batch_solver, solve_sparse_qp_diff)
    from fbstab_tpu_torch.models.dense_qp import dense_qp_data, solve_dense_qp
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.models.sparse_qp import (
        SparseQPData, mpc_sparse_pattern, mpc_sparse_values,
        solve_sparse_qp_batch)
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.tools.profile_paths import device_busy
    from fbstab_tpu_torch.workloads import (
        SPARSE, sparse_arrays, sparse_batch, sparse_f64_residual)

    f64 = torch.float64
    opts = Options(abs_tol=1e-8)
    zeros = lambda pat, n, dev=device: tuple(
        torch.zeros(n, k, dtype=f64, device=dev)
        for k in (pat.nz, pat.nl, pat.nv))

    # 1. bench.py sparse's batch.
    pat, data = sparse_batch(B, device, **SPARSE)
    guess = zeros(pat, B)
    solve = lambda: solve_sparse_qp_batch(pat, data, *guess, opts)
    solve()
    pat.split.reset()
    counts = launch_counter()
    (x, core), ms = timed(solve)
    n_bench = counts()
    split = dataclasses.asdict(pat.split)
    res64 = sparse_f64_residual(pat, data, x, opts.alpha)
    good = (core.eflag == 0).cpu().numpy()
    finite = all(bool(torch.isfinite(a).all()) for a in x)
    plain_ms, prof_ms, events = device_busy(solve)
    busy = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    a = sparse_arrays(**SPARSE)
    dd = dense_qp_data(**{k: v[None] for k, v in a.items()}, dtype=f64,
                       device=device)
    z_gap = 0.0
    for lane in (0, B // 2, B - 1):
        xd, cd = solve_dense_qp(dd._replace(f=dd.f * (1.0 + 1e-4 * lane)),
                                *(g[0] for g in guess), opts)
        if int(cd.eflag) != 0 or not good[lane]:
            fail(f"sparse: lane {lane} did not succeed in both solves")
        z_gap = max(z_gap, (xd.z - x.z[lane]).abs().max().item())
    host_ms = 1e3 * (split["host_s"] + split["copy_s"] + split["wait_s"])
    print(json.dumps({"sparse": dict(
        B=B, **SPARSE, lnnz=pat.lnnz, knnz=pat.knnz, ms=ms,
        qps=B / (ms / 1e3), failed_lanes=int((~good).sum()),
        residual_f64_max_success=float(res64[good].max()),
        newton_iters_max=int(core.newton_iters.max()),
        split_ms=dict(round_trips=split["round_trips"],
                      host_ldl=1e3 * split["host_s"],
                      copies=1e3 * split["copy_s"],
                      device_wait=1e3 * split["wait_s"],
                      rest=ms - host_ms),
        profiled_ms=prof_ms, device_busy_ms=busy,
        idle_share=1.0 - busy / prof_ms, device_kernels=len(events),
        dense_z_gap=z_gap, dense_z_tol=SPARSE_Z_TOL, launches=n_bench)}))
    if not (finite and tuple(x.z.shape) == (B, pat.nz)):
        fail("sparse: non-finite values or the wrong shape")
    if good.mean() < 0.99 or not bool(np.all(res64[good] <= CONTRACT)):
        fail("sparse: a SUCCESS lane misses 1e-6 in host float64")
    if z_gap > SPARSE_Z_TOL:
        fail("sparse: z disagrees with solve_dense_qp")

    # 2. The MPC bridge on the headline batch, in float64.
    mpc = build_batch(B_mpc, **HEADLINE, device=device, dtype=f64)
    mpat = mpc_sparse_pattern(*(HEADLINE[k] for k in ("N", "nx", "nu",
                                                        "nc")))
    vals = mpc_sparse_values(mpc)
    mopts = Options(abs_tol=1e-9)
    mpat.split.reset()
    counts = launch_counter()
    (xs, cs), ms_s = timed(lambda: solve_sparse_qp_batch(
        mpat, vals, *zeros(mpat, B_mpc), mopts))
    n_mpc = counts()
    msplit = dataclasses.asdict(mpat.split)
    (xr, cr), ms_r = timed(lambda: solve_mpc_qp_batch(
        mpc, *zeros_guess(mpc), mopts))
    same = bool(torch.equal(cs.eflag, cr.eflag))
    ok = (cs.eflag == 0) & (cr.eflag == 0)
    gap = (xs.z - xr.z).abs().amax(1)[ok].max().item() if ok.any() else 0.0
    print(json.dumps({"sparse_mpc": dict(
        B=B_mpc, **HEADLINE, lnnz=mpat.lnnz, ms=ms_s,
        qps=B_mpc / (ms_s / 1e3), riccati_ms=ms_r, same_eflags=same,
        split_ms=dict(round_trips=msplit["round_trips"],
                      host_ldl=1e3 * msplit["host_s"],
                      copies=1e3 * msplit["copy_s"],
                      device_wait=1e3 * msplit["wait_s"]),
        success=int(ok.sum()), z_gap=gap, z_tol=SPARSE_MPC_Z_TOL,
        launches=n_mpc)}))
    if not same or ok.float().mean().item() < 0.99 or gap > SPARSE_MPC_Z_TOL:
        fail("sparse: the MPC bridge disagrees with solve_mpc_qp_batch")

    # 3. The differentiable sparse solve, card against CPU.
    sig = 1e-6
    diff_opts = Options(abs_tol=1e-10)

    def grads(d, dev):
        fields = [t.clone().requires_grad_() for t in d]
        fn = make_differentiable_batch_solver(
            pat.ops, functools.partial(solve_sparse_qp_batch, pat),
            diff_opts, sig)
        z, l, _ = fn(SparseQPData(*fields), *zeros(pat, B_diff, dev))
        (0.5 * (z * z).sum() + l.sum()).backward()
        return {k: f.grad.cpu() for k, f in zip(SparseQPData._fields,
                                                 fields)}, z.detach().cpu()

    sub = SparseQPData(*(t[:B_diff] for t in data))
    counts = launch_counter()
    (g_card, z_card), ms_d = timed(lambda: grads(sub, device))
    n_diff = counts()
    g_cpu, _ = grads(SparseQPData(*(t.cpu() for t in sub)), "cpu")
    one = SparseQPData(*(t[:1] for t in sub))
    z1, _, _ = solve_sparse_qp_diff(pat, one, *(g[0] for g in zeros(pat, 1)),
                                    diff_opts, sig)
    finite = all(bool(torch.isfinite(g).all()) for g in g_card.values())
    rel = {k: ((g_card[k] - g_cpu[k]).abs().max()
               / (1 + g_cpu[k].abs().max())).item() for k in g_card}
    print(json.dumps({"sparse_diff": dict(
        B=B_diff, sigma_vjp=sig, ms=ms_d, finite=finite, card_vs_cpu=rel,
        tol=SPARSE_GRAD_TOL, single_vs_batch_lane0=(
            z1.cpu() - z_card[0]).abs().max().item(), launches=n_diff)}))
    if not finite or max(rel.values()) > SPARSE_GRAD_TOL:
        fail("sparse: the card's gradients miss the CPU's")
    if (z1.cpu() - z_card[0]).abs().max().item() > 1e-9:
        fail("sparse: solve_sparse_qp_diff disagrees with lane 0")
    paths = dict(sparse=n_bench, sparse_mpc=n_mpc, sparse_diff=n_diff)
    if any(v for n in paths.values() for v in n.values()):
        fail("sparse: the sparse path launched one of the port's kernels")
    return paths


def phase_sharded(device, B=8192, B_lock=1024, B_dense=4096):
    """The batch sharded over torch.distributed on a mesh of one rank
    (NCCL, a world of one), at the headline's full width: the fused
    solver (K2 and the refinement's K1 per shard), the adaptive solver,
    the lockstep solver (K1 a Newton step), the dense lockstep solver (no
    kernel, as in JAX), the ragged path, the dry run and bench sharded.
    Every path meets the contract and its BatchStats equal the host's
    reduction. Ends the process group it starts."""
    import torch.distributed as dist

    from fbstab_tpu_torch.bench import run_sharded
    from fbstab_tpu_torch.graft_entry import dryrun_multichip
    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.parallel.ragged import solve_mpc_ragged
    from fbstab_tpu_torch.parallel.sharded import (
        make_mesh, shard_batch, sharded_dense_solver, sharded_mpc_solver,
        sharded_mpc_solver_adaptive, sharded_mpc_solver_fused)

    opts = Options.single_precision()
    mesh = make_mesh()
    backend, world = str(dist.get_backend()), mesh.size()
    if "nccl" not in backend or world != 1:
        fail(f"sharded: a card mesh of one rank on NCCL, got {backend} "
             f"over {world}")
    data = build_batch(B, **HEADLINE, device=device)
    guess = zeros_guess(data)
    args = shard_batch(mesh, (data, *guess))
    rows, paths = {}, {}

    def run(tag, solver, a, Bq, reps=3):
        counts = launch_counter()
        (x, core, stats), times = drive(lambda: solver(*a), reps=reps)
        n = counts()
        _check_stats(f"sharded {tag}", stats, core)
        rows[tag] = dict(B=Bq, qps=Bq / min(times),
                         s=[round(t, 4) for t in times], calls=reps + 1,
                         success=int(stats.num_success), launches=n)
        paths[f"sharded_{tag}"] = n
        return x, core, n

    # The fused solver against the direct call on the same data.
    x_d, core_d = solve_mpc_qp_batch(data, *guess, opts)
    x, core, n = run("fused", sharded_mpc_solver_fused(mesh, opts), args, B)
    res64 = mpc_f64_residual(data, x, opts.alpha)
    check_contract("sharded fused", x, core, res64, guess, True)
    z, zd = x.to_float64().z, x_d.to_float64().z
    gap = ((z - zd).abs().amax(1) / (1 + zd.abs().amax(1))).max().item()
    rows["fused"].update(
        residual_f64_max=float(res64.max()), z_gap=gap,
        bit_equal_lanes=int((z == zd).all(1).sum()),
        same_flags=bool(torch.equal(core.eflag, core_d.eflag)),
        same_newton=bool(torch.equal(core.newton_iters,
                                     core_d.newton_iters)))
    if not (rows["fused"]["same_flags"] and rows["fused"]["same_newton"]):
        fail("sharded fused: flags or Newton counts differ from the direct "
             "solve_mpc_qp_batch")
    if gap > Z_TOL or n["K2"] < 1 or n["K1"] < 1:
        fail("sharded fused: z misses the direct solve, or K2 / K1 did not "
             "launch")

    # The two-phase adaptive solver per shard.
    P2 = max(B // 8, 128)
    x, core, n = run("adaptive", sharded_mpc_solver_adaptive(
        mesh, opts, phase1_newton_iters=16, phase2_size=P2), args, B)
    res64 = mpc_f64_residual(data, x, opts.alpha)
    check_contract("sharded adaptive", x, core, res64, guess, True)
    rows["adaptive"].update(residual_f64_max=float(res64.max()), P2=P2)
    if n["K2"] < 1 or n["K1"] < 1:
        fail("sharded adaptive: K2 / K1 did not launch")

    # The lockstep solver: K1 a Newton step of the whole shard.
    dl = build_batch(B_lock, **HEADLINE, device=device)
    gl = zeros_guess(dl)
    x, core, n = run("lockstep", sharded_mpc_solver(mesh, opts),
                     shard_batch(mesh, (dl, *gl)), B_lock, reps=1)
    res64 = mpc_f64_residual(dl, x, opts.alpha)
    good = check_contract("sharded lockstep", x, core, res64, gl, False)
    slowest = int(core.newton_iters.max())
    rows["lockstep"].update(
        residual_f64_max_success=float(res64[good].max()),
        success_frac=float(good.mean()), newton_max=slowest)
    if n["K1"] < rows["lockstep"]["calls"] * slowest or n["K2"]:
        fail("sharded lockstep: fewer K1 launches than Newton steps of the "
             "slowest lane, or a K2 launch")

    # The dense lockstep solver: no kernel (the plain step), as in JAX.
    dd = build_dense(B_dense, DENSE["n"], DENSE["q"], 0, device)
    gd = dense_zeros(dd)
    x, core, n = run("dense", sharded_dense_solver(mesh, opts),
                     shard_batch(mesh, (dd, *gd)), B_dense, reps=1)
    res64 = dense_f64_residual(dd, x, opts.alpha)
    good = check_contract("sharded dense", x, core, res64, gd, False)
    rows["dense"].update(residual_f64_max_success=float(res64[good].max()),
                         success_frac=float(good.mean()),
                         kernels="none (the plain dense step, as in JAX)")
    if any(n.values()):
        fail("sharded dense: the lockstep dense path launched a kernel")

    # A ragged batch: 8191 lanes, padded to 8192 with tile_b = 128.
    Br = B - 1
    dr = build_batch(Br, **HEADLINE, device=device)
    gr = zeros_guess(dr)
    counts = launch_counter()
    (x, core, stats), ms = timed(lambda: solve_mpc_ragged(
        dr, *gr, opts, mesh=mesh, tile_b=128))
    n = counts()
    res64 = mpc_f64_residual(dr, x, opts.alpha)
    check_contract("sharded ragged", x, core, res64, gr, True)
    _check_stats("sharded ragged", stats, core)
    rows["ragged"] = dict(B=Br, padded_to=B, rows=int(core.eflag.shape[0]),
                          num_instances=int(stats.num_instances),
                          qps=Br / (ms / 1e3), residual_f64_max=float(
                              res64.max()), launches=n)
    paths["sharded_ragged"] = n
    if core.eflag.shape[0] != Br or int(stats.num_instances) != Br:
        fail("sharded ragged: the padding reached the rows or the counts")
    if n["K2"] < 1:
        fail("sharded ragged: K2 did not launch")

    counts = launch_counter()
    _, ms = timed(lambda: dryrun_multichip(1))
    paths["sharded_dryrun"] = counts()
    rows["dryrun"] = dict(ms=ms, launches=paths["sharded_dryrun"])
    counts = launch_counter()
    rec, diag = run_sharded(B, device)
    paths["bench_sharded"] = counts()
    print(diag)
    ratio = rec["value"]
    dist.destroy_process_group()
    print(json.dumps({"sharded": dict(backend=backend, world=world,
                                      efficiency=ratio, paths=rows)}))
    if not ratio > 0:
        fail("sharded: bench sharded printed no ratio")
    return paths


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: the kernels run only on the card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, kind = phase_device()
    phase_build()
    if sys.argv[1:] == ["--k3-envelope"]:
        k3_envelope(device)
        return
    if sys.argv[1:] == ["--assoc-crossover"]:
        _, crossover = phase_longhorizon(device, Ns=ASSOC_CROSSOVER_NS,
                                         reps=7)
        print(f"assoc crossover: the assoc solve is the faster from N = "
              f"{crossover} on (of N = {ASSOC_CROSSOVER_NS})")
        return
    k1 = phase_k1(device)
    k2 = phase_k2(1024, device)
    k3 = phase_k3(device)
    k4 = phase_k4(256, device)
    k5 = phase_k5(256, device)
    p1, n_mxu = phase_p1(device)
    p3, n_df = phase_p3(device)
    rr = phase_refine_residual(device)
    qps, n_oneshot = phase_main(8192, device)
    n_dense = phase_dense_main(4096, device)
    n_adapt = phase_adaptive(8192, device, qps)
    n_warm = phase_warmstart(8192, device)
    phase_plants(128, device)
    n_copoly = phase_copoly(2048, device)
    n_env, lowmem, env = phase_envelope(device)
    n_long, _ = phase_longhorizon(device)
    n_assoc = phase_assoc_batch(256, device)
    n_diff = phase_diff(1024, device)
    n_gain = phase_feedback_gain(1024, device)
    n_facade = phase_facade(8192, 4096, device)
    n_sparse = phase_sparse(device)
    n_sharded = phase_sharded(device)
    paths = dict(mpc_one_shot=n_oneshot, dense=n_dense, mpc_adaptive=n_adapt,
                 mpc_copoly=n_copoly, mpc_assoc_batch=n_assoc,
                 longhorizon=n_long, bench_mxu=n_mxu, df_probe=n_df,
                 mpc_warmstart=n_warm, **n_env, **n_diff, **n_gain,
                 **n_facade, **n_sparse, **n_sharded)
    by_path = lambda k: {p: n[k] for p, n in paths.items()}
    kernels = [
        dict(name="riccati_newton_step", route="cuda",
             source="fbstab_tpu_torch/csrc/riccati.cu",
             replaces="fbstab_tpu/ops/riccati_pallas.py:418",
             launches=n_adapt["K1"], launches_by_path=by_path("K1"),
             **k1),
        dict(name="fbstab_mpc_solve_fused", route="cuda",
             source="fbstab_tpu_torch/csrc/mpc_solve.cu",
             replaces="fbstab_tpu/ops/mpc_solve_pallas.py:1109",
             launches=n_adapt["K2"], launches_by_path=by_path("K2"),
             shapes={k: v for k, v in env["corners"].items()
                     if k.startswith("K2")}, **k2),
        dict(name="fbstab_dense_solve_fused", route="cuda",
             source="fbstab_tpu_torch/csrc/dense_solve.cu",
             replaces="fbstab_tpu/ops/dense_solve_pallas.py:421",
             launches=n_dense["K3"], launches_by_path=by_path("K3"), **k3),
        dict(name="mpc_subproblem_fused", route="cuda",
             source="fbstab_tpu_torch/csrc/mpc_subproblem.cu",
             replaces="fbstab_tpu/ops/mpc_solve_pallas.py:1347",
             launches=n_copoly["K4"], launches_by_path=by_path("K4"),
             shapes=dict({k: v for k, v in env["corners"].items()
                          if k.startswith("K4")},
                         envelope_spacecraft={k: env[k] for k in (
                             "B", "qps", "success_frac", "B_turns", "ms",
                             "tier3_ms", "bound_ms", "bound_by")}), **k4),
        dict(name="combine_im", route="cuda",
             source="fbstab_tpu_torch/csrc/assoc_combine.cu",
             replaces="fbstab_tpu/ops/assoc_riccati.py:388",
             launches=n_assoc["K5"], launches_by_path=by_path("K5"), **k5),
    ] + [
        dict(name=name, route="cuda", source=f"fbstab_tpu_torch/csrc/{src}",
             replaces=f"fbstab_tpu/ops/{site}", library_ms=None,
             launches=n_env[path][f"{key}_lowmem"],
             launches_by_path=by_path(f"{key}_lowmem"), **lowmem[key])
        for name, src, site, path, key in (
            ("riccati_newton_step_lowmem", "riccati.cu",
             "riccati_pallas.py:539", "lowmem_k1", "K1"),
            ("fbstab_mpc_solve_fused_lowmem", "mpc_solve.cu",
             "mpc_solve_pallas.py:1191", "lowmem_k2", "K2"),
            ("mpc_subproblem_fused_lowmem", "mpc_subproblem.cu",
             "mpc_solve_pallas.py:1400, :1386", "lowmem_k4", "K4"))
    ] + [
        dict(name=f"mxu_probe_{form}", route="cuda",
             source="fbstab_tpu_torch/csrc/mxu_probe.cu",
             replaces="bench.py:998, scratch/tpu_mxu.py:104",
             launches=n_mxu[key], launches_by_path=by_path(key),
             **p1[form])
        for form, key in (("cuda_perlane", "P1_perlane"),
                          ("cuda_shared", "P1_shared"), ("tc_shared", "P1_tc"))
    ] + [
        dict(name="df_probe", route="cuda",
             source="fbstab_tpu_torch/csrc/df_probe.cu",
             replaces="scratch/tpu_df_kernel.py:77", launches=n_df["P3"],
             launches_by_path=by_path("P3"), design="one thread per column",
             **p3),
        dict(name="refine_residual", route="cuda",
             source="fbstab_tpu_torch/csrc/refine_residual.cu",
             replaces=None, launches=n_copoly["RR"],
             launches_by_path=by_path("RR"), **rr),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

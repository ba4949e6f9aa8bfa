"""Times the MPC and dense kernels and paths and the P1 probe's kernels of
given source trees on one GPU.

    python3 fbstab_tpu_torch/tools/ab_mpc.py TREE [TREE ...]
    python3 fbstab_tpu_torch/tools/ab_mpc.py --p1 TREE [TREE ...]

For each tree, in the order given, a fresh process imports
fbstab_tpu_torch from TREE (building its kernels there; the tree must hold
fbstab_tpu_torch/workloads.py) and prints one JSON line, every solve under
Options.single_precision():
  - k1_headline_ms, k1_copoly_ms: K1 (the Newton-step wrapper, as the
    solvers call it) on the equilibrated headline batch at B = 8192 and the
    equilibrated copolymerization reactor at B = 2048, on seeded random
    iterates (K1's work does not depend on their values); CUDA events,
    five calls after a warm one;
  - k2_ms: K2 on the equilibrated headline batch at B = 1024 (CUDA events,
    three launches after a warm one);
  - k5_ms: K5 (the scan-level combine) at the widest level of the suffix
    scan of one Newton step on the equilibrated copolymerization reactor at
    B = 256 (M = 40 pairs), its operands as the scan hands them (CUDA
    events, five launches after a warm one);
  - k3_ms_1024, k3_ms_4096: K3 on the equilibrated bench dense batch
    (n = 32, q = 64) at B = 1024 and 4096 (CUDA events, three launches
    after a warm one);
  - dense_qps: the dense path, solve_dense_qp_batch at B = 4096 (best of
    three calls after a warm one);
  - main_qps: the one-shot solve_mpc_qp_batch at B = 8192 (best of three
    calls after a warm one);
  - adaptive_qps: the adaptive headline
    (solve_mpc_qp_batch_adaptive_device, phase1 = 16, P2 = 1024) at
    B = 8192 (best of three after a warm one);
  - warmstart_qps: the receding-horizon sweep of the headline plant,
    B = 8192 for 8 steps (best of two after a warm one);
  - k4_ms: the subfused copoly solve on K4 at B = 256 (equilibrated; CUDA
    events, one call after a warm one, as chip_smoke.py times it);
  - copoly_qps: the copoly path at B = 2048 through K4 (best of two after
    a warm one);
  - assoc_batch_ms: solve_mpc_qp_batch(..., riccati="assoc") on the copoly
    batch at B = 256 (best of two after a warm one);
  - longhorizon_ms: the single-instance solve_mpc_qp on the double
    integrator with riccati="scan" and "assoc" at N = 120, 240, 480 (best
    of three after a warm one);
  - p1_perlane_ms, p1_shared_ms, p1_tc_ms: P1's three kernels
    (cuda_perlane, cuda_shared, tc_shared) at the probe's shape (N1 = 81,
    n = 18, B = 128, T = 200; CUDA events, 20 launches after 0.3 s of
    them, so the card runs at its working clocks; a launch is issued by
    the host in about the time tc_shared runs, so these read the host's
    rate where the kernel is faster); p1_*_graph_ms the same apart from
    the host (20 launches captured into a CUDA graph, replayed 10 times
    between CUDA events); p1_*_ms_by_T the same as p1_*_ms
    at T = 200, 400 and 800 (the slope is the time of one application,
    the intercept what a launch costs besides); p1_*_clocks_sm_mhz the
    highest SM clock nvidia-smi read while the form ran its first ~0.3 s
    (every 50 ms; stopped before the timing); p1_*_ms_zero_w at T = 200
    from w0 = 0 (every operand zero: the reference's iterate is normal for
    its first ~50 applications, then subnormal, then zero);
  - K1's to K5's registers and spill bytes from the tree's build log, and
    those of P1's three forms at n = 18, with the opcodes of their SASS
    (p1_*_sass: counts by mnemonic, cuobjdump); p1_*_slope_us, one
    application (the T = 400 -> 800 slope of p1_*_ms_by_T), and
    p1_*_intercept_ms, the rest of the T = 200 time;
  - p3_graph_ms: P3 (launch_df_probe on the probe's (8, 128) inputs) apart
    from the host: 20 launches captured into a CUDA graph, replayed 10
    times between CUDA events; p3_floor_ms a one-element add_ timed the
    same way (the card's launch floor); p3_host_ms the
    wrapper (df_probe) called 20 times back to back, as chip_smoke.py
    timed P3 before; p3_sass the kernel's opcodes.
With --p1 only the P1 and P3 keys are measured (seconds a tree after its
build).
Pass a checkout of the parent and of the change as A B B A to compare them
in turns on one card; copies of one tree that differ in one constant, to
weigh it. K5's inputs are built with the tree's own scan, whose spans are
batch-last in trees before the instance-major K5 (`k5_widest_level`).
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

LONG_NS = (120, 240, 480)
P1_SWEEP_T = (200, 400, 800)
# P1's CUDA-core kernels at n = 18 in a build log: this tree's names, then
# those of trees before the team kernels.
P1_ENTRIES = dict(
    p1_perlane_ptxas=("stage_matvec_teamILi18ELb1E",
                      "stage_matvec_cuda_coresILb1E"),
    p1_shared_ptxas=("stage_matvec_teamILi18ELb0E",
                     "stage_matvec_cuda_coresILb0E"),
    p1_tc_ptxas=("stage_matvec_tcILi3E", "stage_matvec_tensor_cores"))
P1_FORMS = ("p1_perlane", "p1_shared", "p1_tc")


def own_workloads():
    """This tool's own tree's workloads module, loaded by path: the tree
    measured may predate its timing helpers."""
    path = Path(__file__).resolve().parents[1] / "workloads.py"
    spec = importlib.util.spec_from_file_location("ab_own_workloads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k1_inputs(data, seed=5):
    """Seeded iterate pieces and negated residuals for one Newton step on
    `data` (v > 0 around the complementarity corner, sigma 3e-4), on its
    device: the arguments of riccati_newton_step_batched after `data`."""
    import torch

    N1, nx, nu, nc = (data.E.shape[1], data.A.shape[-1], data.B.shape[-1],
                      data.E.shape[-2])
    B = data.x0.shape[0]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32,
                               device=data.x0.device)
    v = np.abs(rng.standard_normal((B, N1 * nc)))
    y = rng.standard_normal((B, N1 * nc))
    vbar = v + 0.1 * rng.standard_normal((B, N1 * nc))
    rz, rl, rv = (rng.standard_normal((B, N1 * n))
                  for n in (nx + nu, nx, nc))
    return (*(t(a) for a in (v, y, vbar, rz, rl, rv)), 3e-4, 0.95)


def k5_widest_level(data):
    """The operands of the widest level of the suffix scan of one Newton
    step on `data`, as the tree's scan hands them to its combine; and that
    combine (K5's wrapper)."""
    from fbstab_tpu_torch.models.mpc_qp import assoc_step_inputs
    from fbstab_tpu_torch.ops import assoc_combine_cuda as k5
    from fbstab_tpu_torch.ops import assoc_riccati as ar
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.workloads import newton_step_args

    _, _, args = assoc_step_inputs(
        *newton_step_args(data, Options.single_precision()))
    if hasattr(ar, "stage_major"):
        elems, _ = ar.stage_elements_im(*map(ar.stage_major, args[:-1]),
                                        args[-1])
        combine, plain = k5.combine_im, k5.combine_im_plain
    else:
        elems, _ = ar.stage_elements_bl(*args)
        combine, plain = k5.combine_bl, k5.combine_bl_plain
    levels = []

    def record(left, right):
        levels.append((left, right))
        return plain(left, right)
    ar.suffix_values(elems, combine=record)
    return combine, levels[0]


def measure_p1(row: dict) -> None:
    """P1's three kernels at the probe's shape, into `row`."""
    import torch

    from fbstab_tpu_torch.ops import mxu_probe_cuda as p1
    from fbstab_tpu_torch.workloads import cuda_ms

    own = own_workloads()
    dev = torch.device("cuda", 0)
    Mp, Ms, w0 = p1.probe_inputs(device=dev)
    zero = torch.zeros_like(w0)
    scale = p1.scale_of(p1.N_STAGE)
    for key, kernel, M in (("p1_perlane", p1.cuda_perlane, Mp),
                           ("p1_shared", p1.cuda_shared, Ms),
                           ("p1_tc", p1.tc_shared, Ms)):
        probe = lambda T=p1.T_DEFAULT, w=w0: kernel(M, w, T, scale)
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.3:
            probe()
            torch.cuda.synchronize()
        smi.terminate()
        samples = [ln.split(",") for ln in smi.communicate()[0].splitlines()
                   if ln.count(",") == 1]
        row[key + "_clocks_sm_mhz"] = max(float(c) for c, _ in samples)
        row[key + "_ms"] = cuda_ms(probe, 20, warm=False)
        row[key + "_graph_ms"] = own.graph_ms(probe)
        row[key + "_ms_by_T"] = {T: cuda_ms(lambda: probe(T), 20)
                                 for T in P1_SWEEP_T}
        row[key + "_ms_zero_w"] = cuda_ms(lambda: probe(w=zero), 20)


def measure_p3(row: dict) -> None:
    """P3 at the probe's shape, into `row`: its device time apart from the
    host (CUDA graphs), the launch floor timed the same way, and the
    wrapper's host-issued time."""
    import torch

    from fbstab_tpu_torch.ops import df_probe_cuda as p3
    from fbstab_tpu_torch.ops._build import load_library
    from fbstab_tpu_torch.workloads import cuda_ms

    own = own_workloads()
    dev = torch.device("cuda", 0)
    lib = load_library()
    a, b = p3.probe_inputs(dev)
    launch = lambda: p3.launch_df_probe(lib, a, b)
    row["p3_graph_ms"] = own.graph_ms(launch)
    row["p3_floor_ms"] = own.launch_floor_ms(dev)
    row["p3_host_ms"] = cuda_ms(lambda: p3.df_probe(a, b), 20)


def sass_opcodes(lib_path, entries) -> dict:
    """Counts by mnemonic (FFMA, LDS, ...) in the SASS of the first kernel
    name of `entries` that the library holds."""
    from collections import Counter

    from fbstab_tpu_torch.ops._build import sass_blocks
    for entry in entries:
        try:
            blocks = sass_blocks(lib_path, entry)
        except RuntimeError:
            continue
        if blocks is None:
            return {}
        ops = Counter(m.group(1).split(".")[0] for blk in blocks
                      for m in re.finditer(
                          r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)", blk))
        return dict(ops.most_common())
    return {}


def measure(tree: str, p1_only: bool = False) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from fbstab_tpu_torch.ops import _build

    row = dict(tree=tree)
    measure_p1(row)
    measure_p3(row)
    row["log"] = str(_build.library_path().with_suffix(".log"))
    if p1_only:
        return row

    from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch
    from fbstab_tpu_torch.models.mpc_qp import (
        MpcQPData, solve_mpc_qp, solve_mpc_qp_batch)
    from fbstab_tpu_torch.models.mpc_subfused import (
        fbstab_mpc_solve_subfused)
    from fbstab_tpu_torch.models.ocp_fixtures import double_integrator
    from fbstab_tpu_torch.models.receding_horizon import simulate_batch
    from fbstab_tpu_torch.models.scaling import (
        apply_dense_scaling, apply_mpc_scaling, ruiz_dense_scaling,
        ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops.dense_solve_cuda import fbstab_dense_solve_fused
    from fbstab_tpu_torch.ops.mpc_solve_cuda import fbstab_mpc_solve_fused
    from fbstab_tpu_torch.ops.riccati_cuda import riccati_newton_step_batched
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.parallel.adaptive import (
        solve_mpc_qp_batch_adaptive_device)
    from fbstab_tpu_torch.workloads import (
        DENSE, HEADLINE, build_batch, build_copoly, build_dense, cuda_ms,
        dense_zeros, timed, zeros_guess)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    opts = Options.single_precision()
    equilibrated = lambda d: apply_mpc_scaling(d, ruiz_mpc_scaling(d))
    best = lambda fn, n: min(timed(fn)[1] for _ in range(n + 1))

    def k1_ms(data):
        args = k1_inputs(data)
        return cuda_ms(lambda: riccati_newton_step_batched(data, *args), 5)

    row["k1_headline_ms"] = k1_ms(
        equilibrated(build_batch(8192, **HEADLINE, device=dev)))
    row["k1_copoly_ms"] = k1_ms(equilibrated(build_copoly(2048, dev)))

    data = equilibrated(build_batch(1024, **HEADLINE, device=dev))
    guess = zeros_guess(data)
    row["k2_ms"] = cuda_ms(
        lambda: fbstab_mpc_solve_fused(data, *guess, opts), 3)
    data = build_batch(8192, **HEADLINE, device=dev)
    guess = zeros_guess(data)
    row["main_qps"] = 8192e3 / best(
        lambda: solve_mpc_qp_batch(data, *guess, opts), 3)
    row["adaptive_qps"] = 8192e3 / best(
        lambda: solve_mpc_qp_batch_adaptive_device(
            data, *guess, opts, phase1_newton_iters=16, phase2_size=1024), 3)
    shared = MpcQPData(*(a[:1] for a in data))
    row["warmstart_qps"] = 8 * 8192e3 / best(
        lambda: simulate_batch(shared, 8, data.x0, opts), 2)

    for B in (1024, 4096):
        data = build_dense(B, DENSE["n"], DENSE["q"], 0, dev)
        data = apply_dense_scaling(data, ruiz_dense_scaling(data))
        guess = dense_zeros(data)
        row[f"k3_ms_{B}"] = cuda_ms(
            lambda: fbstab_dense_solve_fused(data, *guess, opts), 3)
    data = build_dense(4096, DENSE["n"], DENSE["q"], 0, dev)
    guess = dense_zeros(data)
    row["dense_qps"] = 4096e3 / best(
        lambda: solve_dense_qp_batch(data, *guess, opts), 3)

    data = equilibrated(build_copoly(256, dev))
    combine, (left, right) = k5_widest_level(data)
    row["k5_ms"] = cuda_ms(lambda: combine(left, right), 5)
    guess = zeros_guess(data)
    row["k4_ms"] = cuda_ms(
        lambda: fbstab_mpc_solve_subfused(data, *guess, opts), 1)
    data = build_copoly(2048, dev)
    guess = zeros_guess(data)
    row["copoly_qps"] = 2048e3 / best(
        lambda: solve_mpc_qp_batch(data, *guess, opts), 2)
    data = build_copoly(256, dev)
    guess = zeros_guess(data)
    row["assoc_batch_ms"] = best(
        lambda: solve_mpc_qp_batch(data, *guess, opts, riccati="assoc"), 2)

    row["longhorizon_ms"] = {}
    for N in LONG_NS:
        data, _ = double_integrator(N, dtype=torch.float32, device=dev)
        guess = tuple(g[0] for g in zeros_guess(data))
        for mode in ("scan", "assoc"):
            row["longhorizon_ms"][f"{mode} N={N}"] = best(
                lambda: solve_mpc_qp(data, *guess, opts, riccati=mode), 3)
    return row


def main():
    if sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[-1], "--p1" in sys.argv)),
              flush=True)
        return
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from fbstab_tpu_torch.ops._build import ptxas_lines

    p1_only = sys.argv[1] == "--p1"
    for tree in sys.argv[1 + p1_only:]:
        proc = subprocess.run([sys.executable, __file__, "--one",
                               *(["--p1"] if p1_only else []), tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr)
            sys.exit(proc.returncode)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        log = Path(row["log"]).read_text()
        if not p1_only:
            row.update(k1_ptxas=ptxas_lines("riccati.cu", log),
                       k2_ptxas=ptxas_lines("mpc_solve.cu", log),
                       k3_ptxas=ptxas_lines("dense_solve.cu", log),
                       k4_ptxas=ptxas_lines("mpc_subproblem.cu", log),
                       k5_ptxas=ptxas_lines("assoc_combine.cu", log))
        lib = Path(row["log"]).with_suffix(".so")
        for key, entries in P1_ENTRIES.items():
            row[key] = [ln for e in entries
                        for ln in ptxas_lines("mxu_probe.cu", log, e)]
            row[key.replace("ptxas", "sass")] = sass_opcodes(lib, entries)
        row["p3_sass"] = sass_opcodes(lib, ("df_probe_kernel",))
        for key in P1_FORMS:
            by_t = row[key + "_ms_by_T"]
            slope = (by_t["800"] - by_t["400"]) / 400
            row[key + "_slope_us"] = slope * 1e3
            row[key + "_intercept_ms"] = by_t["200"] - 200 * slope
        del row["log"]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

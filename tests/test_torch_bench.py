"""PyTorch port: the bench entry point (`python -m fbstab_tpu_torch.bench`),
its performance model and the two probes (P1, P3), on the CPU.

Every ported mode runs at a tiny size on the CPU (plain versions of the
kernels; the headline shape, the copolymerization reactor and the audited
plants cut to short horizons) and prints one JSON line with bench.py's
metric name for the same function, read from bench.py's source with `ast`
(bench.py is not imported: it rewrites LIBTPU_INIT_ARGS on import). The
perf-model cases mirror tests/test_bench_modes.py. The probes' plain
versions are held against float64 transcriptions of the TPU kernels'
arithmetic; the kernels themselves are held against the plain versions on
the card (marked `cuda`, skipped here). JAX is imported inside the one test
that needs it, so the `cuda` tests run on the card without it.
"""

import ast
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import copoly_arrays, require_cuda, torch_data  # noqa: E402

from fbstab_tpu_torch import bench, perf_model  # noqa: E402
from fbstab_tpu_torch.ops import df_probe_cuda as p3  # noqa: E402
from fbstab_tpu_torch.ops import mxu_probe_cuda as p1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# port mode -> the function of bench.py that runs it
MODE_FUNCS = {
    (): "main", ("refine",): "run_refine", ("adaptive",): "run_adaptive",
    ("adaptive", "mixed"): "run_adaptive_mixed", ("dense",): "run_dense",
    ("copoly",): "run_copoly", ("longhorizon",): "run_longhorizon",
    ("plants",): "run_plants", ("warmstart",): "run_warmstart",
    ("million",): "run_million", ("mxu",): "run_mxu", ("diff",): "run_diff",
    ("sharded",): "run_sharded",
}
# tiny sizes: the mode's own argument (B, N or T)
TINY_ARG = {(): None, ("refine",): 3, ("adaptive",): 3,
            ("adaptive", "mixed"): 3, ("dense",): 4, ("copoly",): 2,
            ("longhorizon",): 8, ("plants",): 2, ("warmstart",): 3,
            ("million",): 3, ("mxu",): 1, ("diff",): 2, ("sharded",): 3}


def _reference_bench():
    """(metric of each function, the mode names of bench.py's __main__)
    from bench.py's source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    metrics = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant) and k.value == "metric"
                            and isinstance(v, ast.Constant)):
                        metrics[fn.name] = v.value
    modes = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "_MODES"
                        for t in node.targets)):
            modes = {k.value for k in node.value.keys}
    return metrics, modes


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench with its fixed shapes cut to short horizons."""
    monkeypatch.setattr(bench, "run_main", bench.run_main)
    monkeypatch.setattr(bench, "HEADLINE", dict(N=4, nx=3, nu=2, nc=4))
    monkeypatch.setattr(bench, "build_copoly", lambda B, dev: torch_data(
        copoly_arrays(B, 3), torch.float32, dev))
    monkeypatch.setattr(bench, "PLANTS", tuple(
        (name, 3, pert) for name, _, pert in bench.PLANTS))
    return bench


@pytest.mark.parametrize("mode", sorted(MODE_FUNCS), ids=" ".join)
def test_mode_prints_one_json_line_with_bench_metric(tiny_bench, capsys,
                                                     mode):
    arg = TINY_ARG[mode]
    if mode == ():     # the headline takes no argument: cut its batch
        tiny_bench.run_main = functools.partial(tiny_bench.run_main, 4)
    rc = tiny_bench.main(list(mode) + ([] if arg is None else [str(arg)]),
                         device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert len(out) == 1, out
    rec = json.loads(out[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    if mode in (("diff",), ("sharded",)):
        # bench.py's own ratios: the gradient's time over the forward's;
        # the sharding layer's efficiency over 0.85.
        assert rec["vs_baseline"] > 0
    else:
        assert rec["vs_baseline"] is None
    assert rec["value"] > 0
    metrics, _ = _reference_bench()
    assert rec["metric"] == metrics[MODE_FUNCS[mode]]
    if mode == ():
        assert rec["success_frac"] == 1.0
        assert rec["residual_f64_max"] <= 1e-6
        assert rec["plants"]["contract_met"]
        seg = rec["perf_model"]["segments"]
        assert seg["retry_count"] >= 0 and seg["explained_pct"] > 0
    if mode == ("mxu",):
        assert {"vpu_perlane_ns", "vpu_shared_ns", "mxu_shared_ns"} <= set(rec)


def test_modes_are_bench_modes():
    """The port's modes are bench.py's; each metric is bench.py's."""
    metrics, modes = _reference_bench()
    assert modes == set(bench.MODES)
    assert set(MODE_FUNCS.values()) <= set(metrics)


@pytest.mark.parametrize("mode", ["nosuch"])
def test_unported_and_unknown_modes_exit_2(capsys, mode):
    assert bench.main([mode]) == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "unknown mode" in cap.err


def test_sparse_mode_prints_bench_keys(monkeypatch, capsys):
    """`sparse` at a small size on the CPU (nz = 40, nl = 4, nv = 20,
    B = 3): one JSON line with bench.py's metric and keys, bench.py's
    ratio (the dense loop's time over the sparse batch's) in vs_baseline,
    no failed lane, and the round trips' split."""
    monkeypatch.setattr(bench, "run_sparse", functools.partial(
        bench.run_sparse, nz=40, nl=4, nv=20))
    monkeypatch.setitem(bench.MODES, "sparse", bench.run_sparse)
    assert bench.main(["sparse", "3"], device="cpu") == 0
    cap = capsys.readouterr()
    rec = json.loads(cap.out.strip())
    metrics, _ = _reference_bench()
    assert rec["metric"] == metrics["run_sparse"] == "sparse_qps_host"
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["unit"] == "QPs/s" and rec["value"] > 0
    assert rec["vs_baseline"] > 0 and rec["fails"] == 0
    assert rec["split"]["round_trips"] > 0 and rec["lnnz"] > 0
    assert cap.err.startswith("bench[sparse]: device=cpu nz=40 nl=4 nv=20")


def test_bench_needs_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["dense", "4"])


# ------------------------------------------------------------------
# The performance model (tests/test_bench_modes.py's cases).
# ------------------------------------------------------------------

def test_perf_model_reports_executed_refine_steps():
    ni = np.full(256, 11, np.int32)
    pm_exec = perf_model.mpc_perf_model(256, 30, 8, 3, 6, ni, 0.05, 3)
    pm_max = perf_model.mpc_perf_model(256, 30, 8, 3, 6, ni, 0.05, 24)
    assert pm_exec["executed_refine_steps"] == 3
    assert pm_exec["bound_by"] == "operations"
    # The refine term enters the bound (the maximum >> the executed).
    assert pm_max["bound_s"] > pm_exec["bound_s"] * 1.5
    assert pm_exec["pct_of_bound"] == pytest.approx(
        100 * pm_exec["bound_s"] / 0.05, rel=1e-3)


def test_dispatch_returns_executed_refine_steps():
    import dataclasses

    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.workloads import build_batch, zeros_guess

    opts = Options.single_precision()
    data = build_batch(8, 10, 4, 2, 4, device="cpu")
    _, core = solve_mpc_qp_batch(data, *zeros_guess(data), opts)
    executed = perf_model.executed_refine_steps(core)
    assert 0 < executed < opts.refine_steps
    assert 0 < perf_model.mean_refine_steps(core) <= executed
    _, core0 = solve_mpc_qp_batch(data, *zeros_guess(data),
                                  dataclasses.replace(opts, refine_steps=0))
    assert perf_model.executed_refine_steps(core0) == 0
    assert bool((core.eflag == 0).all())


def test_perf_model_two_phase_compaction():
    """One 40-iteration lane in each warp of 32: one-shot lockstep pays 40
    per warp; under (phase1=16, P>=64) the stragglers share two phase-2
    warps."""
    B = 2048
    ni = np.full(B, 10, np.int32)
    ni[::32] = 40
    one = perf_model.mpc_perf_model(B, 30, 8, 3, 6, ni, 0.05, 2)
    two = perf_model.mpc_perf_model(B, 30, 8, 3, 6, ni, 0.05, 2,
                                    two_phase=(16, 512))
    assert one["lockstep_warp_iters"] == 64 * 40
    assert two["lockstep_warp_iters"] == 64 * 16 + 2 * 24
    # Capacity below the straggler count: the rest stay capped.
    assert perf_model.lockstep_warp_iters(ni, (16, 32)) == 64 * 16 + 24


def test_plant_contract_gate_requires_perturbed_lanes():
    ok = bench.plant_contract_ok
    assert ok(True, 5e-7, 1.0, True)
    assert not ok(True, 5e-7, 0.992, True)
    assert not ok(True, 2e-6, 1.0, True)
    assert not ok(False, 5e-7, 1.0, True)
    assert not ok(True, 5e-7, 0.0, False)


# ------------------------------------------------------------------
# P1, the stage-matvec probe.
# ------------------------------------------------------------------

def _pallas_forms_f64(Mp, Ms, w, T, scale):
    """bench.py:953-985 transcribed to numpy float64: the per-lane and the
    shared unrolled column forms, and the per-stage dot form."""
    N1, n, B = Mp.shape[0], Mp.shape[1], w.shape[1]
    per, sh, dot = w.copy(), w.copy(), w.copy()
    for _ in range(T):
        ws = per.reshape(N1, n, B)
        acc = Mp[:, :, 0] * ws[:, 0][:, None]
        for j in range(1, n):
            acc = acc + Mp[:, :, j] * ws[:, j][:, None]
        per = (acc * scale).reshape(N1 * n, B)
        ws = sh.reshape(N1, n, B)
        acc = Ms[:, :, 0][:, :, None] * ws[:, 0][:, None]
        for j in range(1, n):
            acc = acc + Ms[:, :, j][:, :, None] * ws[:, j][:, None]
        sh = (acc * scale).reshape(N1 * n, B)
        dot = np.concatenate([Ms[s] @ dot[s * n:(s + 1) * n]
                              for s in range(N1)], 0) * scale
    return per, sh, dot


@pytest.mark.parametrize("T", [1, 2])
def test_probe_plain_forms_match_the_tpu_kernels_arithmetic(T):
    Mp, Ms, w0 = p1.probe_inputs(9, 18, 128, device="cpu",
                                 dtype=torch.float64)
    scale = p1.scale_of(18)
    per, sh, dot = _pallas_forms_f64(Mp.numpy(), Ms.numpy(), w0.numpy(), T,
                                     scale)
    tol = dict(rtol=0, atol=1e-12 * np.abs(per).max())
    np.testing.assert_allclose(p1.perlane_plain(Mp, w0, T, scale).numpy(),
                               per, **tol)
    np.testing.assert_allclose(p1.shared_plain(Ms, w0, T, scale).numpy(),
                               sh, **tol)
    np.testing.assert_allclose(sh, dot, **tol)
    # The CPU wrappers take the plain versions.
    np.testing.assert_array_equal(p1.tc_shared(Ms, w0, T, scale).numpy(),
                                  p1.shared_plain(Ms, w0, T, scale).numpy())
    np.testing.assert_array_equal(p1.cuda_perlane(Mp, w0, T, scale).numpy(),
                                  p1.perlane_plain(Mp, w0, T, scale).numpy())


def test_probe_inputs_are_the_references_draws():
    Mp, Ms, w0 = p1.probe_inputs(device="cpu")
    rng = np.random.default_rng(0)
    for got, shape in ((Mp, (81, 18, 18, 128)), (Ms, (81, 18, 18)),
                       (w0, (81 * 18, 128))):
        want = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want)


def _card_probe_case(kernel, kind):
    """A probe kernel against its plain version at T = 1 and 8 on the card,
    within the stated tolerances (ops/mxu_probe_cuda.py), at the probe's
    n = 18, B = 128 and at n = 5 and 32 on a ragged B = 40 (padded and
    full tiles, masked lanes)."""
    require_cuda()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = p1.perlane_plain if kind == "perlane" else p1.shared_plain
    for n, B in ((18, 128), (5, 40), (32, 40)):
        Mp, Ms, w0 = p1.probe_inputs(p1.N1, n, B, device=dev)
        M = Mp if kind == "perlane" else Ms
        scale = p1.scale_of(n)
        for T in (1, 8):
            got = kernel(M, w0, T, scale)
            want = plain(M, w0, T, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            tol = (p1.tc_tol(T, n, 0.0) if kernel is p1.tc_shared
                   else p1.CUDA_CORE_TOL)
            assert err <= tol, (n, B, T, err, tol)


@pytest.mark.cuda
def test_cuda_perlane_kernel_matches_plain_version():
    _card_probe_case(p1.cuda_perlane, "perlane")


@pytest.mark.cuda
def test_cuda_shared_kernel_matches_plain_version():
    _card_probe_case(p1.cuda_shared, "shared")


@pytest.mark.cuda
def test_tc_shared_kernel_matches_plain_version():
    _card_probe_case(p1.tc_shared, "shared")


def test_ptxas_lines_keep_the_named_kernels_of_a_source():
    """P1's CUDA-core forms are compiled for every n up to the cap, so the
    build log holds dozens of their entries; `ptxas_lines` with `entry`
    keeps the register and spill lines of the kernels whose names hold it
    (chip_smoke.py and tools/ab_mpc.py read the n = 18 ones), and without
    it every line of the source, none of the next source's."""
    from fbstab_tpu_torch.ops._build import ptxas_lines

    def entry(name, regs):
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\nptxas info    : Function properties for {name}\n"
                f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                f"spill loads\nptxas info    : Used {regs} registers, used 0 "
                f"barriers\n")
    log = ("== mxu_probe.cu\nptxas info    : 0 bytes gmem\n"
           + entry("_ZN1_17stage_matvec_teamILi17ELb1EEEv", 70)
           + entry("_ZN1_17stage_matvec_teamILi18ELb1EEEv", 168)
           + entry("_ZN1_17stage_matvec_teamILi18ELb0EEEv", 150)
           + "== riccati.cu\n" + entry("_ZN1_9riccati_kEv", 128))
    assert ptxas_lines("mxu_probe.cu", log, "stage_matvec_teamILi18ELb1E") == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 0 barriers"]
    assert len(ptxas_lines("mxu_probe.cu", log)) == 6
    assert ptxas_lines("riccati.cu", log)[-1].endswith(
        "Used 128 registers, used 0 barriers")


# ------------------------------------------------------------------
# P3, the double-float probe.
# ------------------------------------------------------------------

def _reference_df_probe():
    """The functions of scratch/tpu_df_kernel.py (the Pallas kernel, its
    two transforms and `run`), compiled from the file's source without its
    top-level statements, which edit sys.path and import the JAX
    package."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    path = ROOT / "scratch" / "tpu_df_kernel.py"
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    ns = {"np": np, "jax": jax, "jnp": jnp, "pl": pl,
          "functools": functools}
    exec(compile(tree, str(path), "exec"), ns)
    return ns


def test_df_probe_plain_version_is_exact_and_agrees_with_pallas_kernel():
    """The plain version is exact against float64 on the reference probe's
    inputs, the Pallas kernel in interpret mode gives the same verdict,
    and its six outputs (s, e, p, pe and the compensated dot's hi, lo)
    equal the plain version's bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    a, b = p3.probe_inputs(device="cpu")
    want = p3.df_probe_plain(a, b)
    verdict = p3.exactness(a, b, want)
    assert verdict["two_sum_exact"] and verdict["two_prod_exact"]
    assert verdict["dot_rel_err"] < 1e-3 * verdict["f32_dot_rel_err"]
    ref = _reference_df_probe()
    assert bool(ref["run"](interpret=True))
    R, C = a.shape
    out_shape = ([jax.ShapeDtypeStruct((R, C), jnp.float32)] * 4
                 + [jax.ShapeDtypeStruct((1, C), jnp.float32)] * 2)
    got = jax.jit(functools.partial(
        pl.pallas_call, out_shape=out_shape, interpret=True)(
            ref["kernel"]))(a.numpy(), b.numpy())
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_df_probe_outputs_are_views_of_one_buffer():
    """The wrapper makes its six outputs as contiguous views of one buffer
    of 4 R C + 2 C floats, in the order (s, e, p, pe, dh, dl); the launcher
    raises on tensors that are not on the card."""
    a, b = p3.probe_inputs(device="cpu")
    R, C = a.shape
    out = p3.df_probe_outputs(a)
    assert [tuple(o.shape) for o in out] == [(R, C)] * 4 + [(1, C)] * 2
    assert all(o.is_contiguous() and o.dtype == a.dtype for o in out)
    base = out[0].untyped_storage()
    assert all(o.untyped_storage().data_ptr() == base.data_ptr()
               for o in out)
    assert base.nbytes() == (4 * R * C + 2 * C) * a.element_size()
    assert [o.storage_offset() for o in out] == [
        0, R * C, 2 * R * C, 3 * R * C, 4 * R * C, 4 * R * C + C]
    with pytest.raises(ValueError, match="on the card"):
        p3.launch_df_probe(None, a, b, out)


@pytest.mark.cuda
def test_df_probe_kernel_is_bit_equal_to_plain_version():
    require_cuda()
    a, b = p3.probe_inputs(device="cuda")
    got = p3.df_probe(a, b)
    want = p3.df_probe_plain(a, b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    v = p3.exactness(a, b, got)
    assert v["two_sum_exact"] and v["two_prod_exact"]

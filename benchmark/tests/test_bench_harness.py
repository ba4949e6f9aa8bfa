"""CPU rehearsal of the harness at a tiny size: the loader, the mixes'
generators, the window and metric arithmetic, the roofline arithmetic,
the trace reader and the last line's form."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import perf, trace
from benchmark.run import Loader, Run, main, run_cell

from .conftest import cells

SEED = 2 ** 33 + 5


def _run(calls, window_s=None, trace_=None, dims=(1, 1, 1, 1)):
    window_s = window_s or calls[-1]["t_end"] - calls[0]["t_start"]
    return Run(cell={}, config={}, mix={}, dims=dims, calls=calls,
               window_s=window_s, setup_s=7.5, trace=trace_)


def _calls(times, lanes=4, ok=3, newton=8, prox=2, refine=4):
    out, t = [], 0.0
    for d in times:
        out.append(dict(t_start=t, t_end=t + d, lanes=lanes, ok=ok,
                        newton=newton, prox=prox, refine=refine))
        t += d
    return out


def test_loader_finds_new_files_by_name(tiny):
    """A configuration, a mix, a loop and a metric dropped in as new files,
    with entries added to BENCHMARK.json, run with no edit to any file the
    benchmark has."""
    base = tiny.base
    cfg = json.loads((base / "configs" / "spacecraft_n40.json").read_text())
    cfg.update(name="spacecraft_n3", horizon=3)
    (base / "configs" / "spacecraft_n3.json").write_text(json.dumps(cfg))
    (base / "traffic" / "pair.json").write_text(json.dumps(
        dict(loop="cold", batch=2, checked_lanes=2)))
    (base / "metrics" / "lanes_per_call.py").write_text(
        "def read(run):\n"
        "    return sum(c['lanes'] for c in run.calls) / len(run.calls)\n")
    spec = tiny.spec
    spec["configs"].append(dict(name="spacecraft_n3", source="x",
                                file="benchmark/configs/spacecraft_n3.json",
                                reduced=["horizon"], why="a test"))
    spec["workloads"].append(dict(name="spacecraft_n3.pair",
                                  config="spacecraft_n3", traffic="pair",
                                  chips=1, why="a test"))
    spec["end_to_end"].append(dict(name="lanes_per_call", unit="lanes",
                                   better="higher", bound=0.01,
                                   source="host_clock",
                                   workloads=["spacecraft_n3.pair"]))
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(Loader(tiny.root), "spacecraft_n3.pair", SEED, 0, False,
                   "cpu")
    assert out["metrics"]["lanes_per_call"]["value"] == 2.0
    assert out["correct"], out["checks"]


DENSE_LOOP = """
import torch
import fbstab_tpu_torch as fb


class Loop:
    def __init__(self, ctx):
        self.B, self.n, self.q = (int(ctx.mix["batch"]), ctx.config["n"],
                                  ctx.config["q"])
        self.dims = (self.n, self.q, 0)
        self.gen = torch.Generator().manual_seed(ctx.seed % 2 ** 63)

    def call(self):
        B, n, q, g, kw = self.B, self.n, self.q, self.gen, dict(
            dtype=torch.float64)
        M = torch.randn(B, n, n, generator=g, **kw)
        H = M @ M.transpose(1, 2) + torch.eye(n, **kw)
        f = torch.randn(B, n, generator=g, **kw)
        A = torch.randn(B, q, n, generator=g, **kw)
        b = torch.rand(B, q, generator=g, **kw)
        data = fb.dense_qp_data(H, f, A=A, b=b, device="cpu")
        x, core = fb.solve_dense_qp_batch(
            data, torch.zeros(B, n, **kw), torch.zeros(B, 0, **kw),
            torch.zeros(B, q, **kw), fb.Options())
        sample = dict(H=H, f=f, A=A, b=b, z=x.z, v=x.v)
        return dict(lanes=B, ok=int((core.eflag == 0).sum()),
                    newton=float(core.newton_iters.sum()),
                    prox=float(core.prox_iters.sum()), refine=0.0,
                    sample={k: t.numpy() for k, t in sample.items()})


def setup(ctx):
    return Loop(ctx)
"""

DENSE_REFERENCE = """
import numpy as np


def check(samples, config, device, find):
    worst = 0.0
    for s in samples:
        Az = np.einsum("bij,bj->bi", s["A"], s["z"])
        rz = (np.einsum("bij,bj->bi", s["H"], s["z"]) + s["f"]
              + np.einsum("bji,bj->bi", s["A"], s["v"]))
        rv = np.minimum(s["b"] - Az, s["v"])
        worst = max(worst, float(np.sqrt((rz ** 2).sum(1)
                                         + (rv ** 2).sum(1)).max()))
    return dict(kkt_max=worst)
"""


def test_loader_finds_a_new_problem_class_by_name(tiny):
    """A class of problem other than MPC (random strictly convex dense QPs
    through the program's dense solve) added as files alone: its
    configuration, mix, loop and plain reference, found by name; the
    harness core needs no plant, horizon or solver options of it."""
    base = tiny.base
    (base / "configs" / "dense_toy.json").write_text(json.dumps(dict(
        name="dense_toy", n=3, q=2, reference="dense_kkt",
        limits=dict(kkt_max=1e-6, failed_share=0.0))))
    (base / "traffic" / "dense_pair.json").write_text(json.dumps(
        dict(loop="dense_cold", batch=2)))
    (base / "loops" / "dense_cold.py").write_text(DENSE_LOOP)
    (base / "reference" / "dense_kkt.py").write_text(DENSE_REFERENCE)
    spec = tiny.spec
    spec["configs"].append(dict(name="dense_toy", source="x",
                                file="benchmark/configs/dense_toy.json",
                                reduced=[], why="a test"))
    spec["workloads"].append(dict(name="dense_toy.dense_pair",
                                  config="dense_toy", traffic="dense_pair",
                                  chips=1, why="a test"))
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(Loader(tiny.root), "dense_toy.dense_pair", SEED, 0,
                   False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] == 2 and out["failed"] == 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["checks"]["kkt_max"]["value"] < 1e-6


def test_split_metric_takes_the_reader_of_its_quantity(tiny):
    """`idle_pct.batch` reads with metrics/idle_pct.py; a reader of the
    whole name, where one is added, takes its place."""
    assert tiny.reader("idle_pct.batch") is tiny.module("metrics",
                                                        "idle_pct")
    (tiny.base / "metrics" / "qps.batch.py").write_text(
        "def read(run):\n    return 1.0\n")
    assert tiny.reader("qps.batch").read(None) == 1.0


def test_loader_refuses_unknown_and_unsafe_names(tiny):
    with pytest.raises(KeyError):
        tiny.cell("nope.cold")
    with pytest.raises(ValueError):
        tiny.module("metrics", "../run")
    with pytest.raises(FileNotFoundError):
        tiny.module("metrics", "not_a_metric")


@pytest.mark.parametrize("cell", cells())
def test_mix_generator_is_seeded(tiny, cell):
    """Each mix's loop draws the same inputs and checked lanes from the
    same seed, call after call, and others from another seed."""
    from benchmark.run import Ctx
    w = tiny.cell(cell)
    cfg, mix = tiny.config(w["config"]), tiny.mix(w["traffic"])
    loop = tiny.module("loops", mix["loop"])

    def draw(seed):
        ctx = Ctx(config=cfg, mix=mix, seed=seed, device=torch.device("cpu"),
                  overrides={}, trace=False, find=tiny.module)
        lp = loop.setup(ctx)
        return [lp.call()["sample"]["x0"] for _ in range(2)]

    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])       # new states every call


@pytest.mark.parametrize("cell", cells())
def test_each_cell_runs_tiny_on_the_cpu(tiny, cell):
    for traced in (False, True):
        out = run_cell(tiny, cell, SEED, 0, traced, "cpu")
        assert out["correct"], out["checks"]
        assert out["attempted"] == 4 and out["failed"] == 0
        want = {m["name"] for m in tiny.metrics(cell, traced)}
        # On the CPU the trace holds no kernel: the rooflines stay silent.
        got = set(out["metrics"])
        assert got <= want
        assert {n.split(".")[0] for n in want - got} <= {
            "k1_roofline", "k2_roofline", "k4_roofline"}
    idle = [v for k, v in out["metrics"].items() if k.startswith("idle_pct")]
    assert [v["value"] for v in idle] == [100.0]


def test_window_takes_whole_calls(tiny, monkeypatch):
    """The window ends when the first call that ends past --seconds
    completes; every call in it is counted whole. Each call of the fake
    loop takes 0.03 s of a fake clock: calls end at 0.03, 0.06, 0.09 and
    0.12 s, the fourth the first past 0.1 s."""
    from benchmark import run as run_mod
    clock = [100.0]
    monkeypatch.setattr(run_mod.time, "perf_counter", lambda: clock[0])

    class Loop:
        dims = (1, 1, 1, 1)

        def call(self):
            clock[0] += 0.03
            return dict(lanes=4, ok=3, newton=4.0, prox=4.0, refine=0.0,
                        sample=None)

    real = tiny.module
    parts = dict(loops=SimpleNamespace(setup=lambda ctx: Loop()),
                 reference=SimpleNamespace(
                     check=lambda *a: dict(residual_max=0.0)))
    monkeypatch.setattr(tiny, "module",
                        lambda kind, name: parts.get(kind) or real(kind,
                                                                   name))
    out = run_cell(tiny, "spacecraft_n40.cold_b8192", SEED, 0.1, False,
                   "cpu")
    assert out["attempted"] == 16 and out["failed"] == 4
    assert out["metrics"]["qps"]["value"] == pytest.approx(12 / 0.12)


def test_window_arithmetic():
    calls = _calls([0.5, 0.25, 0.25, 1.0])
    run = _run(calls)
    load = lambda n: Loader().module("metrics", n)
    assert load("qps").read(run) == 12 / 2.0
    assert load("newton_per_qp").read(run) == 2.0
    assert load("setup_s").read(run) == 7.5
    assert load("batch_ms").read(run) == pytest.approx(2000.0 / 4)
    # p90 over all four calls (numpy's linear interpolation).
    assert load("step_p90_ms").read(run) == pytest.approx(
        np.percentile([500, 250, 250, 1000], 90))
    assert load("relay_ms").read(run) is None
    for c, r in zip(calls, (0.001, 0.003, 0.002, 0.002)):
        c["relay_s"] = r
    assert load("relay_ms").read(run) == pytest.approx(2.0)


def test_roofline_arithmetic_by_hand():
    # One stage pair (N = 1) of nx = nu = nc = 1: each stage of the Riccati
    # step counts 2*1*3 + 2 + 1/3 + 1 + 1/3 + 2 + 1 + 2 + 1 + 1/3 + 2 + 2
    # + 12*3 = 56 operations, two stages 112.
    assert perf.riccati_flops(1, 1, 1, 1) == pytest.approx(112.0)
    # The residual: 2 * (2*4 + 6*2 + 2*2 + 10) = 68; the data: two stages
    # of 8 floats, one of 3, and x0: 20.
    assert perf.mpc_residual_flops(1, 1, 1, 1) == 68
    assert perf.mpc_data_floats(1, 1, 1, 1) == 20
    # A solve of 10 instances at 3 Newton and 1 proximal iteration:
    # 10 * (3 * (112 + 16 + 3*68) + 2 * 3 * 68) = 14,040 operations; the
    # bytes: 4 * 10 * (20 + (10 - 2) + 10 + 5) = 1,720 (a point, z, l, v
    # and y, is 2 stages of 5 floats, v's 2 not read).
    assert perf.mpc_solve_flops(10, 1, 1, 1, 1, 3, 1) == pytest.approx(14040)
    assert perf.mpc_solve_bytes(10, 1, 1, 1, 1) == 1720
    assert perf.subproblem_bytes(10, 1, 1, 1, 1, 2) == 4 * 10 * 2 * 48
    # Bytes bound it: 1,720 / 3.35e12 s against 14,040 / 67e12 s.
    ms, by = perf.bound(14040, 1720)
    assert by == "bytes" and ms == pytest.approx(1720 / 3.35e12 * 1e3)
    # K2's share: that bound over 1 ms of mpc_solve_kernel.
    calls = _calls([1.0], lanes=10, newton=30, prox=10)
    tr = trace.Trace(window_s=1.0, busy_s=0.5,
                     by_name={"void mpc_solve_kernel<6>(...)": [1e-3, 1]},
                     gaps=[])
    got = Loader().module("metrics", "k2_roofline").read(
        _run(calls, trace_=tr))
    assert got == pytest.approx(100 * (1720 / 3.35e12) / 1e-3)
    # K1: 4 refinement steps a call, each 112 operations and
    # 4 * (2*(1+1+1+1+1) + (1+1) + 2*(3+2+1+1) + 2*(2+1)) = 128 bytes.
    assert perf.riccati_step_bytes(1, 1, 1, 1, 1) == 128
    tr.by_name = {"riccati_step_kernel": [2e-6, 4]}
    got = Loader().module("metrics", "k1_roofline").read(
        _run(_calls([1.0]), trace_=tr))
    assert got == pytest.approx(100 * (4 * 128 / 3.35e12) / 2e-6)
    assert Loader().module("metrics", "idle_pct").read(
        _run(_calls([1.0]), trace_=tr)) == pytest.approx(50.0)


class _Ev:
    def __init__(self, name, s, e, cuda=False):
        self._n, self._s, self._e, self._c = name, s, e, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_trace_reader_unions_and_names_gaps():
    ev = [_Ev(trace.WINDOW, 0, 1000), _Ev("solve", 0, 600),
          _Ev("aten::item", 400, 460), _Ev("relay", 600, 1000),
          _Ev("k_a", 100, 300, True), _Ev("k_b", 200, 400, True),
          _Ev("Memcpy DtoH", 450, 480, True), _Ev("solve", 0, 1000, True),
          _Ev(trace.WINDOW, 0, 1000, True),
          _Ev("k_a", 900, 1200, True)]
    tr = trace.read(ev)
    assert tr.window_s == 1e-6
    # Busy: 100-400, 450-480 and 900-1000 (clipped to the window); the
    # spans mirrored on the device's timeline are no activity.
    assert tr.busy_s == pytest.approx((300 + 30 + 100) / 1e9)
    assert tr.kernel_s("k_a") == pytest.approx(300e-9)
    assert tr.launches("k_a") == 2
    # Gaps 480-900, 0-100 and 400-450, longest first, each named by the
    # loop's phase and the innermost host op at its middle.
    assert [n for n, _ in tr.gaps] == ["relay", "solve", "solve: aten::item"]
    assert [d for _, d in tr.gaps] == pytest.approx([420e-9, 100e-9, 50e-9])
    bd = tr.breakdown()
    assert [n for n, _ in bd["device_ops"]][0] == "k_a"


def test_last_line_form(tiny, capsys):
    out = run_cell(tiny, "copoly_n80.cold_b2048", SEED, 0, False, "cpu")
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert json.loads(json.dumps(out)) == out


def test_no_card_no_result(capsys, monkeypatch):
    """The measurement path refuses to run without a card: a non-zero
    exit and nothing on standard output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", cells()[0], "--seed", "1", "--seconds", "1",
               "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints nothing on standard output."""
    import os
    import shutil
    import subprocess
    import sys
    from .conftest import REPO
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cells()[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""

"""The per-layer metrics that read the program's own spans and counters
(benchmark/spans.py, fbstab_tpu_torch/telemetry.py): each reader's
arithmetic on a synthetic snapshot, silence where nothing was recorded,
the split names' readers, a tiny traced run on the CPU, and with
`-m cuda` one short traced run on the card whose device trace holds no
span of the program."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import spans
from benchmark.run import Loader, Run, run_cell

from .conftest import REPO

SEED = 2 ** 31 + 977
NEW = ("scaling_ms", "solve_ms", "refine_ms", "refine_residual_ms",
       "refine_useful", "host_syncs", "warmstart_ms")


def _span(device_s, counts=None):
    return dict(calls=1, batches=1, host_s=device_s, self_host_s=0.0,
                device_s=device_s, self_device_s=0.0, counts=counts or {})


SNAPSHOT = {
    "fbstab.mpc_batch": _span(4.0),
    "fbstab.scaling": _span(0.2),
    "fbstab.solve": _span(1.0, {"k4.outer_iters": 8}),
    "fbstab.sync.k4_any_lane": _span(0.01, {"host_sync.k4_any_lane": 10}),
    "fbstab.retry": _span(0.02),
    "fbstab.sync.retry_any": _span(0.001, {"host_sync.retry_any": 2}),
    "fbstab.refine": _span(2.6, {"refine.steps": 12,
                                 "refine.lanes_pending": 300,
                                 "refine.lanes_stepped": 1200}),
    "fbstab.refine.residual": _span(1.4),
    "fbstab.sync.refine_exit": _span(0.05, {"host_sync.refine_exit": 14}),
    "fbstab.refine.gather": _span(0.03, {"host_sync.refine_gather": 4}),
    "fbstab.shift_warmstart": _span(0.004),
}


def _run(calls=2, traced=True):
    return Run(cell={}, config={}, mix={}, dims=(1, 1, 1, 1),
               calls=[{} for _ in range(calls)], window_s=1.0, setup_s=1.0,
               trace=SimpleNamespace() if traced else None)


def _read(name, run):
    return Loader().reader(name).read(run)


def test_readers_on_a_snapshot(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: SNAPSHOT)
    run = _run(calls=2)
    assert _read("scaling_ms", run) == pytest.approx(100.0)
    assert _read("solve_ms", run) == pytest.approx(500.0)
    assert _read("refine_ms", run) == pytest.approx(1300.0)
    assert _read("refine_residual_ms", run) == pytest.approx(700.0)
    assert _read("refine_useful", run) == pytest.approx(25.0)
    assert _read("host_syncs", run) == pytest.approx((10 + 2 + 14 + 4) / 2)
    assert _read("warmstart_ms", run) == pytest.approx(2.0)


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_without_spans(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert _read(name, _run()) is None
    monkeypatch.setattr(spans, "recorded", lambda: SNAPSHOT)
    assert _read(name, _run(traced=False)) is None


def test_span_and_counter_readers_need_their_own_names(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: {
        "fbstab.mpc_batch": _span(1.0),
        "fbstab.solve": dict(_span(1.0), device_s=None)})
    assert _read("solve_ms", _run()) is None        # no device extent
    assert _read("refine_ms", _run()) is None       # no such span
    assert _read("refine_useful", _run()) is None   # no lane stepped
    assert _read("host_syncs", _run()) == 0.0       # recorded, no reads


def test_a_program_without_telemetry_gives_none(monkeypatch):
    """A checkout of the program from before its spans has no telemetry
    module: its traced runs leave these metrics out."""
    import sys

    import fbstab_tpu_torch
    monkeypatch.delattr(fbstab_tpu_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "fbstab_tpu_torch.telemetry", None)
    assert spans.recorded() is None
    assert _read("solve_ms", _run()) is None


@pytest.mark.parametrize("name", ["solve_ms", "refine_ms", "host_syncs"])
def test_split_names_take_their_quantitys_reader(name):
    loader = Loader()
    assert (loader.reader(f"{name}.batch")
            is loader.module("metrics", name))


def test_each_new_metric_names_its_cells():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in spec["workloads"]}
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert set(by_name[name]["workloads"]) <= cells
    assert by_name["warmstart_ms"]["workloads"] == ["copoly_n80.track"]
    for name in ("solve_ms", "refine_ms", "host_syncs"):
        assert by_name[f"{name}.batch"]["workloads"] == [
            "spacecraft_n40.cold_b1024"]


def test_tiny_traced_track_run_reports_the_new_metrics(tiny):
    from fbstab_tpu_torch import telemetry
    telemetry.reset()
    out = run_cell(tiny, "copoly_n80.track", SEED, 0, True, "cpu")
    telemetry.reset()
    want = {m["name"] for m in tiny.metrics("copoly_n80.track", True)}
    for name in set(NEW) & want:
        assert out["metrics"][name]["value"] >= 0, name


@pytest.mark.cuda
def test_cuda_traced_run_has_no_span_on_the_device(monkeypatch):
    """One short traced run of spacecraft_n40.cold_b1024 on the card: no
    device event carries the program's span names, and every per-layer
    metric the cell lists is reported."""
    import torch
    from torch.autograd import DeviceType

    from benchmark import trace
    from fbstab_tpu_torch import telemetry
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seen = {}
    events_of = trace.events_of

    def keep(prof):
        seen["events"] = events_of(prof)
        return seen["events"]

    monkeypatch.setattr(trace, "events_of", keep)
    telemetry.reset()
    loader = Loader()
    cell = "spacecraft_n40.cold_b1024"
    out = run_cell(loader, cell, SEED, 2.0, True, torch.device("cuda", 0))
    telemetry.reset()
    assert out["correct"], out["checks"]
    on_device = [e.name() for e in seen["events"]
                 if e.device_type() == DeviceType.CUDA]
    assert on_device
    assert not [n for n in on_device if n.startswith("fbstab.")]
    assert not [n for n, _ in out["breakdown"]["device_ops"]
                if n.startswith("fbstab.")]
    want = {m["name"] for m in loader.metrics(cell, True)}
    assert want <= set(out["metrics"]), want - set(out["metrics"])

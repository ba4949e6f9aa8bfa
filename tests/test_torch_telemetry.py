"""The port's spans and counters (fbstab_tpu_torch/telemetry.py) on the MPC
batch path: spans only under torch.profiler, as CPU events that are not
user annotations, nested as the code nests them; counters always; the
same results with the profiler on and off. The card's cases (marked
`cuda`) add that no span reaches the device's timeline and that the
spans' device extents tile the call."""

import dataclasses
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch_parity import launches, require_cuda  # noqa: E402

from fbstab_tpu_torch import telemetry  # noqa: E402
from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.workloads import build_plant, zeros_guess  # noqa: E402

# Each span's parent on the batch path.
PARENT = {"fbstab.scaling": "fbstab.mpc_batch",
          "fbstab.solve": "fbstab.mpc_batch",
          "fbstab.refine": "fbstab.mpc_batch",
          "fbstab.refine.step": "fbstab.refine",
          "fbstab.refine.k1": "fbstab.refine.step",
          "fbstab.refine.residual": "fbstab.refine.step"}
NAMES = ("fbstab.mpc_batch",) + tuple(PARENT)


def _plant(name, N, B, device="cpu"):
    data = build_plant(name, N, B, 1e-3, device)
    return data, zeros_guess(data)


def _delta(before):
    now = telemetry.counters()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def _spans(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("fbstab.")]


def _call(data, guess, opts, activities=None):
    """One solve_mpc_qp_batch call from a clean registry: (x, core,
    counters it added, recorded(), the profiler's fbstab.* events)."""
    telemetry.reset()
    if activities is None:
        x, core = solve_mpc_qp_batch(data, *guess, opts)
        events = []
    else:
        with profile(activities=activities) as prof:
            x, core = solve_mpc_qp_batch(data, *guess, opts)
        events = _spans(prof)
    return x, core, telemetry.counters(), telemetry.recorded(), events


@pytest.fixture(scope="module")
def spacecraft_calls():
    """The same float32 spacecraft batch (N = 3, two lanes) solved with the
    profiler off, then on (CPU activity), from the point a first solve
    returned (the profiler slows the CPU's many small ops fivefold, and
    a warm start keeps the refinement's steps)."""
    data, guess = _plant("spacecraft_relative_motion", 3, 2)
    opts = Options.single_precision()
    hi = solve_mpc_qp_batch(data, *guess, opts)[0].hi()
    guess = (hi.z, hi.l, hi.v)
    off = _call(data, guess, opts)
    on = _call(data, guess, opts, [ProfilerActivity.CPU])
    telemetry.reset()
    return off, on


def test_unprofiled_call_records_no_span_but_counts_reads(spacecraft_calls):
    (_, core, counts, rec, _), _ = spacecraft_calls
    assert rec == {}
    assert counts["host_sync.retry_any"] == 1
    steps = int(core.refine_steps.max())
    assert counts["refine.steps"] == steps > 0
    assert counts["host_sync.refine_exit"] >= steps


def test_profiled_call_spans_are_nested_cpu_events(spacecraft_calls):
    _, (_, _, counts, rec, events) = spacecraft_calls
    by_name = {n: [e for e in events if e.name() == n] for n in NAMES}
    for name in NAMES:
        assert by_name[name], name
        assert rec[name]["calls"] == len(by_name[name]), name
        assert rec[name]["batches"] == 1, name
    assert len(by_name["fbstab.mpc_batch"]) == 1
    for e in events:
        assert not e.is_user_annotation(), e.name()
        assert str(e.device_type()).endswith("CPU"), e.name()
    for child, parent in PARENT.items():
        for c in by_name[child]:
            assert any(p.start_ns() <= c.start_ns() <= c.end_ns()
                       <= p.end_ns() for p in by_name[parent]), child
    # A counter added under the profiler is attributed to its span.
    assert (rec["fbstab.sync.refine_exit"]["counts"]["host_sync.refine_exit"]
            == counts["host_sync.refine_exit"])
    # On the CPU a span's device extent is its host extent.
    top = rec["fbstab.mpc_batch"]
    assert top["device_s"] == top["host_s"] > 0
    assert 0 <= top["self_host_s"] < top["host_s"]


def test_profiler_on_and_off_give_the_same_bits(spacecraft_calls):
    (x_off, c_off, n_off, _, _), (x_on, c_on, n_on, _, _) = spacecraft_calls
    for a, b in zip(x_off, x_on):
        for p, q in zip(a, b):
            assert torch.equal(p, q)
    for a, b in zip(c_off, c_on):
        assert torch.equal(a, b)
    assert n_off == n_on


def test_outer_iterations_count_k4_launch_spans():
    from fbstab_tpu_torch.models.mpc_subfused import (
        fbstab_mpc_solve_subfused)
    from fbstab_tpu_torch.ops.mpc_subproblem_cuda import (
        mpc_subproblem_plain)
    data, guess = _plant("servo_motor", 4, 3)
    data = data._replace(**{k: getattr(data, k).double()
                            for k in data._fields})
    guess = tuple(g.double() for g in guess)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, core = fbstab_mpc_solve_subfused(
            data, *guess, Options(abs_tol=1e-8),
            subproblem=mpc_subproblem_plain)
    counts, rec = telemetry.counters(), telemetry.recorded()
    spans = [e for e in _spans(prof) if e.name() == "fbstab.k4.launch"]
    iters = counts["k4.outer_iters"]
    assert iters == len(spans) == rec["fbstab.k4.launch"]["calls"] > 0
    assert iters == rec["fbstab.k4.exits"]["calls"]
    # Every iteration reads the any-lane flag, and so does the exit.
    assert counts["host_sync.k4_any_lane"] in (iters, iters + 1)
    assert int(core.prox_iters.max()) <= iters
    telemetry.reset()


@pytest.mark.parametrize("budget", [1, 2, 50])
def test_refinement_exit_reads_equal_its_exit_tests(budget):
    """One exit test (and read) before each step, and one more where the
    loop stops before its budget."""
    data, guess = _plant("servo_motor", 4, 2)
    opts = dataclasses.replace(Options.single_precision(),
                               refine_steps=budget)
    before = telemetry.counters()
    _, core = solve_mpc_qp_batch(data, *guess, opts)
    counts = _delta(before)
    steps = int(core.refine_steps.max())
    assert 0 < steps <= budget
    assert counts["refine.steps"] == steps
    assert counts["host_sync.refine_exit"] == steps + (steps < budget)
    assert counts["refine.lanes_stepped"] == 2 * steps
    assert 0 < counts["refine.lanes_pending"] <= 2 * steps


def test_counts_from_many_threads_are_not_lost():
    before = telemetry.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            telemetry.count("test.threads") for _ in range(5000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert telemetry.counters()["test.threads"] - before == 16 * 5000


@pytest.mark.cuda
def test_cuda_spans_stay_off_the_device_timeline_and_tile_the_call():
    """On the card at the spacecraft's benchmark horizon (N = 40, K2): no
    device event carries a span's name, the spans' device extents tile
    the call (the batch's own extent outside its children under 3%), the
    solve's extent holds K2's kernel time, and the bits are the
    unprofiled call's."""
    require_cuda()
    from torch.autograd import DeviceType
    data, guess = _plant("spacecraft_relative_motion", 40, 256, "cuda")
    opts = Options.single_precision()
    solve_mpc_qp_batch(data, *guess, opts)      # build, load, warm
    x_off, c_off, _, _, _ = _call(data, guess, opts)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x_on, c_on = solve_mpc_qp_batch(data, *guess, opts)
        torch.cuda.synchronize()
    assert launches("k2") == 1
    rec = telemetry.recorded()
    events = prof.profiler.kineto_results.events()
    on_device = [e for e in events if e.device_type() == DeviceType.CUDA]
    assert on_device
    assert not [e.name() for e in on_device
                if e.name().startswith("fbstab.")]
    k2_s = sum(e.end_ns() - e.start_ns() for e in on_device
               if "mpc_solve_kernel" in e.name()) / 1e9
    top = rec["fbstab.mpc_batch"]
    assert 0 < top["device_s"] <= top["host_s"] * 1.01
    assert abs(top["self_device_s"]) <= 0.03 * top["device_s"]
    assert rec["fbstab.solve"]["device_s"] >= 0.99 * k2_s > 0
    assert (rec["fbstab.refine.residual"]["device_s"]
            <= rec["fbstab.refine"]["device_s"])
    for a, b in zip(x_off, x_on):
        for p, q in zip(a, b):
            assert torch.equal(p, q)
    for a, b in zip(c_off, c_on):
        assert torch.equal(a, b)
    telemetry.reset()

"""Reading a traced window: device time by kernel, the device's busy time,
and the longest idle gaps named by what the host was doing.

The method is that of fbstab_tpu_torch/tools/profile_paths.py at commit
326587a: `torch.profiler` with CPU and CUDA activities, the device events
summed by name. The events are read as the profiler's raw records
(`kineto_results.events()`), which a long window yields in a fraction of
the time `prof.events()` takes to build. Busy time here is the union of
the device's activity inside the window (kernels, copies, sets), so the
idle share 1 - busy / window is an upper bound: the profiler's own host
work stretches the window.
"""

from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType

# The record_function span that the harness opens around the window.
WINDOW = "benchmark.window"
# The spans the loops open around their phases (loops/*.py). The
# profiler mirrors each span on the device's timeline: no activity.
PHASES = ("inputs", "solve", "relay", "record")
TOP = 10


class Trace:
    """What one traced window read: `window_s`, `busy_s`, seconds and
    launches by device op name, and the `TOP` longest idle gaps."""

    def __init__(self, window_s, busy_s, by_name, gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.by_name = by_name     # name -> [seconds, launches]
        self.gaps = gaps           # [(host activity, seconds)]

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the ops whose name contains `fragment`."""
        return sum(s for n, (s, _) in self.by_name.items() if fragment in n)

    def launches(self, fragment: str) -> int:
        return sum(k for n, (_, k) in self.by_name.items() if fragment in n)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        return dict(device_ops=[[n[:120], s] for n, (s, _) in ops],
                    idle_gaps=[[n, s] for n, s in self.gaps])


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_activity(cpu, t) -> str:
    """The loop's phase and the innermost host op running at time t."""
    phase, inner, inner_len = None, None, None
    for s, e, name in cpu:
        if s > t:
            break
        if e < t:
            continue
        if name in PHASES:
            phase = name
        elif name != WINDOW and (inner_len is None or e - s < inner_len):
            inner, inner_len = name, e - s
    parts = [p for p in (phase, inner) if p]
    return ": ".join(parts) if parts else "outside any host op"


def events_of(prof) -> list:
    """The raw records of a finished torch.profiler.profile."""
    return prof.profiler.kineto_results.events()


def read(events) -> Trace:
    """A Trace from the profiler's raw records (`events_of`) of one run
    whose window lies inside the WINDOW span. Times in nanoseconds."""
    win, cpu, dev = None, [], []
    for e in events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if name != WINDOW and name not in PHASES:
                dev.append((s, t, name))
        else:
            if name == WINDOW:
                win = (s, t)
            cpu.append((s, t, name))
    if win is None:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w0, w1 = win
    by_name = defaultdict(lambda: [0.0, 0])
    clipped = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        by_name[name][0] += (t - s) / 1e9
        by_name[name][1] += 1
        clipped.append((s, t))
    busy = _merge(clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)[:TOP]
    cpu.sort()
    named = [(_host_activity(cpu, s + d / 2), d / 1e9) for d, s in gaps
             if d > 0]
    return Trace(window_s=(w1 - w0) / 1e9,
                 busy_s=sum(e - s for s, e in busy) / 1e9,
                 by_name=dict(by_name), gaps=named)

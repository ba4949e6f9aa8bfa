"""Spans and counters inside the port, read by torch.profiler and the
benchmark's per-layer metrics.

`span(name, like=None)` marks a region of the program. It records only
while a torch.profiler session is active (asked at the span's entry);
otherwise it returns a shared no-op context manager and does nothing
else. A recorded span

- opens a `torch._C._profiler._RecordFunctionFast` of its name, so it
  shows in the profiler's CPU timeline and in an exported Chrome trace,
  on the clock of the device's events. `record_function` is a user
  annotation, which kineto also copies onto the device's timeline, where
  a trace reader counts it as device activity; this one it does not copy;
- keeps its host start and end (`time.perf_counter_ns`), its parent span
  and a call id, the number of outermost `fbstab.mpc_batch` spans entered
  so far, which the spans of one batch share;
- on a CUDA stream, records a pair of timing events (pooled) around its
  work, which gives its device-timeline extent: from the stream reaching
  the span's start to the completion of the last work enqueued inside it.
  Sibling spans tile the stream, so the extents put the device's time,
  the idle inside a layer included, down to that layer; a host duration
  cannot, since a kernel's launch returns at once. While the stream is
  captured into a CUDA graph no event is recorded.

The stream is the current stream of the device of `like` (a tensor the
span's work runs on), or else the parent span's. On the CPU the ops run
as they are issued, so a span there has its host extent as its device
extent.

`count(name, n=1)` is always on: it adds `n` to an all-time total and to
the innermost open recorded span of the calling thread, so a counter can
also be read for a traced window alone. `counters()` returns the totals,
`recorded()` the recorded spans aggregated by name, `reset()` clears
both.

The module keeps its spans in memory and writes nothing. An operator
reads them through the profiler's own export:

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_mpc_qp_batch(data, z0, l0, v0, Options.single_precision())
    prof.export_chrome_trace("trace.json")   # the fbstab.* rows: CPU track

Spans of one name do not nest in one another on the port's paths; the
aggregates of `recorded()` rely on that.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

TOP = "fbstab.mpc_batch"
_NOOP = contextlib.nullcontext()
_HOST = "host"


class _Stack(threading.local):
    def __init__(self):
        self.open = []


class _Span:
    __slots__ = ("reg", "name", "like", "parent", "call", "stream", "rf",
                 "t0", "t1", "ev", "counts")

    def __init__(self, reg, name, like):
        self.reg, self.name, self.like = reg, name, like
        self.ev = None
        self.counts = {}

    def __enter__(self):
        reg = self.reg
        stack = reg._local.open
        self.parent = stack[-1] if stack else None
        if self.name == TOP and all(s.name != TOP for s in stack):
            reg._calls += 1
        self.call = reg._calls
        like = self.like
        self.like = None
        if like is not None:
            self.stream = (torch.cuda.current_stream(like.device)
                           if like.is_cuda else _HOST)
        else:
            self.stream = self.parent.stream if self.parent else None
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if (isinstance(self.stream, torch.cuda.Stream)
                and not torch.cuda.is_current_stream_capturing()):
            self.ev = (reg._event(self.stream.device), None)
            self.ev[0].record(self.stream)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev is not None:
            end = self.reg._event(self.stream.device)
            end.record(self.stream)
            self.ev = (self.ev[0], end)
        self.reg._local.open.pop()
        self.rf.__exit__(None, None, None)
        with self.reg._lock:
            self.reg._done.append(self)
        return False


class Registry:
    """Counters and recorded spans of one process (the module's functions
    act on one shared instance)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = _Stack()
        self._counts = {}
        self._done = []
        self._pool = {}
        self._calls = 0

    def span(self, name: str, like=None):
        if not torch._C._autograd._profiler_enabled():
            return _NOOP
        return _Span(self, name, like)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
        stack = self._local.open
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def _event(self, device):
        pool = self._pool.setdefault(device, [])
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def recorded(self) -> dict:
        """The recorded spans by name: `calls` (entries), `batches`
        (distinct call ids), `host_s`, `self_host_s` (less the host time
        of its child spans), `device_s` (device-timeline extent; None
        where no span of the name ran on a known device), `self_device_s`
        (less its child spans' extents) and `counts` (the counters added
        while the span was the innermost open one). Synchronizes each
        device that recorded events once."""
        with self._lock:
            done = list(self._done)
        for dev in {s.stream.device for s in done if s.ev is not None}:
            torch.cuda.synchronize(dev)
        extent = {}
        for s in done:
            if s.ev is not None:
                extent[id(s)] = s.ev[0].elapsed_time(s.ev[1]) / 1e3
            elif s.stream is _HOST:
                extent[id(s)] = (s.t1 - s.t0) / 1e9
        child_host, child_dev = {}, {}
        for s in done:
            if s.parent is not None:
                p = id(s.parent)
                child_host[p] = child_host.get(p, 0) + (s.t1 - s.t0) / 1e9
                if id(s) in extent:
                    child_dev[p] = child_dev.get(p, 0.0) + extent[id(s)]
        out = {}
        for s in done:
            a = out.setdefault(s.name, dict(
                calls=0, batches=set(), host_s=0.0, self_host_s=0.0,
                device_s=None, self_device_s=None, counts={}))
            host = (s.t1 - s.t0) / 1e9
            a["calls"] += 1
            a["batches"].add(s.call)
            a["host_s"] += host
            a["self_host_s"] += host - child_host.get(id(s), 0.0)
            if id(s) in extent:
                e = extent[id(s)]
                a["device_s"] = (a["device_s"] or 0.0) + e
                a["self_device_s"] = ((a["self_device_s"] or 0.0) + e
                                      - child_dev.get(id(s), 0.0))
            for k, n in s.counts.items():
                a["counts"][k] = a["counts"].get(k, 0) + n
        for a in out.values():
            a["batches"] = len(a["batches"])
        return out

    def reset(self) -> None:
        with self._lock:
            for s in self._done:
                if s.ev is not None:
                    self._pool.setdefault(s.stream.device, []).extend(s.ev)
            self._done.clear()
            self._counts.clear()
            self._calls = 0


_REGISTRY = Registry()
span = _REGISTRY.span
count = _REGISTRY.count
counters = _REGISTRY.counters
recorded = _REGISTRY.recorded
reset = _REGISTRY.reset

"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are entries of BENCHMARK.json; everything that belongs to one of them
lives in files of its own under benchmark/, found by name (`Loader`):
configs/<file>.json, traffic/<mix>.json, loops/<loop>.py,
reference/<reference>.py and metrics/<metric>.py, and whatever those
modules look up by name in turn (plants/<plant>.py for the MPC class).
This module is the harness core and knows no cell and no class of
problem: it parses the arguments, refuses to run without the cards the
cell asks for, hands the configuration and the mix to the mix's loop
(which builds the problem, makes the inputs from the seed and warms up),
times the window, traces it with --trace 1, hands the checked lanes and
the configuration to the configuration's reference once the window has
closed, and prints one JSON line last on standard output, after the
numbers compared, each beside its limit, as the last lines on standard
error.

The window starts at the first timed call and ends when the first call
that ends at or past --seconds completes, so every call in it is whole.
A traced run measures at most TRACE_SECONDS of it: the profiler's own
processing of a longer window would take the run past its time limit.
The program's CUDA library is built by the program itself into
fbstab_tpu_torch/_build/ inside the checkout, keyed by a hash of its
sources; the build and kernel caches of PyTorch and Triton are pointed
into .bench_cache/ inside the checkout.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fbstab_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TRACE_SECONDS = 15.0


def cache_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark may not hold,
    compared whole (fbstab_tpu_torch is not fbstab_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Loader:
    """Finds a cell's parts by name under `root`: BENCHMARK.json, and the
    files under root/benchmark/."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.base = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._mods = {}

    @staticmethod
    def _name(name: str) -> str:
        if not isinstance(name, str) or not _NAME.match(name):
            raise ValueError(f"not a benchmark name: {name!r}")
        return name

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r}; BENCHMARK.json has "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r}")

    def mix(self, name: str) -> dict:
        path = self.base / "traffic" / f"{self._name(name)}.json"
        return json.loads(path.read_text())

    def module(self, kind: str, name: str):
        key = (kind, self._name(name))
        if key not in self._mods:
            path = self.base / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"benchmark.{kind}.{name}", path)
            if spec is None or not path.is_file():
                raise FileNotFoundError(f"no {kind} module {path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._mods[key] = mod
        return self._mods[key]

    def reader(self, metric: str):
        """The reader of a metric: metrics/<name>.py, or, for a quantity
        split by the end-to-end metric it moves (`idle_pct.batch`), the
        reader of the part before the first dot where the whole name has
        none of its own."""
        whole = self.base / "metrics" / f"{self._name(metric)}.py"
        return self.module("metrics", metric if whole.is_file()
                           else metric.split(".")[0])

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` reports: the end-to-end ones
        untraced, the per-layer ones traced; each where it names the cell
        or names no cells."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Ctx:
    """What a loop is given: the configuration and mix as read, the seed,
    the device, the fields of the solver's options that the run replaces
    (the control's), whether the run is traced, and `find(kind, name)`,
    the loader's lookup of a module of the benchmark by name."""

    config: dict
    mix: dict
    seed: int
    device: object
    overrides: dict
    trace: bool
    find: object

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Run:
    """What the metric readers read: the cell, configuration and mix, the
    problem's dims as its loop gives them (N, nx, nu, nc for the MPC
    class), the window's calls in order (each with
    t_start, t_end, lanes, ok, newton, prox, refine and, where the loop
    has it, relay_s), the window and set-up seconds and, traced, the
    Trace (benchmark/trace.py)."""

    cell: dict
    config: dict
    mix: dict
    dims: tuple
    calls: list
    window_s: float
    setup_s: float
    trace: object = None


def run_cell(loader: Loader, name: str, seed: int, seconds: float,
             trace: bool, device, overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """Runs one cell on `device` and returns its result (the JSON line's
    keys, `checks` last). `overrides` replaces fields of the
    configuration's solver options (the control turns refinement off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as tracing

    t_start = time.perf_counter() if t_start is None else t_start
    cell = loader.cell(name)
    cfg = loader.config(cell["config"])
    mix = loader.mix(cell["traffic"])
    ctx = Ctx(config=cfg, mix=mix, seed=int(seed),
              device=torch.device(device), overrides=dict(overrides or {}),
              trace=bool(trace), find=loader.module)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.empty(0, device=ctx.device)      # the context, before reset
        torch.cuda.reset_peak_memory_stats(ctx.device)

    loop = loader.module("loops", mix["loop"]).setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    calls = []
    with (record_function(tracing.WINDOW) if trace
          else contextlib.nullcontext()):
        t0 = t_prev = time.perf_counter()
        while True:
            rec = loop.call()
            t = time.perf_counter()
            rec.update(t_start=t_prev, t_end=t)
            calls.append(rec)
            t_prev = t
            if t - t0 >= seconds:
                break
    window_s = calls[-1]["t_end"] - t0
    read = None
    if prof is not None:
        prof.__exit__(None, None, None)
        read = tracing.read(tracing.events_of(prof))
        del prof
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    samples = [c.pop("sample") for c in calls]
    dims = tuple(loop.dims)
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = loader.module("reference", cfg["reference"]).check(
        samples, cfg, ctx.device, loader.module)
    attempted = sum(c["lanes"] for c in calls)
    failed = attempted - sum(c["ok"] for c in calls)
    numbers["failed_share"] = failed / attempted
    checks = {k: dict(value=numbers.get(k), limit=lim)
              for k, lim in cfg["limits"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    run = Run(cell=cell, config=cfg, mix=mix, dims=dims, calls=calls,
              window_s=window_s, setup_s=setup_s, trace=read)
    metrics = {}
    for m in loader.metrics(name, trace):
        value = loader.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    dev = dict(platform="gpu" if cuda else ctx.device.type,
               kind=(torch.cuda.get_device_name(ctx.device) if cuda
                     else "cpu"),
               count=int(cell["chips"]), memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=attempted, failed=failed,
               metrics=metrics, device=dev)
    if read is not None:
        dev.update(busy_s=read.busy_s, window_s=read.window_s)
        out["breakdown"] = read.breakdown()
    out["reference"] = {k: v for k, v in numbers.items() if k not in checks}
    out["checks"] = checks
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch
    torch.set_num_threads(1)    # one launching thread; no spinning pool

    loader = Loader(ROOT)
    cell = loader.cell(args.workload)
    import fbstab_tpu_torch
    if not Path(fbstab_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"fbstab_tpu_torch comes from {fbstab_tpu_torch.__file__}, "
              f"not from this checkout ({ROOT}): no result", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    out = run_cell(loader, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0),
                   t_start=_T_START)
    held = forbidden_modules()
    if held:
        print(f"the run holds forbidden modules {held}: no result",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

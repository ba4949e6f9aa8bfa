"""Readings of the numbers that decide `correct`, for setting their limits.

    python3 -m benchmark.readings --workload <cell> --seconds <s> --seeds 1 2 3 [--control]

Runs the cell once for each seed in one process (the library loads once),
through the harness's own run, and prints one JSON line a seed: the seed,
`correct`, and each number compared with its limit. With --control the
program runs with its refinement switched off (`refine_steps=0`): its
float32 solve alone, the step below the configuration's contract that a
change could be tempted to take. A control that comes out correct is a
comparison that cannot fail. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import ROOT, Loader, cache_env, forbidden_modules, run_cell

CONTROL = {"refine_steps": 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: no readings", file=sys.stderr)
        return 2
    loader = Loader(ROOT)
    for seed in args.seeds:
        out = run_cell(loader, args.workload, seed, args.seconds, False,
                       torch.device("cuda", 0),
                       overrides=CONTROL if args.control else None)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, control=args.control,
            correct=out["correct"], attempted=out["attempted"],
            failed=out["failed"], reference=out["reference"],
            checks=out["checks"],
            metrics=out["metrics"])), flush=True)
    return 3 if forbidden_modules() else 0


if __name__ == "__main__":
    sys.exit(main())

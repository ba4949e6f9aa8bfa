"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a tiny
size (horizons cut to 6, four lanes a call) under a temporary root, which
`Loader` reads exactly as it reads the checkout."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HORIZON, BATCH = 6, 4


def tiny_root(tmp: Path) -> Path:
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for p in (tmp / "benchmark" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["horizon"] = HORIZON
        p.write_text(json.dumps(d))
    for p in (tmp / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(batch=BATCH, checked_lanes=BATCH)
        p.write_text(json.dumps(d))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    from benchmark.run import Loader
    return Loader(tiny_root(tmp_path))


def cells():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]

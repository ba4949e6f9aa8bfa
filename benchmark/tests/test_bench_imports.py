"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the program. Each module is imported in
a fresh interpreter; the top-level names of sys.modules are compared
whole (fbstab_tpu_torch is not fbstab_tpu)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from .conftest import REPO

FORBIDDEN = ["jax", "jaxlib", "flax", "fbstab_tpu"]
BASE = REPO / "benchmark"
CORE = ["benchmark", "benchmark.run", "benchmark.readings", "benchmark.perf",
        "benchmark.trace", "benchmark.mpc_inputs", "benchmark.plants"]
FILES = [f"{kind}/{p.stem}" for kind in ("loops", "metrics", "plants")
         for p in sorted((BASE / kind).glob("*.py"))
         if p.stem != "__init__"]
REFERENCES = [f"reference/{p.stem}" for p in
              sorted((BASE / "reference").glob("*.py"))
              if p.stem != "__init__"]


def _held(code: str) -> list:
    """Top-level module names a fresh interpreter holds after `code`."""
    probe = code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True, env=dict(os.environ,
                                              PYTHONPATH=str(REPO)))
    return json.loads(out.stdout.strip().splitlines()[-1])


def _by_path(rel: str) -> str:
    kind, name = rel.split("/")
    return ("from benchmark.run import Loader\n"
            f"Loader().module({kind!r}, {name!r})\n")


@pytest.mark.parametrize("module", CORE)
def test_harness_module_holds_no_jax(module):
    held = _held(f"import {module}")
    assert not set(held) & set(FORBIDDEN), held


@pytest.mark.parametrize("rel", FILES)
def test_cell_file_holds_no_jax(rel):
    held = _held(_by_path(rel))
    assert not set(held) & set(FORBIDDEN), held


def test_configs_and_mixes_load_without_jax():
    held = _held("from benchmark.run import Loader\n"
                 "L = Loader()\n"
                 "for w in L.spec['workloads']:\n"
                 "    L.config(w['config']); L.mix(w['traffic'])\n")
    assert not set(held) & set(FORBIDDEN), held


@pytest.mark.parametrize("rel", REFERENCES)
def test_reference_holds_nothing_of_the_program(rel):
    kind, name = rel.split("/")
    held = _held("import importlib.util\n"
                 f"p = {str(BASE / kind / (name + '.py'))!r}\n"
                 "s = importlib.util.spec_from_file_location('ref', p)\n"
                 "m = importlib.util.module_from_spec(s)\n"
                 "s.loader.exec_module(m)\n")
    assert not set(held) & set(FORBIDDEN + ["fbstab_tpu_torch"]), held


def test_whole_name_comparison(monkeypatch):
    from benchmark.run import forbidden_modules
    for name in ("fbstab_tpu_torch", "fbstab_tpu_torch.ops", "jaxtyping",
                 "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fbstab_tpu.ops", sys)
    assert forbidden_modules() == ["fbstab_tpu"]

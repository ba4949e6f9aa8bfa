"""The benchmark's frozen copies hold, today, what the program's originals
give: the plants at each configuration's horizon, the perturbation rule,
the performance model's arithmetic and the float64 residual."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import perf, plants
from benchmark.reference import mpc_kkt
from benchmark.run import Loader

from .conftest import REPO

CONFIGS = [c["name"] for c in
           json.loads((REPO / "BENCHMARK.json").read_text())["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_plant_copy_equals_the_program_fixture(name):
    from fbstab_tpu_torch.models import ocp_fixtures
    loader = Loader(REPO)
    cfg = loader.config(name)
    N = int(cfg["horizon"])
    stacked = plants.stack(loader.module("plants", cfg["plant"]).plant(), N)
    one, _ = getattr(ocp_fixtures, cfg["plant"])(N, dtype=torch.float64,
                                                 device="cpu")
    for k in plants.FIELDS:
        np.testing.assert_array_equal(stacked[k], getattr(one, k)[0].numpy(),
                                      err_msg=k)
    assert (cfg["nx"], cfg["nu"], cfg["nc"]) == (
        one.A.shape[-1], one.B.shape[-1], one.E.shape[-2])


@pytest.mark.parametrize("name", CONFIGS)
def test_perturbation_rule_equals_build_plant(name):
    from fbstab_tpu_torch import workloads
    loader = Loader(REPO)
    cfg = loader.config(name)
    pert, B = float(cfg["x0_perturbation"]), 5
    got = workloads.build_plant(cfg["plant"], 3, B, pert, "cpu", seed=7)
    x0 = plants.stack(loader.module("plants", cfg["plant"]).plant(), 3)["x0"]
    x0 = x0.astype(np.float32).astype(np.float64)
    n = np.random.default_rng(7).standard_normal((B, x0.shape[0]))
    mine = plants.perturbed_x0(x0, n, pert, plants.perturbation_scale(x0))
    np.testing.assert_array_equal(mine.astype(np.float32), got.x0.numpy())


@pytest.mark.parametrize("dims", [(40, 6, 3, 12), (80, 18, 5, 10),
                                  (30, 8, 3, 6)])
def test_perf_copy_equals_perf_model(dims):
    from fbstab_tpu_torch import perf_model as pm
    assert perf.riccati_flops(*dims) == pm.riccati_flops(*dims)
    assert perf.mpc_residual_flops(*dims) == pm.mpc_residual_flops(*dims)
    assert perf.mpc_data_floats(*dims) == pm.mpc_data_floats(*dims)
    assert perf.bound(3e9, 5e8) == pm.bound(3e9, 5e8)
    for launches in (1, 4):
        mine = perf.bound(perf.mpc_solve_flops(2048, *dims, 103.5, 9.0),
                          perf.mpc_solve_bytes(2048, *dims, launches))
        assert mine == pm.mpc_solve_bound(2048, *dims, 103.5, 9.0, launches)


def test_reference_residual_equals_workloads_residual():
    from fbstab_tpu_torch import Options, solve_mpc_qp_batch, workloads
    loader = Loader(REPO)
    cfg = loader.config("copoly_n80")
    stacked = plants.stack(loader.module("plants", cfg["plant"]).plant(), 5)
    data = workloads.build_plant(cfg["plant"], 5, 3, 0.05, "cpu")
    x, core = solve_mpc_qp_batch(data, *workloads.zeros_guess(data),
                                 Options.single_precision())
    want = workloads.mpc_f64_residual(data, x, 0.95)
    p = x.to_float64()
    got = mpc_kkt.residual(mpc_kkt.stacked_f32(stacked), data.x0.double(),
                           p.z, p.l, p.v, 0.95).numpy()
    # The terms of rz cancel to ~1e-9 from O(1): float64 rounding of the
    # sums, taken in another order, is ~1e-16 absolute.
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-14)

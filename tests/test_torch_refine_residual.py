"""PyTorch port: the MPC refinement's double-float residual kernel
(ops/refine_residual_cuda.py, csrc/refine_residual.cu) on the card, held
to its plain version, models/refine.py's eager composition, on the same
CUDA tensors: the margin's pair and the four float32 KKT blocks bit for
bit at the benchmark cells' shapes, the norm within 1e-6 relative; and on
the solver's path, one launch an evaluation (entry, each step, final
check) and the plain composition's decisions on every lane. Every test
needs the card (`cuda`); the CPU replay of the device code is in
tests/test_torch_device_code.py. No JAX here: the file runs on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (  # noqa: E402
    launches, perturbed_x0, plant_arrays, require_cuda, residual_case,
    torch_data)

from fbstab_tpu_torch.models import refine  # noqa: E402
from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch  # noqa: E402
from fbstab_tpu_torch.options import Options  # noqa: E402

ALPHA = 0.95

# The benchmark cells' shapes and the forms their residual reads: per-lane
# Ruiz-scaled data (cold cells), an index_select'ed chunk (the spacecraft's
# partial chunks), the track cell's shared-plant scaling expanded over the
# fleet, and the final check's expanded plant; dense Gaussian data, where
# the order of every sum shows in the margin's lo part.
CARD_CASES = {
    "spacecraft_n40.cold_b8192": ("spacecraft", "scaled", 8192),
    "spacecraft_n40.cold_b1024": ("spacecraft", "subbatch", 1024),
    "copoly_n80.cold_b2048": ("copoly", "scaled", 2048),
    "copoly_n80.track": ("copoly", "shared", 2048),
    "final_check_spacecraft": ("spacecraft", "expanded", 8192),
    "final_check_copoly": ("copoly", "expanded", 2048),
    "dense_data": ("dense", "plain", 2048),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_residual_is_bit_equal_to_plain(case):
    """The kernel against the plain composition on the same CUDA float32
    tensors: y's pair and rzx, rzu, rl, rv bit for bit; the norm within
    1e-6 relative, with the blocks and alone."""
    require_cuda()
    from fbstab_tpu_torch.ops.refine_residual_cuda import refine_residual
    plant, form, B = CARD_CASES[case]
    data, point, scal = residual_case(plant, form, B, "cuda")
    for blocks in (True, False):
        before = launches("refine_residual")
        got = refine_residual(data, *point, ALPHA, scal, blocks)
        torch.cuda.synchronize()
        assert launches("refine_residual") == before + 1
        want = refine.mpc_residual_df_plain(data, *point, ALPHA, scal,
                                            blocks)
        if blocks:
            for name, g, w in zip(("y", "y_lo", "rzx", "rzu", "rl", "rv"),
                                  (*got[0], *got[1]), (*want[0], *want[1])):
                assert torch.equal(g.view(torch.int32),
                                   w.view(torch.int32)), name
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


def _solve_batch(plant):
    """The benchmark configurations' cold batches: the spacecraft at
    N = 40, B = 1024, positions dispersed at 0.05 and the chaser at rest;
    the reactor at N = 80, B = 2048, every state dispersed at 0.05 (lane 0
    nominal)."""
    if plant == "spacecraft":
        arrays = plant_arrays("spacecraft_relative_motion", 40, 1024)
        x0 = arrays["x0"][0]
        offs = 0.05 * np.abs(x0).max() * np.abs(
            np.random.default_rng(7).standard_normal((1024, 3)))
        offs[0] = 0.0
        arrays["x0"] = np.concatenate([x0[None, :3] + offs,
                                       np.broadcast_to(x0[3:], (1024, 3))], 1)
    else:
        arrays = perturbed_x0(
            plant_arrays("copolymerization_reactor", 80, 2048), 0.05)
    data = torch_data(arrays, torch.float32, "cuda")
    B, N1 = data.x0.shape[0], data.Q.shape[1]
    nx, nu, nc = data.Q.shape[-1], data.R.shape[-1], data.E.shape[-2]
    z = lambda n: torch.zeros(B, N1 * n, dtype=torch.float32, device="cuda")
    return data, z(nx + nu), z(nx), z(nc)


def _counts():
    from fbstab_tpu_torch import telemetry
    c = telemetry.counters()
    return c.get("launch.refine_residual", 0), c.get("refine.steps", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("plant", ["spacecraft", "copoly"])
def test_cuda_solve_launches_the_residual_once_an_evaluation(plant):
    """solve_mpc_qp_batch in float32 under single_precision: one launch of
    the residual at the refinement's entry, one a step, one at the final
    check."""
    require_cuda()
    batch = _solve_batch(plant)
    launched, steps = _counts()
    solve_mpc_qp_batch(*batch, Options.single_precision())
    torch.cuda.synchronize()
    launched2, steps2 = _counts()
    assert steps2 > steps
    assert launched2 - launched == steps2 - steps + 2


@pytest.mark.cuda
@pytest.mark.parametrize("plant", ["spacecraft", "copoly"])
def test_cuda_solve_takes_the_plain_compositions_decisions(plant,
                                                           monkeypatch):
    """The same solve with the residual's dispatch patched, in this test
    only, to the plain composition on the same CUDA tensors: every lane's
    exit flag and refinement steps equal, the reported residual within
    1e-6 relative."""
    require_cuda()
    batch = _solve_batch(plant)
    opts = Options.single_precision()
    _, ck = solve_mpc_qp_batch(*batch, opts)
    monkeypatch.setattr(refine, "mpc_residual_df",
                        refine.mpc_residual_df_plain)
    before = launches("refine_residual")
    _, cp = solve_mpc_qp_batch(*batch, opts)
    torch.cuda.synchronize()
    assert launches("refine_residual") == before
    assert torch.equal(ck.eflag, cp.eflag)
    assert torch.equal(ck.refine_steps, cp.refine_steps)
    torch.testing.assert_close(ck.residual, cp.residual, rtol=1e-6, atol=0)

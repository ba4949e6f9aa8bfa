"""PyTorch port: Options, exit flags and the no-JAX import boundary, held
field by field against the JAX package."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import fbstab_tpu  # noqa: E402
from fbstab_tpu.core import algorithm as jax_algorithm  # noqa: E402
from torch_parity import modules_after_import, torch_options  # noqa: E402

import fbstab_tpu_torch as pt  # noqa: E402
from fbstab_tpu_torch.core.algorithm import NONMONOTONE_DEPTH  # noqa: E402

PROFILES = {
    "default": lambda O: O(),
    "default_static": lambda O: O.default(),
    "single_precision": lambda O: O.single_precision(),
    "reliable": lambda O: O.reliable(),
    "validated_saturating": lambda O: O(
        sigma0=1e-20, sigma_max=1e9, alpha=2.0, beta=0.0, eta=1.0,
        delta=5.0, abs_tol=0.0, max_newton_iters=0, inner_stall_tol=0.9,
        refine_steps=500, refine_sigma=1e-20).validated(),
    "single_precision_validated": lambda O: O.single_precision().validated(),
    "reliable_validated": lambda O: O.reliable().validated(),
}


def _fields(o):
    return {k: (int(v) if k == "display_level" else v)
            for k, v in dataclasses.asdict(o).items()}


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_options_match_reference_field_by_field(profile):
    ref = PROFILES[profile](fbstab_tpu.Options)
    port = PROFILES[profile](pt.Options)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert _fields(port) == _fields(ref)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_options_carry_across_through_interop(profile):
    ref = PROFILES[profile](fbstab_tpu.Options)
    port = torch_options(ref)
    assert port == PROFILES[profile](pt.Options)
    assert _fields(port.validated()) == _fields(ref.validated())


def test_exit_flags_display_and_merit_depth_match():
    assert {f.name: int(f) for f in pt.ExitFlag} == \
        {f.name: int(f) for f in fbstab_tpu.ExitFlag}
    assert int(pt.ExitFlag.LINEAR_SOLVER_FAILED) == 6
    assert {d.name: int(d) for d in pt.Display} == \
        {d.name: int(d) for d in fbstab_tpu.Display}
    assert NONMONOTONE_DEPTH == jax_algorithm.NONMONOTONE_DEPTH == 5
    assert pt.SolverOut._fields == fbstab_tpu.SolverOut._fields
    assert pt.CoreOut._fields == jax_algorithm.CoreOut._fields


PORT_MODULES = [
    "fbstab_tpu_torch",
    "fbstab_tpu_torch.interop",
    "fbstab_tpu_torch.ops.riccati_cuda",
    "fbstab_tpu_torch.ops.mpc_solve_cuda",
    "fbstab_tpu_torch.ops.dense_solve_cuda",
    "fbstab_tpu_torch.ops.mpc_subproblem_cuda",
    "fbstab_tpu_torch.ops.assoc_combine_cuda",
    "fbstab_tpu_torch.ops.assoc_riccati",
    "fbstab_tpu_torch.models.mpc_subfused",
    "fbstab_tpu_torch.models.ocp_fixtures",
    "fbstab_tpu_torch.parallel.adaptive",
    "fbstab_tpu_torch.workloads",
    "fbstab_tpu_torch.tools.profile_paths",
    "fbstab_tpu_torch.bench",
    "fbstab_tpu_torch.perf_model",
    "fbstab_tpu_torch.models.receding_horizon",
    "fbstab_tpu_torch.ops.mxu_probe_cuda",
    "fbstab_tpu_torch.ops.df_probe_cuda",
    "fbstab_tpu_torch.tools.df_probe",
    "fbstab_tpu_torch.diff",
    "fbstab_tpu_torch.models.batch_facade",
    "fbstab_tpu_torch.parallel.sharded",
    "fbstab_tpu_torch.parallel.ragged",
    "fbstab_tpu_torch.graft_entry",
    "fbstab_tpu_torch.utils.printing",
    "fbstab_tpu_torch.models.sparse_qp",
    "fbstab_tpu_torch.utils.sparse_ldl",
    "fbstab_tpu_torch.utils.native_ldl",
    "chip_smoke",
]


@pytest.fixture(scope="module")
def port_import_modules():
    """sys.modules of one fresh interpreter (no conftest) after importing
    every module of PORT_MODULES: if none of them reaches JAX, each one's
    import closure is free of it."""
    return modules_after_import(", ".join(PORT_MODULES))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_never_imports_jax(port_import_modules, module):
    """A fresh interpreter (no conftest) importing the port holds no JAX,
    and importing it builds nothing."""
    mods = port_import_modules
    assert module in mods
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                   for m in mods)
    assert not any(m == "fbstab_tpu" or m.startswith("fbstab_tpu.")
                   for m in mods)
    assert "triton" not in mods


@pytest.mark.parametrize("plant,N", [
    ("double_integrator", 4), ("servo_motor", 3),
    ("spacecraft_relative_motion", 2), ("copolymerization_reactor", 2),
])
def test_plant_fixtures_equal_reference(plant, N):
    """The port's numpy-built plants equal fbstab_tpu's, leaf by leaf (the
    port's data carries a leading batch axis of one)."""
    import numpy as np
    from fbstab_tpu.models import ocp_fixtures as jfix

    from fbstab_tpu_torch.models import ocp_fixtures as tfix

    ref, rsim = getattr(jfix, plant)(N)
    got, gsim = getattr(tfix, plant)(N, device="cpu")
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for a, b in zip(gsim, rsim):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

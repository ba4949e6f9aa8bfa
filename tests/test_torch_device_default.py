"""PyTorch port: the entry points put their data on the card unless the
caller asks for the CPU. Without a CUDA device, the data constructors, the
plants, the interop helpers and the facades raise an error that says to
pass device="cpu", and succeed when given it (or CPU tensors); with one,
their data lands on the card. Decided at run time, so the test runs the
same way on every worker."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import dense_mixed_batch, mixed_batch  # noqa: E402

from fbstab_tpu_torch import interop  # noqa: E402
from fbstab_tpu_torch.models import dense_qp, mpc_qp, ocp_fixtures  # noqa
from fbstab_tpu_torch.models import sparse_qp  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402

# tests/test_sparse_solve.py's feasible QP, as a batch of one.
SPARSE = {k: np.asarray(v, float)[None] for k, v in dict(
    H=[[3.0, 1.0], [1.0, 1.0]], f=[10.0, 5.0], G=np.zeros((0, 2)),
    h=np.zeros(0), A=[[-1.0, 0.0], [0.0, 1.0]], b=[0.0, 0.0]).items()}


def _sparse_pattern():
    return sparse_qp.sparse_qp_data(**SPARSE, device="cpu")[0]

CONSTRUCTORS = {
    "mpc_qp_data": lambda **kw: mpc_qp.mpc_qp_data(**mixed_batch(), **kw),
    "dense_qp_data": lambda **kw: dense_qp.dense_qp_data(
        **dense_mixed_batch(2), **kw),
    "mpc_data_from_arrays": lambda **kw: interop.mpc_data_from_arrays(
        **mixed_batch(), **kw),
    "dense_data_from_arrays": lambda **kw: interop.dense_data_from_arrays(
        **dense_mixed_batch(), **kw),
    "double_integrator": lambda **kw: ocp_fixtures.double_integrator(
        4, **kw)[0],
    "spacecraft_relative_motion":
        lambda **kw: ocp_fixtures.spacecraft_relative_motion(3, **kw)[0],
    "FBstabMpc": lambda **kw: mpc_qp.FBstabMpc(4, 2, 1, 6, **kw),
    "FBstabDense": lambda **kw: dense_qp.FBstabDense(2, 0, 2, **kw),
    "sparse_qp_data": lambda **kw: sparse_qp.sparse_qp_data(**SPARSE,
                                                            **kw)[1],
    "pattern_values": lambda **kw: sparse_qp.pattern_values(
        _sparse_pattern(), **SPARSE, **kw),
    "sparse_data_from_arrays": lambda **kw: interop.sparse_data_from_arrays(
        **sparse_qp.pattern_values(_sparse_pattern(), **SPARSE,
                                   device="cpu")._asdict(), **kw),
    "FBstabSparse": lambda **kw: sparse_qp.FBstabSparse(_sparse_pattern(),
                                                        **kw),
}


def _device(obj):
    return obj.device if hasattr(obj, "device") else obj[0].device


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_default_device_is_the_card(name):
    make = CONSTRUCTORS[name]
    if torch.cuda.is_available():
        assert _device(make()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert _device(make(device="cpu")).type == "cpu"


def test_cpu_tensors_keep_their_device():
    """Data built from tensors that lie on the CPU stays there, and a
    facade made for the CPU solves it (dense and sparse)."""
    arrays = {k: torch.tensor(np.asarray(v, float)[None])
              for k, v in dict(H=[[3.0, 1.0], [1.0, 1.0]], f=[10.0, 5.0],
                               A=[[-1.0, 0.0], [0.0, 1.0]],
                               b=[0.0, 0.0]).items()}
    data = dense_qp.dense_qp_data(**arrays)
    assert data.H.device.type == "cpu" and tuple(data.G.shape) == (1, 0, 2)
    _, out = dense_qp.FBstabDense(2, 0, 2, device="cpu").solve(data)
    assert int(out.eflag) == ExitFlag.SUCCESS
    pat, sdata = sparse_qp.sparse_qp_data(**arrays)
    assert sdata.Hx.device.type == "cpu" and tuple(sdata.Gx.shape) == (1, 0)
    _, out = sparse_qp.FBstabSparse(pat, device="cpu").solve(sdata)
    assert int(out.eflag) == ExitFlag.SUCCESS


@pytest.mark.parametrize("name", ["make_mesh", "entry"])
def test_sharding_entry_points_need_the_card(monkeypatch, name):
    """make_mesh() and graft_entry.entry() put their work on the card:
    without a CUDA device they raise, naming device="cpu", before any
    process group starts."""
    import torch.distributed as dist

    from fbstab_tpu_torch import graft_entry
    from fbstab_tpu_torch.parallel import sharded
    fn = {"make_mesh": sharded.make_mesh, "entry": graft_entry.entry}[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()
    assert not dist.is_initialized()

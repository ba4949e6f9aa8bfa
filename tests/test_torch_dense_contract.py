"""PyTorch port: the dense float32 contract stack. Ruiz scaling of dense data
gives exactly the JAX package's power-of-two diagonals and scaled data,
and the float32 product path (`solve_dense_qp_batch(...,
Options.single_precision())`: equilibration, the lockstep solve, the
failed-lane retry, double-float refinement) succeeds on every lane where
the JAX package's own float32 product path succeeds, with a host float64
residual <= 1e-6 there. The fixed-step polish `refine_dense_batch` gives
the JAX package's residual history and point from the same float32
solution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fbstab_tpu.models import dense_qp as jdq  # noqa: E402
from fbstab_tpu.models import scaling as jscal  # noqa: E402
from fbstab_tpu.options import Options as JaxOptions  # noqa: E402
from torch_parity import (  # noqa: E402
    dense_arrays, jax_dense_data, torch_dense_data)

from fbstab_tpu_torch.models import refine as tref  # noqa: E402
from fbstab_tpu_torch.models import scaling as tscal  # noqa: E402
from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch  # noqa
from fbstab_tpu_torch.options import Options  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402
from fbstab_tpu_torch.workloads import dense_f64_residual  # noqa: E402


def _arrays(nl, B=16, n=8, q=16):
    arrays = dense_arrays(B, n, q, nl)
    arrays["H"][:, 0] *= 300.0         # badly scaled rows and columns
    arrays["H"][:, :, 0] *= 300.0
    arrays["A"][:, 1] *= 1e-3
    arrays["b"][:, 1] *= 1e-3
    return arrays


@pytest.mark.parametrize("nl", [0, 2])
def test_ruiz_dense_scaling_equals_reference(nl):
    arrays = _arrays(nl)
    jd = jax_dense_data(arrays, jnp.float32)
    ref = jax.vmap(jscal.ruiz_dense_scaling)(jd)
    td = torch_dense_data(arrays, torch.float32)
    got = tscal.ruiz_dense_scaling(td)
    for f in ("dz", "dl", "de", "kc"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(g, w, err_msg=f)
        assert np.all(np.log2(g) == np.round(np.log2(g))), f
    sref = jax.vmap(jscal.apply_dense_scaling)(jd, ref)
    sgot = tscal.apply_dense_scaling(td, got)
    for f in sref._fields:
        np.testing.assert_array_equal(getattr(sgot, f).numpy(),
                                      np.asarray(getattr(sref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("nl", [0, 2])
def test_contract_path_f32_succeeds_where_reference_does(nl):
    arrays = _arrays(nl)
    B, n = arrays["f"].shape
    q = arrays["b"].shape[1]
    jd = jax_dense_data(arrays, jnp.float32)
    jz = (jnp.zeros((B, n), jnp.float32), jnp.zeros((B, nl), jnp.float32),
          jnp.zeros((B, q), jnp.float32))
    jopts = JaxOptions.single_precision()
    _, cr = jax.jit(lambda *a: jdq.solve_dense_qp_batch(*a, jopts))(jd, *jz)
    ref_ok = np.asarray(cr.eflag) == int(ExitFlag.SUCCESS)
    assert ref_ok.mean() >= 0.75

    td = torch_dense_data(arrays, torch.float32)
    tz = tuple(torch.zeros(B, k) for k in (n, nl, q))
    x, core = solve_dense_qp_batch(td, *tz, Options.single_precision())
    assert isinstance(x, tref.VariableDF)
    ok = core.eflag.numpy() == int(ExitFlag.SUCCESS)
    assert np.all(ok[ref_ok])
    res64 = dense_f64_residual(td, x, Options.single_precision().alpha)
    assert np.all(res64[ref_ok] <= 1e-6), res64
    # The reported residual is the double-float value at the same point.
    np.testing.assert_allclose(core.residual.numpy()[ok], res64[ok],
                               rtol=0.05, atol=1e-9)
    assert int(core.refine_steps.min()) >= 1


def test_refine_dense_batch_matches_reference():
    """Three fixed polish steps from the port's float32 solve (no
    refinement) of the nl = 2 batch, in both packages (JAX's eagerly, as
    tests/test_refine.py runs it): the same residual history and refined
    point. The history is the double-float norm rounded to float32, so its
    first entry (the same point in both) agrees to a few float32 ulps.
    Each correction is a float32 factor solve that the two packages round
    differently, and it leaves a residual at float32's rounding floor of
    the step: from there on each lane's history agrees to 1e-3 of its
    first entry, and the points to 1e-9."""
    from fbstab_tpu.core.variable import Variable as JaxVariable
    from fbstab_tpu.models import refine as jref

    arrays = _arrays(2)
    B, n = arrays["f"].shape
    td = torch_dense_data(arrays, torch.float32)
    tz = tuple(torch.zeros(B, k) for k in (n, 2, arrays["b"].shape[1]))
    opts = Options.single_precision()
    x, core = solve_dense_qp_batch(td, *tz, dataclasses.replace(
        opts, refine_steps=0))
    assert (core.eflag == 0).all()
    got, hist = tref.refine_dense_batch(td, x, opts, steps=3)

    jx = JaxVariable(*(jnp.asarray(a.numpy()) for a in x))
    jopts = JaxOptions.single_precision()
    want, jhist = jref.refine_dense_batch(
        jax_dense_data(arrays, jnp.float32), jx, jopts, steps=3)

    jhist = np.asarray(jhist, np.float64)
    assert hist.shape == jhist.shape == (4, B)
    np.testing.assert_allclose(hist[0].numpy(), jhist[0], rtol=3e-7)
    np.testing.assert_allclose(hist.numpy(), jhist, rtol=0,
                               atol=1e-3 * jhist[0].max())
    assert np.all(np.abs(hist.numpy() - jhist) <= 1e-3 * jhist[0])
    assert np.all(hist[-1].numpy() <= 1e-9) and np.all(jhist[-1] <= 1e-9)
    g, w = got.to_float64(), want.to_float64()
    for f in ("z", "l", "v"):
        ref = np.asarray(getattr(w, f))
        np.testing.assert_allclose(getattr(g, f).numpy(), ref, rtol=0,
                                   atol=1e-9 * (1 + np.abs(ref).max()),
                                   err_msg=f)

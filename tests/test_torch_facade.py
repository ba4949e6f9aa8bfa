"""PyTorch port: the batch facades (models/batch_facade.py), the batch
statistics (parallel/sharded.py) and the solver output
(utils/printing.py and the lockstep core's iteration tables), held
against fbstab_tpu on tests/test_batch_facade.py's and
tests/test_display.py's cases in float64, plus the float32 product path
of the facades on the CPU."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fbstab_tpu import FBstabDense as JaxFBstabDense  # noqa: E402
from fbstab_tpu import Options as JaxOptions  # noqa: E402
from fbstab_tpu import dense_qp_data as jax_dense_qp_data  # noqa: E402
from fbstab_tpu.core.algorithm import CoreOut as JaxCoreOut  # noqa: E402
from fbstab_tpu.models.batch_facade import (  # noqa: E402
    FBstabDenseBatch as JaxDenseBatch)
from fbstab_tpu.options import Display as JaxDisplay  # noqa: E402
from fbstab_tpu.parallel.sharded import batch_stats as jax_stats  # noqa: E402
from fbstab_tpu.utils.printing import (  # noqa: E402
    print_batch_final as jax_print_batch_final)
from test_batch_facade import _five_reference_qps  # noqa: E402
from torch_parity import (  # noqa: E402
    dense_arrays, headline_arrays, torch_data, torch_dense_data,
    torch_options)

from fbstab_tpu_torch.core.algorithm import (  # noqa: E402
    CoreOut, fbstab_solve_batch)
from fbstab_tpu_torch.models.batch_facade import (  # noqa: E402
    FBstabDenseBatch, FBstabMpcBatch)
from fbstab_tpu_torch.models.dense_qp import (  # noqa: E402
    DENSE_OPS, FBstabDense, dense_qp_data)
from fbstab_tpu_torch.models.mpc_qp import FBstabMpc  # noqa: E402
from fbstab_tpu_torch.models.refine import VariableDF  # noqa: E402
from fbstab_tpu_torch.options import Display, Options  # noqa: E402
from fbstab_tpu_torch.parallel.adaptive import (  # noqa: E402
    solve_mpc_qp_batch_adaptive_device)
from fbstab_tpu_torch.parallel.sharded import batch_stats  # noqa: E402
from fbstab_tpu_torch.solver_out import ExitFlag  # noqa: E402
from fbstab_tpu_torch.utils.printing import (  # noqa: E402
    NullStream, OutputStream, print_batch_final, print_final)

F64 = torch.float64


class Sink(OutputStream):
    def __init__(self):
        self.buf = []

    def print(self, msg):
        self.buf.append(msg)

    @property
    def text(self):
        return "".join(self.buf)


def _five_arrays():
    return {k: np.asarray(a) for k, a in _five_reference_qps()._asdict()
            .items()}


@pytest.fixture(scope="module")
def jax_five():
    """The JAX facade's two calls (the second warmstarted by its carry)
    on tests/test_batch_facade.py's five reference QPs."""
    solver = JaxDenseBatch(B=5, nz=2, nl=1, nv=5, dtype=jnp.float64,
                           options=JaxOptions(abs_tol=1e-8))
    data = _five_reference_qps()
    return [solver.solve(data) for _ in range(2)]


def _port_five():
    return FBstabDenseBatch(B=5, nz=2, nl=1, nv=5, dtype=F64,
                            options=Options(abs_tol=1e-8), device="cpu")


def _same_lanes(x, out, jx, jout, lanes=slice(None)):
    """Equal exit flags on every lane; equal counts, and iterates within
    1e-9 relative to the lane's largest entry (certificates are
    differences of iterates of ~1e8), on `lanes`."""
    np.testing.assert_array_equal(out.eflag.numpy(), np.asarray(jout.eflag))
    for f in ("newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(out, f).numpy()[lanes],
                                      np.asarray(getattr(jout, f))[lanes],
                                      err_msg=f)
    for f in ("z", "l", "v", "y"):
        got = getattr(x, f).numpy()[lanes]
        want = np.asarray(getattr(jx, f))[lanes]
        scale = 1.0 + np.abs(want).max(1, keepdims=True)
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-9,
                                   err_msg=f)


def test_five_reference_behaviors_in_one_batch(jax_five):
    """tests/test_batch_facade.py's five reference QPs in one batch: the
    port's facade takes the JAX facade's decisions lane for lane, and
    meets that test's analytic answers and statistics."""
    x, out, stats = _port_five().solve(torch_dense_data(_five_arrays(),
                                                        F64))
    jx, jout, jstats = jax_five[0]
    _same_lanes(x, out, jx, jout)
    assert out.eflag.tolist() == [0, 0, 0, int(ExitFlag.PRIMAL_INFEASIBLE),
                                  int(ExitFlag.DUAL_INFEASIBLE)]
    z = x.z.numpy()
    np.testing.assert_allclose(z[0], [0.0, -5.0], atol=1e-8)
    np.testing.assert_allclose(x.v[0, :2].numpy(), [5.0, 0.0], atol=1e-8)
    np.testing.assert_allclose(z[1], [0.25, 0.75], atol=1e-8)
    np.testing.assert_allclose(z[2][0], 1.0, atol=1e-8)
    assert 1.0 - 1e-8 <= z[2][1] <= 3.0 + 1e-8
    assert int(stats.num_success) == 3
    assert int(stats.num_infeasible) == 2
    assert int(stats.num_failed) == 0
    for f in stats._fields:
        np.testing.assert_allclose(getattr(stats, f).numpy(),
                                   np.asarray(getattr(jstats, f)),
                                   rtol=1e-9, err_msg=f)


def test_warmstart_carry_across_calls(jax_five):
    """The second call starts from the first's solution (the carry), as
    the JAX facade's does: the same exit flags, and on the SUCCESS lanes
    the same counts and iterates (the infeasible lanes restart from their
    certificates, ~1e8 in size, where the Newton counts part at
    roundoff); reset_warmstart starts from the origin."""
    solver = _port_five()
    data = torch_dense_data(_five_arrays(), F64)
    x1, out1, _ = solver.solve(data)
    x2, out2, _ = solver.solve(data)
    ok = out1.eflag.numpy() == int(ExitFlag.SUCCESS)
    _same_lanes(x2, out2, *jax_five[1][:2], lanes=ok)
    assert np.all(out2.newton_iters.numpy()[ok]
                  <= out1.newton_iters.numpy()[ok])
    assert np.all(out2.prox_iters.numpy()[ok] == 0)
    np.testing.assert_allclose(x2.z.numpy()[ok], x1.z.numpy()[ok],
                               atol=1e-10)
    solver.reset_warmstart()
    _, out3, _ = solver.solve(data)
    np.testing.assert_array_equal(out3.newton_iters.numpy(),
                                  out1.newton_iters.numpy())


def test_f32_dense_facade_refines_by_default():
    """The float32 facade defaults to Options.single_precision(): the
    solution is a VariableDF, `residual` the refined value below the raw
    one, every lane SUCCESS; the carry works off the hi view
    (tests/test_batch_facade.py:125)."""
    B = 16
    data = torch_dense_data(dense_arrays(B, 8, 12), torch.float32)
    solver = FBstabDenseBatch(B=B, nz=8, nl=0, nv=12, device="cpu")
    assert solver.options.refine_steps == 48
    x, out, stats = solver.solve(data)
    assert isinstance(x, VariableDF)
    assert out.eflag.tolist() == [0] * B
    assert out.residual.median() < out.raw_residual.median()
    assert int(stats.num_success) == B
    _, out2, _ = solver.solve(data)
    assert bool((out2.newton_iters <= out.newton_iters).all())


def test_mpc_batch_facade_quickstart():
    """The three-line batched MPC workflow in float32: construct, solve,
    re-solve the next step (x0 scaled by 0.9) from the shifted carry
    (tests/test_batch_facade.py:151)."""
    B, N, nx, nu, nc = 8, 10, 4, 2, 4
    data = torch_data(headline_arrays(B, N, nx, nu, nc), torch.float32)
    solver = FBstabMpcBatch(B=B, N=N, nx=nx, nu=nu, nc=nc, device="cpu")
    x, out, stats = solver.solve(data)
    assert isinstance(x, VariableDF)
    assert int(stats.num_success) == B
    x2, out2, stats2 = solver.solve(data._replace(x0=data.x0 * 0.9))
    assert int(stats2.num_success) == B
    assert (out2.newton_iters.float().mean()
            <= out.newton_iters.float().mean())


def test_adaptive_facade_is_the_adaptive_solve():
    """adaptive=True is solve_mpc_qp_batch_adaptive_device with the
    facade's phase-1 budget and phase-2 capacity, and converges every lane
    (the capacity overflow takes the fallback pass)."""
    B, N, nx, nu, nc = 8, 10, 4, 2, 4
    data = torch_data(headline_arrays(B, N, nx, nu, nc), torch.float32)
    solver = FBstabMpcBatch(B=B, N=N, nx=nx, nu=nu, nc=nc, adaptive=True,
                            phase1_newton_iters=4, phase2_size=2,
                            device="cpu")
    x, out, stats = solver.solve(data)
    assert int(stats.num_success) == B
    guess = [torch.zeros(B, n) for n in (solver.nz, solver.nl, solver.nv)]
    xr, cr = solve_mpc_qp_batch_adaptive_device(
        data, *guess, Options.single_precision(), phase1_newton_iters=4,
        phase2_size=2)
    torch.testing.assert_close(x.to_float64().z, xr.to_float64().z,
                               rtol=0, atol=0)
    assert out.newton_iters.tolist() == cr.newton_iters.tolist()


@pytest.mark.parametrize("facade", ["dense", "mpc"])
def test_shape_validation(facade):
    """A batch of the wrong size names the field; data on another device
    than the facade's is refused (tests/test_batch_facade.py:176)."""
    if facade == "dense":
        data = torch_dense_data(_five_arrays(), F64)
        solver = FBstabDenseBatch(B=4, nz=2, nl=1, nv=5, dtype=F64,
                                  device="cpu")
        field = "H"
    else:
        data = torch_data(headline_arrays(3, 4, 2, 1, 2), F64)
        solver = FBstabMpcBatch(B=2, N=4, nx=2, nu=1, nc=2, dtype=F64,
                                device="cpu")
        field = "Q"
    with pytest.raises(ValueError, match=f"{field} has shape"):
        solver.solve(data)
    with pytest.raises(ValueError, match="requires"):
        (FBstabDenseBatch(0, 2, 1, 5, device="cpu") if facade == "dense"
         else FBstabMpcBatch(2, 0, 2, 1, 2, device="cpu"))


def _core():
    """tests/test_display.py's four-lane CoreOut."""
    vals = dict(eflag=[0, 0, 3, 6], residual=[1e-9, 2e-9, 1.0, 0.5],
                newton_iters=[5, 7, 20, 60], prox_iters=[2, 2, 10, 30],
                initial_residual=[1.0] * 4, raw_residual=[1e-9, 2e-9, 1.0,
                                                          0.5])
    ints = ("eflag", "newton_iters", "prox_iters")
    port = CoreOut(**{k: torch.tensor(v, dtype=torch.int32 if k in ints
                                      else F64) for k, v in vals.items()})
    ref = JaxCoreOut(**{k: jnp.asarray(v) for k, v in vals.items()})
    return port, ref


def test_batch_stats_and_summary_match_reference():
    """batch_stats equals the JAX package's field by field, and
    print_batch_final writes the JAX package's text."""
    port, ref = _core()
    s, js = batch_stats(port), jax_stats(ref)
    assert s._fields == js._fields
    for f in s._fields:
        np.testing.assert_allclose(getattr(s, f).numpy(),
                                   np.asarray(getattr(js, f)), err_msg=f)
    opts = Options(display_level=Display.FINAL)
    sink, jsink = Sink(), Sink()
    print_batch_final(port, opts, sink)
    jax_print_batch_final(ref, JaxOptions(display_level=JaxDisplay.FINAL),
                          jsink)
    assert sink.text == jsink.text
    assert "4 instances" in sink.text and "success: 2" in sink.text
    quiet = Sink()
    print_batch_final(port, Options(), quiet)
    print_final(port, Options(), quiet)
    assert quiet.buf == []
    # A batched SolverOut handed to print_final goes to the batch summary.
    sink2 = Sink()
    print_final(port, opts, sink2)
    assert sink2.text == sink.text
    NullStream().print("nothing")


FEASIBLE = dict(H=[[3.0, 1.0], [1.0, 1.0]], f=[10.0, 5.0],
                A=[[-1.0, 0.0], [0.0, 1.0]], b=[0.0, 0.0])


def _assert_same_tables(text, ref):
    """Line for line the reference's text but the wall-clock line: the
    same words and integers, and the printed residual norms within
    rtol 1e-6 or 1e-9 (norms near zero are roundoff of either solve)."""
    lines = lambda t: [ln for ln in t.splitlines()
                       if not ln.startswith("Time elapsed")]
    got, want = lines(text), lines(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        ta, tb = a.replace(",", " ").split(), b.replace(",", " ").split()
        assert len(ta) == len(tb), (a, b)
        for x, y in zip(ta, tb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (a, b)
                continue
            assert np.isclose(fx, fy, rtol=1e-6, atol=1e-9), (a, b)


def _jax_display(level):
    """The JAX facade's output at `level` on tests/test_display.py's QP,
    through an injected stream."""
    sink = Sink()
    s = JaxFBstabDense(2, 0, 2, stream=sink)
    s.update_options(JaxOptions(abs_tol=1e-8, display_level=level))
    _, o = s.solve(jax_dense_qp_data(**FEASIBLE))
    jax.effects_barrier()
    return sink.text, int(o.prox_iters)


def _port_display(level, stream=None, via_set_stream=False):
    data = dense_qp_data(**{k: np.asarray(v)[None] for k, v in
                            FEASIBLE.items()}, device="cpu")
    sink = Sink()
    s = FBstabDense(2, 0, 2, F64, None if via_set_stream else sink,
                    device="cpu")
    if via_set_stream:
        s.set_stream(sink)
    s.update_options(Options(abs_tol=1e-8, display_level=level))
    _, out = s.solve(data, stream=stream)
    return sink.text, out


@pytest.mark.parametrize("level", ["ITER", "ITER_DETAILED"])
def test_iteration_tables_match_reference(level):
    """The facade's iteration tables and FINAL summary through the stream
    the facade was made with or given by set_stream: at Display.ITER line
    for line the JAX package's (_assert_same_tables); at ITER_DETAILED
    the shape tests/test_display.py checks."""
    text, out = _port_display(Display[level],
                              via_set_stream=level == "ITER_DETAILED")
    if level == "ITER":
        jtext, jprox = _jax_display(JaxDisplay.ITER)
        _assert_same_tables(text, jtext)
        assert int(out.prox_iters) == jprox
        rows = [ln for ln in text.splitlines()
                if re.match(r"\s+\d+\s+\d+\s+[\d.e+-]+", ln)]
        assert len(rows) == int(out.prox_iters) + 1
        assert "Optimization completed!" in text and "Tolerance" in text
    else:
        assert "Begin Prox Iter:" in text and "Step Size" in text
        assert "Exiting inner loop." in text
        assert re.search(r"\d+\s+1\.0\d+e\+00\s+[\d.e+-]+\s+[\d.e+-]+", text)


def test_off_prints_nothing(capfd):
    """Display.OFF writes nothing, to the stream or to stdout."""
    text, out = _port_display(Display.OFF)
    assert text == ""
    assert capfd.readouterr().out == ""
    assert int(out.eflag) == ExitFlag.SUCCESS


def test_final_summary_goes_to_the_call_stream():
    """solve(..., stream=s) sends the FINAL summary to s for that call;
    the tables stay on the facade's stream."""
    call = Sink()
    text, _ = _port_display(Display.ITER, stream=call)
    assert "prox iter" in text and "Optimization completed!" not in text
    assert "Optimization completed!" in call.text


def test_mpc_facade_iteration_table():
    """FBstabMpc prints the ITER table through its stream: one line per
    outer iteration (prox_iters + 1) and the summary."""
    data = torch_data(headline_arrays(1, 4, 2, 1, 2), F64)
    sink = Sink()
    s = FBstabMpc(4, 2, 1, 2, F64, sink, device="cpu")
    s.update_options(Options(abs_tol=1e-8, display_level=Display.ITER))
    _, out = s.solve(data)
    rows = [ln for ln in sink.text.splitlines()
            if re.match(r"\s+\d+\s+\d+\s+[\d.e+-]+", ln)]
    assert len(rows) == int(out.prox_iters) + 1
    assert "Optimization completed!" in sink.text


def test_batched_core_tables_lane_zero():
    """The lockstep core prints lane 0's table for a batch, after a note
    that says so; the batch's result is the same with display off."""
    arrays = {k: np.repeat(np.asarray(v)[None], 2, 0)
              for k, v in FEASIBLE.items()}
    arrays["f"][1] *= 2.0
    data = dense_qp_data(**arrays, device="cpu")
    guess = [torch.zeros(2, n, dtype=F64) for n in (2, 0, 2)]
    sink = Sink()
    opts = Options(abs_tol=1e-8, display_level=Display.ITER)
    x, core = fbstab_solve_batch(DENSE_OPS, data, *guess, opts, sink)
    assert sink.buf[0].startswith("(iteration table of lane 0 of a batch "
                                  "of 2)")
    rows = [ln for ln in sink.text.splitlines()
            if re.match(r"\s+\d+\s+\d+\s+[\d.e+-]+", ln)]
    assert len(rows) == int(core.prox_iters[0]) + 1
    x0, core0 = fbstab_solve_batch(DENSE_OPS, data, *guess,
                                   dataclasses.replace(opts,
                                                       display_level=0))
    assert torch.equal(x.z, x0.z)
    assert core.newton_iters.tolist() == core0.newton_iters.tolist()


def test_options_carry_display_across():
    """The display level crosses over from the JAX package's Options."""
    assert torch_options(JaxOptions(display_level=JaxDisplay.ITER)) \
        .display_level == Display.ITER

"""PyTorch port: the associative (parallel-in-horizon) Riccati step of
ops/assoc_riccati.py and its scan-level kernel K5 (ops/assoc_combine_cuda.py;
on the CPU its plain version) against `fbstab_tpu.ops.assoc_riccati`, in
float64: one combine level against the Pallas kernel in interpret mode
(1e-10 relative; the port's spans are instance-major, the JAX package's
batch-last), the KKT solve against JAX's batch-last one and against the
saddle system it solves (1e-9), and the single-instance and batched solves
with riccati="assoc" (exit flags and iteration counts equal per lane). The
explicit scan is held against a sequential fold and against
`jax.lax.associative_scan`'s order of combination, and K5's wrapper is
shown to take the scan's stage-strided views as they are. K5 itself is compared
with its plain version on the card (marked `cuda`); JAX is imported inside
the parity tests only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402
    dims, headline_arrays, jax_data, launches, plant_arrays, require_cuda,
    span_arrays, spd_bl, torch_data, torch_options)

from fbstab_tpu_torch.models import mpc_qp as tm  # noqa: E402
from fbstab_tpu_torch.ops import assoc_combine_cuda as k5  # noqa: E402
from fbstab_tpu_torch.ops.assoc_riccati import (  # noqa: E402
    assoc_kkt_solve_im, associative_scan, suffix_values)


def span_im(side, **kw):
    """A batch-last numpy span stack as an instance-major SpanElement:
    (M, n, n, B) -> (M, B, n, n), (M, n, B) -> (M, B, n)."""
    return k5.SpanElement(*(
        torch.tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)), **kw)
        for a in side))


def batch_last(t):
    """An instance-major output (M, B, ...) as batch-last numpy."""
    return np.moveaxis(t.cpu().numpy(), 1, -1)


def kkt_arrays(N, nx, nu, B, seed=0):
    """Inputs of the batch-last KKT solve: SPD stage Hessians [Qh Sh'; Sh
    Rh], dynamics, right-hand sides and a per-lane sigma."""
    rng = np.random.default_rng(seed)
    H = spd_bl(rng, N + 1, nx + nu, B, 1.0)
    return dict(
        Qh=H[:, :nx, :nx], Rh=H[:, nx:, nx:], Sh=H[:, nx:, :nx],
        A=np.eye(nx)[None, :, :, None] + 0.2 * rng.standard_normal(
            (N, nx, nx, B)),
        B=rng.standard_normal((N, nx, nu, B)),
        r1x=rng.standard_normal((N + 1, nx, B)),
        r1u=rng.standard_normal((N + 1, nu, B)),
        rl=rng.standard_normal((N + 1, nx, B)),
        sigma=10.0 ** rng.uniform(-3, -1, B))


def _rel(got, want):
    """max |got - want| / (1 + max |want|) per lane (the last axis)."""
    g, w = np.asarray(got), np.asarray(want)
    axes = tuple(range(w.ndim - 1))
    return (np.abs(g - w).max(axes) / (1 + np.abs(w).max(axes))).max()


def test_combine_matches_pallas_kernel_interpret(monkeypatch):
    import jax.numpy as jnp
    from fbstab_tpu.ops import assoc_riccati as jar

    monkeypatch.setattr(jar, "PALLAS_MODE", "interpret")
    left, right = span_arrays(3, 4, 5)
    jl = jar._SpanElement(*(jnp.asarray(a) for a in left))
    jr = jar._SpanElement(*(jnp.asarray(a) for a in right))
    assert jar._combine_kernel_eligible(jl.P11)
    want = jar._combine_bl(jl, jr)
    tl, tr = span_im(left), span_im(right)
    for got in (k5.combine_im_plain(tl, tr), k5.combine_im(tl, tr)):
        for name, g, w in zip(k5.SpanElement._fields, got, want):
            assert _rel(batch_last(g), w) <= 1e-10, name


def test_combine_wrapper_takes_plain_version_for_cpu_tensors():
    left, right = span_arrays(2, 3, 4)
    tl, tr = span_im(left), span_im(right)
    before = launches("k5")
    got, want = k5.combine_im(tl, tr), k5.combine_im_plain(tl, tr)
    assert launches("k5") == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


class _RecordingLib:
    """Stands in for the kernel library: records what launch_combine
    passes to fb_assoc_combine."""

    def __init__(self):
        self.calls = []

    def fb_assoc_combine(self, n, M, B, strides, *ptrs):
        self.calls.append((n, M, B, list(strides), ptrs[:10]))
        return 0


def test_combine_wrapper_takes_the_scans_strided_views_without_copies():
    """Every level of the suffix scan hands K5's launcher views of every
    other stage element; the launcher passes their own pointers and pair
    strides (no copy) with contiguous (B, n, n) blocks."""
    from fbstab_tpu_torch.ops.assoc_combine_cuda import launch_combine

    left, _ = span_arrays(9, 3, 4)
    elems = span_im(left, dtype=torch.float32)
    lib, seen = _RecordingLib(), []

    def level(l, r):
        launch_combine(lib, l, r, 0)
        seen.append([(t.data_ptr(), t.stride(0)) for t in (*l, *r)])
        return k5.combine_im_plain(l, r)
    suffix_values(elems, combine=level)
    assert len(lib.calls) == len(seen) >= 4
    strided = 0
    for (n, M, B, strides, ptrs), views in zip(lib.calls, seen):
        assert (n, B) == (3, 4)
        assert list(ptrs) == [p for p, _ in views]
        assert strides == [s for _, s in views]
        strided += sum(s > B * n * n for s in strides[:3])
    assert strided > 0


@pytest.mark.parametrize("shape", [(8, 4, 3, 5), (40, 3, 2, 4)])
def test_kkt_solve_matches_reference_and_saddle_system(shape):
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.ops.assoc_riccati import assoc_kkt_solve_bl as jax_solve

    N, nx, nu, B = shape
    a = kkt_arrays(N, nx, nu, B)
    args = [a[k] for k in ("Qh", "Rh", "Sh", "A", "B", "r1x", "r1u", "rl",
                           "sigma")]
    want = jax.jit(jax_solve)(*(jnp.asarray(x) for x in args))
    first = [torch.tensor(np.moveaxis(x, -1, 0)) for x in args[:-1]]
    got = [np.moveaxis(g.numpy(), 0, -1) for g in assoc_kkt_solve_im(
        *first, torch.tensor(args[-1]))]
    for name, g, w in zip(("xs", "us", "lams"), got, want):
        assert _rel(g, w) <= 1e-9, name

    # The saddle system: Qh x + Sh'u - l + A'l+ = r1x, Sh x + Rh u + B'l+
    # = r1u (no l+ at stage N), -(G z) + sigma l = rl with (G z)_0 = -x_0,
    # (G z)_i = A x_{i-1} + B u_{i-1} - x_i.
    xs, us, ls = got
    mv = lambda M, v: np.einsum("sijb,sjb->sib", M, v)
    mtv = lambda M, v: np.einsum("sjib,sjb->sib", M, v)
    Qh, Rh, Sh, A, Bm = (a[k] for k in ("Qh", "Rh", "Sh", "A", "B"))
    pad = lambda v: np.concatenate([v, np.zeros_like(v[:1])])
    rx = mv(Qh, xs) + mtv(Sh, us) - ls + pad(mtv(A, ls[1:]))
    ru = mv(Sh, xs) + mv(Rh, us) + pad(mtv(Bm, ls[1:]))
    Gz = np.concatenate([-xs[:1], mv(A, xs[:-1]) + mv(Bm, us[:-1])
                         - xs[1:]])
    rl = -Gz + a["sigma"] * ls
    for name, lhs, rhs in (("x rows", rx, a["r1x"]), ("u rows", ru, a["r1u"]),
                           ("l rows", rl, a["rl"])):
        assert _rel(lhs, rhs) <= 1e-9, name


def _di_or_servo(plant, N):
    arrays = plant_arrays(plant, N, 1)
    return arrays, [np.zeros(n) for n in dims(arrays)[4:]]


@pytest.mark.parametrize("plant,N,tol", [
    ("double_integrator", 20, 1e-9), ("servo_motor", 25, 1e-8)])
def test_single_instance_assoc_solve_matches_reference(plant, N, tol):
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.models.mpc_qp import solve_mpc_qp as jax_solve
    from fbstab_tpu.options import Options as JaxOptions

    arrays, guess = _di_or_servo(plant, N)
    jopts = JaxOptions(abs_tol=tol)
    one = {k: v[0] for k, v in arrays.items()}
    xr, cr = jax.jit(lambda d, z, l, v: jax_solve(
        d, z, l, v, jopts, riccati="assoc"))(
        jax_data(one, jnp.float64), *(jnp.asarray(g) for g in guess))
    xt, ct = tm.solve_mpc_qp(torch_data(arrays, torch.float64),
                             *(torch.tensor(g) for g in guess),
                             torch_options(jopts), riccati="assoc")
    assert int(cr.eflag) == 0
    for f in ("eflag", "newton_iters", "prox_iters"):
        assert int(getattr(ct, f)) == int(getattr(cr, f)), f
    np.testing.assert_allclose(xt.z.numpy(), np.asarray(xr.z), atol=1e-8)


def test_batched_assoc_solve_matches_reference():
    """bench.build_batch(6, 16, 4, 2, 4)'s batch with riccati="assoc", as
    tests/test_assoc_riccati.py runs it."""
    import jax
    import jax.numpy as jnp
    from fbstab_tpu.models.mpc_qp import solve_mpc_qp_batch as jax_solve
    from fbstab_tpu.options import Options as JaxOptions

    arrays = headline_arrays(6, 16, 4, 2, 4)
    B = 6
    guess = [np.zeros((B, n)) for n in dims(arrays)[4:]]
    jopts = JaxOptions(abs_tol=1e-9)
    xr, cr = jax.jit(lambda d, z, l, v: jax_solve(
        d, z, l, v, jopts, riccati="assoc"))(
        jax_data(arrays, jnp.float64), *(jnp.asarray(g) for g in guess))
    xt, ct = tm.solve_mpc_qp_batch(torch_data(arrays, torch.float64),
                                   *(torch.tensor(g) for g in guess),
                                   torch_options(jopts), riccati="assoc")
    assert np.all(np.asarray(cr.eflag) == 0)
    for f in ("eflag", "newton_iters", "prox_iters"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cr, f)), err_msg=f)
    np.testing.assert_allclose(xt.z.numpy(), np.asarray(xr.z), atol=1e-9)


def test_auto_policy():
    """riccati="auto": the associative step from ASSOC_MIN_HORIZON on the
    CPU (single instance and batches); float32 batches on the card stay on
    the sequential scan."""
    short, _ = _di_or_servo("double_integrator", 20)
    long_, _ = _di_or_servo("double_integrator", tm.ASSOC_MIN_HORIZON)
    ds, dl = (torch_data(a, torch.float64) for a in (short, long_))
    assert tm._pick_mpc_ops(ds, "auto") is tm.MPC_OPS
    assert tm._pick_mpc_ops(dl, "auto") is tm.MPC_OPS_ASSOC
    assert tm._auto_batch_riccati(dl, torch.float64, "cpu") == "assoc"
    assert tm._auto_batch_riccati(ds, torch.float64, "cpu") == "scan"
    assert tm._auto_batch_riccati(dl, torch.float32, "cuda") == "scan"
    with pytest.raises(ValueError):
        tm._pick_mpc_ops(ds, "sweep")


def _matmul(a, b):
    return (a[0] @ b[0],)


def _skewed(a, b):
    # Not associative: the result depends on the combination tree.
    return (2.0 * a[0] + b[0] * b[0] / 3.0,)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_sequential_fold_and_jax_order(n, reverse):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    mats = rng.standard_normal((n, 3, 3)) / 2
    got = associative_scan(_matmul, (torch.tensor(mats),),
                           reverse=reverse)[0].numpy()
    # Sequential fold: prefix products, or with reverse suffix products
    # whose later factor comes first (fn(later, earlier)).
    want = np.empty_like(mats)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc = None
    for i in order:
        acc = mats[i] if acc is None else acc @ mats[i]
        want[i] = acc
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    vals = rng.standard_normal((n, 4))
    mine = associative_scan(_skewed, (torch.tensor(vals),),
                            reverse=reverse)[0].numpy()
    ref = jax.lax.associative_scan(_skewed, (jnp.asarray(vals),),
                                   reverse=reverse)[0]
    np.testing.assert_array_equal(mine, np.asarray(ref))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """K5 on the card against its plain version in float32 on well
    conditioned spans (n = 4 and the copolymerization reactor's n = 18):
    within 1e-4 of each lane's largest entry."""
    require_cuda()
    dev = torch.device("cuda", 0)
    for M, n, B in ((3, 4, 40), (5, 18, 64)):
        left, right = span_arrays(M, n, B)
        f32 = dict(dtype=torch.float32, device=dev)
        tl, tr = span_im(left, **f32), span_im(right, **f32)
        before = launches("k5")
        got = k5.combine_im(tl, tr)
        torch.cuda.synchronize()
        assert launches("k5") == before + 1
        want = k5.combine_im_plain(tl, tr)
        for name, g, w in zip(k5.SpanElement._fields, got, want):
            assert _rel(batch_last(g), batch_last(w)) <= 1e-4, name

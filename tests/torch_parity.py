"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is built in numpy from a fixed seed or from the JAX package's
fixtures, and handed to both packages: `jax_data` for `fbstab_tpu`,
`torch_data` (through `fbstab_tpu_torch.interop`) for the port.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np


def plant_arrays(plant: str, N, B, x0s=None):
    """A reference plant (by fixture name) as numpy arrays with a leading
    batch axis B (lanes equal unless x0s is given). Built by the port's
    numpy fixtures, which equal fbstab_tpu's (tests/test_torch_options.py),
    so the module needs no JAX."""
    from fbstab_tpu_torch.models import ocp_fixtures
    data, _ = getattr(ocp_fixtures, plant)(N, device="cpu")
    arrays = {k: np.broadcast_to(v[0].numpy(), (B,) + tuple(v.shape[1:]))
              .copy() for k, v in data._asdict().items()}
    if x0s is not None:
        arrays["x0"] = np.asarray(x0s, np.float64).reshape(B, -1)
    return arrays


def mixed_batch():
    """The mixed feasible / infeasible double-integrator batch of
    tests/test_fused_solve.py (N = 6, B = 8)."""
    x0s = [[0.0, 0.0], [1.5, 0.3], [-1.0, 0.0], [0.3, -0.2],
           [1.9, 0.05], [-2.5, 0.0], [0.7, 0.6], [1.0, -0.9]]
    return plant_arrays("double_integrator", 6, 8, x0s=x0s)


def copoly_arrays(B, N, seed=0):
    """The copolymerization reactor (nx = 18, nu = 5, nc = 10) at horizon
    N with x0 = 0.02 N(0, 1) per lane (tests/test_subfused.py's batch,
    bench.py copoly's at N = 80), as numpy arrays for both packages."""
    rng = np.random.default_rng(seed)
    return plant_arrays("copolymerization_reactor", N, B,
                        x0s=0.02 * rng.standard_normal((B, 18)))


def spd_bl(rng, S, n, B, shift):
    """S x B random SPD n x n matrices (M M' / n + shift I), stage-stacked
    with the batch last: (S, n, n, B), contiguous."""
    M = rng.standard_normal((S, B, n, n))
    P = M @ np.swapaxes(M, -1, -2) / n + shift * np.eye(n)
    return np.ascontiguousarray(np.moveaxis(P, 1, -1))


def span_arrays(M, n, B, seed=0):
    """Two stacks (left, right) of M span elements of the associative
    Riccati scan, batch last: SPD diagonal blocks whose sum K is well
    conditioned, Gaussian off-diagonal blocks and vectors."""
    rng = np.random.default_rng(seed)

    def span():
        return (spd_bl(rng, M, n, B, 1.0),
                0.3 * rng.standard_normal((M, n, n, B)),
                spd_bl(rng, M, n, B, 0.5),
                rng.standard_normal((M, n, B)), rng.standard_normal((M, n, B)))
    return span(), span()


def perturbed_x0(arrays, pert, seed=7):
    """bench.plants_contract_check's x0 perturbation; lane 0 nominal."""
    x0 = arrays["x0"][0]
    B, nx = arrays["x0"].shape
    rng = np.random.default_rng(seed)
    scale = float(np.max(np.abs(x0))) or 0.02
    offs = pert * scale * np.abs(rng.standard_normal((B, nx)))
    offs[0] = 0.0
    out = dict(arrays)
    out["x0"] = x0[None] + offs
    return out


def headline_arrays(B, N=30, nx=8, nu=3, nc=6, seed=0):
    """bench.build_batch's scenario-MPC batch in numpy (the generator
    chip_smoke.py drives the card with), as writable copies."""
    from fbstab_tpu_torch.workloads import headline_arrays as gen
    return {k: np.array(v) for k, v in gen(B, N, nx, nu, nc, seed).items()}


def dense_arrays(B, n=32, q=64, nl=0, seed=1):
    """bench.build_dense_batch's random dense QPs in numpy (the generator
    chip_smoke.py drives the card with), as writable copies."""
    from fbstab_tpu_torch.workloads import dense_arrays as gen
    return {k: np.array(v) for k, v in gen(B, n, q, nl, seed).items()}


def dense_mixed_batch(nl=0, B=8, n=6, q=10):
    """tests/test_dense_fused.py's mixed batch (seed 0) with a
    rank-deficient lane (3), plus a primal-infeasible lane (5: z0 <= -1
    and -z0 <= -2) and an unbounded lane (6: H singular along e1, f1 < 0,
    A e1 <= 0); with nl > 0, random equality rows (G e1 = 0 on lane 6),
    and lane 7 primal infeasible through them (G forces z0 = 5 against
    z0 <= 1), so that G'dl and h'dl decide its certificate."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((B, n, n))
    H = M @ np.transpose(M, (0, 2, 1)) / n + np.eye(n)
    H[3] = 0.0
    H[3, 0, 0] = 1.0
    f = rng.standard_normal((B, n))
    A = rng.standard_normal((B, q, n))
    b = np.abs(rng.standard_normal((B, q))) + 0.5
    G = rng.standard_normal((B, nl, n))
    h = 0.1 * rng.standard_normal((B, nl))
    A[5, :2] = 0.0
    A[5, 0, 0], A[5, 1, 0] = 1.0, -1.0
    b[5, :2] = -1.0, -2.0
    H[6, 1, :] = 0.0
    H[6, :, 1] = 0.0
    f[6, 1] = -1.0
    A[6, :, 1] = -np.abs(A[6, :, 1])
    G[6, :, 1] = 0.0
    if nl > 0:
        G[7] = np.eye(nl, n)
        h[7] = 0.0
        h[7, 0] = 5.0
        A[7, 0] = 0.0
        A[7, 0, 0] = 1.0
        b[7, 0] = 1.0
    return dict(H=H, f=f, G=G, h=h, A=A, b=b)


def dims(arrays):
    """(N, nx, nu, nc, nz, nl, nv)."""
    N, nx = arrays["A"].shape[1], arrays["A"].shape[-1]
    nu, nc = arrays["B"].shape[-1], arrays["E"].shape[-2]
    N1 = N + 1
    return N, nx, nu, nc, N1 * (nx + nu), N1 * nx, N1 * nc


def jax_data(arrays, dtype):
    import jax.numpy as jnp
    from fbstab_tpu.models.mpc_qp import MpcQPData
    return MpcQPData(**{k: jnp.asarray(v, dtype) for k, v in arrays.items()})


def torch_data(arrays, dtype, device="cpu"):
    from fbstab_tpu_torch.interop import mpc_data_from_arrays
    return mpc_data_from_arrays(dtype=dtype, device=device, **arrays)


def jax_dense_data(arrays, dtype):
    import jax.numpy as jnp
    from fbstab_tpu.models.dense_qp import DenseQPData
    return DenseQPData(**{k: jnp.asarray(v, dtype)
                          for k, v in arrays.items()})


def torch_dense_data(arrays, dtype, device="cpu"):
    from fbstab_tpu_torch.interop import dense_data_from_arrays
    return dense_data_from_arrays(dtype=dtype, device=device, **arrays)


def torch_options(jax_options):
    from fbstab_tpu_torch.interop import options_from_fields
    return options_from_fields(dataclasses.asdict(jax_options))


def f64_residual(arrays, z, l, v, alpha, data_dtype=np.float32):
    """Host float64 penalized natural residual (bench.f64_pnr_np) of the
    problem the solver saw: the data rounded to `data_dtype` first."""
    from bench import f64_pnr_np
    from fbstab_tpu.models.mpc_qp import MpcQPData
    seen = {k: np.asarray(a, data_dtype) for k, a in arrays.items()}
    return f64_pnr_np(MpcQPData(**seen), np.asarray(z, np.float64),
                      np.asarray(l, np.float64), np.asarray(v, np.float64),
                      alpha)


def modules_after_import(module: str) -> set:
    """sys.modules of a fresh interpreter (no conftest) after importing
    `module` (one name, or several separated by commas)."""
    code = (f"import sys, {module}; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    return set(out.stdout.split())


def launches(kernel: str) -> int:
    """All-time launches of a kernel ("k1", "k2_lowmem", ...), from the
    port's counters (fbstab_tpu_torch/telemetry.py)."""
    from fbstab_tpu_torch import telemetry
    return telemetry.counters().get(f"launch.{kernel}", 0)


def require_cuda():
    """Skips the calling test unless a CUDA device is present (decided at
    run time, never at import or collection)."""
    import pytest
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")

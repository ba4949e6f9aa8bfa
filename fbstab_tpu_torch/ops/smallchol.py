"""Batched small-matrix Cholesky and triangular solves, unrolled over the
matrix dimension (counterpart of `fbstab_tpu/ops/smallchol.py`).

Every step is one batched elementwise op over all leading axes. Failure
(a non-positive pivot) produces NaNs through sqrt of a negative number,
which is the failure convention `_riccati_factor_ok` relies on. Beyond
UNROLL_LIMIT, `cholesky` falls back to `torch.linalg.cholesky_ex` with its
`info` mapped onto the same NaN convention.
"""

from __future__ import annotations

import torch

UNROLL_LIMIT = 32


def cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n) SPD matrices, right-looking
    outer-product form (the recurrence of the JAX package)."""
    n = A.shape[-1]
    if n == 0:
        return A
    cols = []
    for k in range(n):
        d = torch.sqrt(A[..., k, k])
        col = A[..., :, k] / d[..., None]
        if k > 0:
            col = torch.cat([torch.zeros_like(col[..., :k]), col[..., k:]],
                            dim=-1)
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky with NaN-on-failure semantics."""
    if A.shape[-1] <= UNROLL_LIMIT:
        return cholesky_small(A)
    Lf, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(Lf, float("nan")), Lf)


def solve_triangular_small(L: torch.Tensor, b: torch.Tensor,
                           lower: bool = True) -> torch.Tensor:
    """Solves T x = b for triangular T (..., n, n); b is (..., n) or
    (..., n, m). Unrolled substitution over n."""
    n = L.shape[-1]
    if n == 0:
        return b
    if n > UNROLL_LIMIT:
        vec = b.ndim == L.ndim - 1
        r = b[..., None] if vec else b
        x = torch.linalg.solve_triangular(L, r, upper=not lower)
        return x[..., 0] if vec else x
    vec = b.ndim == L.ndim - 1
    r = b[..., None] if vec else b
    order = range(n) if lower else range(n - 1, -1, -1)
    xs = [None] * n
    for k in order:
        xk = r[..., k, :] / L[..., k, k, None]
        r = r - L[..., :, k, None] * xk[..., None, :]
        xs[k] = xk
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def cho_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves (L L') x = b given the lower factor L."""
    t = solve_triangular_small(L, b, lower=True)
    return solve_triangular_small(L.transpose(-1, -2), t, lower=False)

"""Penalized Fischer-Burmeister function and its generalized gradient
(counterpart of `fbstab_tpu/ops/pfb.py`; reference full_residual.cc:115-118
and dense_cholesky_solver.cc:129-148). Elementwise over any shape."""

from __future__ import annotations

import torch

from fbstab_tpu_torch.ops.doublefloat import sqrt_rn

# Reference: DenseCholeskySolver::zero_tolerance_ (dense_cholesky_solver.h:94).
ZERO_TOLERANCE = 1e-13


def pfb(a, b, alpha):
    """alpha*(a + b - sqrt(a^2 + b^2)) + (1 - alpha)*max(0, a)*max(0, b)."""
    fb = a + b - sqrt_rn(a * a + b * b)
    return alpha * fb + (1.0 - alpha) * torch.clamp(a, min=0.0) * \
        torch.clamp(b, min=0.0)


def pfb_gradient(a, b, alpha):
    """(ga, gb), an element of the C-differential of pfb, with the
    reference's 3-branch selection (degenerate / interior / otherwise)."""
    r = sqrt_rn(a * a + b * b)
    degenerate = r < ZERO_TOLERANCE
    r_safe = torch.where(degenerate, torch.ones_like(r), r)

    ga_fb = alpha * (1.0 - a / r_safe)
    gb_fb = alpha * (1.0 - b / r_safe)

    interior = (a > 0) & (b > 0)
    ga = torch.where(interior, ga_fb + (1.0 - alpha) * b, ga_fb)
    gb = torch.where(interior, gb_fb + (1.0 - alpha) * a, gb_fb)

    two = torch.tensor(2.0, dtype=r.dtype, device=r.device)
    d = alpha * (1.0 - 1.0 / sqrt_rn(two))
    ga = torch.where(degenerate, d, ga)
    gb = torch.where(degenerate, d, gb)
    return ga, gb


def pfb_weights(y, v, vbar, sigma, alpha):
    """Newton-system weights (gamma, mus, Gamma = gamma/mus) at
    ys = y + sigma*(v - vbar) (riccati_linear_solver.cc:91-99). sigma is a
    Python scalar or a tensor that broadcasts against y."""
    ys = y + sigma * (v - vbar)
    g, m0 = pfb_gradient(ys, v, alpha)
    mus = m0 + sigma * g
    return g, mus, g / mus


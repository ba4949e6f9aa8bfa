"""The QP-class abstraction (counterpart of `fbstab_tpu/core/problem.py`;
reference abstract_components.h): a bundle of batched functions over a
data object. Every function takes and returns tensors with a leading
batch axis."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple


class ProblemOps(NamedTuple):
    """Batched operator contract for a QP class.

    gemvH/A/G/AT/GT(data, x) -> (B, n) products; f_vec/h_vec/b_vec(data)
    -> (B, n) forcing vectors; forcing_norm(data) -> (B,).
    newton_step(data, x, xbar, sigma, alpha, rz, rl, rv) -> (dx, ok) with
    (rz, rl, rv) the negated inner residual and ok a (B,) bool.
    """

    gemvH: Callable[[Any, Any], Any]
    gemvA: Callable[[Any, Any], Any]
    gemvG: Callable[[Any, Any], Any]
    gemvAT: Callable[[Any, Any], Any]
    gemvGT: Callable[[Any, Any], Any]
    f_vec: Callable[[Any], Any]
    h_vec: Callable[[Any], Any]
    b_vec: Callable[[Any], Any]
    forcing_norm: Callable[[Any], Any]
    newton_step: Callable[..., Any]

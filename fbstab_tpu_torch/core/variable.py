"""Batched primal-dual variable (counterpart of `fbstab_tpu/core/variable.py`;
reference full_variable.{h,cc}). Every field carries a leading batch axis:
z (B, nz), l (B, nl), v (B, nv), y (B, nv)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Variable(NamedTuple):
    """Primal-dual point; y is the constraint margin b - A z."""

    z: torch.Tensor
    l: torch.Tensor
    v: torch.Tensor
    y: torch.Tensor


def tree_map(f, *trees):
    """Maps f over matching tensor leaves of nested (named) tuples."""
    t0 = trees[0]
    if not isinstance(t0, tuple):
        return f(*trees)
    mapped = (tree_map(f, *ch) for ch in zip(*trees))
    return type(t0)(*mapped) if hasattr(t0, "_fields") else tuple(mapped)


def lane_col(a):
    """A per-lane (B,) tensor as a (B, 1) column; scalars pass through."""
    if isinstance(a, torch.Tensor) and a.ndim == 1:
        return a[:, None]
    return a


def var_axpy(a, x: Variable, acc: Variable, b_vec) -> Variable:
    """acc + a*x with the margin identity y = b - A z preserved
    (full_variable.cc:55-65). a is a scalar or a per-lane (B,) tensor."""
    a = lane_col(a)
    return Variable(
        z=acc.z + a * x.z,
        l=acc.l + a * x.l,
        v=acc.v + a * x.v,
        y=acc.y + a * (x.y - b_vec),
    )


def var_norm(x: Variable):
    """Per-lane 2-norm over (z, l, v); y is excluded
    (full_variable.cc:77-83)."""
    s = ((x.z * x.z).sum(-1) + (x.l * x.l).sum(-1) + (x.v * x.v).sum(-1))
    return torch.sqrt(s)


def project_duals(x: Variable) -> Variable:
    """v <- max(v, 0) (full_variable.cc:75)."""
    return x._replace(v=torch.clamp(x.v, min=0.0))


def select_var(mask, a: Variable, b: Variable) -> Variable:
    """Per-lane select: a where mask (B,) is set, else b (NaN-safe)."""
    m = mask[:, None]
    return Variable(*(torch.where(m, ai, bi) for ai, bi in zip(a, b)))

"""Double-float ("two-float") arithmetic in plain PyTorch (counterpart of
`fbstab_tpu/ops/doublefloat.py`).

A value is an unevaluated sum hi + lo of two floats (~48 significand bits
for float32), kept exact by Knuth's two_sum and Dekker's two_prod. The
transforms are exact only if every operation rounds on its own: eager
PyTorch runs each operator as its own kernel, so nothing contracts
`a*b + c` into a fused multiply-add or re-associates a sum. Do not wrap
this code in `torch.compile`, whose generated kernels may contract or
re-associate, which would break two_prod. A kernel written by hand may
carry it only with every operation its own rounding:
csrc/doublefloat.cuh writes each as a rounding intrinsic (`__fadd_rn`,
`__fsub_rn`, `__fmul_rn`), which nvcc never contracts, and the MPC
refinement's residual kernel on it (ops/refine_residual_cuda.py) is bit
for bit this module's arithmetic.

A DF value is a plain (hi, lo) tuple of equal-shape tensors.
"""

from __future__ import annotations

import torch

# Dekker split constants: 2^12 + 1 for float32, 2^27 + 1 for float64.
_SPLIT_F32 = 4097.0
_SPLIT_F64 = 134217729.0


def _split_const(dtype):
    return _SPLIT_F32 if dtype == torch.float32 else _SPLIT_F64


def sqrt_rn(x):
    """Correctly rounded square root. PyTorch's float32 sqrt on the CPU is
    off by one ulp on some inputs; the float64 root rounded back to
    float32 is exact (double rounding is innocuous for sqrt). Other
    devices and dtypes take torch.sqrt, which is IEEE-exact there."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def two_sum(a, b):
    """Exact addition: s + e == a + b with s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact addition assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Exact product: p + e == a * b with p = fl(a * b) (Dekker)."""
    p = a * b
    c = _split_const(a.dtype)
    a_big = c * a
    a_hi = a_big - (a_big - a)
    a_lo = a - a_hi
    b_big = c * b
    b_hi = b_big - (b_big - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df(hi, lo=None):
    """Lifts a tensor (or pair) into DF form."""
    if lo is None:
        lo = torch.zeros_like(hi)
    return (hi, lo)


def df_to(x):
    """Collapses a DF to its nearest single-float value."""
    return x[0] + x[1]


def df_neg(x):
    return (-x[0], -x[1])


def df_add(x, y):
    """DF + DF."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def df_add_f(x, a):
    """DF + float."""
    s, e = two_sum(x[0], a)
    e = e + x[1]
    return fast_two_sum(s, e)


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul_ff(a, b):
    """float * float -> DF (exact)."""
    return two_prod(a, b)


def df_mul_f(x, a):
    """DF * float."""
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return fast_two_sum(p, e)


def df_mul(x, y):
    """DF * DF."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def df_div_f(x, a):
    """DF / float via one Newton correction on the float quotient."""
    q = x[0] / a
    p, e = two_prod(q, a)
    r = df_add(x, (-p, -e))
    return fast_two_sum(q, df_to(r) / a)


def df_sqrt(x):
    """sqrt(DF) via one Newton step: s + (x - s^2) / (2 s)."""
    s = sqrt_rn(x[0])
    p, e = two_prod(s, s)
    r = df_add(x, (-p, -e))
    pos = s > 0
    denom = torch.where(pos, 2.0 * s, torch.ones_like(s))
    corr = torch.where(pos, df_to(r) / denom, torch.zeros_like(s))
    return fast_two_sum(s, corr)


def df_min(x, y):
    """Elementwise min by hi-then-lo lexicographic comparison."""
    take_x = (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))
    return (torch.where(take_x, x[0], y[0]), torch.where(take_x, x[1], y[1]))


def df_max0(x):
    """max(0, DF)."""
    pos = (x[0] > 0) | ((x[0] == 0) & (x[1] > 0))
    zero = torch.zeros_like(x[0])
    return (torch.where(pos, x[0], zero), torch.where(pos, x[1], zero))


def df_where(pred, x, y):
    return (torch.where(pred, x[0], y[0]), torch.where(pred, x[1], y[1]))


def df_matvec(M, x):
    """Compensated matvec over the LAST axis of M: M (..., m, k) float,
    x = (hi, lo) DF (..., k) -> DF (..., m). The products are error-free
    transforms taken all at once; the k contraction then accumulates in
    the JAX package's order (j = 0, 1, ...)."""
    hi, lo = x
    p, e = two_prod(M, hi[..., None, :])
    e = e + M * lo[..., None, :]
    acc = df(torch.zeros(M.shape[:-1], dtype=M.dtype, device=M.device))
    for j in range(M.shape[-1]):
        acc = df_add(acc, (p[..., j], e[..., j]))
    return acc


def df_matvec_T(M, x):
    """Compensated transposed matvec: M (..., m, k) float, x DF (..., m)
    -> DF (..., k) computing M'x, accumulated over i = 0, 1, ..."""
    hi, lo = x
    p, e = two_prod(M, hi[..., :, None])
    e = e + M * lo[..., :, None]
    acc = df(torch.zeros(M.shape[:-2] + (M.shape[-1],), dtype=M.dtype,
                         device=M.device))
    for i in range(M.shape[-2]):
        acc = df_add(acc, (p[..., i, :], e[..., i, :]))
    return acc

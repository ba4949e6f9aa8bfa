"""K5, one level of the associative Riccati scan, as a CUDA kernel
(csrc/assoc_combine.cu).

Counterpart of `fbstab_tpu/ops/assoc_riccati.py::_combine_bl_pallas`: it
combines M pairs of adjacent span elements of every instance, n <= 32.
The spans are instance-major: stage-stacked (M, B, n, n) matrices and
(M, B, n) vectors, where the JAX package keeps the batch last ((M, n, n,
B), (M, n, B)); `combine_im_plain` is its `_combine_bl` and `psolve_im`
its `_psolve_bl` in this layout.

`combine_im` takes the plain version (`combine_im_plain`) only for tensors
on the CPU. For CUDA tensors it launches the kernel or raises; it never
falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fbstab_tpu_torch import telemetry

# The kernel's limit on the state dimension (the Pallas kernel's).
COMBINE_MAX_N = 32


class SpanElement(NamedTuple):
    """Quadratic form on a span's boundary states (a, b):
    1/2 a'P11 a + a'P12 b + 1/2 b'P22 b + p1'a + p2'b, instance-major."""

    P11: torch.Tensor   # (S, B, n, n)
    P12: torch.Tensor   # (S, B, n, n)
    P22: torch.Tensor   # (S, B, n, n)
    p1: torch.Tensor    # (S, B, n)
    p2: torch.Tensor    # (S, B, n)


def _mv(X, y):
    """(..., i, j) @ (..., j) -> (..., i)."""
    return (X @ y[..., None])[..., 0]


def _T(X):
    return X.transpose(-1, -2)


def psolve_im(K, rhs):
    """SPD solve: K (..., n, n), rhs (..., n) or (..., n, m).
    Jacobi-equilibrated (the system with s K s, s = 1 / sqrt(|diag K| +
    tiny)), on the unrolled small Cholesky; NaNs on a failed factor."""
    from fbstab_tpu_torch.ops.smallchol import cho_solve_small, cholesky
    tiny = torch.finfo(K.dtype).tiny
    s = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1).abs() + tiny)
    Keq = K * s[..., :, None] * s[..., None, :]
    smat = s if rhs.ndim == K.ndim - 1 else s[..., None]
    return cho_solve_small(cholesky(Keq), rhs * smat) * smat


def combine_im_plain(left: SpanElement, right: SpanElement) -> SpanElement:
    """The plain PyTorch version of K5 (`_combine_bl` of the JAX package):
    eliminates the boundary state shared by the left and right spans."""
    K = left.P22 + right.P11
    KiP12LT = psolve_im(K, _T(left.P12))
    KiP12R = psolve_im(K, right.P12)
    Kiw = psolve_im(K, left.p2 + right.p1)
    P11 = left.P11 - left.P12 @ KiP12LT
    P12 = -(left.P12 @ KiP12R)
    P22 = right.P22 - _T(right.P12) @ KiP12R
    p1 = left.p1 - _mv(left.P12, Kiw)
    p2 = right.p2 - _mv(_T(right.P12), Kiw)
    P11 = 0.5 * (P11 + _T(P11))
    P22 = 0.5 * (P22 + _T(P22))
    return SpanElement(P11, P12, P22, p1, p2)


def launch_combine(lib, left: SpanElement, right: SpanElement, stream: int
                   ) -> SpanElement:
    """Allocates the combined blocks and launches K5 from `lib` on float32
    spans of one shape, each with contiguous inner (B, n, n) or (B, n)
    dims and any stride along the pair axis."""
    from fbstab_tpu_torch.ops._build import check
    M, B, n, _ = left.P11.shape
    dev = left.P11.device
    mat, vec = (M, B, n, n), (M, B, n)
    for name, t in (*zip(("l" + f for f in SpanElement._fields), left),
                    *zip(("r" + f for f in SpanElement._fields), right)):
        want = mat if t.ndim == 4 else vec
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != want):
            raise ValueError(f"{name}: K5 takes float32 {want} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t[0].is_contiguous():
            raise ValueError(f"{name}: K5 takes contiguous inner dims, got "
                             f"strides {t.stride()}")
    ins = (*left, *right)
    strides = (ctypes.c_longlong * 10)(*(t.stride(0) for t in ins))
    out = SpanElement(*(torch.empty(s, dtype=torch.float32, device=dev)
                        for s in (mat, mat, mat, vec, vec)))
    err = lib.fb_assoc_combine(n, M, B, strides, *[t.data_ptr() for t in ins],
                               *[t.data_ptr() for t in out], stream)
    check(err, "assoc_combine")
    return out


def combine_im(left: SpanElement, right: SpanElement) -> SpanElement:
    """One scan level: combines the M pairs (left[m], right[m]) of every
    instance. CPU tensors take the plain version; CUDA float32 tensors with
    n <= COMBINE_MAX_N launch K5."""
    x = left.P11
    if x.device.type == "cpu":
        return combine_im_plain(left, right)
    if not x.is_cuda:
        raise ValueError(f"no combine kernel for device {x.device}")
    if x.shape[-1] > COMBINE_MAX_N:
        raise ValueError(f"K5 takes n <= {COMBINE_MAX_N}, got n = "
                         f"{x.shape[-1]}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    out = launch_combine(lib, left, right,
                         torch.cuda.current_stream(x.device).cuda_stream)
    telemetry.count("launch.k5")
    return out


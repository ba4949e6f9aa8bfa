"""K5, one level of the associative Riccati scan, as a CUDA kernel
(csrc/assoc_combine.cu).

Counterpart of `fbstab_tpu/ops/assoc_riccati.py::_combine_bl_pallas`: it
combines M pairs of adjacent span elements of every instance, stage-stacked
with the batch last ((M, n, n, B) matrices, (M, n, B) vectors), n <= 32.

`combine_bl` takes the plain version (`combine_bl_plain`, the batched
PyTorch algebra of `_combine_bl`) only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# The kernel's limit on the state dimension (the Pallas kernel's).
COMBINE_MAX_N = 32


class SpanElement(NamedTuple):
    """Quadratic form on a span's boundary states (a, b):
    1/2 a'P11 a + a'P12 b + 1/2 b'P22 b + p1'a + p2'b, batch last."""

    P11: torch.Tensor   # (S, n, n, B)
    P12: torch.Tensor   # (S, n, n, B)
    P22: torch.Tensor   # (S, n, n, B)
    p1: torch.Tensor    # (S, n, B)
    p2: torch.Tensor    # (S, n, B)


def _mm_bl(X, Y):
    """(S, i, j, B) @ (S, j, k, B) -> (S, i, k, B)."""
    return torch.einsum("sijb,sjkb->sikb", X, Y)


def _mv_bl(X, y):
    """(S, i, j, B) @ (S, j, B) -> (S, i, B)."""
    return torch.einsum("sijb,sjb->sib", X, y)


def _T_bl(X):
    return X.transpose(1, 2)


def psolve_bl(K, rhs):
    """SPD solve, batch last: K (S, n, n, B), rhs (S, n, B) or (S, n, m, B).
    Jacobi-equilibrated (the system with s K s, s = 1 / sqrt(|diag K| +
    tiny)), on the unrolled small Cholesky; NaNs on a failed factor."""
    from fbstab_tpu_torch.ops.smallchol import (
        cholesky, solve_triangular_small)
    tiny = torch.finfo(K.dtype).tiny
    s = torch.rsqrt(torch.diagonal(K, dim1=1, dim2=2).abs() + tiny)  # (S,B,n)
    s = s.transpose(1, 2)                                           # (S,n,B)
    Keq = K * s[:, :, None, :] * s[:, None, :, :]
    vec = rhs.ndim == 3
    smat = s if vec else s[:, :, None, :]
    beq = rhs * smat
    L = cholesky(Keq.permute(0, 3, 1, 2))                           # (S,B,n,n)
    b = beq.permute(0, 2, 1) if vec else beq.permute(0, 3, 1, 2)
    t = solve_triangular_small(L, b, lower=True)
    x = solve_triangular_small(L.transpose(-1, -2), t, lower=False)
    x = x.permute(0, 2, 1) if vec else x.permute(0, 2, 3, 1)
    return x * smat


def combine_bl_plain(left: SpanElement, right: SpanElement) -> SpanElement:
    """The plain PyTorch version of K5 (`_combine_bl` of the JAX package):
    eliminates the boundary state shared by the left and right spans."""
    K = left.P22 + right.P11
    KiP12LT = psolve_bl(K, _T_bl(left.P12))
    KiP12R = psolve_bl(K, right.P12)
    Kiw = psolve_bl(K, left.p2 + right.p1)
    P11 = left.P11 - _mm_bl(left.P12, KiP12LT)
    P12 = -_mm_bl(left.P12, KiP12R)
    P22 = right.P22 - _mm_bl(_T_bl(right.P12), KiP12R)
    p1 = left.p1 - _mv_bl(left.P12, Kiw)
    p2 = right.p2 - _mv_bl(_T_bl(right.P12), Kiw)
    P11 = 0.5 * (P11 + _T_bl(P11))
    P22 = 0.5 * (P22 + _T_bl(P22))
    return SpanElement(P11, P12, P22, p1, p2)


def launch_combine(lib, left: SpanElement, right: SpanElement, stream: int
                   ) -> SpanElement:
    """Allocates the combined blocks and the scratch and launches K5 from
    `lib` on contiguous float32 spans of one shape."""
    from fbstab_tpu_torch.ops._build import check
    M, n, _, B = left.P11.shape
    dev = left.P11.device
    mat, vec = (M, n, n, B), (M, n, B)
    for name, t in (*zip(("l" + f for f in SpanElement._fields), left),
                    *zip(("r" + f for f in SpanElement._fields), right)):
        want = mat if t.ndim == 4 else vec
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != want):
            raise ValueError(f"{name}: K5 takes float32 {want} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ins = [t.contiguous() for t in (*left, *right)]
    out = SpanElement(*(torch.empty(s, dtype=torch.float32, device=dev)
                        for s in (mat, mat, mat, vec, vec)))
    ws = torch.empty(lib.fb_combine_ws_floats(n), M * B,
                     dtype=torch.float32, device=dev)
    err = lib.fb_assoc_combine(n, M, B, *[t.data_ptr() for t in ins],
                               *[t.data_ptr() for t in out], ws.data_ptr(),
                               stream)
    check(err, "assoc_combine")
    return out


def combine_bl(left: SpanElement, right: SpanElement) -> SpanElement:
    """One scan level: combines the M pairs (left[m], right[m]) of every
    instance. CPU tensors take the plain version; CUDA float32 tensors with
    n <= COMBINE_MAX_N launch K5."""
    x = left.P11
    if x.device.type == "cpu":
        return combine_bl_plain(left, right)
    if not x.is_cuda:
        raise ValueError(f"no combine kernel for device {x.device}")
    if x.shape[1] > COMBINE_MAX_N:
        raise ValueError(f"K5 takes n <= {COMBINE_MAX_N}, got n = "
                         f"{x.shape[1]}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    out = launch_combine(lib, left, right,
                         torch.cuda.current_stream(x.device).cuda_stream)
    combine_bl.launches += 1
    return out


combine_bl.launches = 0

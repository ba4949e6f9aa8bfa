"""The MPC refinement's double-float residual as a CUDA kernel
(csrc/refine_residual.cu on csrc/refine_residual.cuh).

One launch an evaluation computes, for every lane, the margin
y = -d - (E zx + L zu) as a double-float pair, the KKT blocks rzx, rzu, rl
and the penalized FB block rv rounded to float32 (the right-hand side of
the correction, which K1 reads), and the original-units penalized natural
residual norm. It replaces the eager composition of models/refine.py
(`_margin`, `_mpc_kkt_residual_df`, `_mpc_norms` and `df_to` of the
blocks), and y and the four blocks are bit for bit that
composition's: the same rounding operations in the same order. The norm
sums its squares in float64 (deterministic; within 1e-6 relative of
torch.sum's float32 order). It replaces no TPU kernel: the JAX package
leaves this residual to XLA.

The kernel reads every field of the data, the iterate pairs and the
scaling at the strides PyTorch holds them (an expanded plant, batch stride
0, or an index_select'ed sub-batch), so nothing is copied. The dispatch is
`models/refine.py::mpc_residual_df`: CUDA float32 tensors launch the
kernel (`refine_residual`), every other tensor takes the plain version,
the composition itself (`mpc_residual_df_plain` there); nothing falls
back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fbstab_tpu_torch import telemetry


class Field(ctypes.Structure):
    """Mirror of `struct RrField`: element (b, i, m, k) of a field at
    p[b sb + i ss + m sm + k sk] (floats)."""

    _fields_ = [("p", ctypes.c_void_p)] + [
        (n, ctypes.c_longlong) for n in ("sb", "ss", "sm", "sk")]


class ResidualArgs(ctypes.Structure):
    """Mirror of `struct RrArgs` in csrc/refine_residual.cuh (field order
    and types must match)."""

    _fields_ = [(n, Field) for n in (
        "Q", "R", "S", "A", "B", "E", "L", "q", "r", "c", "d", "x0",
        "zx", "zx_lo", "zu", "zu_lo", "l", "l_lo", "v", "v_lo",
        "dx", "du", "de", "kc")] + [
        (n, ctypes.c_void_p) for n in (
            "y", "y_lo", "rzx", "rzu", "rl", "rv", "res")] + [
        (n, ctypes.c_float) for n in ("alpha", "om_alpha")]


def field(t: torch.Tensor | None) -> Field:
    """A (B, stages, m, k), (B, stages, m), (B, m) or (B,) tensor as the
    kernel reads it (None: a null field)."""
    if t is None:
        return Field(None, 0, 0, 0, 0)
    st = {4: lambda s: s, 3: lambda s: s + (0,),
          2: lambda s: (s[0], 0, s[1], 0),
          1: lambda s: (s[0], 0, 0, 0)}[t.dim()](tuple(t.stride()))
    return Field(t.data_ptr(), *st)


def residual_outputs(B, dims, device, blocks: bool):
    """The launch's outputs: (y pair, (rzx, rzu, rl, rv), res), the pair
    and blocks None without `blocks`."""
    N, nx, nu, nc = dims
    f32 = dict(dtype=torch.float32, device=device)
    res = torch.empty(B, **f32)
    if not blocks:
        return None, None, res
    stages = lambda n: torch.empty(B, N + 1, n, **f32)
    return ((stages(nc), stages(nc)),
            (stages(nx), stages(nu), stages(nx), stages(nc)), res)


def residual_args(data, zx, zu, l, v, alpha, scal, outs):
    """The kernel's ResidualArgs for these inputs and outputs (the
    tensors must outlive the launch). The weights are rounded to float32
    as the plain composition rounds them: alpha, and the FB block's
    1 - alpha rounded once (the norm's 1 - alpha, `_mpc_norms`' 1 minus
    the rounded alpha, the kernel takes itself)."""
    y, rhs, res = outs
    none = (None,) * 6 if y is None else (*y, *rhs)
    sc = (None,) * 4 if scal is None else (scal.dx, scal.du, scal.de,
                                           scal.kc)
    return ResidualArgs(
        *[field(t) for t in (
            data.Q, data.R, data.S, data.A, data.B, data.E, data.L, data.q,
            data.r, data.c, data.d, data.x0, *zx, *zu, *l, *v, *sc)],
        *[None if t is None else t.data_ptr() for t in (*none, res)],
        float(np.float32(alpha)), float(np.float32(1.0 - alpha)))


def _check(dims, B, data, pairs, scal, device):
    N, nx, nu, nc = dims
    N1 = N + 1
    want = dict(Q=(N1, nx, nx), R=(N1, nu, nu), S=(N1, nu, nx),
                A=(N, nx, nx), B=(N, nx, nu), E=(N1, nc, nx),
                L=(N1, nc, nu), q=(N1, nx), r=(N1, nu), c=(N, nx),
                d=(N1, nc), x0=(nx,))
    named = {f"data.{k}": (getattr(data, k), s) for k, s in want.items()}
    for name, (p, n) in pairs.items():
        named[f"{name}[0]"] = (p[0], (N1, n))
        named[f"{name}[1]"] = (p[1], (N1, n))
    if scal is not None:
        named.update({"scal.dx": (scal.dx, (N1, nx)),
                      "scal.du": (scal.du, (N1, nu)),
                      "scal.de": (scal.de, (N1, nc)),
                      "scal.kc": (scal.kc, ())})
    for name, (t, shape) in named.items():
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name}: the CUDA kernel takes float32 on "
                             f"{device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (B,) + shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B,) + shape}")


def launch_refine_residual(lib, data, zx, zu, l, v, alpha: float, scal,
                           blocks: bool, stream: int | None):
    """Checks the inputs, allocates the outputs and launches the kernel
    from `lib` (the card's library on `stream`, or the CPU replay's with
    stream None). Returns (y, (rzx, rzu, rl, rv), res); y and the blocks
    None without `blocks`."""
    N, nx, nu, nc = dims = (data.A.shape[-3], data.A.shape[-1],
                            data.B.shape[-1], data.E.shape[-2])
    B = zx[0].shape[0]
    dev = zx[0].device
    _check(dims, B, data, dict(zx=(zx, nx), zu=(zu, nu), l=(l, nx),
                               v=(v, nc)), scal, dev)
    outs = residual_outputs(B, dims, dev, blocks)
    if B == 0:
        return outs
    from fbstab_tpu_torch.ops._build import check
    err = lib.fb_refine_residual(
        N, nx, nu, nc, B,
        residual_args(data, zx, zu, l, v, alpha, scal, outs), stream)
    check(err, "refine_residual")
    return outs


def refine_residual(data, zx, zu, l, v, alpha: float, scal=None,
                    blocks: bool = True):
    """The residual of a batch of CUDA float32 lanes in one launch:
    data: MpcQPData (batch-first, any strides); zx, zu, l, v: (hi, lo)
    pairs of (B, N+1, n) tensors; scal: an MpcScaling whose units the norm
    is taken in (None: the data's). Returns (y, (rzx, rzu, rl, rv),
    res) as the plain version does; without `blocks` only res (y and the
    blocks None). Counts its launches as `launch.refine_residual`
    (telemetry.counters())."""
    dev = zx[0].device
    if not zx[0].is_cuda:
        raise ValueError(f"no refinement-residual kernel for device {dev}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = launch_refine_residual(lib, data, zx, zu, l, v, alpha, scal,
                                  blocks, stream)
    telemetry.count("launch.refine_residual")
    return outs

"""K1, the batched MPC Newton step, as a CUDA kernel (csrc/riccati.cu).

Counterpart of `fbstab_tpu/ops/riccati_pallas.py::riccati_newton_step_batched`
in both its modes: `lowmem=True` launches the recompute-factors kernel,
which keeps only the carried Riccati factors and recomputes each stage's
in the vector passes, bit for bit the storing kernel's step (the JAX
package's lowmem launch, riccati_pallas.py:539). The plain version does
not depend on the mode. One launch runs, for every instance of the
batch, the PFB weights, the barrier-augmented stage Hessians, the forward
Riccati matrix recursion, the forward vector recursion and the backward
substitution, giving (dz, dl); the dual recovery (dv, dy) is a wide
elementwise pass done here in PyTorch, as the JAX wrapper leaves it to
XLA. The kernel runs a team of threads per instance on the batch-first
(instance-major) tensors as torch holds them.

`riccati_newton_step_batched` takes the plain version
(`riccati_newton_step_plain`, the Python stage loop of models/mpc_qp.py)
only for tensors on the CPU. For CUDA tensors it launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch import telemetry
from fbstab_tpu_torch.ops.pfb import pfb_weights


def riccati_newton_step_plain(data, v, y, vbar, rz, rl, rv, sigma, alpha):
    """The plain PyTorch version of K1: returns (dz, dl, dv, dy)."""
    from fbstab_tpu_torch.models.mpc_qp import _fused_step_impl
    dz, dl, dv, dy, _ = _fused_step_impl(data, v, y, vbar, rz, rl, rv,
                                         sigma, alpha)
    return dz, dl, dv, dy


def _check_f32(device, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(
                f"{name}: the CUDA kernel takes float32 on {device}, got "
                f"{t.dtype} on {t.device}")


def check_batch(B, data):
    """Every array of `data` holds B instances."""
    for name, a in data._asdict().items():
        if a.shape[0] != B:
            raise ValueError(f"data.{name} has {a.shape[0]} instances, the "
                             f"iterates {B}")


def launch_riccati_step(lib, data, v, y, vbar, rz, rl, rv, sigma,
                        alpha: float, stream: int, lowmem: bool = False):
    """Allocates outputs and scratch and launches K1 from `lib` on the
    batch-first inputs (contiguous, as the kernel reads them), in the
    storing or (lowmem) the recompute-factors mode. Returns batch-first
    (dz, dl). Raises KernelResourceError where the card cannot give the
    scratch."""
    N, nx, nu, nc = (data.A.shape[-3], data.A.shape[-1], data.B.shape[-1],
                     data.E.shape[-2])
    B = v.shape[0]
    N1, ns = N + 1, nx + nu
    dev = v.device
    _check_f32(dev, Q=data.Q, R=data.R, S=data.S, A=data.A, B=data.B,
               E=data.E, L=data.L, v=v, y=y, vbar=vbar, rz=rz, rl=rl, rv=rv)
    shapes = dict(v=(v, N1 * nc), y=(y, N1 * nc), vbar=(vbar, N1 * nc),
                  rz=(rz, N1 * ns), rl=(rl, N1 * nx), rv=(rv, N1 * nc))
    for name, (t, n) in shapes.items():
        if tuple(t.shape) != (B, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(B, n)}")
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    sig = sig.reshape(-1).expand(B).contiguous()
    check_batch(B, data)
    from fbstab_tpu_torch.ops._build import check, check_scratch
    wsf = lib.fb_riccati_ws_floats(N, nx, nu, nc, int(lowmem))
    check_scratch("riccati_newton_step", B, wsf, dev)
    ins = [a.contiguous() for a in (
        data.Q, data.R, data.S, data.A, data.B, data.E, data.L,
        v, y, vbar, rz, rl, rv)]
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty(B, N1 * ns, **f32)
    dl = torch.empty(B, N1 * nx, **f32)
    ws = torch.empty(B, wsf, **f32)
    err = lib.fb_riccati_step(
        N, nx, nu, nc, B, int(lowmem), float(alpha), 1.0 - float(alpha),
        sig.data_ptr(), *[a.data_ptr() for a in ins], dz.data_ptr(),
        dl.data_ptr(), ws.data_ptr(), stream)
    check(err, "riccati_newton_step")
    return dz, dl


def riccati_newton_step_batched(data, v, y, vbar, rz, rl, rv, sigma,
                                alpha: float, lowmem: bool = False):
    """Batched Newton step. data: MpcQPData (batch-first); v, y, vbar:
    (B, nv); rz, rl, rv: (B, nz / nl / nv), the NEGATED inner residual;
    sigma: a scalar or per-lane (B,). Returns batch-first (dz, dl, dv, dy).
    CPU tensors take the plain version; CUDA float32 tensors launch K1, in
    the recompute-factors mode with `lowmem` (the JAX signature's; the
    solvers' dispatch picks it with models.mpc_qp.riccati_mode). Counts
    the storing kernel's launches as `launch.k1`, the recompute-factors
    kernel's as `launch.k1_lowmem` (telemetry.counters())."""
    if v.device.type == "cpu":
        return riccati_newton_step_plain(data, v, y, vbar, rz, rl, rv,
                                         sigma, alpha)
    if not v.is_cuda:
        raise ValueError(f"no Newton-step kernel for device {v.device}")
    from fbstab_tpu_torch.ops._build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    dz, dl = launch_riccati_step(lib, data, v, y, vbar, rz, rl, rv, sigma,
                                 alpha, stream, lowmem)
    telemetry.count("launch.k1_lowmem" if lowmem else "launch.k1")

    # Dual recovery (riccati_linear_solver.cc:329-342).
    B = v.shape[0]
    N1, nx, nu, nc = (data.E.shape[1], data.A.shape[-1], data.B.shape[-1],
                      data.E.shape[-2])
    sig = torch.as_tensor(sigma, dtype=v.dtype, device=v.device)
    sig_col = sig[:, None] if sig.ndim else sig
    gamma, mus, _ = pfb_weights(y, v, vbar, sig_col, alpha)
    dzs = dz.reshape(B, N1, nx + nu)
    Adz = (torch.matmul(data.E, dzs[..., :nx, None])
           + torch.matmul(data.L, dzs[..., nx:, None])).reshape(B, N1 * nc)
    dv = (rv + gamma * Adz) / mus
    dy = -data.d.reshape(B, N1 * nc) - Adz
    return dz, dl, dv, dy


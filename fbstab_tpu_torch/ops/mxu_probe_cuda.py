"""P1, the stage-matvec probe, as CUDA kernels (csrc/mxu_probe.cu).

Counterpart of the three Pallas kernels of bench.py's `run_mxu`
(bench.py:953-998; the same probe in scratch/tpu_mxu.py:104): T
applications of w_s <- scale * M_s w_s to every stage vector of every lane,
with per-lane M (N1, n, n, B) or one shared M (N1, n, n), w (N1 * n, B).
On the card:

  cuda_perlane  per-lane M on the CUDA cores (the TPU's vpu_perlane);
  cuda_shared   shared M on the CUDA cores (vpu_shared);
  tc_shared     shared M on the TF32 tensor cores, a warp per stage and
                16 lanes with w in registers for all T (mxu_shared).

Each wrapper takes its plain version (the same recurrence as `einsum` /
`bmm`) only for tensors on the CPU; for CUDA tensors it launches its kernel
or raises. `probe_inputs` draws the reference probe's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from fbstab_tpu_torch import telemetry

# bench.py's probe: the copolymerization reactor's stage size over its
# horizon (N = 80), one 128-lane tile, 200 applications.
N1, N_STAGE, LANES, T_DEFAULT = 81, 18, 128, 200


# Tolerances against the float32 plain version, relative to its largest
# entry. The CUDA-core forms do the plain version's float32 arithmetic in
# another order: a few ulps of an 18-term sum.
CUDA_CORE_TOL = 1e-5


def tc_tol(T, n, gap):
    """tc_shared's tolerance after T applications: TF32 keeps 10 mantissa
    bits (unit roundoff 2^-11), and rounding both factors of an n-term
    product moves an entry by up to 2 * 2^-11 * sum_j |M_ij w_j|, about
    2^-10 sqrt(n) of the largest entry on Gaussian inputs; T applications
    add up to T of those. `gap` is the plain version's float32-vs-float64
    relative gap, added with a margin of 10. A wrong fragment layout moves
    entries by O(1)."""
    return T * 2.0 ** -10 * float(np.sqrt(n)) + 10 * gap


def scale_of(n):
    """The probe's contraction factor (bench.py: SCALE = 0.9 / n)."""
    return 0.9 / n


def probe_inputs(N1=N1, n=N_STAGE, B=LANES, device=None,
                 dtype=torch.float32):
    """(Mp, Ms, w0): the reference's inputs, drawn in its order from
    `np.random.default_rng(0)`: per-lane M (N1, n, n, B), shared M
    (N1, n, n) and w0 (N1 * n, B)."""
    from fbstab_tpu_torch.device import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    draw = lambda *shape: torch.tensor(rng.standard_normal(shape),
                                       dtype=dtype, device=device)
    Mp = draw(N1, n, n, B)
    Ms = draw(N1, n, n)
    w0 = draw(N1 * n, B)
    return Mp, Ms, w0


def perlane_plain(M, w, T, scale):
    """T applications with per-lane M (N1, n, n, B), as einsums."""
    N1_, n = M.shape[0], M.shape[1]
    w = w.reshape(N1_, n, -1)
    for _ in range(T):
        w = torch.einsum("sijb,sjb->sib", M, w) * scale
    return w.reshape(N1_ * n, -1)


def shared_plain(M, w, T, scale):
    """T applications with shared M (N1, n, n), as batched products."""
    N1_, n = M.shape[0], M.shape[1]
    w = w.reshape(N1_, n, -1)
    for _ in range(T):
        w = torch.bmm(M, w) * scale
    return w.reshape(N1_ * n, -1)


def _launch(form, M, w0, T, scale):
    N1_, n, B = M.shape[0], M.shape[1], w0.shape[1]
    want = (N1_, n, n, B) if form == 0 else (N1_, n, n)
    if tuple(M.shape) != want or tuple(w0.shape) != (N1_ * n, B):
        raise ValueError(f"M {tuple(M.shape)} and w {tuple(w0.shape)}: "
                         f"expected M {want} and w {(N1_ * n, B)}")
    for name, t in (("M", M), ("w", w0)):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name}: the probe kernels take float32 on the "
                             f"card, got {t.dtype} on {t.device}")
    from fbstab_tpu_torch.ops._build import check, load_library
    lib = load_library()
    if n > lib.fb_mxu_max_n():
        raise ValueError(f"n = {n}: the probe kernels take n <= "
                         f"{lib.fb_mxu_max_n()}")
    M, w0 = M.contiguous(), w0.contiguous()
    w = torch.empty_like(w0)
    stream = torch.cuda.current_stream(w0.device).cuda_stream
    check(lib.fb_mxu_probe(form, N1_, n, B, int(T), float(scale),
                           M.data_ptr(), w0.data_ptr(), w.data_ptr(),
                           stream), "mxu_probe")
    return w


def cuda_perlane(M, w0, T, scale):
    """Per-lane stage matvecs: the kernel on the CUDA cores."""
    if w0.device.type == "cpu":
        return perlane_plain(M, w0, T, scale)
    w = _launch(0, M, w0, T, scale)
    telemetry.count("launch.mxu_perlane")
    return w


def cuda_shared(M, w0, T, scale):
    """Shared-M stage matvecs: the kernel on the CUDA cores."""
    if w0.device.type == "cpu":
        return shared_plain(M, w0, T, scale)
    w = _launch(1, M, w0, T, scale)
    telemetry.count("launch.mxu_shared")
    return w


def tc_shared(M, w0, T, scale):
    """Shared-M stage matvecs: the kernel on the TF32 tensor cores (each
    application rounds M and w to TF32, 10 mantissa bits, and accumulates
    in float32)."""
    if w0.device.type == "cpu":
        return shared_plain(M, w0, T, scale)
    w = _launch(2, M, w0, T, scale)
    telemetry.count("launch.mxu_tc")
    return w


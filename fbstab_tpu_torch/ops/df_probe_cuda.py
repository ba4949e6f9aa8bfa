"""P3, the double-float probe, as a CUDA kernel (csrc/df_probe.cu on the
transforms of csrc/doublefloat.cuh).

Counterpart of scratch/tpu_df_kernel.py: on a and b of shape (R, C) it
computes two_sum (s, e) and two_prod (p, pe) elementwise and the
compensated dot product down axis 0, (1, C) hi and lo. The question it
answers: do the error-free transforms stay exact in device code built with
the library's flags, so that the double-float refinement could be fused
into a kernel?

`df_probe` takes its plain version (`df_probe_plain`, the transforms of
ops/doublefloat.py in eager PyTorch, every operation its own kernel) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from fbstab_tpu_torch import telemetry
from fbstab_tpu_torch.ops.doublefloat import two_prod, two_sum

R, C = 8, 128


def probe_inputs(device=None):
    """The reference probe's a and b (seed 0): float32 Gaussians scaled by
    powers of two from 2^-15 to 2^14, magnitudes spread up to 2^30."""
    from fbstab_tpu_torch.device import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((R, C))
         * np.exp2(rng.integers(-15, 15, (R, C)))).astype(np.float32)
    b = (rng.standard_normal((R, C))
         * np.exp2(rng.integers(-15, 15, (R, C)))).astype(np.float32)
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


def df_probe_plain(a, b):
    """(s, e, p, pe, dh, dl) by ops/doublefloat.py's transforms."""
    s, e = two_sum(a, b)
    p, pe = two_prod(a, b)
    hi = torch.zeros_like(a[0:1])
    lo = torch.zeros_like(a[0:1])
    for i in range(a.shape[0]):
        ph, pl = two_prod(a[i:i + 1], b[i:i + 1])
        hi, e1 = two_sum(hi, ph)
        lo = lo + (e1 + pl)
        hi, e2 = two_sum(hi, lo)
        lo = e2
    return s, e, p, pe, hi, lo


def df_probe_outputs(a):
    """(s, e, p, pe, dh, dl) for `a`'s shape (R, C): row blocks of one
    (4 R + 2, C) buffer on a's device, each contiguous; two calls into
    PyTorch in place of six allocations."""
    rows, cols = a.shape
    buf = torch.empty(4 * rows + 2, cols, dtype=a.dtype, device=a.device)
    return buf.split([rows] * 4 + [1, 1])


def launch_df_probe(lib, a, b, out=None):
    """Launches fb_df_probe from `lib` on float32 (R, C) CUDA tensors, into
    `out` (df_probe_outputs(a), made here unless given)."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or not t.is_cuda or t.ndim != 2:
            raise ValueError(f"{name}: the probe takes a float32 matrix on "
                             f"the card, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    a, b = a.contiguous(), b.contiguous()
    rows, cols = a.shape
    if out is None:
        out = df_probe_outputs(a)
    from fbstab_tpu_torch.ops._build import check
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(lib.fb_df_probe(rows, cols, a.data_ptr(), b.data_ptr(),
                          *[o.data_ptr() for o in out], stream), "df_probe")
    return out


def df_probe(a, b):
    """The probe: (s, e, p, pe, dh, dl). CPU tensors take the plain
    version; CUDA float32 tensors launch the kernel."""
    if a.device.type == "cpu":
        return df_probe_plain(a, b)
    from fbstab_tpu_torch.ops._build import load_library
    out = launch_df_probe(load_library(), a, b)
    telemetry.count("launch.df_probe")
    return out



def exactness(a, b, out):
    """The reference's verdict on (s, e, p, pe, dh, dl), against float64:
    two_sum exact (s + e == a + b everywhere), two_prod exact
    (p + pe == a b everywhere), and the dot's relative error beside plain
    float32's."""
    a64, b64 = (t.double().cpu().numpy() for t in (a, b))
    s, e, p, pe, dh, dl = (t.double().cpu().numpy() for t in out)
    dot64 = (a64 * b64).sum(0)
    den = np.maximum(np.abs(dot64), 1e-30)
    f32 = (a.cpu().numpy() * b.cpu().numpy()).sum(0, dtype=np.float32)
    return dict(
        two_sum_exact=bool(np.all(s + e == a64 + b64)),
        two_prod_exact=bool(np.all(p + pe == a64 * b64)),
        dot_rel_err=float(np.max(np.abs(dh[0] + dl[0] - dot64) / den)),
        f32_dot_rel_err=float(np.max(np.abs(f32.astype(np.float64) - dot64)
                                     / den)))


# ------------------------------------------------------------------
# The contraction question: the same kernel with plain operators.
# ------------------------------------------------------------------

def plain_ops_library():
    """(library, path): csrc/df_probe.cu built with the library's flags
    but the plain operators (FB_DF_PLAIN_OPS), bound for launch_df_probe."""
    import ctypes

    from fbstab_tpu_torch.ops._build import bind_df_probe, build_variant
    path = build_variant("df_probe.cu", ("FB_DF_PLAIN_OPS",))
    return bind_df_probe(ctypes.CDLL(str(path))), path


def sass_ffma_count(lib_path, kernel="df_probe_kernel"):
    """FFMA instructions in the SASS of `kernel` inside the shared library
    at `lib_path` (cuobjdump -sass), or None where cuobjdump is missing."""
    from fbstab_tpu_torch.ops._build import sass_blocks
    mine = sass_blocks(lib_path, kernel)
    if mine is None:
        return None
    return sum(len(re.findall(r"\bFFMA\b", blk)) for blk in mine)

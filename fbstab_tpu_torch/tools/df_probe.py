"""Do the double-float transforms stay exact in the port's device code?

    python3 -m fbstab_tpu_torch.tools.df_probe

The counterpart of scratch/tpu_df_kernel.py's check, on the card: the P3
kernel (csrc/df_probe.cu, built with the library's flags) computes
two_sum, two_prod and a compensated dot product on the reference probe's
inputs (a, b of shape (8, 128), seed 0, magnitudes spread up to 2^30), and
the result is held against float64. Prints the reference's line and exits
1 unless both transforms are exact on every element. Without a CUDA
device it fails.
"""

from __future__ import annotations

import sys

import torch


def probe(device=None):
    """Runs P3 on `device` (the card unless given "cpu") and returns the
    verdict of ops.df_probe_cuda.exactness."""
    from fbstab_tpu_torch.ops.df_probe_cuda import (
        df_probe, exactness, probe_inputs)
    a, b = probe_inputs(device)
    return exactness(a, b, df_probe(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("df_probe: no CUDA device: the kernel runs only on the card",
              file=sys.stderr)
        return 1
    v = probe()
    print(f"[cuda] two_sum exact: {v['two_sum_exact']}  two_prod exact: "
          f"{v['two_prod_exact']}  dot df rel err: {v['dot_rel_err']:.2e} "
          f"(plain f32: {v['f32_dot_rel_err']:.2e})", flush=True)
    return 0 if v["two_sum_exact"] and v["two_prod_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())

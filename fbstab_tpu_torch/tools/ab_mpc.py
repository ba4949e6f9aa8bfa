"""Times K2 and the one-shot MPC path of given source trees on one GPU.

    python3 fbstab_tpu_torch/tools/ab_mpc.py TREE [TREE ...]

For each tree, in the order given, a fresh process imports
fbstab_tpu_torch from TREE (building its kernels there; the tree must hold
fbstab_tpu_torch/workloads.py) and prints one
JSON line: K2's mean time on the equilibrated headline batch at B = 1024
(CUDA events, three launches after a warm one) and the one-shot
solve_mpc_qp_batch(..., Options.single_precision()) QPs/s at B = 8192
(best of three calls after a warm one), with K2's registers and spill
bytes from the tree's build log. Pass a checkout of the parent and of the
change as A B B A to compare them in turns on one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def measure(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops import _build
    from fbstab_tpu_torch.ops.mpc_solve_cuda import fbstab_mpc_solve_fused
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.workloads import (
        HEADLINE, build_batch, cuda_ms, timed, zeros_guess)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    opts = Options.single_precision()

    data = build_batch(1024, **HEADLINE, device=dev)
    data = apply_mpc_scaling(data, ruiz_mpc_scaling(data))
    guess = zeros_guess(data)
    k2_ms = cuda_ms(lambda: fbstab_mpc_solve_fused(data, *guess, opts), 3)
    data = build_batch(8192, **HEADLINE, device=dev)
    guess = zeros_guess(data)
    times = [timed(lambda: solve_mpc_qp_batch(data, *guess, opts))[1]
             for _ in range(4)][1:]
    log = _build.library_path().with_suffix(".log").read_text()
    k2_log = log.split("== mpc_solve.cu")[-1].split("==")[0] if (
        "== mpc_solve.cu" in log) else log
    ptxas = [ln.strip() for ln in k2_log.splitlines()
             if "registers" in ln or "spill" in ln]
    return dict(tree=tree, k2_ms=k2_ms, main_qps=8192e3 / min(times),
                main_ms=times, k2_ptxas=ptxas)


def main():
    if sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()

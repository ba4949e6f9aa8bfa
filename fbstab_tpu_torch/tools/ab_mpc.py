"""Times K2, K4 and the one-shot MPC path of given source trees on one GPU.

    python3 fbstab_tpu_torch/tools/ab_mpc.py TREE [TREE ...]

For each tree, in the order given, a fresh process imports
fbstab_tpu_torch from TREE (building its kernels there; the tree must hold
fbstab_tpu_torch/workloads.py) and prints one JSON line: K2's mean time on
the equilibrated headline batch at B = 1024 (CUDA events, three launches
after a warm one), the one-shot solve_mpc_qp_batch(...,
Options.single_precision()) QPs/s at B = 8192 (best of three calls after a
warm one), the subfused copoly solve on K4 at B = 256 (equilibrated; CUDA
events, one call after a warm one, as chip_smoke.py times it), the copoly
path solve_mpc_qp_batch(..., Options.single_precision()) QPs/s at
B = 2048 through K4 (best of two calls after a warm one), and K2's and
K4's registers and spill bytes from the tree's build log. Pass a
checkout of the parent and of the change as A B B A to compare them in
turns on one card.
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
    from fbstab_tpu_torch.models.mpc_subfused import (
        fbstab_mpc_solve_subfused)
    from fbstab_tpu_torch.models.scaling import (
        apply_mpc_scaling, ruiz_mpc_scaling)
    from fbstab_tpu_torch.ops import _build
    from fbstab_tpu_torch.ops.mpc_solve_cuda import fbstab_mpc_solve_fused
    from fbstab_tpu_torch.options import Options
    from fbstab_tpu_torch.workloads import (
        HEADLINE, build_batch, build_copoly, cuda_ms, timed, zeros_guess)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    opts = Options.single_precision()
    equilibrated = lambda d: apply_mpc_scaling(d, ruiz_mpc_scaling(d))

    data = equilibrated(build_batch(1024, **HEADLINE, device=dev))
    guess = zeros_guess(data)
    k2_ms = cuda_ms(lambda: fbstab_mpc_solve_fused(data, *guess, opts), 3)
    data = build_batch(8192, **HEADLINE, device=dev)
    guess = zeros_guess(data)
    times = [timed(lambda: solve_mpc_qp_batch(data, *guess, opts))[1]
             for _ in range(4)][1:]
    data = equilibrated(build_copoly(256, dev))
    guess = zeros_guess(data)
    k4_ms = cuda_ms(lambda: fbstab_mpc_solve_subfused(data, *guess, opts), 1)
    data = build_copoly(2048, dev)
    guess = zeros_guess(data)
    copoly = [timed(lambda: solve_mpc_qp_batch(data, *guess, opts))[1]
              for _ in range(3)][1:]
    return dict(tree=tree, k2_ms=k2_ms, main_qps=8192e3 / min(times),
                main_ms=times, k4_ms=k4_ms,
                copoly_qps=2048e3 / min(copoly), copoly_ms=copoly,
                log=str(_build.library_path().with_suffix(".log")))


def main():
    if sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from fbstab_tpu_torch.ops._build import ptxas_lines

    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr)
            sys.exit(proc.returncode)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        log = Path(row.pop("log")).read_text()
        row.update(k2_ptxas=ptxas_lines("mpc_solve.cu", log),
                   k4_ptxas=ptxas_lines("mpc_subproblem.cu", log))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

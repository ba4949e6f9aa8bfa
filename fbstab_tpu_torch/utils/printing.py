"""Solver logging (counterpart of `fbstab_tpu/utils/printing.py`).

The reference routes all printing through a replaceable OutputStream
(tools/output_stream.h:15-38) so that embedders can redirect solver logs.
Here the lockstep core prints its Display.ITER / ITER_DETAILED tables
through one (core/algorithm.py), and the facades print the FINAL summary
through one. Nothing prints unless Options.display_level asks for it, so
a solve without display makes no extra host sync.
"""

from __future__ import annotations

import sys

import torch

from fbstab_tpu_torch.options import Display, Options
from fbstab_tpu_torch.solver_out import ExitFlag, SolverOut

_EFLAG_NAMES = {
    ExitFlag.SUCCESS: "Success",
    ExitFlag.DIVERGENCE: "Divergence",
    ExitFlag.MAXITERATIONS: "Iteration limit exceeded",
    ExitFlag.PRIMAL_INFEASIBLE: "Primal Infeasibility",
    ExitFlag.DUAL_INFEASIBLE: "Dual Infeasibility",
    ExitFlag.PRIMAL_DUAL_INFEASIBLE: "Primal-Dual Infeasibility",
    ExitFlag.LINEAR_SOLVER_FAILED: "Linear solver failure",
}


class OutputStream:
    """Replaceable print sink (reference: tools/output_stream.h)."""

    def print(self, msg: str) -> None:
        sys.stdout.write(msg)


class NullStream(OutputStream):
    def print(self, msg: str) -> None:
        pass


def _num(a):
    """A Python number from a tensor of one element or a number."""
    return a.item() if isinstance(a, torch.Tensor) else a


def print_final(out: SolverOut, options: Options,
                stream: OutputStream | None = None,
                block_norms=None, combo_tol: float | None = None) -> None:
    """Final summary (reference: FBstabAlgorithm::PrintFinal,
    fbstab_algorithm-impl.h:491-541). Batched output (an eflag with a
    batch axis) goes to `print_batch_final`.

    block_norms: optional (|rz|, |rl|, |rv|) of the penalized natural
    residual at the returned point, for the reference's closing table.
    """
    if options.display_level < Display.FINAL:
        return
    stream = stream or OutputStream()
    if isinstance(out.eflag, torch.Tensor) and out.eflag.ndim > 0:
        print_batch_final(out, options, stream)
        return
    name = _EFLAG_NAMES.get(ExitFlag(int(_num(out.eflag))), "Unknown")
    stream.print("\nOptimization completed!  Exit code: %s\n" % name)
    stream.print(
        "Time elapsed: %f ms (-1.0 indicates timing disabled)\n"
        % (1000.0 * float(_num(out.solve_time))))
    stream.print("Proximal iterations: %d out of %d\n"
                 % (int(_num(out.prox_iters)), options.max_prox_iters))
    stream.print("Newton iterations: %d out of %d\n"
                 % (int(_num(out.newton_iters)), options.max_newton_iters))
    if block_norms is not None:
        # Closing |rz| |rl| |rv| table (impl.h:529-537); combo_tol
        # defaults to abs_tol when the forcing-norm term is not given.
        tol = combo_tol if combo_tol is not None else options.abs_tol
        bz, bl, bv = (float(_num(v)) for v in block_norms)
        stream.print("%10s  %10s  %10s  %10s\n"
                     % ("|rz|", "|rl|", "|rv|", "Tolerance"))
        stream.print("%10.4e  %10.4e  %10.4e  %10.4e\n" % (bz, bl, bv, tol))
    else:
        stream.print("Residual: %10.4e\n" % float(_num(out.residual)))
    stream.print("\n")


def print_batch_final(out, options: Options,
                      stream: OutputStream | None = None) -> None:
    """Batched-solve closing summary: the reference's PrintFinal has no
    batch analog, so Display.FINAL on a batched solve prints the
    BatchStats reduction (parallel/sharded.py) instead."""
    if options.display_level < Display.FINAL:
        return
    stream = stream or OutputStream()
    from fbstab_tpu_torch.parallel.sharded import batch_stats

    s = batch_stats(out)
    stream.print("\nBatch optimization completed!  %d instances\n"
                 % int(_num(s.num_instances)))
    stream.print(
        "  success: %d   infeasible: %d   failed: %d\n"
        % (int(_num(s.num_success)), int(_num(s.num_infeasible)),
           int(_num(s.num_failed))))
    stream.print(
        "  residual max: %10.4e   mean: %10.4e\n"
        % (float(_num(s.max_residual)), float(_num(s.mean_residual))))
    stream.print(
        "  newton iters total: %d   max: %d\n\n"
        % (int(_num(s.total_newton_iters)), int(_num(s.max_newton_iters))))

"""Solver options for the PyTorch port.

The same 24 fields, defaults, profiles and saturation rules as
`fbstab_tpu/options.py` (which mirrors the reference's
fbstab_algorithm.h:48-82 and fbstab_algorithm-impl.h:7-74). Options are a
frozen dataclass of Python scalars; the solvers read them on the host.
"""

from __future__ import annotations

import dataclasses
import enum


class Display(enum.IntEnum):
    """Verbosity levels (reference: fbstab_algorithm.h:40-45)."""

    OFF = 0
    FINAL = 1
    ITER = 2
    ITER_DETAILED = 3


def _saturate(x: float, lo: float, hi: float) -> float:
    """Clamp x into [lo, hi] (reference: tools/utilities.h saturate)."""
    return min(max(x, lo), hi)


@dataclasses.dataclass(frozen=True)
class Options:
    """Algorithm parameters; field-for-field `fbstab_tpu.Options`."""

    sigma0: float = 1e-8
    sigma_max: float = 1e-6
    sigma_min: float = 1e-12
    alpha: float = 0.95
    beta: float = 0.75
    eta: float = 1e-8
    delta: float = 0.2
    gamma: float = 0.1

    abs_tol: float = 1e-6
    rel_tol: float = 1e-12
    stall_tol: float = 1e-10
    infeas_tol: float = 1e-8

    inner_tol_max: float = 1e-2
    inner_tol_min: float = 1e-12

    max_newton_iters: int = 200
    max_prox_iters: int = 30
    max_inner_iters: int = 50
    max_linesearch_iters: int = 20

    check_feasibility: bool = True
    nonmonotone_linesearch: bool = True
    display_level: Display = Display.OFF

    # Exit the inner Newton loop after 3 consecutive iterations without a
    # relative residual improvement of at least this factor (0 disables).
    inner_stall_tol: float = 0.0
    # Maximum mixed-precision refinement steps for f32 solves
    # (models/refine.py); the loop exits early at refine_target.
    refine_steps: int = 0
    refine_target: float = 1e-6
    # Proximal sigma of the refinement corrections; 0.0 means sigma0.
    refine_sigma: float = 0.0
    # Re-solve LINEAR_SOLVER_FAILED lanes with a 4x sigma (f32 batches).
    retry_failed: bool = False
    # Ruiz equilibration before f32 solves (models/scaling.py).
    equilibrate: bool = False

    def validated(self) -> "Options":
        """Copy with every field saturated into its safe range
        (reference: AlgorithmParameters::ValidateOptions)."""
        sigma0 = max(self.sigma0, 1e-10)
        sigma_max = _saturate(self.sigma_max, 1e-6, 1e2)
        sigma_min = _saturate(self.sigma_min, 1e-13, 1e-8)
        sigma0 = _saturate(sigma0, sigma_min, sigma_max)
        return dataclasses.replace(
            self,
            sigma0=sigma0,
            sigma_max=sigma_max,
            sigma_min=sigma_min,
            alpha=_saturate(self.alpha, 0.001, 0.999),
            beta=_saturate(self.beta, 0.1, 0.99),
            eta=_saturate(self.eta, 1e-12, 0.499),
            delta=_saturate(self.delta, 0.0001, 0.99),
            gamma=_saturate(self.gamma, 0.001, 0.9),
            abs_tol=max(self.abs_tol, 1e-14),
            rel_tol=max(self.rel_tol, 0.0),
            stall_tol=max(self.stall_tol, 1e-14),
            infeas_tol=max(self.infeas_tol, 1e-14),
            inner_tol_max=_saturate(self.inner_tol_max, 1e-8, 1e2),
            inner_tol_min=_saturate(self.inner_tol_min, 1e-14, 1e-2),
            max_newton_iters=max(self.max_newton_iters, 1),
            max_prox_iters=max(self.max_prox_iters, 1),
            max_inner_iters=max(self.max_inner_iters, 1),
            max_linesearch_iters=max(self.max_linesearch_iters, 1),
            inner_stall_tol=_saturate(self.inner_stall_tol, 0.0, 0.5),
            refine_steps=int(_saturate(self.refine_steps, 0, 96)),
            refine_target=max(self.refine_target, 1e-14),
            refine_sigma=(0.0 if self.refine_sigma == 0.0
                          else _saturate(self.refine_sigma, 1e-8, 1e-1)),
        )

    @staticmethod
    def default() -> "Options":
        """Recommended settings (reference: DefaultParameters)."""
        return Options()

    @staticmethod
    def single_precision() -> "Options":
        """The float32 product profile: sigma0 3e-4 keeps the f32 Newton
        system well conditioned, tolerances sit above the f32 residual
        floor, and equilibration + failed-lane retry + double-float
        refinement carry the result to the 1e-6 contract."""
        return dataclasses.replace(
            Options(),
            sigma0=3e-4,
            sigma_max=1e-2,
            sigma_min=1e-6,
            abs_tol=1e-4,
            rel_tol=1e-6,
            stall_tol=1e-6,
            infeas_tol=1e-6,
            inner_tol_min=1e-7,
            inner_stall_tol=1e-3,
            refine_steps=48,
            refine_sigma=1e-5,
            equilibrate=True,
            retry_failed=True,
        )

    @staticmethod
    def reliable() -> "Options":
        """Settings for hard problems (reference: ReliableParameters)."""
        return dataclasses.replace(
            Options(),
            sigma0=1e-4,
            sigma_max=1e-2,
            sigma_min=1e-10,
            beta=0.9,
            abs_tol=1e-4,
            rel_tol=1e-6,
            max_linesearch_iters=40,
            max_newton_iters=500,
            max_prox_iters=100,
            nonmonotone_linesearch=False,
        )

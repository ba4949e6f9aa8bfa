"""Construct-once facades for the batched product path (counterpart of
`fbstab_tpu/models/batch_facade.py`).

They bundle what a batched workflow otherwise composes by hand:

 - batch dispatch through solve_mpc_qp_batch / solve_dense_qp_batch (the
   fused kernels K2 / K3 on the card in float32, riccati="auto"),
 - double-float refinement per Options.refine_steps (the float32
   default), so solutions meet the reference's 1e-6 accuracy contract,
 - warmstart carry across calls (carry_warmstart=True replays the last
   solution, shifted one stage for MPC: the receding-horizon pattern),
 - BatchStats (parallel/sharded.py) and the Display.FINAL batch summary
   through an OutputStream,
 - the optional two-phase adaptive solve (parallel/adaptive.py).

Quick start (the headline workload in three lines):

    solver = FBstabMpcBatch(B=8192, N=30, nx=8, nu=3, nc=6)
    x, out, stats = solver.solve(data)        # VariableDF, 1e-6-grade
    x, out, stats = solver.solve(next_data)   # warmstarted from x

The facades solve on the card unless given device="cpu". The JAX
facades compile their solve once per facade with the TPU's compiler
options; the port runs eagerly and has nothing to compile.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.device import resolve_device
from fbstab_tpu_torch.options import Display, Options
from fbstab_tpu_torch.solver_out import SolverOut


class _BatchFacadeBase:
    """Shared machinery: warmstart carry, timing, stats, display."""

    def __init__(self, options: Optional[Options], dtype, carry_warmstart,
                 adaptive, phase1_newton_iters=16, phase2_size=None,
                 phase2_fallback=True, device=None):
        if options is None:
            options = (Options.single_precision()
                       if dtype == torch.float32 else Options.default())
        self._options = options.validated()
        self.dtype = dtype
        self.device = resolve_device(device)
        self.carry_warmstart = carry_warmstart
        self.adaptive = adaptive
        self.phase1_newton_iters = phase1_newton_iters
        self.phase2_size = phase2_size
        self.phase2_fallback = phase2_fallback
        self._last: Optional[Variable] = None
        self.last_stats = None

    def _adaptive_kwargs(self):
        return dict(phase1_newton_iters=self.phase1_newton_iters,
                    phase2_size=self.phase2_size,
                    phase2_fallback=self.phase2_fallback)

    def update_options(self, options: Options) -> None:
        self._options = options.validated()

    @property
    def options(self) -> Options:
        return self._options

    def reset_warmstart(self) -> None:
        self._last = None

    def _zeros(self) -> Variable:
        kw = dict(dtype=self.dtype, device=self.device)
        B = self.B
        return Variable(z=torch.zeros(B, self.nz, **kw),
                        l=torch.zeros(B, self.nl, **kw),
                        v=torch.zeros(B, self.nv, **kw),
                        y=torch.zeros(B, self.nv, **kw))

    def _resolve_x0(self, data, x0: Optional[Variable]) -> Variable:
        if x0 is not None:
            return x0
        if self.carry_warmstart and self._last is not None:
            return self._carry(self._last, data)
        return self._zeros()

    def solve(self, data, x0: Optional[Variable] = None, stream=None):
        """Solves the batch. Returns (solution, SolverOut, BatchStats);
        with refinement engaged (the float32 default) the solution is a
        VariableDF double-float pair (`.hi()` for the float32 view), else a
        Variable. x0 overrides the automatic warmstart carry. With
        Display.FINAL the batch summary goes to `stream` (stdout when
        None)."""
        from fbstab_tpu_torch.models.refine import VariableDF
        from fbstab_tpu_torch.parallel.sharded import batch_stats

        self._validate(data)
        guess = self._resolve_x0(data, x0)
        t0 = time.perf_counter()
        x, core = self._solve(data, guess.z, guess.l, guess.v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0

        self._last = x.hi() if isinstance(x, VariableDF) else x
        out = SolverOut(
            eflag=core.eflag, residual=core.residual,
            newton_iters=core.newton_iters, prox_iters=core.prox_iters,
            solve_time=torch.tensor(elapsed),
            initial_residual=core.initial_residual,
            raw_residual=core.raw_residual,
            refine_steps=core.refine_steps)
        stats = batch_stats(core)
        self.last_stats = stats
        if self._options.display_level >= Display.FINAL:
            from fbstab_tpu_torch.utils.printing import print_batch_final
            print_batch_final(out, self._options, stream)
        return x, out, stats

    def _check_fields(self, data, expect: dict) -> None:
        name = type(self).__name__
        for field, want in expect.items():
            got = tuple(getattr(data, field).shape)
            if got != want:
                raise ValueError(f"{name}.solve: {field} has shape {got}, "
                                 f"expected {want}.")
        dev = getattr(data, next(iter(expect))).device
        if dev.type != self.device.type:
            raise ValueError(f"{name}.solve: the data lies on {dev}, the "
                             f"solver was made for {self.device}.")


class FBstabMpcBatch(_BatchFacadeBase):
    """Construct-once batched MPC solver (sizes as FBstabMpc,
    fbstab_mpc.cc:70-72, plus the batch size B fixed at construction)."""

    def __init__(self, B: int, N: int, nx: int, nu: int, nc: int,
                 dtype=torch.float32, options: Optional[Options] = None,
                 carry_warmstart: bool = True, shift_carry: bool = True,
                 adaptive: bool = False, riccati: str = "auto",
                 phase1_newton_iters: int = 16,
                 phase2_size: Optional[int] = None,
                 phase2_fallback: bool = True, *, device=None):
        """adaptive=True takes the two-phase solve
        (solve_mpc_qp_batch_adaptive_device): phase 1 capped at
        `phase1_newton_iters` Newton iterations, up to `phase2_size`
        stragglers (default B // 8) re-solved with a reliable-leaning full
        budget, and with `phase2_fallback` a full-batch full-budget pass
        when the stragglers overflow that capacity. `device` is
        keyword-only: the positional parameters are the JAX facade's."""
        if min(B, N, nx, nu, nc) <= 0:
            raise ValueError("FBstabMpcBatch requires B,N,nx,nu,nc > 0.")
        self.B, self.N, self.nx, self.nu, self.nc = B, N, nx, nu, nc
        self.nz = (N + 1) * (nx + nu)
        self.nl = (N + 1) * nx
        self.nv = (N + 1) * nc
        self.shift_carry = shift_carry
        self.riccati = riccati
        super().__init__(options, dtype, carry_warmstart, adaptive,
                         phase1_newton_iters, phase2_size, phase2_fallback,
                         device)

    def _solve(self, d, z, l, v):
        if self.adaptive:
            from fbstab_tpu_torch.parallel.adaptive import (
                solve_mpc_qp_batch_adaptive_device)
            return solve_mpc_qp_batch_adaptive_device(
                d, z, l, v, self._options, riccati=self.riccati,
                **self._adaptive_kwargs())
        from fbstab_tpu_torch.models.mpc_qp import solve_mpc_qp_batch
        return solve_mpc_qp_batch(d, z, l, v, self._options,
                                  riccati=self.riccati)

    def _carry(self, last: Variable, data) -> Variable:
        from fbstab_tpu_torch.models.receding_horizon import shift_warmstart
        if not self.shift_carry:
            return last
        # Per-instance shift; the margin y = b - Az uses each instance's
        # own constraint data.
        return shift_warmstart(last, data)

    def _validate(self, data) -> None:
        B, N, nx, nu, nc = self.B, self.N, self.nx, self.nu, self.nc
        self._check_fields(data, dict(
            Q=(B, N + 1, nx, nx), R=(B, N + 1, nu, nu),
            S=(B, N + 1, nu, nx), q=(B, N + 1, nx), r=(B, N + 1, nu),
            A=(B, N, nx, nx), B=(B, N, nx, nu), c=(B, N, nx),
            E=(B, N + 1, nc, nx), L=(B, N + 1, nc, nu),
            d=(B, N + 1, nc), x0=(B, nx)))


class FBstabDenseBatch(_BatchFacadeBase):
    """Construct-once batched dense-QP solver (sizes as FBstabDense,
    fbstab_dense.h:50, plus the batch size B)."""

    def __init__(self, B: int, nz: int, nl: int, nv: int,
                 dtype=torch.float32, options: Optional[Options] = None,
                 carry_warmstart: bool = True, adaptive: bool = False,
                 phase1_newton_iters: int = 16,
                 phase2_size: Optional[int] = None,
                 phase2_fallback: bool = True, *, device=None):
        """The two-phase adaptive knobs as FBstabMpcBatch's."""
        if B <= 0 or nz <= 0 or nv <= 0 or nl < 0:
            raise ValueError(
                "FBstabDenseBatch requires B, nz, nv > 0 and nl >= 0.")
        self.B, self.nz, self.nl, self.nv = B, nz, nl, nv
        super().__init__(options, dtype, carry_warmstart, adaptive,
                         phase1_newton_iters, phase2_size, phase2_fallback,
                         device)

    def _solve(self, d, z, l, v):
        if self.adaptive:
            from fbstab_tpu_torch.parallel.adaptive import (
                solve_dense_qp_batch_adaptive_device)
            return solve_dense_qp_batch_adaptive_device(
                d, z, l, v, self._options, **self._adaptive_kwargs())
        from fbstab_tpu_torch.models.dense_qp import solve_dense_qp_batch
        return solve_dense_qp_batch(d, z, l, v, self._options)

    def _carry(self, last: Variable, data) -> Variable:
        # Dense QPs have no stage structure to shift: replay as it is (the
        # reference's overwrite-the-guess contract).
        return last

    def _validate(self, data) -> None:
        B, nz, nl, nv = self.B, self.nz, self.nl, self.nv
        self._check_fields(data, dict(
            H=(B, nz, nz), f=(B, nz), G=(B, nl, nz), h=(B, nl),
            A=(B, nv, nz), b=(B, nv)))

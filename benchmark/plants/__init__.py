"""The benchmark's own plants: frozen copies of the upstream problems.

Each module beside this one holds one plant constructor, `plant()`, which
returns the single-stage data of a linear-quadratic optimal control
problem as float64 numpy arrays (Q, R, S, q, r, A, B, c, E, L, d, x0).
A configuration names its plant by module name. `stack` replicates one
stage over a horizon and `perturbed_x0` is the rule by which every run
draws its initial states; both are frozen copies, so that a change to the
program cannot change what the benchmark solves.

Copied from fbstab_tpu_torch/models/ocp_fixtures.py
(`replicate_over_horizon`) and fbstab_tpu_torch/workloads.py
(`build_plant`'s perturbation) at commit 326587a.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "c", "E", "L", "d", "x0")


def stack(stage: dict, N: int) -> dict:
    """One stage replicated over an N-step horizon with E(0) zeroed, so
    that x0 is unconstrained (the upstream OcpGenerator::CopyOverHorizon,
    ocp_generator.cc:365-421). Returns float64 arrays without a batch
    axis: Q (N+1, nx, nx), ..., A (N, nx, nx), ..., x0 (nx,)."""
    E_seq = np.repeat(np.asarray(stage["E"], float)[None], N + 1, axis=0)
    E_seq[0] = 0.0
    rep1 = lambda k: np.repeat(np.asarray(stage[k], float)[None], N + 1,
                               axis=0)
    repN = lambda k: np.repeat(np.asarray(stage[k], float)[None], N, axis=0)
    return dict(Q=rep1("Q"), R=rep1("R"), S=rep1("S"), q=rep1("q"),
                r=rep1("r"), A=repN("A"), B=repN("B"), c=repN("c"), E=E_seq,
                L=rep1("L"), d=rep1("d"),
                x0=np.asarray(stage["x0"], float).copy())


def perturbation_scale(x0) -> float:
    """max |x0| of the nominal state, 0.02 where it is zero."""
    return float(np.max(np.abs(np.asarray(x0, float)))) or 0.02


def perturbed_x0(x0_nominal, std_normal, pert: float, scale: float):
    """x0 + pert scale |n| for each row of standard normals n (B, nx),
    lane 0 nominal, where scale is perturbation_scale(x0). Works on numpy
    arrays and torch tensors alike."""
    offs = pert * scale * abs(std_normal)
    offs[0] = 0.0
    return x0_nominal[None] + offs

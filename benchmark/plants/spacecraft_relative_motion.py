"""Spacecraft relative motion (Clohessy-Wiltshire), nx=6, nu=3, nc=12
(reference: OcpGenerator::SpacecraftRelativeMotion,
ocp_generator.cc:171-244).

CW equations linearized about a 650 km circular orbit, forward-Euler
discretized at ts = 30 s with delta-v inputs (B <- A B); input and
velocity box constraints at 1e-3.

Frozen copy of the numpy body of
`fbstab_tpu_torch.models.ocp_fixtures.spacecraft_relative_motion`
at commit 326587a, returning the single stage that
`benchmark.plants.stack` replicates.
"""

from __future__ import annotations

import numpy as np


def plant() -> dict:
    """The single-stage data (Q, R, S, q, r, A, B, c, E, L, d, x0), float64."""
    mu, Re, alt = 398600.4418, 6371.0, 650.0
    n = np.sqrt(mu / (Re + alt) ** 3)

    A21 = np.array([
        [2 * n * n, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [0.0, 0.0, -n * n]])
    A22 = np.array([
        [0.0, 2 * n, 0.0],
        [-2 * n, 0.0, 0.0],
        [0.0, 0.0, 0.0]])
    Ac = np.block([
        [np.zeros((3, 3)), np.eye(3)],
        [A21, A22]])
    Bc = np.vstack([np.zeros((3, 3)), np.eye(3)])

    ts = 30.0
    A = np.eye(6) + ts * Ac
    B = A @ (ts * Bc)   # delta-v input formulation
    c = np.zeros(6)
    x0 = np.array([-2.8, -0.01, -1.0, 0.0, 0.0, 0.0])

    Q = np.diag(np.concatenate([np.ones(3), 1e-3 * np.ones(3)]))
    R = np.eye(3)
    S = np.zeros((3, 6))
    q = np.zeros(6)
    r = np.zeros(3)

    umax = 1e-3
    vmax = 1e-3
    E = np.block([
        [np.zeros((6, 6))],
        [np.zeros((3, 3)), np.eye(3)],
        [np.zeros((3, 3)), -np.eye(3)]])
    L = np.vstack([np.eye(3), -np.eye(3), np.zeros((6, 3))])
    d = np.concatenate([-umax * np.ones(6), -vmax * np.ones(6)])

    return dict(Q=Q, R=R, S=S, q=q, r=r, A=A, B=B, c=c, E=E, L=L, d=d,
                x0=x0)

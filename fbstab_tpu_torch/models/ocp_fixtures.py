"""Canonical MPC benchmark problems (counterpart of
`fbstab_tpu/models/ocp_fixtures.py`, built in numpy the same way).

The equivalent of the reference's OcpGenerator test fixture
(fbstab/test/ocp_generator.{h,cc}), which builds four linear-quadratic
optimal control problems from the FBstab paper's benchmark set
(ocp_generator.h:73-119 cites the source papers). Each builder returns a
time-invariant plant replicated over the horizon as stacked arrays, with
E(0) = 0 so the (fixed) initial state is unconstrained, matching
CopyOverHorizon (ocp_generator.cc:365-421).

Each function returns (MpcQPData, SimulationData): the data as a batch of
one instance (leading axis 1; `mpc_qp.batch_data` replicates it), and the
plant matrices for receding-horizon simulation (ocp_generator.h
SimulationInputs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from fbstab_tpu_torch.models.mpc_qp import MpcQPData, mpc_qp_data


class SimulationData(NamedTuple):
    """Plant data for closed-loop simulation (reference:
    OcpGenerator::SimulationInputs, ocp_generator.h:121-139)."""

    A: np.ndarray   # (nx, nx) discrete-time dynamics
    B: np.ndarray   # (nx, nu)
    C: np.ndarray   # (ny, nx) output map
    D: np.ndarray   # (ny, nu)
    x0: np.ndarray  # (nx,)
    T: int          # suggested simulation length


def replicate_over_horizon(Q, R, S, q, r, A, B, c, E, L, d, x0, N,
                           dtype=None, device=None) -> MpcQPData:
    """Stacks single-stage LTI data over an N-step horizon with E(0) zeroed
    so x0 is unconstrained (reference: OcpGenerator::CopyOverHorizon,
    ocp_generator.cc:365-421)."""
    E_seq = np.repeat(np.asarray(E, float)[None], N + 1, axis=0)
    E_seq[0] = 0.0
    rep1 = lambda M: np.repeat(np.asarray(M, float)[None], N + 1, axis=0)
    repN = lambda M: np.repeat(np.asarray(M, float)[None], N, axis=0)
    one = lambda a: np.asarray(a, float)[None]
    return mpc_qp_data(
        Q=one(rep1(Q)), R=one(rep1(R)), S=one(rep1(S)), q=one(rep1(q)),
        r=one(rep1(r)), A=one(repN(A)), B=one(repN(B)), c=one(repN(c)),
        E=one(E_seq), L=one(rep1(L)), d=one(rep1(d)), x0=one(x0),
        dtype=torch.float64 if dtype is None else dtype, device=device)


def double_integrator(N: int, dtype=None, device=None
                      ) -> tuple[MpcQPData, SimulationData]:
    """Constrained double integrator, nx=2, nu=1, nc=6
    (reference: OcpGenerator::DoubleIntegrator, ocp_generator.cc:319-363).

    Discrete-time double integrator x+ = [[1,1],[0,1]] x + [0;1] u with
    state box |x| <= (0, 2)..(2, 2) via -x <= 0, x <= 2 and input box
    |u| <= 1, quadratic cost Q = diag(2, 1), R = 3, S = [1, 0], q = (-2, 0).
    """
    Q = np.array([[2.0, 0.0], [0.0, 1.0]])
    R = np.array([[3.0]])
    S = np.array([[1.0, 0.0]])
    q = np.array([-2.0, 0.0])
    r = np.array([0.0])

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    c = np.zeros(2)

    E = np.array([
        [-1.0, 0.0],
        [0.0, -1.0],
        [1.0, 0.0],
        [0.0, 1.0],
        [0.0, 0.0],
        [0.0, 0.0]])
    L = np.array([[0.0], [0.0], [0.0], [0.0], [-1.0], [1.0]])
    d = np.array([0.0, 0.0, -2.0, -2.0, -1.0, -1.0])
    x0 = np.zeros(2)

    data = replicate_over_horizon(Q, R, S, q, r, A, B, c, E, L, d, x0, N,
                                  dtype, device)
    sim = SimulationData(A=A, B=B, C=np.eye(2), D=np.zeros((2, 1)),
                         x0=x0, T=40)
    return data, sim


def servo_motor(N: int, dtype=None, device=None
                ) -> tuple[MpcQPData, SimulationData]:
    """Servo motor position tracking, nx=4, nu=1, nc=4
    (reference: OcpGenerator::ServoMotor, ocp_generator.cc:245-315).

    Continuous-time two-mass servo model discretized by forward Euler at
    ts = 0.05 s; output/torque constraints |y2| <= 78.5358, |u| <= 220;
    tracking target 30 degrees on the load angle.
    """
    kt, bl, Jm, bm = 10.0, 25.0, 0.5, 0.1
    ktheta, RR, rho = 1280.2, 20.0, 20.0
    Jl = 20.0 * Jm
    umax, ymax = 220.0, 78.5358

    Ac = np.array([
        [0.0, 1.0, 0.0, 0.0],
        [-ktheta / Jl, -bl / Jl, ktheta / (rho * Jl), 0.0],
        [0.0, 0.0, 0.0, 1.0],
        [ktheta / (rho * Jm), 0.0, -ktheta / (rho * rho * Jm),
         -(bm + kt * kt / RR) / Jm]])
    Bc = np.array([[0.0], [0.0], [0.0], [kt / (RR * Jm)]])
    C = np.array([
        [1.0, 0.0, 0.0, 0.0],
        [ktheta, 0.0, -ktheta / rho, 0.0]])

    ts = 0.05
    A = np.eye(4) + ts * Ac
    B = ts * Bc
    c = np.zeros(4)
    x0 = np.zeros(4)

    Q = np.zeros((4, 4))
    Q[0, 0] = 1000.0
    R = np.array([[1e-4]])
    S = np.zeros((1, 4))

    xtrg = np.array([30.0 * np.pi / 180.0, 0.0, 0.0, 0.0])
    q = -Q @ xtrg
    r = np.zeros(1)

    E = np.vstack([C[1], -C[1], np.zeros((2, 4))])
    L = np.array([[0.0], [0.0], [1.0], [-1.0]])
    d = np.array([-ymax, -ymax, -umax, -umax])

    data = replicate_over_horizon(Q, R, S, q, r, A, B, c, E, L, d, x0, N,
                                  dtype, device)
    sim = SimulationData(A=A, B=B, C=C, D=np.zeros((2, 1)), x0=x0, T=40)
    return data, sim


def spacecraft_relative_motion(N: int, dtype=None, device=None
                               ) -> tuple[MpcQPData, SimulationData]:
    """Spacecraft relative motion (Clohessy-Wiltshire), nx=6, nu=3, nc=12
    (reference: OcpGenerator::SpacecraftRelativeMotion,
    ocp_generator.cc:171-244).

    CW equations linearized about a 650 km circular orbit, forward-Euler
    discretized at ts = 30 s with delta-v inputs (B <- A B); input and
    velocity box constraints at 1e-3.
    """
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

    data = replicate_over_horizon(Q, R, S, q, r, A, B, c, E, L, d, x0, N,
                                  dtype, device)
    sim = SimulationData(A=A, B=B, C=np.eye(6), D=np.zeros((6, 3)),
                         x0=x0, T=100)
    return data, sim


def copolymerization_reactor(N: int, dtype=None, device=None
                             ) -> tuple[MpcQPData, SimulationData]:
    """Copolymerization reactor, nx=18, nu=5, nc=10
    (reference: OcpGenerator::CopolymerizationReactor,
    ocp_generator.cc:73-169).

    Modal state-space realization of the 4x5 Congalidis-Richards-Ray
    transfer-function model, zero-order-hold discretized; output-weighted
    cost Q = C'C and input box |u| <= 0.05.
    """
    A = np.zeros((18, 18))
    ai = [1, 2, 3, 4, 5, 6, 7, 8, 7, 8, 9, 10, 11, 12, 13, 12, 13, 14, 15,
          16, 15, 16, 17, 18, 17, 18]
    aj = [1, 2, 3, 4, 5, 6, 7, 7, 8, 8, 9, 10, 11, 12, 12, 13, 13, 14, 15,
          15, 16, 16, 17, 17, 18, 18]
    av = [0.55531, 0.81264, 0.82131, 0.30408, 0.71811, 0.72276, 0.97319,
          0.12353, -0.16471, 0.98966, 0.70834, 0.69048, 0.83152, -0.016569,
          0.07277, -0.040608, 0.17835, 0.53526, -0.015422, 0.04805,
          -0.093847, 0.2924, -0.22577, 0.43126, -0.38505, 0.2517]
    for i, j, v in zip(ai, aj, av):
        A[i - 1, j - 1] = v

    B = np.zeros((18, 5))
    bi = list(range(1, 19))
    bj = [1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 5, 5, 5, 5, 5, 5, 5]
    bv = [0.18899, 0.22577, 0.11347, 0.14614, 0.21282, 0.21347, 0.24707,
          0.015512, 0.21145, 0.41785, 0.11415, 0.14554, 2.9448, 0.1859,
          0.04805, 0.36229, 0.21563, 0.41905]
    for i, j, v in zip(bi, bj, bv):
        B[i - 1, j - 1] = v

    C = np.zeros((4, 18))
    C[0] = [0.8, 0, 0, 1, 0, 0, 0.0416666666666667, 0.333333333333333, 0, 0,
            0, 25.9553571428571, 1.80245535714286, 0, 0, 0, 0, 0]
    C[1] = [0, -0.340248962655602, 0, 0, 0.874172185430464, 0, 0, 0,
            -0.413793103448276, 0, 0, 0, 0, -0.93, 0, 0, 0, 0]
    C[2] = [0, 0, 0.47244, 0, 0, 0.63636, 0, 0, 0, -0.52593, -0.2952, 0, 0,
            0, 0, -9.1992, 0, 0]
    C[3] = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1.6757, 1.8214]

    c = np.zeros(18)
    x0 = 0.2 * np.sin(np.arange(1, 19, dtype=float))

    Q = C.T @ C
    R = 0.1 * np.eye(5)
    S = np.zeros((5, 18))
    q = np.zeros(18)
    r = np.zeros(5)

    umax = 5.0 / 100.0
    E = np.zeros((10, 18))
    L = np.vstack([np.eye(5), -np.eye(5)])
    d = -umax * np.ones(10)

    data = replicate_over_horizon(Q, R, S, q, r, A, B, c, E, L, d, x0, N,
                                  dtype, device)
    sim = SimulationData(A=A, B=B, C=C, D=np.zeros((4, 5)), x0=x0, T=200)
    return data, sim

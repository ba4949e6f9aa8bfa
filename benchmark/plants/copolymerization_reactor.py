"""Copolymerization reactor, nx=18, nu=5, nc=10
(reference: OcpGenerator::CopolymerizationReactor,
ocp_generator.cc:73-169).

Modal state-space realization of the 4x5 Congalidis-Richards-Ray
transfer-function model, zero-order-hold discretized; output-weighted
cost Q = C'C and input box |u| <= 0.05.

Frozen copy of the numpy body of
`fbstab_tpu_torch.models.ocp_fixtures.copolymerization_reactor`
at commit 326587a, returning the single stage that
`benchmark.plants.stack` replicates.
"""

from __future__ import annotations

import numpy as np


def plant() -> dict:
    """The single-stage data (Q, R, S, q, r, A, B, c, E, L, d, x0), float64."""
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

    return dict(Q=Q, R=R, S=S, q=q, r=r, A=A, B=B, c=c, E=E, L=L, d=d,
                x0=x0)

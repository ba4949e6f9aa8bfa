"""The batches the port is measured and tested on, their float64 host
residuals, and timing helpers for the card.

`chip_smoke.py`, the measurement scripts under `fbstab_tpu_torch/tools/`
and the CPU tests all take their inputs from here. The generators are
plain numpy from a seed (the JAX package's `bench.build_batch` and
`bench.build_dense_batch` problems), so the same arrays can be fed to
any implementation; the residuals are plain numpy in float64, the check
of the 1e-6 contract.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

# bench.py's headline MPC shape, its dense shape (BASELINE config 3) and
# the copolymerization reactor's shape (`bench.py copoly`), and the
# sparse problem's (`bench.py sparse`).
HEADLINE = dict(N=30, nx=8, nu=3, nc=6)
DENSE = dict(n=32, q=64)
COPOLY = dict(N=80, nx=18, nu=5, nc=10)
SPARSE = dict(nz=400, nl=40, nv=200)


def headline_arrays(B, N=30, nx=8, nu=3, nc=6, seed=0):
    """The scenario-MPC batch as numpy float64 arrays: a shared stable
    plant, varied x0 and cost offsets, input box |u| <= 1 (on the first
    nc // 2 inputs where nc < 2 nu; rows beyond the box are 0 <= 1). The
    shared leaves are read-only broadcast views."""
    rng = np.random.default_rng(seed)
    A1 = np.eye(nx) + 0.08 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    B1 = 0.2 * rng.standard_normal((nx, nu))
    L1 = np.zeros((nc, nu))
    k = min(nu, nc // 2)
    L1[:k] = np.eye(nu)[:k]
    L1[k:2 * k] = -np.eye(nu)[:k]
    tile = lambda M, n: np.broadcast_to(M, (B, n) + M.shape)
    Np1 = N + 1
    return dict(
        Q=tile(np.eye(nx), Np1), R=tile(0.1 * np.eye(nu), Np1),
        S=tile(np.zeros((nu, nx)), Np1),
        q=0.1 * rng.standard_normal((B, Np1, nx)), r=np.zeros((B, Np1, nu)),
        A=tile(A1, N), B=tile(B1, N), c=np.zeros((B, N, nx)),
        E=tile(np.zeros((nc, nx)), Np1), L=tile(L1, Np1),
        d=tile(-np.ones(nc), Np1), x0=rng.standard_normal((B, nx)))


def dense_arrays(B, n=32, q=64, nl=0, seed=1):
    """Random strictly convex dense QPs as numpy float64 arrays (seed 1 is
    bench.build_dense_batch's batch). With nl > 0, Gaussian equality rows
    G z = h (entries of variance 1/n) through a small point z_f that the
    inequality rows keep feasible."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    H = M @ np.transpose(M, (0, 2, 1)) / n + 2.0 * np.eye(n)
    f = rng.standard_normal((B, n))
    A = rng.standard_normal((B, q, n))
    b = np.abs(rng.standard_normal((B, q))) + 0.5      # origin feasible
    G, h = np.zeros((B, 0, n)), np.zeros((B, 0))
    if nl > 0:
        G = rng.standard_normal((B, nl, n)) / np.sqrt(n)
        zf = 0.05 * rng.standard_normal((B, n, 1))
        h = (G @ zf)[..., 0]
        b = b + np.abs(A @ zf)[..., 0]
    return dict(H=H, f=f, G=G, h=h, A=A, b=b)


def sparse_arrays(nz=400, nl=40, nv=200, seed=0):
    """bench.py sparse's problem as dense numpy float64 matrices (one
    instance): a banded H (2 + U(0, 1) on the diagonal, -0.5 beside it),
    four Gaussian entries in each of the nl rows of G, three in each of
    the nv rows of A, f ~ N(0, 1), h ~ 0.1 N(0, 1), b = |N(0, 1)| + 1."""
    rng = np.random.default_rng(seed)
    H = np.zeros((nz, nz))
    for i in range(nz):
        H[i, i] = 2.0 + rng.random()
        if i + 1 < nz:
            H[i, i + 1] = H[i + 1, i] = -0.5
    G = np.zeros((nl, nz))
    for j in range(nl):
        G[j, rng.choice(nz, 4, replace=False)] = rng.standard_normal(4)
    A = np.zeros((nv, nz))
    for j in range(nv):
        A[j, rng.choice(nz, 3, replace=False)] = rng.standard_normal(3)
    f = rng.standard_normal(nz)
    h = rng.standard_normal(nl) * 0.1
    b = np.abs(rng.standard_normal(nv)) + 1.0
    return dict(H=H, f=f, G=G, h=h, A=A, b=b)


def sparse_batch(B, device, nz=400, nl=40, nv=200, dtype=torch.float64):
    """bench.py sparse's batch: the pattern and SparseQPData of
    sparse_arrays with B lanes, f scaled by 1 + 1e-4 i on lane i."""
    from fbstab_tpu_torch.models.sparse_qp import sparse_qp_data
    a = sparse_arrays(nz, nl, nv)
    pat, d = sparse_qp_data(**{k: v[None] for k, v in a.items()},
                            dtype=dtype, device=device)
    scale = 1.0 + 1e-4 * torch.arange(B, dtype=dtype, device=device)
    lanes = lambda t: t.expand(B, -1).contiguous()
    return pat, type(d)(*(lanes(t) for t in d))._replace(
        f=d.f * scale[:, None])


def build_batch(B, N, nx, nu, nc, device, dtype=torch.float32):
    """The headline batch as MpcQPData on `device`."""
    from fbstab_tpu_torch.models.mpc_qp import mpc_qp_data
    return mpc_qp_data(**headline_arrays(B, N, nx, nu, nc), dtype=dtype,
                       device=device)


def build_dense(B, n, q, nl, device, dtype=torch.float32):
    """The dense batch as DenseQPData on `device`."""
    from fbstab_tpu_torch.models.dense_qp import dense_qp_data
    return dense_qp_data(**dense_arrays(B, n, q, nl), dtype=dtype,
                         device=device)


def build_copoly(B, device, N=COPOLY["N"]):
    """bench.py copoly's float32 batch: the copolymerization reactor at
    horizon N (by default COPOLY's) with x0 = 0.02 N(0, 1) per lane
    (seed 0)."""
    from fbstab_tpu_torch.models.mpc_qp import batch_data
    from fbstab_tpu_torch.models.ocp_fixtures import copolymerization_reactor
    one, _ = copolymerization_reactor(N, dtype=torch.float32, device=device)
    x0 = 0.02 * np.random.default_rng(0).standard_normal((B, COPOLY["nx"]))
    return batch_data(one, B)._replace(
        x0=torch.tensor(x0, dtype=torch.float32, device=device))


def build_plant(name, N, B, pert, device, seed=7):
    """A reference plant (ocp_fixtures, by name) at horizon N as a float32
    batch of B lanes, x0 perturbed around the nominal as bench.py's
    plants_contract_check perturbs it: x0 + pert max|x0| |N(0, 1)|, lane 0
    nominal."""
    from fbstab_tpu_torch.models import ocp_fixtures
    from fbstab_tpu_torch.models.mpc_qp import batch_data
    one, _ = getattr(ocp_fixtures, name)(N, dtype=torch.float32,
                                         device=device)
    x0 = one.x0[0].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    scale = float(np.max(np.abs(x0))) or 0.02
    offs = pert * scale * np.abs(rng.standard_normal((B, x0.shape[0])))
    offs[0] = 0.0
    return batch_data(one, B)._replace(x0=torch.tensor(
        x0[None] + offs, dtype=torch.float32, device=device))


def zeros_guess(data):
    """Zero (z, l, v) guesses for an MPC batch, in its dtype and device."""
    from fbstab_tpu_torch.models.mpc_qp import mpc_dims
    N, nx, nu, nc = mpc_dims(data)
    B = data.x0.shape[0]
    kw = dict(dtype=data.x0.dtype, device=data.x0.device)
    return (torch.zeros(B, (N + 1) * (nx + nu), **kw),
            torch.zeros(B, (N + 1) * nx, **kw),
            torch.zeros(B, (N + 1) * nc, **kw))


def newton_step_args(data, options, steps=3):
    """The arguments (data, v, y, vbar, rz, rl, rv, sigma, alpha) of a
    Newton step (K1's, or the associative step's) at the iterate that
    `steps` plain proximal Newton steps from the zero guess reach, with
    vbar = v and the negated inner residual there."""
    from fbstab_tpu_torch.core.residuals import inner_residual
    from fbstab_tpu_torch.core.variable import Variable, var_axpy
    from fbstab_tpu_torch.models.mpc_qp import MPC_OPS, _b_vec, _gemvA
    from fbstab_tpu_torch.ops.riccati_cuda import riccati_newton_step_plain

    z0, l0, v0 = zeros_guess(data)
    b = _b_vec(data)
    x = Variable(z=z0, l=l0, v=v0, y=b - _gemvA(data, z0))
    sigma, alpha = options.sigma0, options.alpha
    for _ in range(steps):
        r = inner_residual(MPC_OPS, data, x, x, sigma, alpha)
        d = riccati_newton_step_plain(data, x.v, x.y, x.v, -r.z, -r.l, -r.v,
                                      sigma, alpha)
        x = var_axpy(1.0, Variable(*d), x, b)
        x = x._replace(v=torch.clamp(x.v, min=0.0))
    r = inner_residual(MPC_OPS, data, x, x, sigma, alpha)
    return data, x.v, x.y, x.v, -r.z, -r.l, -r.v, sigma, alpha


def dense_zeros(data):
    """Zero (z, l, v) guesses for a dense batch."""
    B, kw = data.H.shape[0], dict(dtype=data.H.dtype, device=data.H.device)
    n, q, nl = data.H.shape[-1], data.A.shape[-2], data.G.shape[-2]
    return (torch.zeros(B, n, **kw), torch.zeros(B, nl, **kw),
            torch.zeros(B, q, **kw))


# ------------------------------------------------------------------
# Host float64 residuals: the penalized natural residual with the margin
# rebuilt in float64 (y = b - A z), per lane.
# ------------------------------------------------------------------

def _host(sol):
    x = sol.to_float64() if hasattr(sol, "to_float64") else sol
    return (x.z.double().cpu().numpy(), x.l.double().cpu().numpy(),
            x.v.double().cpu().numpy())


def _pnr_rv(y, v, alpha):
    return (alpha * np.minimum(y, v)
            + (1 - alpha) * np.maximum(0, y) * np.maximum(0, v))


def mpc_f64_residual(data, sol, alpha):
    """bench.f64_pnr_np's formula on the port's MpcQPData and solution."""
    d = {k: getattr(data, k).double().cpu().numpy() for k in data._fields}
    z, l, v = _host(sol)
    B, N1 = z.shape[0], d["Q"].shape[1]
    nx, nu, nc = d["Q"].shape[-1], d["R"].shape[-1], d["E"].shape[2]
    zs = z.reshape(B, N1, nx + nu)
    zx, zu = zs[..., :nx], zs[..., nx:]
    ls = l.reshape(B, N1, nx)
    vs = v.reshape(B, N1, nc)
    hx = (np.einsum("bsij,bsj->bsi", d["Q"], zx)
          + np.einsum("bsji,bsj->bsi", d["S"], zu))
    hu = (np.einsum("bsij,bsj->bsi", d["S"], zx)
          + np.einsum("bsij,bsj->bsi", d["R"], zu))
    atl = np.einsum("bsji,bsj->bsi", d["A"], ls[:, 1:])
    btl = np.einsum("bsji,bsj->bsi", d["B"], ls[:, 1:])
    gx = -ls + np.concatenate([atl, np.zeros((B, 1, nx))], 1)
    gu = np.concatenate([btl, np.zeros((B, 1, nu))], 1)
    ax = np.einsum("bsci,bsc->bsi", d["E"], vs)
    au = np.einsum("bsci,bsc->bsi", d["L"], vs)
    rzx = d["q"] + hx + gx + ax
    rzu = d["r"] + hu + gu + au
    gzt = (np.einsum("bsij,bsj->bsi", d["A"], zx[:, :-1])
           + np.einsum("bsij,bsj->bsi", d["B"], zu[:, :-1]) - zx[:, 1:])
    gz = np.concatenate([-zx[:, :1], gzt], 1)
    rl = -np.concatenate([d["x0"][:, None, :], d["c"]], 1) - gz
    az = (np.einsum("bsci,bsi->bsc", d["E"], zx)
          + np.einsum("bsci,bsi->bsc", d["L"], zu))
    rv = _pnr_rv(-d["d"] - az, vs, alpha)
    sq = lambda a: (a.reshape(B, -1) ** 2).sum(1)
    return np.sqrt(sq(rzx) + sq(rzu) + sq(rl) + sq(rv))


def sparse_f64_residual(pat, data, sol, alpha):
    """The penalized natural residual of SparseQPData on its pattern, in
    float64 on the host: rz = f + Hz + G'l + A'v, rl = h - Gz, rv at
    y = b - Az, each CSR product summed with numpy."""
    d = {k: getattr(data, k).double().cpu().numpy() for k in data._fields}
    z, l, v = _host(sol)

    def mv(M, vals, x, out_n, transpose=False):
        rows, cols = (M.indices, M.row_ids) if transpose else (M.row_ids,
                                                               M.indices)
        y = np.zeros((x.shape[0], out_n))
        np.add.at(y, (slice(None), rows), vals * x[:, cols])
        return y

    rz = (d["f"] + mv(pat.H, d["Hx"], z, pat.nz)
          + mv(pat.G, d["Gx"], l, pat.nz, True)
          + mv(pat.A, d["Ax"], v, pat.nz, True))
    rl = d["h"] - mv(pat.G, d["Gx"], z, pat.nl)
    rv = _pnr_rv(d["b"] - mv(pat.A, d["Ax"], z, pat.nv), v, alpha)
    sq = lambda a: (a ** 2).sum(1)
    return np.sqrt(sq(rz) + sq(rl) + sq(rv))


def dense_f64_residual(data, sol, alpha):
    """rz = f + Hz + G'l + A'v, rl = h - Gz, rv at y = b - Az."""
    d = {k: getattr(data, k).double().cpu().numpy() for k in data._fields}
    z, l, v = _host(sol)
    mv = lambda M, x: np.einsum("bij,bj->bi", M, x)
    mtv = lambda M, x: np.einsum("bji,bj->bi", M, x)
    rz = d["f"] + mv(d["H"], z) + mtv(d["G"], l) + mtv(d["A"], v)
    rl = d["h"] - mv(d["G"], z)
    rv = _pnr_rv(d["b"] - mv(d["A"], z), v, alpha)
    sq = lambda a: (a ** 2).sum(1)
    return np.sqrt(sq(rz) + sq(rl) + sq(rv))


# ------------------------------------------------------------------
# Timing on the card.
# ------------------------------------------------------------------

def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds per call on the card (CUDA events), after one
    warm call (unless the caller has just made one: warm=False)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


GRAPH_CALLS = 20


def graph_ms(fn, reps=10):
    """Device milliseconds per call of fn, apart from the host's issue of
    each call: GRAPH_CALLS calls of fn captured into one CUDA graph (after
    a warm call on a side stream, as capture requires), the graph replayed
    `reps` times between CUDA events. What fn allocates while captured
    comes from the graph's own pool, and every replay reuses it. A graph
    of one call replayed would read the replays' own launch rate (~5 us
    on an H100), not a short kernel's time: hence 20 calls a graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * GRAPH_CALLS)


def launch_floor_ms(device, reps=10):
    """The card's launch floor, timed as graph_ms times a kernel: a
    one-element PyTorch op (add_ on one float)."""
    x = torch.zeros(1, device=device)
    return graph_ms(lambda: x.add_(1.0), reps)


def timed(fn):
    """(fn(), host milliseconds) around synchronized work (the card is
    synchronized where there is one)."""
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]

"""Sparse QP class, batched in PyTorch: CSR products on the data's device,
the quasi-definite KKT system factored on the host by the native sparse
LDL', and the FBstabSparse facade.

Counterpart of `fbstab_tpu/models/sparse_qp.py`, and the same design:

 - The sparsity PATTERN is static numpy (SparsePattern: the CSR patterns
   of H, G and A, the upper-triangular CSC pattern of the KKT matrix K in
   a fill-reducing order, the scatter maps that assemble K's values, and
   the symbolic factorization), built once per structure and shared by
   every batch. The VALUES are batched tensors (SparseQPData), every field
   with a leading batch axis B.
 - The products run where the data lies (the card by default): a gather
   of x at the column indices times the values, then each output entry
   summed from its own row of an ELL table (the positions of its terms,
   padded to the longest row with a zero term: `_ell`), left to right in
   the entries' order. K's values are summed the same way from every
   contribution. The sums are deterministic, the card's bit for bit the
   CPU's. (An atomic scatter-add, `index_add`, adds in a varying order
   on the card; the core's exit tests compare residuals that it computes
   twice at one point, so a last-bit difference between the two ended 5
   of 256 headline MPC lanes on the stall test with a residual of ~1e-6,
   on an H100 in float64, where the CPU took a second Newton step.) The
   cost is memory, (B, rows, longest row), and one add a column.
 - The Newton step solves K = [H + sigma I + A' diag(Gamma) A, G';
   G, -sigma I] (paper (28)/(29)) on the host: one round trip per Newton
   step copies K's values and the right-hand side to the host in float64,
   factors and solves every lane with the C kernel (native/sparse_ldl.c,
   the lanes spread over a thread pool, since the ctypes calls release the
   GIL), and copies the solution back. Sparse triangular elimination is
   pointer chasing: host work by design, as in the JAX package, whose
   TPU path makes the same round trip.

A lane whose factorization fails (a zero pivot, or a non-finite pivot from
non-finite data) returns ok = False and NaN in its step, so the core exits
that lane with LINEAR_SOLVER_FAILED and leaves the others alone.

The host side of each round trip is timed into `SparsePattern.split`:
the wait for the device work queued before it, the copies, and the host
LDL'.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from fbstab_tpu_torch.core.algorithm import fbstab_solve, fbstab_solve_batch
from fbstab_tpu_torch.core.problem import ProblemOps
from fbstab_tpu_torch.core.variable import Variable
from fbstab_tpu_torch.device import resolve_device
from fbstab_tpu_torch.models.mpc_qp import (
    _lane_sigma, facade_out, facade_print_final)
from fbstab_tpu_torch.ops.pfb import pfb_weights
from fbstab_tpu_torch.options import Options
from fbstab_tpu_torch.solver_out import SolverOut
from fbstab_tpu_torch.utils import native_ldl
from fbstab_tpu_torch.utils.sparse_ldl import SparseLDL


class _CSRPattern(NamedTuple):
    """Static CSR pattern (indptr, indices) of an (m, n) matrix, plus the
    per-entry row ids that make a product one gather and one sum."""

    indptr: np.ndarray   # (m+1,) int64
    indices: np.ndarray  # (nnz,) int64, column of each entry
    row_ids: np.ndarray  # (nnz,) int64, row of each entry
    m: int
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def _csr_pattern(indptr, indices, m: int, n: int) -> _CSRPattern:
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    if indptr.shape != (m + 1,):
        raise ValueError(f"indptr must have length {m + 1}.")
    row_ids = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    return _CSRPattern(indptr=indptr, indices=indices, row_ids=row_ids,
                       m=m, n=n)


def _csr_from_dense_mask(M: np.ndarray) -> _CSRPattern:
    """The pattern of the entries of M (m, n) that are nonzero."""
    m, n = M.shape
    mask = M != 0.0
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(mask)[1].astype(np.int64)
    return _csr_pattern(indptr, indices, m, n)


def _ell(dst: np.ndarray, n_out: int) -> np.ndarray:
    """(n_out, w) int64: row r holds the positions of the terms whose
    destination is r (in their order), padded to the longest row w with
    len(dst), the position of an appended zero term."""
    counts = np.bincount(dst, minlength=n_out) if dst.size else \
        np.zeros(n_out, np.int64)
    w = max(1, int(counts.max()) if n_out else 1)
    pos = np.full((n_out, w), dst.size, np.int64)
    order = np.argsort(dst, kind="stable")
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    pos[dst[order], np.arange(dst.size) - starts] = order
    return pos


def _host_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _fill_reducing_perm(n: int, entries, ordering: str):
    """(perm, iperm) with new index a <-> old index perm[a]: reverse
    Cuthill-McKee over K's adjacency (scipy), or the identity."""
    ident = np.arange(n, dtype=np.int64)
    if ordering == "natural" or n <= 2:
        return ident, ident.copy()
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    rows, cols = [], []
    for i, j in entries:
        rows.append(i)
        cols.append(j)
        if i != j:
            rows.append(j)
            cols.append(i)
    M = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(M, symmetric_mode=True),
                      np.int64)
    iperm = np.empty(n, np.int64)
    iperm[perm] = ident
    return perm, iperm


@dataclasses.dataclass
class HostSplit:
    """Where the Newton steps' round trips spend their time, summed since
    the last reset (host clock): `wait_s` the wait for the device work
    queued before each round trip, `copy_s` the copies to the host and
    back, `host_s` the host LDL' (factor and solve of every lane)."""

    round_trips: int = 0
    wait_s: float = 0.0
    copy_s: float = 0.0
    host_s: float = 0.0

    def reset(self) -> None:
        self.round_trips, self.wait_s, self.copy_s, self.host_s = 0, 0., 0., 0.


class _Index(NamedTuple):
    """A pattern's index arrays as int64 tensors on one device: for each
    matrix M of H, G, A its column and row of each entry and the ELL
    tables of the product (M_row_ell, by row) and of the transposed
    product (M_col_ell, by column); the gathers and the ELL table of K's
    assembly; the fill-reducing permutation."""

    H_cols: torch.Tensor
    H_rows: torch.Tensor
    H_row_ell: torch.Tensor
    H_col_ell: torch.Tensor
    G_cols: torch.Tensor
    G_rows: torch.Tensor
    G_row_ell: torch.Tensor
    G_col_ell: torch.Tensor
    A_cols: torch.Tensor
    A_rows: torch.Tensor
    A_row_ell: torch.Tensor
    A_col_ell: torch.Tensor
    h_src: torch.Tensor
    g_src: torch.Tensor
    a_src1: torch.Tensor
    a_src2: torch.Tensor
    a_row: torch.Tensor
    k_ell: torch.Tensor    # over h_dst, a_dst, g_dst, zdiag, ldiag in a row
    perm: torch.Tensor
    iperm: torch.Tensor


class SparsePattern:
    """Symbolic side of a sparse QP: CSR patterns of H (full symmetric),
    G, A, and everything derived from them — the upper-triangular CSC
    pattern of the quasi-definite KKT matrix K, the static scatter maps
    that assemble K's values, and the sparse LDL' symbolic factorization
    (elimination tree, nnz(L)).

    Build once per problem structure and reuse across solves and batches
    (the analog of the reference wrapper's analyze-in-constructor,
    qdldl_wrapper.h:24-45). Building one builds the C kernel on first use
    (utils/native_ldl.py) and raises where it does not build.

    ``ordering``: fill-reducing symmetric permutation of K. "rcm"
    (default) uses reverse Cuthill-McKee on K's adjacency; "natural"
    keeps the [z; l] order. Any symmetric permutation is numerically
    safe here — K is quasi-definite, hence strongly factorizable.
    """

    def __init__(self, H: _CSRPattern, G: _CSRPattern, A: _CSRPattern,
                 ordering: str = "rcm"):
        if H.m != H.n:
            raise ValueError("H must be square.")
        nz, nl, nv = H.n, G.m, A.m
        if G.n != nz or A.n != nz:
            raise ValueError("G and A must have nz columns.")
        if ordering not in ("rcm", "natural"):
            raise ValueError(f"Unknown ordering {ordering!r}.")
        self.H, self.G, self.A = H, G, A
        self.nz, self.nl, self.nv = nz, nl, nv
        self.n = nz + nl

        # ---- K's upper-triangular entry set (natural [z; l] coords) ---
        entries = set()
        for j in range(self.n):
            entries.add((j, j))   # sigma*I / -sigma*I diagonals
        h_items = []  # (H data idx, i, j) for upper-triangle entries
        for p in range(H.nnz):
            i, j = int(H.row_ids[p]), int(H.indices[p])
            if i <= j:
                h_items.append((p, i, j))
                entries.add((i, j))
        a_items = []  # (p, q, row k, i, j): A'*diag(Gamma)*A contributions
        for k in range(nv):
            lo, hi = int(A.indptr[k]), int(A.indptr[k + 1])
            row = [(p, int(A.indices[p])) for p in range(lo, hi)]
            for p, ci in row:
                for q, cj in row:
                    if ci <= cj:
                        a_items.append((p, q, k, ci, cj))
                        entries.add((ci, cj))
        g_items = []  # (G data idx, i, nz + j): the G' off-diagonal block
        for p in range(G.nnz):
            j, i = int(G.row_ids[p]), int(G.indices[p])
            g_items.append((p, i, nz + j))
            entries.add((i, nz + j))

        # ---- fill-reducing permutation: new index a <-> old perm[a] ---
        self.perm, self.iperm = _fill_reducing_perm(
            self.n, entries, ordering)
        ip = self.iperm

        def _ppos(i, j):
            a, b = int(ip[i]), int(ip[j])
            return (a, b) if a <= b else (b, a)

        # ---- permuted CSC with sorted rows (diagonal last per column) -
        cols: list[list[int]] = [[] for _ in range(self.n)]
        for i, j in entries:
            a, b = _ppos(i, j)
            cols[b].append(a)
        Kp = np.zeros(self.n + 1, np.int64)
        Ki = np.empty(len(entries), np.int64)
        pos = {}
        q = 0
        for j in range(self.n):
            for i in sorted(cols[j]):
                pos[(i, j)] = q
                Ki[q] = i
                q += 1
            Kp[j + 1] = q
        self.Kp, self.Ki = Kp, Ki
        self.knnz = q

        # ---- static scatter maps for the value assembly ---------------
        self.h_src = np.asarray([p for p, _, _ in h_items], np.int64)
        self.h_dst = np.asarray([pos[_ppos(i, j)] for _, i, j in h_items],
                                np.int64)
        self.a_src1 = np.asarray([p for p, _, _, _, _ in a_items], np.int64)
        self.a_src2 = np.asarray([q_ for _, q_, _, _, _ in a_items],
                                 np.int64)
        self.a_row = np.asarray([k for _, _, k, _, _ in a_items], np.int64)
        self.a_dst = np.asarray(
            [pos[_ppos(i, j)] for _, _, _, i, j in a_items], np.int64)
        self.g_src = np.asarray([p for p, _, _ in g_items], np.int64)
        self.g_dst = np.asarray([pos[_ppos(i, j)] for _, i, j in g_items],
                                np.int64)
        self.zdiag = np.asarray([pos[_ppos(j, j)] for j in range(nz)],
                                np.int64)
        self.ldiag = np.asarray(
            [pos[_ppos(nz + j, nz + j)] for j in range(nl)], np.int64)

        # ---- sparse LDL' symbolic analysis on the native kernel -------
        self._ldl = SparseLDL(self.n, Kp, Ki, backend="native")
        self.lnnz = self._ldl.nnz
        self._lock = threading.Lock()
        self._thread_local = threading.local()
        self._pool = None
        self._index: dict = {}
        self.split = HostSplit()
        # Fix the canonical L row indices once: the fill pattern of the
        # up-looking factorization depends only on (Kp, Ki), so a dummy
        # quasi-definite factorization writes the Li every later solve
        # shares read-only (worker threads factor into private Li
        # scratch, see _factor_into).
        dummy = np.zeros(self.knnz, np.float64)
        dummy[self.zdiag] = 1.0
        if self.ldiag.size:
            dummy[self.ldiag] = -1.0
        self._ldl.factor(dummy)
        self.ops = _make_ops(self)

    def index(self, device) -> _Index:
        """The index arrays as tensors on `device`, made once per device."""
        device = torch.device(device)
        idx = self._index.get(device)
        if idx is None:
            t = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                          device=device)
            mats = {}
            for name in "HGA":
                M = getattr(self, name)
                mats.update({
                    f"{name}_cols": t(M.indices), f"{name}_rows": t(M.row_ids),
                    f"{name}_row_ell": t(_ell(M.row_ids, M.m)),
                    f"{name}_col_ell": t(_ell(M.indices, M.n))})
            k_dst = np.concatenate([self.h_dst, self.a_dst, self.g_dst,
                                    self.zdiag, self.ldiag])
            idx = _Index(
                **mats, h_src=t(self.h_src), g_src=t(self.g_src),
                a_src1=t(self.a_src1), a_src2=t(self.a_src2),
                a_row=t(self.a_row), k_ell=t(_ell(k_dst, self.knnz)),
                perm=t(self.perm), iperm=t(self.iperm))
            self._index[device] = idx
        return idx

    # ---- host side of the Newton step ---------------------------------
    #
    # A batch's lanes are spread over a small thread pool: the native
    # factor/solve are ctypes calls that release the GIL, so a B-lane
    # batch factors on all host cores at once. Each worker owns
    # thread-local numeric buffers; the symbolic arrays parent/Lp and the
    # canonical Li are shared read-only.

    def _factor_into(self, Kv_row, Lx_out, Dinv_out) -> bool:
        """Factor one lane into caller slices; False on failure."""
        s = self._ldl
        tl = self._thread_local
        if not hasattr(tl, "ws"):
            tl.ws = native_ldl._Workspace(self.n)
            tl.D = np.empty(self.n, np.float64)
            # Per-thread Li scratch: numeric factorization rewrites the
            # (pattern-deterministic) row indices; the canonical copy in
            # self._ldl.Li was fixed at construction and is shared
            # read-only by the solves.
            tl.Li = np.empty(self.lnnz, np.int64)
        try:
            native_ldl.factor(self.n, s.Ap, s.Ai, Kv_row, s.parent, s.Lp,
                              tl.Li, Lx_out, tl.D, Dinv_out, tl.ws)
            return bool(np.isfinite(tl.D).all())
        except ZeroDivisionError:
            return False

    def _solve_into(self, Lx_row, Dinv_row, x_row) -> None:
        """In-place solve of one lane from explicit factors."""
        s = self._ldl
        native_ldl.solve(self.n, s.Lp, s.Li, Lx_row, Dinv_row, x_row)

    def _map_batch(self, B, work) -> None:
        """Run work(b) for b in range(B), on the thread pool when the
        batch warrants it."""
        if B >= 4:
            from concurrent.futures import ThreadPoolExecutor
            if self._pool is None:
                with self._lock:
                    if self._pool is None:
                        self._pool = ThreadPoolExecutor(
                            max_workers=_host_workers())
            list(self._pool.map(work, range(B)))
        else:
            for b in range(B):
                work(b)

    def _host_factor(self, KvB: np.ndarray):
        """(B, knnz) K values -> (Lx (B, lnnz), Dinv (B, n), ok (B,))."""
        B = KvB.shape[0]
        Lx = np.empty((B, self.lnnz), np.float64)
        Dinv = np.empty((B, self.n), np.float64)
        ok = np.empty(B, bool)

        def work(b):
            good = self._factor_into(KvB[b], Lx[b], Dinv[b])
            if not good:
                Lx[b] = np.nan
                Dinv[b] = np.nan
            ok[b] = good

        self._map_batch(B, work)
        return Lx, Dinv, ok

    def _host_solve(self, LxB, DinvB, xB: np.ndarray) -> None:
        """Solves every lane of xB (B, n) in place."""
        self._map_batch(xB.shape[0], lambda b: self._solve_into(
            LxB[b], DinvB[b], xB[b]))

    def _host_factor_solve(self, KvB: np.ndarray, xB: np.ndarray):
        """Factor and solve every lane, xB in place; returns ok (B,)."""
        B = KvB.shape[0]
        ok = np.empty(B, bool)
        Lx = np.empty((B, self.lnnz), np.float64)
        Dinv = np.empty((B, self.n), np.float64)

        def work(b):
            good = self._factor_into(KvB[b], Lx[b], Dinv[b])
            if good:
                self._solve_into(Lx[b], Dinv[b], xB[b])
            else:
                xB[b] = np.nan
            ok[b] = good

        self._map_batch(B, work)
        return ok

    def round_trip(self, host_fn, *arrays):
        """Runs host_fn on float64 host copies of `arrays` (device
        tensors; the last one is solved or written in place), timing the
        split. Returns host_fn's result and the host arrays."""
        dev = arrays[0].device
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        host = [np.array(a.detach().to("cpu", torch.float64).numpy())
                for a in arrays]
        t2 = time.perf_counter()
        out = host_fn(*host)
        t3 = time.perf_counter()
        s = self.split
        s.round_trips += 1
        s.wait_s += t1 - t0
        s.copy_s += t2 - t1
        s.host_s += t3 - t2
        return out, host

    def to_device(self, a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A host result back onto `like`'s device and dtype (the copy
        timed into the split)."""
        t0 = time.perf_counter()
        out = torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
        if like.device.type == "cuda":
            torch.cuda.synchronize(like.device)
        self.split.copy_s += time.perf_counter() - t0
        return out


class SparseQPData(NamedTuple):
    """Batched values for a fixed SparsePattern:
    min 1/2 z'Hz + f'z  s.t.  Gz = h, Az <= b. Hx/Gx/Ax are the CSR value
    arrays of the pattern's H/G/A (H stored full symmetric)."""

    Hx: torch.Tensor  # (B, nnz(H))
    f: torch.Tensor   # (B, nz)
    Gx: torch.Tensor  # (B, nnz(G))
    h: torch.Tensor   # (B, nl)
    Ax: torch.Tensor  # (B, nnz(A))
    b: torch.Tensor   # (B, nv)


def _check_data(pat: SparsePattern, data: SparseQPData, who: str,
                B: int) -> None:
    """Raises ValueError naming the first field whose shape is not
    (B, n) for the pattern."""
    for name, nn in (("Hx", pat.H.nnz), ("f", pat.nz), ("Gx", pat.G.nnz),
                     ("h", pat.nl), ("Ax", pat.A.nnz), ("b", pat.nv)):
        got = tuple(getattr(data, name).shape)
        if got != (B, nn):
            raise ValueError(f"{who}: {name} has shape {got}, expected "
                             f"{(B, nn)}.")


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def sparse_qp_data(H, f, G=None, h=None, A=None, b=None,
                   dtype=torch.float64, ordering: str = "rcm", device=None):
    """Builds (SparsePattern, SparseQPData) from dense arrays with a common
    leading batch axis B, keeping the entries that are nonzero in any
    lane. The pattern is reusable: pack new values for the same structure
    with `pattern_values`. With no `device` the values go where H lies if
    it is a tensor, else on the card."""
    device = resolve_device(device, like=H)
    Hn = _as_numpy(H)
    if Hn.ndim != 3 or Hn.shape[1] != Hn.shape[2]:
        raise ValueError("sparse_qp_data: H needs a leading batch axis, "
                         f"(B, nz, nz); got shape {Hn.shape}.")
    Bq, nz = Hn.shape[0], Hn.shape[1]
    if not np.allclose(Hn, np.swapaxes(Hn, 1, 2)):
        raise ValueError("H must be symmetric.")
    if A is None or b is None:
        raise ValueError(
            "A and b are required (nv >= 1), as in FBstabDense.")
    if G is None:
        G = np.zeros((Bq, 0, nz))
        h = np.zeros((Bq, 0))
    Gn, An = _as_numpy(G), _as_numpy(A)
    mask = lambda M: np.any(M != 0.0, axis=0)
    pat = SparsePattern(_csr_from_dense_mask(mask(Hn)),
                        _csr_from_dense_mask(mask(Gn)),
                        _csr_from_dense_mask(mask(An)), ordering=ordering)
    return pat, pattern_values(pat, Hn, f, Gn, h, An, b, dtype=dtype,
                               device=device)


def pattern_values(pat: SparsePattern, H, f, G, h, A, b,
                   dtype=torch.float64, device=None) -> SparseQPData:
    """Packs dense arrays with a leading batch axis into the value tensors
    for an existing pattern (entries outside the pattern must be zero).
    With no `device` the values go where H lies if it is a tensor, else
    on the card."""
    device = resolve_device(device, like=H)
    H, G, A = (_as_numpy(M) for M in (H, G, A))
    t = lambda a: torch.as_tensor(_as_numpy(a), dtype=dtype, device=device)

    def _pack(pat_m: _CSRPattern, M):
        return t(M[:, pat_m.row_ids, pat_m.indices])

    data = SparseQPData(Hx=_pack(pat.H, H), f=t(f), Gx=_pack(pat.G, G),
                        h=t(h), Ax=_pack(pat.A, A), b=t(b))
    _check_data(pat, data, "pattern_values", H.shape[0])
    return data


# ----------------------------------------------------------------------
# MPC -> sparse bridge: the block-banded MPC QP built directly as CSR
# patterns and values, with no dense (nz x nz) materialization. The
# pattern depends only on the stage dims (structural zeros inside stage
# blocks are kept), so one pattern serves every instance of a shape.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def mpc_sparse_pattern(N: int, nx: int, nu: int, nc: int,
                       ordering: str = "rcm") -> "SparsePattern":
    """SparsePattern of the MPC QP with horizon N and stage dims
    (nx, nu, nc): H block-diagonal with (nx+nu) stage blocks, A
    block-diagonal with (nc, nx+nu) stage blocks, G the dynamics
    bidiagonal [A_{i-1} B_{i-1} | -I] (reference layout:
    mpc_data.cc:107-151 / tests/test_mpc_solve.py::materialize)."""
    ns = nx + nu
    nz, nl, nv = (N + 1) * ns, (N + 1) * nx, (N + 1) * nc

    # H: dense (ns, ns) block per stage, row-major within the block.
    h_indptr = np.arange(nz + 1, dtype=np.int64) * ns
    h_indices = np.concatenate([
        np.tile(np.arange(i * ns, (i + 1) * ns, dtype=np.int64), ns)
        for i in range(N + 1)]) if nz else np.zeros(0, np.int64)

    # A: dense (nc, ns) block per stage.
    a_indptr = np.arange(nv + 1, dtype=np.int64) * ns
    a_indices = np.concatenate([
        np.tile(np.arange(i * ns, (i + 1) * ns, dtype=np.int64), nc)
        for i in range(N + 1)]) if nv else np.zeros(0, np.int64)

    # G: block row 0 is -I on x_0; block row i >= 1 is
    # [A_{i-1} B_{i-1}] on stage i-1 plus -I on x_i (diagonal entry per
    # row, stored last so each row is sorted).
    g_indptr = [0]
    g_indices = []
    for r in range(nx):                      # block 0
        g_indices.append(r)
        g_indptr.append(len(g_indices))
    for i in range(1, N + 1):
        prev = (i - 1) * ns
        for r in range(nx):
            g_indices.extend(range(prev, prev + ns))
            g_indices.append(i * ns + r)
            g_indptr.append(len(g_indices))
    return SparsePattern(
        _csr_pattern(h_indptr, h_indices, nz, nz),
        _csr_pattern(np.asarray(g_indptr, np.int64),
                     np.asarray(g_indices, np.int64), nl, nz),
        _csr_pattern(a_indptr, a_indices, nv, nz),
        ordering=ordering)


def mpc_sparse_values(data) -> SparseQPData:
    """Packs the port's batched MpcQPData into the value tensors for
    `mpc_sparse_pattern` of the same dims (entry order matches the
    pattern's construction), on the data's device."""
    Q, R, S = data.Q, data.R, data.S
    Bq, Np1, nx = Q.shape[0], Q.shape[1], Q.shape[2]
    # H stage blocks [[Q, S'], [S, R]], row-major.
    top = torch.cat([Q, S.transpose(-1, -2)], dim=-1)
    bot = torch.cat([S, R], dim=-1)
    Hx = torch.cat([top, bot], dim=-2).reshape(Bq, -1)
    # A stage blocks [E, L].
    Ax = torch.cat([data.E, data.L], dim=-1).reshape(Bq, -1)
    # G: -I block, then per-stage [A B | -1-diagonal].
    neg1 = torch.full((Bq, Np1 - 1, nx, 1), -1.0, dtype=Q.dtype,
                      device=Q.device)
    body = torch.cat([data.A, data.B, neg1], dim=-1).reshape(Bq, -1)
    Gx = torch.cat([torch.full((Bq, nx), -1.0, dtype=Q.dtype,
                               device=Q.device), body], dim=1)
    f = torch.cat([data.q, data.r], dim=-1).reshape(Bq, -1)
    h = -torch.cat([data.x0, data.c.reshape(Bq, -1)], dim=1)
    b = -data.d.reshape(Bq, -1)
    return SparseQPData(Hx=Hx, f=f, Gx=Gx, h=h, Ax=Ax, b=b)


# ----------------------------------------------------------------------
# ProblemOps over a static pattern.
# ----------------------------------------------------------------------

def _ell_sum(terms, ell):
    """terms (B, T) summed into (B, n_out) along the ELL table (n_out,
    w), whose padding points at an appended zero term. The sum runs left
    to right over the table's columns, each term in the order of its
    entry (a scatter-add's order on the CPU, and the JAX package's), so
    it gives the same bits on the CPU and on the card."""
    padded = torch.cat([terms, terms.new_zeros(terms.shape[0], 1)], 1)
    g = padded[:, ell]
    acc = g[..., 0]
    for j in range(1, ell.shape[1]):
        acc = acc + g[..., j]
    return acc


def _gemv(ix: _Index, name: str, vals, x):
    """Batched CSR product y = M x of the pattern's matrix `name`: vals
    (B, nnz), x (B, n) -> (B, m)."""
    cols = getattr(ix, name + "_cols")
    return _ell_sum(vals * x[:, cols], getattr(ix, name + "_row_ell"))


def _gemv_t(ix: _Index, name: str, vals, y):
    """Batched transposed CSR product x = M' y: (B, m) -> (B, n)."""
    rows = getattr(ix, name + "_rows")
    return _ell_sum(vals * y[:, rows], getattr(ix, name + "_col_ell"))


def _assemble(pat: SparsePattern, ix: _Index, d: SparseQPData, Gamma,
              sigma):
    """Upper-triangular values (B, knnz) of K = [H + sigma I +
    A' diag(Gamma) A, G'; G, -sigma I]: every contribution, in the order
    H, A'GA, G, +sigma, -sigma, summed into its entry."""
    B, dtype, dev = d.f.shape[0], d.f.dtype, d.f.device
    sig = _lane_sigma(sigma, d.f)
    ones = lambda n: torch.ones(B, n, dtype=dtype, device=dev)
    parts = torch.cat([
        d.Hx[:, ix.h_src],
        Gamma[:, ix.a_row] * d.Ax[:, ix.a_src1] * d.Ax[:, ix.a_src2],
        d.Gx[:, ix.g_src], sig * ones(pat.nz), -sig * ones(pat.nl)], 1)
    return _ell_sum(parts, ix.k_ell)


class SparseFactorization(NamedTuple):
    Lx: torch.Tensor     # (B, nnz(L))
    Dinv: torch.Tensor   # (B, nz + nl)
    ok: torch.Tensor     # (B,) bool
    gamma: torch.Tensor  # (B, nv)
    mus: torch.Tensor    # (B, nv)


def _weights(x, xbar, sigma, alpha):
    return pfb_weights(x.y, x.v, xbar.v, _lane_sigma(sigma, x.v), alpha)


def _rhs(pat, ix, d, rz, rl, rv, mus):
    """The KKT right-hand side [rz - A'(rv ./ mus); -rl] in the
    factorization's order."""
    r1 = rz - _gemv_t(ix, "A", d.Ax, rv / mus)
    return torch.cat([r1, -rl], 1)[:, ix.perm]


def _recover(pat, ix, d, sol, rv, gamma, mus) -> Variable:
    """(dz, dl) from the solution in the factorization's order, then the
    dual recovery dv = (rv + gamma A dz) / mus and dy = b - A dz."""
    dzl = sol[:, ix.iperm]
    dz, dl = dzl[:, :pat.nz], dzl[:, pat.nz:]
    Adz = _gemv(ix, "A", d.Ax, dz)
    dv = (rv + gamma * Adz) / mus
    return Variable(z=dz, l=dl, v=dv, y=d.b - Adz)


def factor(pat: SparsePattern, d: SparseQPData, x: Variable, xbar: Variable,
           sigma, alpha) -> SparseFactorization:
    """The first call of the three-call contract: K's values assembled on
    the data's device, factored on the host (one round trip)."""
    ix = pat.index(d.f.device)
    gamma, mus, Gamma = _weights(x, xbar, sigma, alpha)
    Kv = _assemble(pat, ix, d, Gamma, sigma)
    (Lx, Dinv, ok), _ = pat.round_trip(pat._host_factor, Kv)
    return SparseFactorization(
        Lx=pat.to_device(Lx, Kv), Dinv=pat.to_device(Dinv, Kv),
        ok=torch.from_numpy(ok).to(Kv.device), gamma=gamma, mus=mus)


def factor_ok(fact: SparseFactorization):
    """Per lane: the factorization succeeded."""
    return fact.ok


def newton_solve(pat: SparsePattern, d: SparseQPData,
                 fact: SparseFactorization, rz, rl, rv) -> Variable:
    """The Newton step from a factorization: the KKT solve on the host
    (one round trip), permuted into the factorization's order and back."""
    ix = pat.index(d.f.device)
    rhs = _rhs(pat, ix, d, rz, rl, rv, fact.mus)
    _, (_, _, xB) = pat.round_trip(pat._host_solve, fact.Lx, fact.Dinv, rhs)
    return _recover(pat, ix, d, pat.to_device(xB, rhs), rv, fact.gamma,
                    fact.mus)


def newton_step(pat: SparsePattern, d: SparseQPData, x: Variable,
                xbar: Variable, sigma, alpha, rz, rl, rv):
    """The fused Newton step: factor and solve in one host round trip.
    Returns (dx, ok)."""
    ix = pat.index(d.f.device)
    gamma, mus, Gamma = _weights(x, xbar, sigma, alpha)
    Kv = _assemble(pat, ix, d, Gamma, sigma)
    rhs = _rhs(pat, ix, d, rz, rl, rv, mus)
    ok, (_, xB) = pat.round_trip(pat._host_factor_solve, Kv, rhs)
    dx = _recover(pat, ix, d, pat.to_device(xB, rhs), rv, gamma, mus)
    return dx, torch.from_numpy(ok).to(rhs.device)


def _make_ops(pat: SparsePattern) -> ProblemOps:
    """The ProblemOps bundle of one pattern: batched CSR products and the
    fused host Newton step."""
    def prod(name, transpose=False):
        def gemv(d, x):
            fn = _gemv_t if transpose else _gemv
            return fn(pat.index(x.device), name, getattr(d, name + "x"), x)
        return gemv

    def forcing_norm(d):
        sq = lambda a: (a * a).sum(-1)
        return torch.sqrt(sq(d.f) + sq(d.h) + sq(d.b))

    return ProblemOps(
        gemvH=prod("H"), gemvA=prod("A"), gemvG=prod("G"),
        gemvAT=prod("A", True), gemvGT=prod("G", True),
        f_vec=lambda d: d.f, h_vec=lambda d: d.h, b_vec=lambda d: d.b,
        forcing_norm=forcing_norm,
        newton_step=functools.partial(newton_step, pat),
    )


# ----------------------------------------------------------------------
# Entry points and facade.
# ----------------------------------------------------------------------

def solve_sparse_qp(pattern: SparsePattern, data: SparseQPData,
                    z0, l0, v0, options: Options = Options()):
    """Single-instance sparse solve: `data` with a batch of one, guesses
    z0 (nz,), l0 (nl,), v0 (nv,). Returns lane 0's (Variable, CoreOut),
    unbatched."""
    return fbstab_solve(pattern.ops, data, z0, l0, v0, options)


def solve_sparse_qp_batch(pattern: SparsePattern, data: SparseQPData,
                          z0, l0, v0, options: Options = Options()):
    """Batched sparse solve (shared pattern, batched values and guesses):
    the masked-lockstep core; each Newton step hands the host the whole
    batch of KKT systems in one round trip."""
    return fbstab_solve_batch(pattern.ops, data, z0, l0, v0, options)


class FBstabSparse:
    """Allocate-once/solve-many facade for sparse QPs, shaped like
    FBstabDense: made per problem structure (a SparsePattern), it solves
    one value instance at a time (SparseQPData with a batch of one), on
    the card unless given device="cpu"; warmstart by passing the previous
    solution. `stream` (keyword-only, as `device`): the OutputStream
    (utils/printing.py) that receives the Display.ITER / ITER_DETAILED
    tables and the FINAL summary; None prints them to stdout."""

    def __init__(self, pattern: SparsePattern,
                 options: Optional[Options] = None, *, stream=None,
                 device=None):
        self.pattern = pattern
        self._options = options if options is not None else Options()
        self._stream = stream
        self.device = resolve_device(device)

    def update_options(self, options: Options) -> None:
        self._options = options.validated()

    @staticmethod
    def default_options() -> Options:
        return Options.default()

    @staticmethod
    def reliable_options() -> Options:
        return Options.reliable()

    def solve(self, data: SparseQPData, x0: Optional[Variable] = None,
              stream=None) -> "tuple[Variable, SolverOut]":
        """Solves one QP from the warmstart x0 (the origin if omitted;
        fields with a batch of one); returns lane 0's result with its
        batch axis, as FBstabDense does."""
        pat = self.pattern
        _check_data(pat, data, "FBstabSparse.solve", 1)
        dev = data.f.device
        if dev.type != self.device.type:
            raise ValueError(f"FBstabSparse.solve: the data lies on {dev}, "
                             f"the solver was made for {self.device}.")
        zeros = lambda n: torch.zeros(1, n, dtype=data.f.dtype, device=dev)
        if x0 is None:
            x0 = Variable(z=zeros(pat.nz), l=zeros(pat.nl), v=zeros(pat.nv),
                          y=zeros(pat.nv))
        t0 = time.perf_counter()
        x, core = fbstab_solve_batch(pat.ops, data, x0.z, x0.l, x0.v,
                                     self._options, self._stream)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = facade_out(core, time.perf_counter() - t0)
        facade_print_final(pat.ops, data, x, out, self._options,
                           stream or self._stream)
        return x, out


__all__ = [
    "FBstabSparse", "HostSplit", "SparseFactorization", "SparsePattern",
    "SparseQPData", "factor", "factor_ok", "mpc_sparse_pattern",
    "mpc_sparse_values", "newton_solve", "newton_step", "pattern_values",
    "solve_sparse_qp", "solve_sparse_qp_batch", "sparse_qp_data",
]

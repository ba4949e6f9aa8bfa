"""Sparse quasi-definite LDL' factorization on the host (counterpart of
`fbstab_tpu/utils/sparse_ldl.py`).

The three-phase contract of the reference's QdldlWrapper
(tools/qdldl/qdldl_wrapper.h:19): symbolic analysis (elimination tree and
column counts) at construction for a fixed upper-triangular CSC pattern,
`factor(Ax)` for each new set of values, and an in-place `solve(b)`. The
factorization is the up-looking sparse LDL' (Davis, "Direct Methods for
Sparse Linear Systems", Algorithm 8.1), twice behind one class: the native
C kernel (the port's `native/sparse_ldl.c` through utils/native_ldl.py),
which the sparse QP class runs, and a pure-NumPy version, the plain
version the tests hold the C kernel to bit for bit.

A is symmetric quasi-definite, with ONLY the upper triangle stored in CSC
(column pointers Ap, row indices Ai, values Ax), diagonal included.

One departure from the JAX package, decided on purpose: its "auto"
backend falls back to NumPy when no C compiler is found; here "auto" means
the native kernel, and raises where the C source does not build.
"""

from __future__ import annotations

import numpy as np

from fbstab_tpu_torch.utils import native_ldl


class SparseLDL:
    """Up-looking LDL' of a fixed upper-triangular CSC pattern.

    ``backend``: "native" or "auto" (the C kernel; raises if it does not
    build), or "python" (pure NumPy, the plain version). Both backends
    produce identical factors and obey the same error contract.
    """

    def __init__(self, n: int, Ap, Ai, backend: str = "auto"):
        self.n = int(n)
        # Contiguity matters: the native backend hands raw data pointers
        # to C, which would read a strided view's base buffer wrong.
        self.Ap = np.ascontiguousarray(Ap, np.int64)
        self.Ai = np.ascontiguousarray(Ai, np.int64)
        if self.Ap.shape != (self.n + 1,):
            raise ValueError("Ap must have length n+1.")
        if self.Ai.shape != (int(self.Ap[-1]),):
            raise ValueError(
                f"Ai must have length Ap[n] = {int(self.Ap[-1])}.")
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"Unknown backend {backend!r}.")
        self._native = backend != "python"
        if self._native:
            native_ldl.load()
        self.backend = "native" if self._native else "python"
        for j in range(self.n):
            rows = self.Ai[self.Ap[j]:self.Ap[j + 1]]
            if rows.size == 0 or rows[-1] != j:
                raise ValueError(
                    "Each column must be upper-triangular with an explicit "
                    f"diagonal entry (column {j}).")

        # Symbolic analysis: elimination tree + column counts of L
        # (the role of QDLDL_etree, qdldl_wrapper.h:24-45).
        n_ = self.n
        if self._native:
            parent, Lnz, _ = native_ldl.etree(n_, self.Ap, self.Ai)
            self._ws = native_ldl._Workspace(n_)
        else:
            parent = np.full(n_, -1, np.int64)
            flag = np.full(n_, -1, np.int64)
            Lnz = np.zeros(n_, np.int64)
            for k in range(n_):
                flag[k] = k
                for p in range(self.Ap[k], self.Ap[k + 1]):
                    i = self.Ai[p]
                    if i >= k:
                        continue
                    while flag[i] != k:
                        if parent[i] == -1:
                            parent[i] = k
                        Lnz[i] += 1
                        flag[i] = k
                        i = parent[i]
        self.parent = parent
        self.nnz = int(Lnz.sum())
        self.Lp = np.zeros(n_ + 1, np.int64)
        np.cumsum(Lnz, out=self.Lp[1:])
        self.Li = np.zeros(self.nnz, np.int64)
        self.Lx = np.zeros(self.nnz, float)
        self.D = np.zeros(n_, float)
        self.Dinv = np.zeros(n_, float)
        self._factored = False

    def factor(self, Ax) -> None:
        """Numeric factorization A = L D L' for values Ax matching the
        analyzed pattern (the role of QdldlWrapper::Factor)."""
        Ax = np.ascontiguousarray(Ax, float)
        if Ax.shape != (int(self.Ap[-1]),):
            raise ValueError(
                f"Ax must have length Ap[n] = {int(self.Ap[-1])}.")
        if self._native:
            native_ldl.factor(self.n, self.Ap, self.Ai, Ax, self.parent,
                              self.Lp, self.Li, self.Lx, self.D,
                              self.Dinv, self._ws)
            self._factored = True
            return
        n, Ap, Ai, parent = self.n, self.Ap, self.Ai, self.parent
        Lp, Li, Lx, D = self.Lp, self.Li, self.Lx, self.D
        Y = np.zeros(n, float)
        pattern = np.zeros(n, np.int64)
        flag = np.full(n, -1, np.int64)
        Lnz = np.zeros(n, np.int64)

        for k in range(n):
            top = n
            flag[k] = k
            D[k] = 0.0
            for p in range(Ap[k], Ap[k + 1]):
                i = Ai[p]
                if i > k:
                    raise ValueError("Lower-triangular entry in input.")
                Y[i] += Ax[p]
                ln = 0
                while flag[i] != k:
                    pattern[ln] = i
                    ln += 1
                    flag[i] = k
                    i = parent[i]
                # Prepend this path (deepest-last) to the pattern stack.
                while ln > 0:
                    top -= 1
                    ln -= 1
                    pattern[top] = pattern[ln]
            D[k] += Y[k]
            Y[k] = 0.0
            # Sparse triangular solve along the pattern, updating column
            # k's entries of L and the pivot D[k].
            for t in range(top, n):
                i = pattern[t]
                yi = Y[i]
                Y[i] = 0.0
                for p in range(Lp[i], Lp[i] + Lnz[i]):
                    Y[Li[p]] -= Lx[p] * yi
                lki = yi / D[i]
                D[k] -= lki * yi
                q = Lp[i] + Lnz[i]
                Li[q] = k
                Lx[q] = lki
                Lnz[i] += 1
            if D[k] == 0.0:
                raise ZeroDivisionError(
                    f"Zero pivot at column {k}: matrix is not "
                    "quasi-definite with this ordering.")
            self.Dinv[k] = 1.0 / D[k]
        self._factored = True

    def solve(self, x: np.ndarray) -> None:
        """In-place solve (L D L') x = b (the role of
        QdldlWrapper::Solve, qdldl_wrapper.h:57-61)."""
        if not self._factored:
            raise RuntimeError("factor() must be called before solve().")
        if x.shape != (self.n,):
            raise ValueError(f"x must have shape ({self.n},).")
        if self._native:
            if not (isinstance(x, np.ndarray) and x.dtype == np.float64
                    and x.flags.c_contiguous):
                raise ValueError("solve() needs a contiguous float64 array.")
            native_ldl.solve(self.n, self.Lp, self.Li, self.Lx,
                             self.Dinv, x)
            return
        n, Lp, Li, Lx = self.n, self.Lp, self.Li, self.Lx
        # L y = b (unit lower triangular, stored by columns)
        for j in range(n):
            xj = x[j]
            for p in range(Lp[j], Lp[j + 1]):
                x[Li[p]] -= Lx[p] * xj
        x *= self.Dinv
        # L' z = y
        for j in range(n - 1, -1, -1):
            acc = 0.0
            for p in range(Lp[j], Lp[j + 1]):
                acc += Lx[p] * x[Li[p]]
            x[j] -= acc

    def factor_solve_batch(self, AxB: np.ndarray, xB: np.ndarray) -> int:
        """Factor+solve a batch of systems sharing this pattern: AxB is
        (batch, nnz(A)) values, xB (batch, n) right-hand sides solved in
        place. Returns 0, or the 1-based column of the first zero pivot
        (that instance's rhs is left untouched). One native call for the
        whole batch."""
        AxB = np.ascontiguousarray(AxB, float)
        if xB.dtype != np.float64 or not xB.flags.c_contiguous:
            raise ValueError("xB must be a contiguous float64 array.")
        annz = int(self.Ap[-1])
        if AxB.ndim != 2 or AxB.shape[1] != annz:
            raise ValueError(f"AxB must have shape (batch, {annz}).")
        if xB.shape != (AxB.shape[0], self.n):
            raise ValueError(
                f"xB must have shape ({AxB.shape[0]}, {self.n}).")
        if self._native:
            st = native_ldl.factor_solve_batch(
                self.n, self.Ap, self.Ai, AxB, self.parent, self.Lp,
                self.Li, self.Lx, self.D, self.Dinv, self._ws, xB)
            # Lx/D/Dinv hold the last instance's factor, as on the
            # python path (identical backend contract for solve()).
            self._factored = True
            return st
        first_bad = 0
        for b in range(AxB.shape[0]):
            try:
                self.factor(AxB[b])
            except ZeroDivisionError:
                bad_col = 1 + int(np.flatnonzero(self.D == 0.0)[0])
                if first_bad == 0:
                    first_bad = bad_col
                continue
            self.solve(xB[b])
        return first_bad

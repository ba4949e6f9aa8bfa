/* The port's copy of the native sparse LDL' kernel.
 *
 * Carried over unchanged from fbstab_tpu/native/sparse_ldl.c (the JAX
 * package's host kernel, from the line "Sparse quasi-definite LDL'" on),
 * so that the port factors every KKT matrix bit for bit as the JAX
 * package does; tests/test_torch_sparse.py holds the two files equal
 * below this header. The port builds it with the host C compiler into
 * fbstab_tpu_torch/_build/ (fbstab_tpu_torch/utils/native_ldl.py); where
 * the text below names fbstab_tpu/utils/native_ldl.py or sparse_ldl.py,
 * read the port's modules of the same names.
 */

/* Sparse quasi-definite LDL' factorization — native host kernel.
 *
 * C implementation of the same three-phase contract as
 * fbstab_tpu/utils/sparse_ldl.py (the TPU-framework analog of the
 * reference's QdldlWrapper, tools/qdldl/qdldl_wrapper.h:19, whose hot
 * path is likewise a C library): symbolic elimination-tree analysis for
 * a fixed upper-triangular CSC pattern, up-looking numeric
 * factorization A = L D L', and an in-place triangular solve.
 *
 * Algorithm: classic up-looking sparse LDL' (Davis, "Direct Methods for
 * Sparse Linear Systems", Alg. 8.1). Indices are int64 to match the
 * NumPy arrays the ctypes binding passes straight through; no memory is
 * allocated here — the caller owns every buffer, so factor/solve are
 * allocation-free exactly like the reference wrapper's Factor/Solve.
 *
 * Build: compiled lazily by fbstab_tpu/utils/native_ldl.py with the
 * system C compiler into a private shared object; there is no external
 * dependency.
 */

#include <stdint.h>

typedef int64_t idx;

/* Elimination tree + column counts of L for an upper-triangular CSC
 * pattern (Ap, Ai) with explicit diagonals.
 *
 * Outputs: parent[n] (etree, -1 = root), Lnz[n] (strictly-below-diagonal
 * entries per column of L), work[n] scratch.
 * Returns total nnz(L) >= 0, or -(k+1) if column k is malformed
 * (empty, diagonal not last, or a row index out of [0, k]). Row order
 * within a column is otherwise not required.
 */
int64_t fbstab_ldl_etree(idx n, const idx *Ap, const idx *Ai,
                         idx *parent, idx *Lnz, idx *work) {
  idx k, p, i;
  int64_t nnz = 0;
  for (k = 0; k < n; k++) {
    parent[k] = -1;
    work[k] = -1; /* flag: last column that touched row k */
    Lnz[k] = 0;
  }
  for (k = 0; k < n; k++) {
    idx lo = Ap[k], hi = Ap[k + 1];
    if (hi <= lo || Ai[hi - 1] != k) return -(int64_t)(k + 1);
    work[k] = k;
    for (p = lo; p < hi; p++) {
      i = Ai[p];
      if (i > k || i < 0) return -(int64_t)(k + 1);
      if (i == k) continue;
      /* Walk up the etree from i, marking the path with k. */
      while (work[i] != k) {
        if (parent[i] == -1) parent[i] = k;
        Lnz[i]++;
        work[i] = k;
        i = parent[i];
      }
    }
  }
  for (k = 0; k < n; k++) nnz += Lnz[k];
  return nnz;
}

/* Up-looking numeric factorization A = L D L'.
 *
 * Inputs: pattern (Ap, Ai), values Ax, etree parent, column pointers
 * Lp[n+1] (exclusive prefix sum of the symbolic Lnz).
 * Outputs: Li/Lx (nnz(L)), D[n], Dinv[n].
 * Scratch (caller-allocated, each length n): Y (doubles, must be
 * zero-initialized by the caller on first use — this function leaves it
 * zeroed), pattern_stack, flag, Lnz_cur (int64).
 * Returns 0 on success, k+1 on a zero pivot in column k.
 */
int64_t fbstab_ldl_factor(idx n, const idx *Ap, const idx *Ai,
                          const double *Ax, const idx *parent,
                          const idx *Lp, idx *Li, double *Lx,
                          double *D, double *Dinv, double *Y,
                          idx *pattern_stack, idx *flag, idx *Lnz_cur) {
  idx k, p, i, t, top, ln, q;
  for (k = 0; k < n; k++) {
    Y[k] = 0.0;
    flag[k] = -1;
    Lnz_cur[k] = 0;
  }
  for (k = 0; k < n; k++) {
    top = n;
    flag[k] = k;
    D[k] = 0.0;
    for (p = Ap[k]; p < Ap[k + 1]; p++) {
      i = Ai[p];
      Y[i] += Ax[p];
      /* Record the (reversed) etree path from i in the stack so the
       * sparse triangular solve visits rows in topological order. */
      ln = 0;
      while (flag[i] != k) {
        pattern_stack[ln++] = i;
        flag[i] = k;
        i = parent[i];
      }
      while (ln > 0) pattern_stack[--top] = pattern_stack[--ln];
    }
    D[k] += Y[k];
    Y[k] = 0.0;
    for (t = top; t < n; t++) {
      i = pattern_stack[t];
      double yi = Y[i];
      Y[i] = 0.0;
      idx end = Lp[i] + Lnz_cur[i];
      for (p = Lp[i]; p < end; p++) Y[Li[p]] -= Lx[p] * yi;
      double lki = yi / D[i];
      D[k] -= lki * yi;
      q = Lp[i] + Lnz_cur[i];
      Li[q] = k;
      Lx[q] = lki;
      Lnz_cur[i]++;
    }
    if (D[k] == 0.0) return (int64_t)(k + 1);
    Dinv[k] = 1.0 / D[k];
  }
  return 0;
}

/* In-place solve (L D L') x = b. L is unit lower triangular in CSC
 * (columns hold the strictly-below-diagonal entries). */
void fbstab_ldl_solve(idx n, const idx *Lp, const idx *Li,
                      const double *Lx, const double *Dinv, double *x) {
  idx j, p;
  for (j = 0; j < n; j++) {
    double xj = x[j];
    for (p = Lp[j]; p < Lp[j + 1]; p++) x[Li[p]] -= Lx[p] * xj;
  }
  for (j = 0; j < n; j++) x[j] *= Dinv[j];
  for (j = n - 1; j >= 0; j--) {
    double acc = 0.0;
    for (p = Lp[j]; p < Lp[j + 1]; p++) acc += Lx[p] * x[Li[p]];
    x[j] -= acc;
  }
}

/* Batched driver: factor+solve nrhs systems sharing one pattern but
 * distinct values/rhs — the shape a sparse FBstab path would feed
 * (one KKT system per QP instance). Amortizes the ctypes call overhead
 * over the batch. Values are (batch, annz) row-major; rhs (batch, n).
 * Returns 0, or the first nonzero factor status encountered (and skips
 * the solve for that instance, leaving its rhs untouched). */
int64_t fbstab_ldl_factor_solve_batch(
    idx batch, idx n, const idx *Ap, const idx *Ai, const double *Ax,
    const idx *parent, const idx *Lp, idx *Li, double *Lx, double *D,
    double *Dinv, double *Y, idx *pattern_stack, idx *flag, idx *Lnz_cur,
    double *x, idx annz) {
  int64_t first_bad = 0;
  idx b;
  for (b = 0; b < batch; b++) {
    int64_t st = fbstab_ldl_factor(n, Ap, Ai, Ax + b * annz, parent, Lp,
                                   Li, Lx, D, Dinv, Y, pattern_stack,
                                   flag, Lnz_cur);
    if (st != 0) {
      if (first_bad == 0) first_bad = st;
      continue;
    }
    fbstab_ldl_solve(n, Lp, Li, Lx, Dinv, x + b * n);
  }
  return first_bad;
}

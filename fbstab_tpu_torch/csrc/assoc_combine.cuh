// The span combination of the associative Riccati scan for one (pair,
// instance): the device function of K5 (assoc_combine.cu), plain C++
// behind FB_DEV like the other headers so that it replays on the CPU.
//
// Two adjacent span elements F(a, b) = 1/2 a'P11 a + a'P12 b + 1/2 b'P22 b
// + p1'a + p2'b (left: stages i..j, right: j+1..k) are combined by
// minimizing over the shared boundary state (fbstab_tpu/ops/
// assoc_riccati.py::_combine_bl and its Pallas kernel _make_combine_kernel):
//   K = P22_l + P11_r,
//   P11 = P11_l - P12_l K^-1 P12_l',   P12 = -P12_l K^-1 P12_r,
//   P22 = P22_r - P12_r' K^-1 P12_r,
//   p1 = p1_l - P12_l K^-1 w,          p2 = p2_r - P12_r' K^-1 w,
//   w = p2_l + p1_r,
// with the diagonal blocks symmetrized. Each K^-1 is a Jacobi-equilibrated
// Cholesky solve (s = 1 / sqrt(|diag K| + tiny), solve with s K s): K's
// diagonal mixes 1/sigma prox entries with O(1) curvature, and the scaling
// keeps the pivots of one magnitude. A failed factorization gives NaNs.
//
// The work is split over the (pair, instance)'s team (fbstab_common.cuh):
// K, s and s K s elementwise, the Cholesky column by column, the 2n + 1
// right-hand sides (the columns of P12_l' and P12_r, and w) whole, each
// solved by one thread against the shared factor, and the products by
// output entry. Every output entry is computed by one thread in the team
// of one's order, so the outputs are bit for bit the team of one's.
//
// A team that stages copies its operands into a stage block (in shared
// memory on the card) with contiguous loads, works there, computes the
// outputs in place of their inputs' copies (P11, P22, p1, p2; P12 in the
// factor's place) and writes them home with contiguous stores. A team
// that does not stage (the team of one) reads the operands where they
// lie, keeps the factor, the solves and the scales in its scratch and
// writes the outputs directly.
#pragma once

#include "fbstab_common.cuh"

// Added to |K_ii| before the inverse square root (the smallest normal
// float32, jnp.finfo(float32).tiny).
#ifndef FB_TINY
#define FB_TINY 1.17549435e-38f
#endif

// The five blocks of one span element at one (pair, instance): n x n
// row-major matrices and n-vectors.
struct Span {
  Lane P11, P12, P22, p1, p2;
};

// Offsets (floats) in a team's stage block, or its scratch if it does not
// stage: the factor of s K s, K^-1 P12_l', K^-1 P12_r, K^-1 w and the
// scales s; for a team that stages, then the copies of P12_l, P12_r,
// P11_l, P22_r, p1_l and p2_r.
struct CombineLayout {
  int L, X1, X2, w, s, A, Bm, P11, P22, p1, p2, total;
};

FB_HD CombineLayout combine_layout(int n, bool stages) {
  const int nn = n * n;
  CombineLayout c;
  int o = 0;
  c.L = o;   o += nn;
  c.X1 = o;  o += nn;
  c.X2 = o;  o += nn;
  c.w = o;   o += n;
  c.s = o;   o += n;
  c.A = c.Bm = c.P11 = c.P22 = c.p1 = c.p2 = o;
  if (stages) {
    c.A = o;   o += nn;
    c.Bm = o;  o += nn;
    c.P11 = o; o += nn;
    c.P22 = o; o += nn;
    c.p1 = o;  o += n;
    c.p2 = o;  o += n;
  }
  c.total = o;
  return c;
}

template <class Tm>
FB_DEV void assoc_combine_team(const Tm& tm, int n, const Span& l,
                               const Span& r, const Span& o, Lane st) {
  const int T = tm.size(), me = tm.rank(), nn = n * n;
  const CombineLayout c = combine_layout(n, Tm::kStages);
  const Lane L = st.at(c.L), X1 = st.at(c.X1), X2 = st.at(c.X2),
             w = st.at(c.w), s = st.at(c.s);
  // The operands the products read (copies for a team that stages), and
  // where each output is computed: in place of its input's copy, P12 in
  // the factor's place, for a team that stages; at home otherwise.
  const Lane A = fb_stage_in(tm, st.at(c.A), l.P12, nn);
  const Lane Bm = fb_stage_in(tm, st.at(c.Bm), r.P12, nn);
  const Lane P11 = fb_stage_in(tm, st.at(c.P11), l.P11, nn);
  const Lane P22 = fb_stage_in(tm, st.at(c.P22), r.P22, nn);
  const Lane p1 = fb_stage_in(tm, st.at(c.p1), l.p1, n);
  const Lane p2 = fb_stage_in(tm, st.at(c.p2), r.p2, n);
  const Lane oP11 = fb_work(tm, P11, o.P11), oP22 = fb_work(tm, P22, o.P22),
             oP12 = fb_work(tm, L, o.P12), op1 = fb_work(tm, p1, o.p1),
             op2 = fb_work(tm, p2, o.p2);
  // K = P22_l + P11_r, w = p2_l + p1_r, the scales, and s K s.
  for (int k = me; k < nn; k += T) L[k] = l.P22[k] + r.P11[k];
  for (int i = me; i < n; i += T) w[i] = l.p2[i] + r.p1[i];
  tm.sync();
  for (int i = me; i < n; i += T)
    s[i] = 1.0f / sqrtf(fabsf(L[i * n + i]) + FB_TINY);
  tm.sync();
  for (int k = me; k < nn; k += T) L[k] = (L[k] * s[k / n]) * s[k % n];
  tm.sync();
  fb_chol(tm, L, n);
  // X1 = K^-1 P12_l', X2 = K^-1 P12_r, w <- K^-1 w: x <- s .* inv(L L')
  // (s .* x), each right-hand side by one thread.
  for (int j = me; j <= 2 * n; j += T) {
    Lane x = j < n ? fb_col(X1, n, j)
                   : (j < 2 * n ? fb_col(X2, n, j - n) : w);
    for (int i = 0; i < n; ++i) {
      float b = j < n ? A[j * n + i]
                      : (j < 2 * n ? Bm[i * n + (j - n)] : x[i]);
      x[i] = b * s[i];
    }
    fb_cho_solve(Solo{}, L, n, x);
    for (int i = 0; i < n; ++i) x[i] = x[i] * s[i];
  }
  tm.sync();
  // The products, by output entry. Entry (i, j) of P12; for j >= i also
  // the pair (i, j), (j, i) of P11 and of P22, symmetrized as
  // (P + P') / 2 by the one thread that writes both (in place for a team
  // that stages: no other thread reads them).
  for (int k = me; k < nn; k += T) {
    const int i = k / n, j = k % n;
    float a = 0.0f;
    for (int m = 0; m < n; ++m) a += A[i * n + m] * X2[m * n + j];
    if (j >= i) {
      float aij = 0.0f, aji = 0.0f, bij = 0.0f, bji = 0.0f;
      for (int m = 0; m < n; ++m) {
        aij += A[i * n + m] * X1[m * n + j];
        aji += A[j * n + m] * X1[m * n + i];
        bij += Bm[m * n + i] * X2[m * n + j];
        bji += Bm[m * n + j] * X2[m * n + i];
      }
      const float p11 = 0.5f * ((P11[i * n + j] - aij) + (P11[j * n + i] - aji));
      const float p22 = 0.5f * ((P22[i * n + j] - bij) + (P22[j * n + i] - bji));
      oP11[i * n + j] = p11;
      oP11[j * n + i] = p11;
      oP22[i * n + j] = p22;
      oP22[j * n + i] = p22;
    }
    // The factor is read by no one after the solves.
    oP12[k] = -a;
  }
  for (int i = me; i < n; i += T) {
    float a = 0.0f, b = 0.0f;
    for (int m = 0; m < n; ++m) {
      a += A[i * n + m] * w[m];
      b += Bm[m * n + i] * w[m];
    }
    op1[i] = p1[i] - a;
    op2[i] = p2[i] - b;
  }
  tm.sync();
  fb_stage_out(tm, o.P11, oP11, nn);
  fb_stage_out(tm, o.P12, oP12, nn);
  fb_stage_out(tm, o.P22, oP22, nn);
  fb_stage_out(tm, o.p1, op1, n);
  fb_stage_out(tm, o.p2, op2, n);
}

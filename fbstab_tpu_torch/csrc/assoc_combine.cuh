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

// Floats of scratch per (pair, instance): the factor of K, K^-1 P12_l',
// K^-1 P12_r, K^-1 w and the scales s.
FB_HD long long assoc_combine_ws_floats(int n) {
  return 3LL * n * n + 2LL * n;
}

// x <- s .* K^-1 (s .* x) on the factor L of s K s, in place.
FB_DEV void fb_eq_solve(Lane L, Lane s, int n, Lane x) {
  for (int i = 0; i < n; ++i) x[i] = x[i] * s[i];
  fb_cho_solve(Solo{}, L, n, x);
  for (int i = 0; i < n; ++i) x[i] = x[i] * s[i];
}

FB_DEV void assoc_combine_lane(int n, const Span& l, const Span& r,
                               const Span& o, Lane ws) {
  const long long nn = (long long)n * n;
  Lane L = ws, X1 = ws.at(nn), X2 = ws.at(2 * nn), w = ws.at(3 * nn),
       s = ws.at(3 * nn + n);
  // K = P22_l + P11_r, its scales, and the factor of s K s.
  for (int i = 0; i < n; ++i)
    s[i] = 1.0f / sqrtf(fabsf(l.P22[i * n + i] + r.P11[i * n + i]) + FB_TINY);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      L[i * n + j] = ((l.P22[i * n + j] + r.P11[i * n + j]) * s[i]) * s[j];
  fb_chol(Solo{}, L, n);
  // X1 = K^-1 P12_l', X2 = K^-1 P12_r, w <- K^-1 (p2_l + p1_r).
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      X1[i * n + j] = l.P12[j * n + i];
      X2[i * n + j] = r.P12[i * n + j];
    }
  for (int j = 0; j < n; ++j) {
    fb_eq_solve(L, s, n, fb_col(X1, n, j));
    fb_eq_solve(L, s, n, fb_col(X2, n, j));
  }
  for (int i = 0; i < n; ++i) w[i] = l.p2[i] + r.p1[i];
  fb_eq_solve(L, s, n, w);
  // The six products; P11 and P22 symmetrized as (P + P') / 2.
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j) {
      float aij = 0.0f, aji = 0.0f, bij = 0.0f, bji = 0.0f;
      for (int k = 0; k < n; ++k) {
        aij += l.P12[i * n + k] * X1[k * n + j];
        aji += l.P12[j * n + k] * X1[k * n + i];
        bij += r.P12[k * n + i] * X2[k * n + j];
        bji += r.P12[k * n + j] * X2[k * n + i];
      }
      float p11 = 0.5f * ((l.P11[i * n + j] - aij) + (l.P11[j * n + i] - aji));
      float p22 = 0.5f * ((r.P22[i * n + j] - bij) + (r.P22[j * n + i] - bji));
      o.P11[i * n + j] = p11;
      o.P11[j * n + i] = p11;
      o.P22[i * n + j] = p22;
      o.P22[j * n + i] = p22;
    }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      float a = 0.0f;
      for (int k = 0; k < n; ++k) a += l.P12[i * n + k] * X2[k * n + j];
      o.P12[i * n + j] = -a;
    }
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < n; ++k) {
      a += l.P12[i * n + k] * w[k];
      b += r.P12[k * n + i] * w[k];
    }
    o.p1[i] = l.p1[i] - a;
    o.p2[i] = r.p2[i] - b;
  }
}

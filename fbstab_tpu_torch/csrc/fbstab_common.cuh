// Shared definitions of the FBstab CUDA kernels.
//
// Every per-instance array lives in device memory in batch-last layout:
// element k of instance b is at k * B + b, so the 32 threads of a warp
// (32 consecutive instances) touch 32 consecutive floats on every access.
// A `Lane` is the view of one instance's array.
//
// The device code is plain C++ behind FB_DEV, so the same headers also
// compile as host code for a CPU rehearsal of the arithmetic.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define FB_DEV __device__ __forceinline__
#define FB_HD __host__ __device__ __forceinline__
#else
#define FB_DEV inline
#define FB_HD inline
#endif

struct Lane {
  float* p;       // &array[0 * B + b]
  long long s;    // stride between consecutive elements: B
  FB_DEV float& operator[](long long i) const { return p[i * s]; }
  FB_DEV Lane at(long long off) const { return Lane{p + off * s, s}; }
};

FB_DEV Lane lane_of(const float* base, long long B, long long b) {
  return Lane{const_cast<float*>(base) + b, B};
}

struct MpcDims {
  int N, nx, nu, nc;
};

// Batch-last MPC data at one instance (stage blocks row-major):
// Q (N+1,nx,nx), R (N+1,nu,nu), S (N+1,nu,nx), q (N+1,nx), r (N+1,nu),
// A (N,nx,nx), B (N,nx,nu), c (N,nx), E (N+1,nc,nx), L (N+1,nc,nu),
// d (N+1,nc), x0 (nx).
struct MpcProb {
  Lane Q, R, S, q, r, A, B, c, E, L, d, x0;
};

// Primal-dual point: z (N+1, nx+nu) stage-major, l (N+1, nx),
// v and y (N+1, nc).
struct Vars {
  Lane z, l, v, y;
};

// Zero tolerance of the PFB gradient (dense_cholesky_solver.h:94).
#define FB_ZERO_TOL 1e-13f

// PFB gradient weights (gamma, mus) at ys = y + sigma (v - vbar)
// (riccati_linear_solver.cc:91-99, dense_cholesky_solver.cc:129-148).
FB_DEV void fb_pfb_weights(float ys, float v, float sigma, float alpha,
                           float om_alpha, float& gamma, float& mus) {
  float r = sqrtf(ys * ys + v * v);
  bool deg = r < FB_ZERO_TOL;
  float rs = deg ? 1.0f : r;
  float ga = alpha * (1.0f - ys / rs);
  float gb = alpha * (1.0f - v / rs);
  if (ys > 0.0f && v > 0.0f) {
    ga = ga + om_alpha * v;
    gb = gb + om_alpha * ys;
  }
  if (deg) {
    float dgn = alpha * (1.0f - 1.0f / sqrtf(2.0f));
    ga = dgn;
    gb = dgn;
  }
  gamma = ga;
  mus = gb + sigma * ga;
}

// Penalized Fischer-Burmeister function (full_residual.cc:115-118).
FB_DEV float fb_pfb(float a, float b, float alpha, float om_alpha) {
  float fb = a + b - sqrtf(a * a + b * b);
  return alpha * fb + om_alpha * fmaxf(0.0f, a) * fmaxf(0.0f, b);
}

// Small dense linear algebra on row-major blocks of one instance, shared
// by the kernels.

// In place lower Cholesky of the n x n row-major block A (lower triangle
// read; the strict upper triangle is zeroed).
FB_DEV void fb_chol(Lane A, int n) {
  for (int k = 0; k < n; ++k) {
    float d = sqrtf(A[k * n + k]);
    for (int r = k; r < n; ++r) A[r * n + k] = A[r * n + k] / d;
    for (int r = k + 1; r < n; ++r) {
      float lrk = A[r * n + k];
      for (int c = k + 1; c <= r; ++c) A[r * n + c] -= lrk * A[c * n + k];
    }
  }
  for (int r = 0; r < n; ++r)
    for (int c = r + 1; c < n; ++c) A[r * n + c] = 0.0f;
}

// x <- inv(L) x for lower L (n x n).
FB_DEV void fb_trsv_lower(Lane L, int n, Lane x) {
  for (int k = 0; k < n; ++k) {
    float xk = x[k] / L[k * n + k];
    x[k] = xk;
    for (int r = k + 1; r < n; ++r) x[r] -= L[r * n + k] * xk;
  }
}

// x <- inv(L') x for lower L (n x n).
FB_DEV void fb_trsv_upperT(Lane L, int n, Lane x) {
  for (int k = n - 1; k >= 0; --k) {
    float xk = x[k] / L[k * n + k];
    x[k] = xk;
    for (int r = 0; r < k; ++r) x[r] -= L[k * n + r] * xk;
  }
}

// x <- inv(L L') x.
FB_DEV void fb_cho_solve(Lane L, int n, Lane x) {
  fb_trsv_lower(L, n, x);
  fb_trsv_upperT(L, n, x);
}

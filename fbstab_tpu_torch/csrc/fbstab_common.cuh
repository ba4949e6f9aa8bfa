// Shared definitions of the FBstab CUDA kernels.
//
// A `Lane` is the view of one instance's array: element k at p[k * s].
// Every kernel keeps its per-instance arrays instance-major (s = 1:
// element k of instance b at b * n + k, the batch-first layout torch
// holds, so the threads of one instance's team touch consecutive floats);
// a stride s = n views a column of a row-major n x n block (fb_col).
//
// A team is the group of threads that runs one instance (one pair and
// instance, K5): `Solo`, one thread (the host replay's team of one), or
// `Team<T>`, a thread_block_tile of T threads (K1-K5), or a thread that
// solves alone inside a team's phase. Work split over a team goes
// round-robin: thread `rank` takes items rank, rank + size, ... Every
// reduction is an xor butterfly, which leaves the same bits on every
// thread, so a team's control flow never diverges.
//
// The device code is plain C++ behind FB_DEV, so the same headers also
// compile as host code for a CPU rehearsal of the arithmetic.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#define FB_DEV __device__ __forceinline__
#define FB_HD __host__ __device__ __forceinline__
// Unrolls a dot product over device memory, so that several of its loads
// are in flight at once.
#define FB_UNROLL _Pragma("unroll 4")
#else
#define FB_DEV inline
#define FB_HD inline
#define FB_UNROLL
#endif

struct Lane {
  float* p;       // &array[0] of this instance
  int s;          // stride between consecutive elements: B or 1
  FB_DEV float& operator[](long long i) const { return p[i * s]; }
  FB_DEV Lane at(long long off) const { return Lane{p + off * s, s}; }
};

// Column j of the n x n row-major block X, as a vector.
FB_DEV Lane fb_col(Lane X, int n, int j) {
  return Lane{X.p + (long long)j * X.s, X.s * n};
}

// Instance-major: element k of instance b at b * n + k.
FB_DEV Lane lane_im(const float* base, long long n, long long b) {
  return Lane{const_cast<float*>(base) + b * n, 1};
}

// The team of one thread. It reads every operand where it lies.
struct Solo {
  static constexpr bool kStages = false;
  static FB_HD int size() { return 1; }
  FB_DEV int rank() const { return 0; }
  FB_DEV void sync() const {}
  FB_DEV float sum(float x) const { return x; }
  FB_DEV float max(float x) const { return x; }
  FB_DEV bool any(bool x) const { return x; }
  FB_DEV float bcast(float x, int) const { return x; }
};

#ifdef __CUDACC__
// A team of T threads (T a power of two, at most 32): a tile of a warp.
// Several teams may share a warp and run apart; a tile's shuffles and
// syncs use only its own lanes' mask.
template <int T, bool S = true>
struct Team {
  // Whether the team copies each stage's operands into a stage block in
  // shared memory before working on them (riccati.cuh); a team that does
  // not keeps the stage block in its device-memory scratch, as Solo does.
  static constexpr bool kStages = S;
  cooperative_groups::thread_block_tile<T> g;
  static FB_HD int size() { return T; }
  FB_DEV int rank() const { return (int)g.thread_rank(); }
  FB_DEV void sync() const { g.sync(); }
  FB_DEV float sum(float x) const {
    for (int o = T / 2; o > 0; o >>= 1) x += g.shfl_xor(x, o);
    return x;
  }
  FB_DEV float max(float x) const {
    for (int o = T / 2; o > 0; o >>= 1) x = fmaxf(x, g.shfl_xor(x, o));
    return x;
  }
  FB_DEV bool any(bool x) const { return g.any(x ? 1 : 0) != 0; }
  FB_DEV float bcast(float x, int src) const { return g.shfl(x, src); }
};

// The launch a kernel takes at some dims on the current device.
template <typename Kernel>
struct Launch {
  Kernel kernel;
  bool stages;          // the teams keep their stage blocks in shared memory
  long long smem;       // dynamic shared bytes per block (0: in place)
  long long ws_floats;  // device-memory scratch per instance
};

// The staging policy of K1-K4: a block whose teams' stage blocks take
// `smem` bytes stages them in shared memory where that fits what a block
// can opt in to on the current device (opting in above the default
// 48 KB), and its teams work in place otherwise. `staged` and `in_place`
// are the kernel's two instantiations, ws_floats(stages) their scratch.
template <typename Kernel, typename WsFloats>
Launch<Kernel> pick_launch(long long smem, Kernel staged, Kernel in_place,
                           WsFloats ws_floats) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool stages = smem <= optin;
  const Kernel k = stages ? staged : in_place;
  if (stages && smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  return Launch<Kernel>{k, stages, stages ? smem : 0, ws_floats(stages)};
}

// A launch's shape for the kernels' info entries: info[0..5] = threads
// per team, teams per block, registers per thread, local (spill) bytes per
// thread, shared bytes per block (0: the teams work in place), resident
// blocks per SM. Returns cudaGetLastError().
template <typename Kernel>
int launch_info(const Launch<Kernel>& l, int team, int threads, int* info) {
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, l.kernel);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, threads,
                                                (size_t)l.smem);
  info[0] = team;
  info[1] = threads / team;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = (int)l.smem;
  info[5] = blocks;
  return (int)cudaGetLastError();
}
#endif

struct MpcDims {
  int N, nx, nu, nc;
};

// MPC data of one instance (stage blocks row-major):
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
// by the kernels, split over a team. Each element goes through the same
// operations in the same order whatever the team's size, so a team's
// factors and solves are bit for bit the team of one's. On entry every
// operand is visible to the whole team; on return so is every result.

// In place lower Cholesky of the n x n row-major block A (lower triangle
// read; the strict upper triangle is zeroed), one column at a time: the
// team scales the column below the pivot, then updates the trailing rows,
// one row per thread.
template <class Tm>
FB_DEV void fb_chol(const Tm& tm, Lane A, int n) {
  const int T = tm.size();
  for (int k = 0; k < n; ++k) {
    float d = sqrtf(A[k * n + k]);
    for (int r = k + 1 + tm.rank(); r < n; r += T)
      A[r * n + k] = A[r * n + k] / d;
    tm.sync();
    // The pivot is read by no one in this pass.
    if (tm.rank() == k % T) A[k * n + k] = A[k * n + k] / d;
    for (int r = k + 1 + tm.rank(); r < n; r += T) {
      float lrk = A[r * n + k];
      for (int c = k + 1; c <= r; ++c) A[r * n + c] -= lrk * A[c * n + k];
    }
    tm.sync();
  }
  for (int r = tm.rank(); r < n; r += T)
    for (int c = r + 1; c < n; ++c) A[r * n + c] = 0.0f;
  tm.sync();
}

// x <- inv(L) x for lower L (n x n). Element r of x belongs to thread
// r % size: the owner of k forms x[k], a shuffle hands it to the team,
// and each thread updates its own rows below k.
template <class Tm>
FB_DEV void fb_trsv_lower(const Tm& tm, Lane L, int n, Lane x) {
  const int T = tm.size();
  for (int k = 0; k < n; ++k) {
    const int own = k % T;
    float xk = 0.0f;
    if (tm.rank() == own) {
      xk = x[k] / L[k * n + k];
      x[k] = xk;
    }
    xk = tm.bcast(xk, own);
    for (int r = tm.rank(); r < n; r += T)
      if (r > k) x[r] -= L[r * n + k] * xk;
  }
  tm.sync();
}

// x <- inv(L') x for lower L (n x n), with the ownership of fb_trsv_lower.
template <class Tm>
FB_DEV void fb_trsv_upperT(const Tm& tm, Lane L, int n, Lane x) {
  const int T = tm.size();
  for (int k = n - 1; k >= 0; --k) {
    const int own = k % T;
    float xk = 0.0f;
    if (tm.rank() == own) {
      xk = x[k] / L[k * n + k];
      x[k] = xk;
    }
    xk = tm.bcast(xk, own);
    for (int r = tm.rank(); r < k; r += T) x[r] -= L[k * n + r] * xk;
  }
  tm.sync();
}

// x <- inv(L L') x.
template <class Tm>
FB_DEV void fb_cho_solve(const Tm& tm, Lane L, int n, Lane x) {
  fb_trsv_lower(tm, L, n, x);
  fb_trsv_upperT(tm, L, n, x);
}

// The team's working view of the n floats at src: for a team that stages
// its operands, a copy at dst (its stage block in shared memory), visible
// after the caller's next sync; for the team of one, src itself.
template <class Tm>
FB_DEV Lane fb_stage_in(const Tm& tm, Lane dst, Lane src, int n) {
  if (!Tm::kStages) return src;
  for (int k = tm.rank(); k < n; k += tm.size()) dst[k] = src[k];
  return dst;
}

// Where a team computes a block that ends up at `home`: at `staged` for a
// team that stages (fb_stage_out then writes it home), at home otherwise.
template <class Tm>
FB_DEV Lane fb_work(const Tm&, Lane staged, Lane home) {
  return Tm::kStages ? staged : home;
}

template <class Tm>
FB_DEV void fb_stage_out(const Tm& tm, Lane home, Lane src, int n) {
  if (!Tm::kStages) return;
  for (int k = tm.rank(); k < n; k += tm.size()) home[k] = src[k];
}

// K3: the fused FBstab dense QP solver on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/dense_solve_pallas.py::
// fbstab_dense_solve_fused (kernel body _make_dense_kernel): the whole
// algorithm for every instance in one launch, outer proximal loop, inner
// semismooth Newton loop on the quasi-definite block step
// E = H + sigma I + A' diag(gamma ./ mus) A = Le Le' (and, for nl > 0,
// the Schur complement S = sigma I + W'W, W = Le^{-1} G'), nonmonotone
// linesearch, infeasibility checks and exit flags. The loop is the one
// K2 runs (fbstab_solve.cuh), instantiated with the dense problem class
// of dense_solve.cuh.
//
// Design: a team of threads per instance (a thread_block_tile,
// fbstab_common.cuh), each team running its instance's data-dependent
// loops to its own exit, so the Pallas kernel's Mosaic workarounds (the
// `mater` round-trips, int32 mask carries, arithmetic blends, the dummy
// equality row when nl = 0) have no counterpart. Inside an instance the
// team splits the rows of the residuals, the entries of E and S, the rows
// of W' and the Cholesky columns (dense_solve.cuh). Data and iterates are
// instance-major in device memory (the batch-first tensors torch holds,
// no transposes); the team copies H, A and G into a stage block of shared
// memory at the start and keeps the factors, W' and the PFB weights there
// (17.3 KB at the dense bench's n = 32, q = 64, nl = 0; 22.4 KB at
// nl = 16; 116.5 KB at the JAX gate's corner n = 64, q = 128, nl = 64,
// for which the kernel opts in to more than the default 48 KB a block).
// Where one team's stage block exceeds what a block can hold, the same
// team runs without staging, the data read where it lies and the
// Newton-step scratch in its device-memory scratch.
//
// What bounds it: per Newton iteration per instance, forming A'ΓA is
// about n^2 q / 2 multiply-adds (~33k at n = 32, q = 64), the Cholesky
// n^3 / 6 (~5.5k), plus a few residual passes of ~n^2 + 2nq; the card's
// rates are far from the limit. One thread per instance on batch-last
// data, the design this replaces, ran that chain alone on device-memory
// loads, 32 threads a block, about one warp an SM at B = 4096: 39.1 ms at
// B = 1024 (bound 0.016 ms; H100 80GB HBM3 at 700 W, PERF.md). Here the
// chain is the team's: each phase a few shared-memory round trips a
// thread, the Choleskys and triangular solves n steps of shuffles. On the
// same card a warp took 1.3 ms at B = 1024 and 3.9 ms at the dense path's
// B = 4096 (bound 0.063 ms), at 168 registers and 12 blocks an SM (the
// registers and the 17.3 KB stage block each allow 12-13), so B = 4096
// runs in 2.6 waves. A team of 16 (two a block) took 1.8 and 4.8-4.9 ms;
// the warp with its registers capped at 128 spilled more and took 1.6 and
// 4.6 ms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dense_solve.cuh"

namespace {

namespace cg = cooperative_groups;

// Threads per instance; teams fill a one-warp block.
constexpr int kTeam = 32;
constexpr int kThreads = 32;

struct DenseArgs {
  const float *H, *f, *G, *h, *A, *b;
  const float *z0, *l0, *v0;
  float *z, *l, *v, *y;
  int *eflag;
  float *res;
  int *newton, *prox;
  float *res0;
  float *ws;
  long long ws_floats;  // scratch floats per instance
};

template <int T, bool S>
__global__ void __launch_bounds__(kThreads)
    dense_solve_kernel(DenseDims D, int B, SolveOpts o, DenseArgs a) {
  extern __shared__ float smem[];
  const Team<T, S> tm{cg::tiled_partition<T>(cg::this_thread_block())};
  const int t = threadIdx.x / T;
  const long long b = (long long)blockIdx.x * (kThreads / T) + t;
  if (b >= B) return;
  const long long n = D.n, q = D.q, nl = D.nl;
  DenseProb P;
  P.H = lane_im(a.H, n * n, b);
  P.f = lane_im(a.f, n, b);
  P.G = lane_im(a.G, nl * n, b);
  P.h = lane_im(a.h, nl, b);
  P.A = lane_im(a.A, q * n, b);
  P.b = lane_im(a.b, q, b);
  SolveOut out;
  out.x = Vars{lane_im(a.z, n, b), lane_im(a.l, nl, b), lane_im(a.v, q, b),
               lane_im(a.y, q, b)};
  out.eflag = a.eflag + b;
  out.res = a.res + b;
  out.newton = a.newton + b;
  out.prox = a.prox + b;
  out.res0 = a.res0 + b;
  const Lane ws = lane_im(a.ws, a.ws_floats, b);
  const Lane st = S ? Lane{smem + t * dense_stage_layout(D).total, 1} : ws;
  fbstab_dense_solve_lane(tm, D, o, P, lane_im(a.z0, n, b),
                          lane_im(a.l0, nl, b), lane_im(a.v0, q, b), out, ws,
                          st);
}

using DenseKernel = void (*)(DenseDims, int, SolveOpts, DenseArgs);

// The launch K3 takes at these dims on the current device (pick_launch).
Launch<DenseKernel> k3_launch(const DenseDims& D) {
  return pick_launch(4LL * (kThreads / kTeam) * dense_stage_layout(D).total,
                     &dense_solve_kernel<kTeam, true>,
                     &dense_solve_kernel<kTeam, false>,
                     [&](bool s) { return dense_solve_layout(D, s).total; });
}

}  // namespace

extern "C" {

// Floats of solver scratch per instance for the launch at these dims.
long long fb_dense_ws_floats(int n, int q, int nl) {
  return k3_launch(DenseDims{n, q, nl}).ws_floats;
}

// K3's launch shape at these dims, as fb_riccati_info gives K1's:
// info[0..5] = threads per team, teams per block, registers per thread,
// local (spill) bytes per thread, shared bytes per block (0: the team
// does not stage), resident blocks per SM. Returns cudaGetLastError().
int fb_dense_solve_info(int n, int q, int nl, int* info) {
  return launch_info(k3_launch(DenseDims{n, q, nl}), kTeam, kThreads, info);
}

// Launches K3 on `stream`. Arrays are instance-major (B, floats per
// instance), ws is (B, fb_dense_ws_floats); eflag, res, newton, prox,
// res0 are (B,). G, h, l0 and l are not read when nl = 0. Returns
// cudaGetLastError().
int fb_dense_solve(int n, int q, int nl, int B, SolveOpts o, const float* H,
                   const float* f, const float* G, const float* h,
                   const float* A, const float* b, const float* z0,
                   const float* l0, const float* v0, float* z, float* l,
                   float* v, float* y, int* eflag, float* res, int* newton,
                   int* prox, float* res0, float* ws, void* stream) {
  const DenseDims D{n, q, nl};
  const Launch<DenseKernel> kl = k3_launch(D);
  DenseArgs a{H, f, G, h, A, b, z0, l0, v0, z, l, v, y,
              eflag, res, newton, prox, res0, ws, kl.ws_floats};
  const int teams = kThreads / kTeam;
  const int blocks = (B + teams - 1) / teams;
  const DenseKernel k = kl.kernel;
  k<<<blocks, kThreads, (size_t)kl.smem, (cudaStream_t)stream>>>(D, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

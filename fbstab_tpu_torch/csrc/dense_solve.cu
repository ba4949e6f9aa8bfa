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
// Design: one thread per instance, each running its own data-dependent
// loops to its own exit, so the Pallas kernel's Mosaic workarounds (the
// `mater` round-trips, int32 mask carries, arithmetic blends, the dummy
// equality row when nl = 0) have no counterpart. Data, iterates and the
// Newton-step scratch (Le, W', Ls, the PFB weights) are batch-last in
// device memory, so a warp's access is one coalesced transaction; the
// wrapper allocates them, the kernel allocates nothing.
//
// What bounds it: per Newton iteration per instance, forming A'ΓA is
// about n^2 q / 2 multiply-adds (~33k at n = 32, q = 64) and the Cholesky
// about n^3 / 6 (~5.5k), each operand a load from device memory or L2 on
// one thread, plus a few residual passes of ~n^2 + 2nq. At B = 4096 and
// 32 threads per block the card holds about one warp per SM, so load
// latency, not arithmetic or bandwidth, sets the time. A first, exact
// kernel accepts that; tiles of A in shared memory, a warp per instance
// and tensor-core products for A'ΓA are later work.
#include <cuda_runtime.h>

#include "dense_solve.cuh"

namespace {

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
};

__global__ void dense_solve_kernel(DenseDims D, int B, SolveOpts o,
                                   DenseArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  DenseProb P;
  P.H = lane_of(a.H, B, b);
  P.f = lane_of(a.f, B, b);
  P.G = lane_of(a.G, B, b);
  P.h = lane_of(a.h, B, b);
  P.A = lane_of(a.A, B, b);
  P.b = lane_of(a.b, B, b);
  SolveOut out;
  out.x = Vars{lane_of(a.z, B, b), lane_of(a.l, B, b), lane_of(a.v, B, b),
               lane_of(a.y, B, b)};
  out.eflag = a.eflag + b;
  out.res = a.res + b;
  out.newton = a.newton + b;
  out.prox = a.prox + b;
  out.res0 = a.res0 + b;
  fbstab_dense_solve_lane(D, o, P, lane_of(a.z0, B, b), lane_of(a.l0, B, b),
                          lane_of(a.v0, B, b), out, lane_of(a.ws, B, b));
}

}  // namespace

extern "C" {

// Floats of solver scratch per instance.
long long fb_dense_ws_floats(int n, int q, int nl) {
  return dense_solve_layout(DenseDims{n, q, nl}).total;
}

// Launches K3 on `stream`. Arrays are batch-last (rows, B); eflag, res,
// newton, prox, res0 are (B,). G, h, l0 and l are not read when nl = 0.
// Returns cudaGetLastError().
int fb_dense_solve(int n, int q, int nl, int B, SolveOpts o, const float* H,
                   const float* f, const float* G, const float* h,
                   const float* A, const float* b, const float* z0,
                   const float* l0, const float* v0, float* z, float* l,
                   float* v, float* y, int* eflag, float* res, int* newton,
                   int* prox, float* res0, float* ws, void* stream) {
  DenseArgs a{H, f, G, h, A, b, z0, l0, v0, z, l, v, y,
              eflag, res, newton, prox, res0, ws};
  const int blocks = (B + kThreads - 1) / kThreads;
  dense_solve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      DenseDims{n, q, nl}, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

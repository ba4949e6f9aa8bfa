// K2: the fused FBstab MPC solver on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/mpc_solve_pallas.py::
// fbstab_mpc_solve_fused (kernel body _make_solve_kernel on _build_ctx and
// _solve_subproblem), standard mode: the whole algorithm for every
// instance in one launch, outer proximal loop, inner semismooth Newton
// loop on the shared riccati_factor_solve (riccati.cuh), nonmonotone
// linesearch, infeasibility checks and exit flags (mpc_solve.cuh).
//
// Design: one thread per instance, each running its own data-dependent
// loops to its own exit, so the lockstep masks, selects and int32 mask
// carries of the Pallas kernel (Mosaic workarounds) have no counterpart.
// Iterates (xk, xi, the step, the trial point, the residual) and the
// Newton-step scratch are batch-last in device memory; the wrapper
// allocates them, the kernel allocates nothing.
//
// What bounds it: per instance, a Newton iteration is ~1e5 dependent
// scalar FLOPs (the Riccati factorization, ~90% of them) plus a few
// residual passes of ~1e4, and a solve takes some tens of iterations, all
// on one thread; every operand is a load from the instance's working set
// (55 KB of scratch and 34 KB of data at the headline dims) in L2/HBM.
// With B = 8192 instances at 32 threads per block the card holds about
// two warps per SM, so load latency, not arithmetic or bandwidth, sets
// the time, and the slowest instance of each warp sets its warp's time. A first, exact kernel accepts that; register-resident
// stage blocks and several threads per instance are later work.
#include <cuda_runtime.h>

#include "mpc_solve.cuh"

namespace {

constexpr int kThreads = 32;

struct SolveArgs {
  const float *q, *r, *c, *x0, *d, *Q, *R, *S, *A, *B, *E, *L;
  const float *z0, *l0, *v0;
  float *z, *l, *v, *y;
  int *eflag;
  float *res;
  int *newton, *prox;
  float *res0;
  float *ws;
};

__global__ void mpc_solve_kernel(MpcDims D, int B, SolveOpts o,
                                 SolveArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  MpcProb P;
  P.Q = lane_of(a.Q, B, b);
  P.R = lane_of(a.R, B, b);
  P.S = lane_of(a.S, B, b);
  P.q = lane_of(a.q, B, b);
  P.r = lane_of(a.r, B, b);
  P.A = lane_of(a.A, B, b);
  P.B = lane_of(a.B, B, b);
  P.c = lane_of(a.c, B, b);
  P.E = lane_of(a.E, B, b);
  P.L = lane_of(a.L, B, b);
  P.d = lane_of(a.d, B, b);
  P.x0 = lane_of(a.x0, B, b);
  SolveOut out;
  out.x = Vars{lane_of(a.z, B, b), lane_of(a.l, B, b), lane_of(a.v, B, b),
               lane_of(a.y, B, b)};
  out.eflag = a.eflag + b;
  out.res = a.res + b;
  out.newton = a.newton + b;
  out.prox = a.prox + b;
  out.res0 = a.res0 + b;
  fbstab_mpc_solve_lane(D, o, P, lane_of(a.z0, B, b), lane_of(a.l0, B, b),
                        lane_of(a.v0, B, b), out, lane_of(a.ws, B, b));
}

}  // namespace

extern "C" {

// Floats of solver scratch per instance.
long long fb_solve_ws_floats(int N, int nx, int nu, int nc) {
  return solve_layout(MpcDims{N, nx, nu, nc}).total;
}

// Launches K2 on `stream`. Arrays are batch-last (rows, B); eflag, res,
// newton, prox, res0 are (B,). Returns cudaGetLastError().
int fb_mpc_solve(int N, int nx, int nu, int nc, int B, SolveOpts o,
                 const float* q, const float* r, const float* c,
                 const float* x0, const float* d, const float* Q,
                 const float* R, const float* S, const float* A,
                 const float* Bm, const float* E, const float* L,
                 const float* z0, const float* l0, const float* v0, float* z,
                 float* l, float* v, float* y, int* eflag, float* res,
                 int* newton, int* prox, float* res0, float* ws,
                 void* stream) {
  SolveArgs a{q, r, c, x0, d, Q, R, S, A, Bm, E, L, z0, l0, v0, z, l, v, y,
              eflag, res, newton, prox, res0, ws};
  const int blocks = (B + kThreads - 1) / kThreads;
  mpc_solve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      MpcDims{N, nx, nu, nc}, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

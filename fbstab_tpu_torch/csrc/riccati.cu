// K1: the batched MPC Newton step on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/riccati_pallas.py::
// riccati_newton_step_batched (kernel body _newton_step_kernel ->
// riccati_factor_solve): PFB weights, barrier-augmented stage Hessians,
// the forward Riccati matrix recursion with small Choleskys, the forward
// vector recursion and the backward substitution, giving (dz, dl). The
// dual recovery (dv, dy) is a wide elementwise pass left to PyTorch, as
// the JAX wrapper leaves it to XLA.
//
// Design: one thread per instance (riccati.cuh's team of one). The
// recursion is sequential in the horizon and every stage is a chain of
// tiny (nx <= 32) dependent factorizations; each thread runs its own
// recursion and the parallelism is the batch (K2 and K4 split the same
// device code over a team per instance). All per-instance arrays,
// inputs, outputs and the stage-factor scratch (Lc, M, SM, SG, AM, P, th,
// h and the stage temporaries, (N+1)(3nx^2 + nu^2 + 2nx nu) + O(N nx)
// floats) are batch-last in device memory, so each warp access is one
// coalesced 128-byte transaction.
//
// What bounds it: dependent scalar FLOPs per thread (about 3e3 per stage
// at nx = 8, nu = 3, nc = 6, each waiting on the load before it) and the
// scratch traffic, 36 KB per instance written and re-read, beside 34 KB
// of problem data (at B = 8192 the ~570 MB working set spills the 50 MB
// L2 to HBM). With 32 threads per block, B = 8192 fills 256 blocks, about
// two warps per SM: too few to hide the latency of those loads. The design takes that as the price of
// a first, simple, exact kernel; keeping stage matrices in registers or
// shared memory and splitting an instance across a warp is later work.
#include <cuda_runtime.h>

#include "riccati.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void riccati_step_kernel(MpcDims D, int B, float alpha,
                                    float om_alpha, const float* sigma,
                                    const float* Q, const float* R,
                                    const float* S, const float* A,
                                    const float* Bm, const float* E,
                                    const float* L, const float* v,
                                    const float* y, const float* vbar,
                                    const float* rz, const float* rl,
                                    const float* rv, float* dz, float* dl,
                                    float* ws) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  MpcProb P{};
  P.Q = lane_of(Q, B, b);
  P.R = lane_of(R, B, b);
  P.S = lane_of(S, B, b);
  P.A = lane_of(A, B, b);
  P.B = lane_of(Bm, B, b);
  P.E = lane_of(E, B, b);
  P.L = lane_of(L, B, b);
  const Lane w = lane_of(ws, B, b);
  riccati_factor_solve(Solo{}, D, sigma[b], alpha, om_alpha, P,
                       lane_of(v, B, b), lane_of(y, B, b),
                       lane_of(vbar, B, b), lane_of(rz, B, b),
                       lane_of(rl, B, b), lane_of(rv, B, b),
                       lane_of(dz, B, b), lane_of(dl, B, b), w,
                       w.at(ric_layout(D).stage));
}

}  // namespace

extern "C" {

// Floats of Newton-step scratch per instance.
long long fb_riccati_ws_floats(int N, int nx, int nu, int nc) {
  return ric_layout(MpcDims{N, nx, nu, nc}).total;
}

// Launches K1 on `stream`. Every array is batch-last: (rows, B) with
// rows = the per-instance size. Returns cudaGetLastError().
int fb_riccati_step(int N, int nx, int nu, int nc, int B, float alpha,
                    float om_alpha, const float* sigma, const float* Q,
                    const float* R, const float* S, const float* A,
                    const float* Bm, const float* E, const float* L,
                    const float* v, const float* y, const float* vbar,
                    const float* rz, const float* rl, const float* rv,
                    float* dz, float* dl, float* ws, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      MpcDims{N, nx, nu, nc}, B, alpha, om_alpha, sigma, Q, R, S, A, Bm, E,
      L, v, y, vbar, rz, rl, rv, dz, dl, ws);
  return (int)cudaGetLastError();
}

}  // extern "C"

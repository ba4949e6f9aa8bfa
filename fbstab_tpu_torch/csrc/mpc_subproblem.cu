// K4: one outer proximal iteration of the FBstab MPC solver on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/mpc_solve_pallas.py::
// mpc_subproblem_fused (kernel body _make_subproblem_kernel): the tier of
// large stage dimensions (the copolymerization reactor, nx = 18, N = 80),
// whose outer proximal loop runs on the host (models/mpc_subfused.py) and
// launches this kernel once per outer iteration. Per instance it computes
// Ek, the success / stall test and the inner tolerance, then runs the whole
// inner semismooth Newton loop with its nonmonotone linesearch (the
// fb_subproblem of fbstab_solve.cuh on the MPC class of mpc_solve.cuh, the
// loop K2 runs) and the norm of the step xi - xk (fb_outer_step). A lane
// that enters done or succeeds returns xi = xk, Eo = 0 and its counters
// unchanged.
//
// Design: one thread per instance, as K2; the lockstep masks of the Pallas
// kernel have no counterpart, and its lowmem / staged modes (VMEM and
// Mosaic register-allocator limits of the TPU) are not needed: the stage
// factors and iterates live batch-last in device memory, 0.47 MB per
// instance at the copolymerization reactor's dims, sized by the wrapper.
//
// What bounds it: a Newton iteration at nx = 18, N = 80 is ~4.4 MFLOP of
// dependent scalar work in the Riccati factorization plus ~0.3 MFLOP per
// residual pass, all on one thread, against a working set (0.8 MB per
// instance with the data) that does not stay in L2 across a warp, so load
// latency sets the time and the slowest instance of a warp sets the warp's.
// Several threads per instance (a warp sharing each stage's small matrix
// products) are the lever for later work.
#include <cuda_runtime.h>

#include "mpc_solve.cuh"

namespace {

constexpr int kThreads = 32;

struct SubArgs {
  const float *q, *r, *c, *x0, *d, *Q, *R, *S, *A, *B, *E, *L;
  const float *zk, *lk, *vk, *yk;
  const float *itol_prev, *dxn_prev;
  const int *newton0, *done;
  float *z, *l, *v, *y;
  float *Eo;
  int *newton, *lfail;
  float *Ek;
  int *success;
  float *itol, *dxn;
  float *ws;
};

__global__ void mpc_subproblem_kernel(MpcDims D, int B, SolveOpts o,
                                      SubArgs a) {
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
  const Vars xk{lane_of(a.zk, B, b), lane_of(a.lk, B, b), lane_of(a.vk, B, b),
                lane_of(a.yk, B, b)};
  const Vars xi{lane_of(a.z, B, b), lane_of(a.l, B, b), lane_of(a.v, B, b),
                lane_of(a.y, B, b)};
  const OuterStep s = fbstab_mpc_subproblem_lane(
      D, o, P, xk, xi, a.itol_prev[b], a.dxn_prev[b], a.newton0[b],
      a.done[b] != 0, lane_of(a.ws, B, b));
  a.Eo[b] = s.Eo;
  a.newton[b] = s.newton;
  a.lfail[b] = s.lfail ? 1 : 0;
  a.Ek[b] = s.Ek;
  a.success[b] = s.success ? 1 : 0;
  a.itol[b] = s.itol;
  a.dxn[b] = s.dxn;
}

}  // namespace

extern "C" {

// Floats of K4's scratch per instance.
long long fb_subproblem_ws_floats(int N, int nx, int nu, int nc) {
  return subproblem_ws_floats(MpcDims{N, nx, nu, nc});
}

// Launches K4 on `stream`. Arrays are batch-last (rows, B); itol_prev,
// dxn_prev, newton0, done and the scalar outputs are (B,). Returns
// cudaGetLastError().
int fb_mpc_subproblem(int N, int nx, int nu, int nc, int B, SolveOpts o,
                      const float* q, const float* r, const float* c,
                      const float* x0, const float* d, const float* Q,
                      const float* R, const float* S, const float* A,
                      const float* Bm, const float* E, const float* L,
                      const float* zk, const float* lk, const float* vk,
                      const float* yk, const float* itol_prev,
                      const float* dxn_prev, const int* newton0,
                      const int* done, float* z, float* l, float* v,
                      float* y, float* Eo, int* newton, int* lfail,
                      float* Ek, int* success, float* itol, float* dxn,
                      float* ws, void* stream) {
  SubArgs a{q, r, c, x0, d, Q, R, S, A, Bm, E, L,
            zk, lk, vk, yk, itol_prev, dxn_prev, newton0, done,
            z, l, v, y, Eo, newton, lfail, Ek, success, itol, dxn, ws};
  const int blocks = (B + kThreads - 1) / kThreads;
  mpc_subproblem_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      MpcDims{N, nx, nu, nc}, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

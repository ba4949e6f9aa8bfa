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
// Design: a warp per instance (a team of 32 threads, fbstab_common.cuh;
// nx + nu = 23 rows of a stage), one team per block,
// sharing each stage's small products, factorizations and solves as K2's
// teams do; the lockstep masks of the Pallas kernel have no counterpart,
// and its lowmem / staged modes (VMEM and Mosaic register-allocator limits
// of the TPU) are not needed. Data, iterates and the stage factors are
// instance-major in device memory (0.47 MB of factors per instance at the
// copolymerization reactor's dims, sized by the wrapper); the team works
// on the current stage in a stage block of shared memory (the Hessians,
// T = inv(L L'), the vector temporaries and the staged E, L and factors;
// 10 KB).
//
// What bounds it: the chain of dependent team phases per instance (a
// Newton iteration at nx = 18, N = 80 is ~4.4 MFLOP of Riccati work split
// over the warp, with a Cholesky column, a triangular-solve step or a
// product phase between syncs), each phase a few shared-memory round
// trips; at B = 256 one warp per instance leaves most of each SM idle. On
// an H100 80GB HBM3 at 700 W (PERF.md) the subfused copoly solve
// (4 launches) took 135 ms at B = 256 with 255 registers a thread, where
// one thread per instance took 2,478 ms. The registers are capped at 128
// (__launch_bounds__ asks for 16 resident blocks an SM, not 8): the
// copoly path runs at B = 2048, where the cap took the whole call from
// 1,521 to 1,551 QPs/s in an A B B A run, for 13% more time at B = 256
// and 1.5 KB of spill loads; a cap at 168 registers (12 blocks) gained
// nothing.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mpc_solve.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTeam = kK4Team;
constexpr int kTeams = kK4TeamsPerBlock;
constexpr int kThreads = kTeam * kTeams;

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

__global__ void __launch_bounds__(kThreads, 16)
    mpc_subproblem_kernel(MpcDims D, int B, SolveOpts o, SubArgs a) {
  extern __shared__ float smem[];
  const Team<kTeam> tm{cg::tiled_partition<kTeam>(cg::this_thread_block())};
  const int t = threadIdx.x / kTeam;
  const long long b = (long long)blockIdx.x * kTeams + t;
  if (b >= B) return;
  const MpcProb P = mpc_prob_im(D, a.q, a.r, a.c, a.x0, a.d, a.Q, a.R, a.S,
                                a.A, a.B, a.E, a.L, b);
  const Vars xk = mpc_vars_im(D, a.zk, a.lk, a.vk, a.yk, b);
  const Vars xi = mpc_vars_im(D, a.z, a.l, a.v, a.y, b);
  const RicLayout rl = ric_layout(D);
  const OuterStep s = fbstab_mpc_subproblem_lane(
      tm, D, o, P, xk, xi, a.itol_prev[b], a.dxn_prev[b], a.newton0[b],
      a.done[b] != 0, lane_im(a.ws, subproblem_ws_floats(D), b),
      Lane{smem + t * rl.stage_floats, 1});
  if (tm.rank() == 0) {
    a.Eo[b] = s.Eo;
    a.newton[b] = s.newton;
    a.lfail[b] = s.lfail ? 1 : 0;
    a.Ek[b] = s.Ek;
    a.success[b] = s.success ? 1 : 0;
    a.itol[b] = s.itol;
    a.dxn[b] = s.dxn;
  }
}

}  // namespace

extern "C" {

// Floats of K4's scratch per instance.
long long fb_subproblem_ws_floats(int N, int nx, int nu, int nc) {
  return subproblem_ws_floats(MpcDims{N, nx, nu, nc});
}

// Bytes of shared memory per block.
long long fb_subproblem_smem_bytes(int N, int nx, int nu, int nc) {
  return subproblem_smem_bytes(MpcDims{N, nx, nu, nc});
}

// K4's launch shape at these dims, as fb_mpc_solve_info gives K2's.
int fb_mpc_subproblem_info(int N, int nx, int nu, int nc, int* info) {
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, mpc_subproblem_kernel);
  const long long smem = subproblem_smem_bytes(MpcDims{N, nx, nu, nc});
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, mpc_subproblem_kernel, kThreads, (size_t)smem);
  info[0] = kTeam;
  info[1] = kTeams;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = (int)smem;
  info[5] = blocks;
  return (int)cudaGetLastError();
}

// Launches K4 on `stream`. Arrays are instance-major (B, floats per
// instance); itol_prev, dxn_prev, newton0, done and the scalar outputs
// are (B,). Returns cudaGetLastError().
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
  const MpcDims D{N, nx, nu, nc};
  const int blocks = (B + kTeams - 1) / kTeams;
  mpc_subproblem_kernel<<<blocks, kThreads,
                          (size_t)subproblem_smem_bytes(D),
                          (cudaStream_t)stream>>>(D, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

// K4: one outer proximal iteration of the FBstab MPC solver on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/mpc_solve_pallas.py::
// mpc_subproblem_fused (kernel body _make_subproblem_kernel, both modes:
// standard and lowmem, mpc_solve_pallas.py:1256-1283, :1386, the Riccati
// solve's recompute-factors mode of riccati.cuh, bit for bit the standard
// mode's): the tier of shapes whose carried state is beyond the full-solve
// kernel's (the JAX package's _subfused_eligible: the copolymerization
// reactor, nx = 18, N = 80; the spacecraft plant at N = 45-160),
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
// teams do; the lockstep masks of the Pallas kernel have no counterpart.
// Its staged formulation (per-stage residual, norm and linesearch math,
// which bounds Mosaic's register spill on the TPU) is what the device code
// does in every mode: the team works stage by stage. Data, iterates and
// the stage factors are instance-major in device memory (0.47 MB of
// factors per instance at the copolymerization reactor's dims in the
// standard mode, 0.1 MB in lowmem, sized by the wrapper); the team works
// on the current stage in a stage block of shared memory (the Hessians,
// T = inv(L L'), the vector temporaries and the staged E, L and factors;
// 10 KB, 48.7 KB at the JAX package's gate corner, for which the block
// opts in to more than the default 48 KB). Where the stage block exceeds
// what a block can hold, the team works in place, its stage block in its
// device-memory scratch (as K1's does).
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

template <bool S, bool Store>
__global__ void __launch_bounds__(kThreads, 16)
    mpc_subproblem_kernel(MpcDims D, int B, SolveOpts o, SubArgs a) {
  extern __shared__ float smem[];
  const Team<kTeam, S> tm{
      cg::tiled_partition<kTeam>(cg::this_thread_block())};
  const int t = threadIdx.x / kTeam;
  const long long b = (long long)blockIdx.x * kTeams + t;
  if (b >= B) return;
  const MpcProb P = mpc_prob_im(D, a.q, a.r, a.c, a.x0, a.d, a.Q, a.R, a.S,
                                a.A, a.B, a.E, a.L, b);
  const Vars xk = mpc_vars_im(D, a.zk, a.lk, a.vk, a.yk, b);
  const Vars xi = mpc_vars_im(D, a.z, a.l, a.v, a.y, b);
  const RicLayout rl = ric_layout(D, !Store);
  const Lane ws = lane_im(a.ws, subproblem_ws_floats(D, !Store, S), b);
  const OuterStep s = fbstab_mpc_subproblem_lane<Store>(
      tm, D, o, P, xk, xi, a.itol_prev[b], a.dxn_prev[b], a.newton0[b],
      a.done[b] != 0, ws,
      S ? Lane{smem + t * rl.stage_floats, 1} : ws.at(rl.stage));
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

using SubKernel = void (*)(MpcDims, int, SolveOpts, SubArgs);

// The launch K4 takes at these dims, in this mode, on the current device:
// the team stages where a block can hold its stage block, and works in
// place otherwise (pick_launch).
Launch<SubKernel> k4_launch(const MpcDims& D, bool lowmem) {
  return pick_launch(
      subproblem_smem_bytes(D),
      lowmem ? &mpc_subproblem_kernel<true, false>
             : &mpc_subproblem_kernel<true, true>,
      lowmem ? &mpc_subproblem_kernel<false, false>
             : &mpc_subproblem_kernel<false, true>,
      [&](bool s) { return subproblem_ws_floats(D, lowmem, s); });
}

}  // namespace

extern "C" {

// Floats of K4's scratch per instance for the launch at these dims in this
// mode (lowmem: the recompute-factors mode).
long long fb_subproblem_ws_floats(int N, int nx, int nu, int nc,
                                  int lowmem) {
  return k4_launch(MpcDims{N, nx, nu, nc}, lowmem != 0).ws_floats;
}

// Bytes of shared memory a block whose team stages asks for.
long long fb_subproblem_smem_bytes(int N, int nx, int nu, int nc) {
  return subproblem_smem_bytes(MpcDims{N, nx, nu, nc});
}

// K4's launch shape at these dims in this mode, as fb_mpc_solve_info gives
// K2's.
int fb_mpc_subproblem_info(int N, int nx, int nu, int nc, int lowmem,
                           int* info) {
  return launch_info(k4_launch(MpcDims{N, nx, nu, nc}, lowmem != 0), kTeam,
                     kThreads, info);
}

// Launches K4 on `stream` in the standard mode or (lowmem) the
// recompute-factors mode. Arrays are instance-major (B, floats per
// instance); itol_prev, dxn_prev, newton0, done and the scalar outputs
// are (B,); ws is (B, fb_subproblem_ws_floats). Returns
// cudaGetLastError().
int fb_mpc_subproblem(int N, int nx, int nu, int nc, int B, int lowmem,
                      SolveOpts o, const float* q, const float* r,
                      const float* c, const float* x0, const float* d,
                      const float* Q, const float* R, const float* S,
                      const float* A, const float* Bm, const float* E,
                      const float* L, const float* zk, const float* lk,
                      const float* vk, const float* yk,
                      const float* itol_prev, const float* dxn_prev,
                      const int* newton0, const int* done, float* z,
                      float* l, float* v, float* y, float* Eo, int* newton,
                      int* lfail, float* Ek, int* success, float* itol,
                      float* dxn, float* ws, void* stream) {
  SubArgs a{q, r, c, x0, d, Q, R, S, A, Bm, E, L,
            zk, lk, vk, yk, itol_prev, dxn_prev, newton0, done,
            z, l, v, y, Eo, newton, lfail, Ek, success, itol, dxn, ws};
  const MpcDims D{N, nx, nu, nc};
  const Launch<SubKernel> k = k4_launch(D, lowmem != 0);
  const int blocks = (B + kTeams - 1) / kTeams;
  k.kernel<<<blocks, kThreads, (size_t)k.smem, (cudaStream_t)stream>>>(
      D, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

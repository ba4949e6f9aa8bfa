// K2: the fused FBstab MPC solver on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/mpc_solve_pallas.py::
// fbstab_mpc_solve_fused (kernel body _make_solve_kernel on _build_ctx and
// _solve_subproblem) in its modes: the standard grid launch and the serial
// launch for lowmem or staged (mpc_solve_pallas.py:1191). The whole
// algorithm for every instance in one launch, outer proximal loop, inner
// semismooth Newton loop on the shared riccati_factor_solve (riccati.cuh),
// nonmonotone linesearch, infeasibility checks and exit flags
// (mpc_solve.cuh). lowmem is the Riccati solve's recompute-factors mode
// (riccati.cuh), bit for bit the standard mode's; the Pallas kernel's
// staged mode (per-stage residual and linesearch math, a Mosaic register
// limit of the TPU) is what the device code does in every mode, a team
// working stage by stage.
//
// Design: a team of 8 threads per instance (a thread_block_tile,
// fbstab_common.cuh; nx = 8 rows of a stage at the headline), four teams
// to a one-warp block, no block-wide barrier. Each team runs its
// instance's data-dependent loops to its own exit, so the lockstep masks,
// selects and int32 mask carries of the Pallas kernel (Mosaic
// workarounds) have no counterpart; inside a stage the team shares
// the small products, factorizations and solves (the split is set out in
// riccati.cuh and mpc_solve.cuh). Data, iterates and the Riccati factors
// are instance-major in device memory, so a team's accesses are
// contiguous; each team works on the current stage in a stage block of
// shared memory (the Hessians, T = inv(L L'), the vector temporaries and
// the staged E, L and factors; 2.3 KB at the headline, 17.7 KB at
// nx = 24, nu = 8, nc = 8 and 48.7 KB at the JAX package's gate corner
// nx = 32, nu = 24, nc = 48), the block opting in to more than the default
// 48 KB where its four teams need it. Where four stage blocks exceed what a
// block can hold, the teams work in place, their stage blocks in their
// device-memory scratch (as K1's do). The wrapper allocates the
// device-memory scratch; the kernel allocates nothing.
//
// What bounds it: the chain of dependent steps per instance, ~11 Newton
// iterations of one Riccati factor-and-solve (per stage a few dozen team
// phases, each a handful of dependent shared-memory round trips, shuffles
// and FMAs) and ~3 residual passes; the card's rates are far from the
// limit. On an H100 80GB HBM3 at 700 W (PERF.md) it took 114 ms at
// B = 1024 on the equilibrated headline, where one thread per instance
// took 920 ms, and 406 ms at B = 8192. There each thread holds 255
// registers (and spills ~0.5 KB to L1), so an SM holds 8 blocks and the
// batch runs in two waves; capping the registers at 128 for 16 blocks an
// SM spilled more and lost 7-14% at B = 1024, at 8192 and on the adaptive
// headline. Teams of 16 and 32 were faster at
// B = 1024 and slower at 8192 and on the adaptive headline; keeping the
// whole Riccati scratch in shared memory (36 KB a team, six teams an SM)
// lost at every team size but 32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mpc_solve.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTeam = kK2Team;
constexpr int kTeams = kK2TeamsPerBlock;
constexpr int kThreads = kTeam * kTeams;

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

template <bool S, bool Store>
__global__ void __launch_bounds__(kThreads)
    mpc_solve_kernel(MpcDims D, int B, SolveOpts o, SolveArgs a) {
  extern __shared__ float smem[];
  const Team<kTeam, S> tm{
      cg::tiled_partition<kTeam>(cg::this_thread_block())};
  const int t = threadIdx.x / kTeam;
  const long long b = (long long)blockIdx.x * kTeams + t;
  if (b >= B) return;
  const MpcProb P = mpc_prob_im(D, a.q, a.r, a.c, a.x0, a.d, a.Q, a.R, a.S,
                                a.A, a.B, a.E, a.L, b);
  SolveOut out;
  out.x = mpc_vars_im(D, a.z, a.l, a.v, a.y, b);
  out.eflag = a.eflag + b;
  out.res = a.res + b;
  out.newton = a.newton + b;
  out.prox = a.prox + b;
  out.res0 = a.res0 + b;
  const long long N1 = D.N + 1;
  const SolveLayout L = solve_layout(D, !Store, S);
  const RicLayout rl = ric_layout(D, !Store);
  const Lane ws = lane_im(a.ws, L.total, b);
  const Lane fac = ws.at(L.step);
  fbstab_mpc_solve_lane<Store>(
      tm, D, o, P, lane_im(a.z0, N1 * (D.nx + D.nu), b),
      lane_im(a.l0, N1 * D.nx, b), lane_im(a.v0, N1 * D.nc, b), out, fac,
      S ? Lane{smem + t * rl.stage_floats, 1} : fac.at(rl.stage),
      ws.at(L.xk));
}

using SolveKernel = void (*)(MpcDims, int, SolveOpts, SolveArgs);

// The launch K2 takes at these dims, in this mode, on the current device:
// its teams stage where a block can hold their four stage blocks, and work
// in place otherwise (pick_launch).
Launch<SolveKernel> k2_launch(const MpcDims& D, bool lowmem) {
  return pick_launch(
      solve_smem_bytes(D),
      lowmem ? &mpc_solve_kernel<true, false> : &mpc_solve_kernel<true, true>,
      lowmem ? &mpc_solve_kernel<false, false>
             : &mpc_solve_kernel<false, true>,
      [&](bool s) { return solve_layout(D, lowmem, s).total; });
}

}  // namespace

extern "C" {

// Floats of device-memory scratch per instance for the launch at these
// dims in this mode (lowmem: the recompute-factors mode).
long long fb_solve_ws_floats(int N, int nx, int nu, int nc, int lowmem) {
  return k2_launch(MpcDims{N, nx, nu, nc}, lowmem != 0).ws_floats;
}

// Bytes of shared memory a block of teams that stage asks for.
long long fb_solve_smem_bytes(int N, int nx, int nu, int nc) {
  return solve_smem_bytes(MpcDims{N, nx, nu, nc});
}

// K2's launch shape at these dims in this mode: info[0..5] = threads per
// team, teams per block, registers per thread, local (spill) bytes per
// thread, shared bytes per block (0: the teams work in place), resident
// blocks per SM. Returns cudaGetLastError().
int fb_mpc_solve_info(int N, int nx, int nu, int nc, int lowmem, int* info) {
  return launch_info(k2_launch(MpcDims{N, nx, nu, nc}, lowmem != 0), kTeam,
                     kThreads, info);
}

// Launches K2 on `stream` in the standard mode or (lowmem) the
// recompute-factors mode. Arrays are instance-major (B, floats per
// instance); eflag, res, newton, prox, res0 are (B,); ws is
// (B, fb_solve_ws_floats). Returns cudaGetLastError().
int fb_mpc_solve(int N, int nx, int nu, int nc, int B, int lowmem,
                 SolveOpts o, const float* q, const float* r, const float* c,
                 const float* x0, const float* d, const float* Q,
                 const float* R, const float* S, const float* A,
                 const float* Bm, const float* E, const float* L,
                 const float* z0, const float* l0, const float* v0, float* z,
                 float* l, float* v, float* y, int* eflag, float* res,
                 int* newton, int* prox, float* res0, float* ws,
                 void* stream) {
  SolveArgs a{q, r, c, x0, d, Q, R, S, A, Bm, E, L, z0, l0, v0, z, l, v, y,
              eflag, res, newton, prox, res0, ws};
  const MpcDims D{N, nx, nu, nc};
  const Launch<SolveKernel> k = k2_launch(D, lowmem != 0);
  const int blocks = (B + kTeams - 1) / kTeams;
  k.kernel<<<blocks, kThreads, (size_t)k.smem, (cudaStream_t)stream>>>(
      D, B, o, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

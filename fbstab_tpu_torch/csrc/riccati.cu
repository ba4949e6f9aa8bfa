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
// Design: a team of threads per instance (a thread_block_tile,
// fbstab_common.cuh), teams filling a one-warp block, on the device code
// K2 and K4 run (riccati.cuh): inside a stage the team shares the
// Hessians, the products, the Choleskys column by column and the
// triangular solves. The team is chosen at launch from the stage's rows:
// kTeamSmall threads for nx <= kSmallNx (the headline, four teams a
// block), kTeamLarge beyond (the copolymerization reactor). Every factor
// and step entry is computed by one thread in the team of one's order, so
// each instantiation gives the same bits. Data, iterates, outputs and the
// stage factors are instance-major in device memory (the batch-first
// tensors as torch holds them, no transposes), so a team's accesses are
// contiguous; each team works on the current stage in a stage block of
// shared memory (2.3 KB at the headline, 10 KB at the copolymerization
// reactor, 49.9 KB at the JAX gate's corner nx = 32, nu = 24, nc = 48,
// for which the kernel opts in to more than the default 48 KB a block).
// Where one team's stage block exceeds what a block can hold, the same
// team runs without staging, its stage block in its device-memory scratch.
//
// What bounds it: the chain of dependent team phases per instance, N + 1
// stages of a few dozen phases (a Cholesky column, a triangular-solve
// step, a product), each a few shared-memory round trips, shuffles and
// syncs; the card's rates are far from the limit. One thread per instance
// on batch-last data, the design this replaces, paid a device-memory
// latency on each dependent load instead, with too few threads to hide it
// (fewer than one warp an SM at the copolymerization reactor's B = 2048).
// On an H100 80GB HBM3 at 700 W (PERF.md; the wrapper as the solvers call
// it) the step took 4.6-4.9 ms at the headline's B = 8192, where one
// thread per instance took 15.0 ms (bound 0.094 ms), and 24-25 ms at the
// copolymerization reactor's B = 2048, where it took 186 ms (bound
// 0.24 ms). The registers are capped at 128 (16 one-warp blocks an SM):
// uncapped, ptxas takes 168 and the SM holds 12 blocks, so both batches
// run in two waves, and the step took 6.3-7.5 and 32 ms. Teams of 16 and
// 32 were slower at the headline (8.3 and 13-14 ms uncapped); at the
// copolymerization reactor an uncapped team of 16 was ~3% faster than
// the capped warp and a team of 8 slower (30 ms). Where one instance
// runs alone (the single-instance scan, B = 1), the step is the latency
// of one team walking N + 1 stages: ~9 ms at N = 480, nx = 2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "riccati.cuh"

namespace {

namespace cg = cooperative_groups;

// K1's teams, constants chosen on the card (PERF.md): threads per
// instance for stages of at most kSmallNx state rows, and beyond. Teams
// fill a one-warp block. The registers are capped for kMinBlocks resident
// blocks an SM (128 a thread), so that the headline's B = 8192 and the
// copolymerization reactor's B = 2048 each run in one wave.
constexpr int kSmallNx = 8;
constexpr int kTeamSmall = 8;
constexpr int kTeamLarge = 32;
constexpr int kThreads = 32;
constexpr int kMinBlocks = 16;

struct StepArgs {
  const float *sigma, *Q, *R, *S, *A, *B, *E, *L, *v, *y, *vbar, *rz, *rl,
      *rv;
  float *dz, *dl, *ws;
  long long ws_floats;  // scratch floats per instance
};

template <int T, bool S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    riccati_step_kernel(MpcDims D, int B, float alpha, float om_alpha,
                        StepArgs a) {
  extern __shared__ float smem[];
  const Team<T, S> tm{cg::tiled_partition<T>(cg::this_thread_block())};
  const int t = threadIdx.x / T;
  const long long b = (long long)blockIdx.x * (kThreads / T) + t;
  if (b >= B) return;
  const long long N1 = D.N + 1, nx = D.nx, nu = D.nu, nc = D.nc;
  MpcProb P{};
  P.Q = lane_im(a.Q, N1 * nx * nx, b);
  P.R = lane_im(a.R, N1 * nu * nu, b);
  P.S = lane_im(a.S, N1 * nu * nx, b);
  P.A = lane_im(a.A, D.N * nx * nx, b);
  P.B = lane_im(a.B, D.N * nx * nu, b);
  P.E = lane_im(a.E, N1 * nc * nx, b);
  P.L = lane_im(a.L, N1 * nc * nu, b);
  const RicLayout rl = ric_layout(D);
  const Lane w = lane_im(a.ws, a.ws_floats, b);
  const Lane st = S ? Lane{smem + t * rl.stage_floats, 1} : w.at(rl.stage);
  riccati_factor_solve(
      tm, D, a.sigma[b], alpha, om_alpha, P, lane_im(a.v, N1 * nc, b),
      lane_im(a.y, N1 * nc, b), lane_im(a.vbar, N1 * nc, b),
      lane_im(a.rz, N1 * (nx + nu), b), lane_im(a.rl, N1 * nx, b),
      lane_im(a.rv, N1 * nc, b), lane_im(a.dz, N1 * (nx + nu), b),
      lane_im(a.dl, N1 * nx, b), w, st);
}

using StepKernel = void (*)(MpcDims, int, float, float, StepArgs);

// The launch K1 takes at these dims on the current device.
struct K1Launch {
  StepKernel kernel;
  int team;
  bool stages;
  long long smem;       // dynamic shared bytes per block
  long long ws_floats;  // device-memory scratch per instance
};

K1Launch k1_launch(const MpcDims& D) {
  const RicLayout rl = ric_layout(D);
  const int team = D.nx <= kSmallNx ? kTeamSmall : kTeamLarge;
  const long long smem = 4LL * (kThreads / team) * rl.stage_floats;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool stages = smem <= optin;
  StepKernel k;
  if (team == kTeamSmall)
    k = stages ? &riccati_step_kernel<kTeamSmall, true>
               : &riccati_step_kernel<kTeamSmall, false>;
  else
    k = stages ? &riccati_step_kernel<kTeamLarge, true>
               : &riccati_step_kernel<kTeamLarge, false>;
  // Above the default 48 KB a block takes dynamic shared memory only
  // after it opts in.
  if (stages && smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  return K1Launch{k, team, stages, stages ? smem : 0,
                  stages ? rl.stage : rl.total};
}

}  // namespace

extern "C" {

// Floats of Newton-step scratch per instance for the launch at these dims.
long long fb_riccati_ws_floats(int N, int nx, int nu, int nc) {
  return k1_launch(MpcDims{N, nx, nu, nc}).ws_floats;
}

// K1's launch shape at these dims, as fb_mpc_solve_info gives K2's:
// info[0..5] = threads per team, teams per block, registers per thread,
// local (spill) bytes per thread, shared bytes per block (0: the team
// does not stage), resident blocks per SM. Returns cudaGetLastError().
int fb_riccati_info(int N, int nx, int nu, int nc, int* info) {
  const K1Launch l = k1_launch(MpcDims{N, nx, nu, nc});
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, l.kernel);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, kThreads,
                                                (size_t)l.smem);
  info[0] = l.team;
  info[1] = kThreads / l.team;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = (int)l.smem;
  info[5] = blocks;
  return (int)cudaGetLastError();
}

// Launches K1 on `stream`. Every array is instance-major (B, floats per
// instance), sigma is (B,), ws is (B, fb_riccati_ws_floats). Returns
// cudaGetLastError().
int fb_riccati_step(int N, int nx, int nu, int nc, int B, float alpha,
                    float om_alpha, const float* sigma, const float* Q,
                    const float* R, const float* S, const float* A,
                    const float* Bm, const float* E, const float* L,
                    const float* v, const float* y, const float* vbar,
                    const float* rz, const float* rl, const float* rv,
                    float* dz, float* dl, float* ws, void* stream) {
  const MpcDims D{N, nx, nu, nc};
  const K1Launch l = k1_launch(D);
  const StepArgs a{sigma, Q, R, S, A, Bm, E, L, v, y, vbar, rz, rl, rv,
                   dz, dl, ws, l.ws_floats};
  const int teams = kThreads / l.team;
  const int blocks = (B + teams - 1) / teams;
  const StepKernel k = l.kernel;
  k<<<blocks, kThreads, (size_t)l.smem, (cudaStream_t)stream>>>(
      D, B, alpha, om_alpha, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

// K1: the batched MPC Newton step on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/riccati_pallas.py::
// riccati_newton_step_batched (kernel body _newton_step_kernel ->
// riccati_factor_solve) in both its modes: the storing grid launch and the
// recompute-factors ("lowmem") launch, riccati_pallas.py:539, which keeps
// only the carried factors Lc and recomputes each stage's factors in the
// vector passes (riccati.cuh, bit for bit the storing mode's step). A
// launch takes lowmem where the caller asks (models/mpc_qp.py::
// riccati_mode: where the batch's storing scratch would fill more than a
// quarter of the card's memory). PFB weights, barrier-augmented stage
// Hessians, the forward Riccati matrix recursion with small Choleskys, the
// forward vector recursion and the backward substitution, giving (dz, dl).
// The dual recovery (dv, dy) is a wide elementwise pass left to PyTorch,
// as the JAX wrapper leaves it to XLA.
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

template <int T, bool S, bool Store>
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
  const RicLayout rl = ric_layout(D, !Store);
  const Lane w = lane_im(a.ws, a.ws_floats, b);
  const Lane st = S ? Lane{smem + t * rl.stage_floats, 1} : w.at(rl.stage);
  riccati_factor_solve<Store>(
      tm, D, a.sigma[b], alpha, om_alpha, P, lane_im(a.v, N1 * nc, b),
      lane_im(a.y, N1 * nc, b), lane_im(a.vbar, N1 * nc, b),
      lane_im(a.rz, N1 * (nx + nu), b), lane_im(a.rl, N1 * nx, b),
      lane_im(a.rv, N1 * nc, b), lane_im(a.dz, N1 * (nx + nu), b),
      lane_im(a.dl, N1 * nx, b), w, st);
}

using StepKernel = void (*)(MpcDims, int, float, float, StepArgs);

// K1's team at these dims: kTeamSmall threads up to kSmallNx states,
// kTeamLarge beyond.
int k1_team(const MpcDims& D) {
  return D.nx <= kSmallNx ? kTeamSmall : kTeamLarge;
}

template <int T, bool Store>
Launch<StepKernel> k1_pick(const MpcDims& D, bool lowmem) {
  return pick_launch(4LL * (kThreads / T) * ric_layout(D, lowmem).stage_floats,
                     &riccati_step_kernel<T, true, Store>,
                     &riccati_step_kernel<T, false, Store>,
                     [&](bool s) { return ric_ws_floats(D, lowmem, s); });
}

// The launch K1 takes at these dims, in this mode, on the current device.
Launch<StepKernel> k1_launch(const MpcDims& D, bool lowmem) {
  if (k1_team(D) == kTeamSmall)
    return lowmem ? k1_pick<kTeamSmall, false>(D, true)
                  : k1_pick<kTeamSmall, true>(D, false);
  return lowmem ? k1_pick<kTeamLarge, false>(D, true)
                : k1_pick<kTeamLarge, true>(D, false);
}

}  // namespace

extern "C" {

// Floats of Newton-step scratch per instance for the launch at these dims
// in this mode (lowmem: the recompute-factors mode).
long long fb_riccati_ws_floats(int N, int nx, int nu, int nc, int lowmem) {
  return k1_launch(MpcDims{N, nx, nu, nc}, lowmem != 0).ws_floats;
}

// K1's launch shape at these dims in this mode, as fb_mpc_solve_info gives
// K2's: info[0..5] = threads per team, teams per block, registers per
// thread, local (spill) bytes per thread, shared bytes per block (0: the
// team does not stage), resident blocks per SM. Returns
// cudaGetLastError().
int fb_riccati_info(int N, int nx, int nu, int nc, int lowmem, int* info) {
  const MpcDims D{N, nx, nu, nc};
  return launch_info(k1_launch(D, lowmem != 0), k1_team(D), kThreads, info);
}

// Launches K1 on `stream` in the storing mode or (lowmem) the
// recompute-factors mode. Every array is instance-major (B, floats per
// instance), sigma is (B,), ws is (B, fb_riccati_ws_floats). Returns
// cudaGetLastError().
int fb_riccati_step(int N, int nx, int nu, int nc, int B, int lowmem,
                    float alpha, float om_alpha, const float* sigma,
                    const float* Q, const float* R, const float* S,
                    const float* A, const float* Bm, const float* E,
                    const float* L, const float* v, const float* y,
                    const float* vbar, const float* rz, const float* rl,
                    const float* rv, float* dz, float* dl, float* ws,
                    void* stream) {
  const MpcDims D{N, nx, nu, nc};
  const Launch<StepKernel> l = k1_launch(D, lowmem != 0);
  const StepArgs a{sigma, Q, R, S, A, Bm, E, L, v, y, vbar, rz, rl, rv,
                   dz, dl, ws, l.ws_floats};
  const int teams = kThreads / k1_team(D);
  const int blocks = (B + teams - 1) / teams;
  const StepKernel k = l.kernel;
  k<<<blocks, kThreads, (size_t)l.smem, (cudaStream_t)stream>>>(
      D, B, alpha, om_alpha, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

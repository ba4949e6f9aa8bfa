// The MPC refinement's double-float residual on Hopper: one launch an
// evaluation computes, for every lane, the margin y as a (hi, lo) pair, the
// KKT blocks rzx, rzu, rl and the penalized FB block rv rounded to float32
// (the right-hand side K1 reads), and the original-units penalized natural
// residual norm (refine_residual.cuh). It replaces the eager PyTorch
// composition of models/refine.py (`_margin`, `_mpc_kkt_residual_df`,
// `_mpc_norms`, `df_to`), about two thousand small
// operator launches an evaluation, and is bit for bit that composition's y
// and blocks. It replaces no TPU kernel: the JAX package leaves this
// residual to XLA, which fuses the same elementwise chain.
//
// What bounds it: the bytes of the (per-lane Ruiz-scaled) stage data, read
// once: 1,134 floats a stage at the copolymerization reactor (nx 18, nu 5,
// nc 10), 81 stages, B = 2048: 0.75 GB, 0.22 ms at 3.35 TB/s; 252 floats
// at the spacecraft (nx 6, nu 3, nc 12), 41 stages, B = 8192: 0.34 GB,
// 0.10 ms. The arithmetic, ~1,800 double-float multiply-adds a reactor
// stage at ~30 rounding float32 operations each (no contraction), is ~9 G
// operations at B = 2048, ~0.3 ms at the card's float32 rate without FMA. An
// expanded plant (batch stride 0, the final check's data) reads one
// instance from L2.
//
// Design: a team of threads per lane, chosen at launch from the stage's
// rows as K1's is (kTeamSmall threads for nx <= kSmallNx, a warp beyond),
// teams filling a one-warp block. The team walks the lane's stages; at each
// it copies the stage's operands (the data at any batch and stage stride,
// so an expanded plant or an index_select'ed sub-batch is read where it
// lies, and the iterate pairs) into its stage block in shared memory, then
// its threads take the stage's outputs round-robin, one output a thread,
// each the same four-product code, and write them. The norm's partial sums
// stay in registers until the end, then meet in rank order in shared
// memory: no atomics, the same bits every run. Where a team's stage block
// exceeds what a block can hold, the same team reads its operands in place.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md; device time from CUDA
// graph replays, the wrapper's host time 0.1-0.2 ms beside it): 2.26-2.30
// ms an evaluation at the reactor's B = 2048 on per-lane data, 1.47-1.50 ms
// at the spacecraft's B = 8192, 1.49 and 0.84 ms for the final check's
// norm on an expanded plant; the eager composition took 48-50 and 23-24
// ms. Still ~8x from the bound: each multiply-add is a chain of dependent
// roundings, and the teams hold 128 registers (16 one-warp blocks an SM).
// Tried and not kept, in turns on one card: the staging copies as cp.async
// (no faster), an output's four products advanced side by side (17%
// faster at the reactor's step, 11-53% slower elsewhere), and a cap of 80
// registers for 24 blocks an SM (spills, 20-40% slower).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fbstab_common.cuh"
#include "refine_residual.cuh"

namespace {

namespace cg = cooperative_groups;

// Threads per lane for stages of at most kSmallNx state rows, and beyond
// (K1's choice); teams fill a one-warp block.
constexpr int kSmallNx = 8;
constexpr int kTeamSmall = 8;
constexpr int kTeamLarge = 32;
constexpr int kThreads = 32;

// Shared bytes of a block's partial sums (4 doubles a thread); the stage
// blocks of a staging launch follow them.
constexpr long long kPartBytes = 4LL * 8 * kThreads;

template <int T, bool S>
__global__ void __launch_bounds__(kThreads)
    refine_residual_kernel(int N, int nx, int nu, int nc, int B, RrArgs a) {
  extern __shared__ double smem[];
  const Team<T, S> tm{cg::tiled_partition<T>(cg::this_thread_block())};
  const int t = threadIdx.x / T;
  const long long b = (long long)blockIdx.x * (kThreads / T) + t;
  if (b >= B) return;
  float* blk = S ? reinterpret_cast<float*>(smem + 4 * kThreads) +
                       t * rr_stage_floats(nx, nu, nc)
                 : nullptr;
  rr_lane(tm, N, nx, nu, nc, a, b, blk, smem + 4 * T * t);
}

using ResidualKernel = void (*)(int, int, int, int, int, RrArgs);

int rr_team(int nx) { return nx <= kSmallNx ? kTeamSmall : kTeamLarge; }

template <int T>
Launch<ResidualKernel> rr_pick(int nx, int nu, int nc) {
  Launch<ResidualKernel> l = pick_launch(
      kPartBytes + 4LL * (kThreads / T) * rr_stage_floats(nx, nu, nc),
      &refine_residual_kernel<T, true>, &refine_residual_kernel<T, false>,
      [](bool) { return 0LL; });
  if (!l.stages) l.smem = kPartBytes;
  return l;
}

// The launch at these dims on the current device.
Launch<ResidualKernel> rr_launch(int nx, int nu, int nc) {
  return rr_team(nx) == kTeamSmall ? rr_pick<kTeamSmall>(nx, nu, nc)
                                   : rr_pick<kTeamLarge>(nx, nu, nc);
}

}  // namespace

extern "C" {

// The launch shape at these dims, as fb_riccati_info gives K1's: info[0..5]
// = threads per team, teams per block, registers per thread, local (spill)
// bytes per thread, shared bytes per block, resident blocks per SM.
// Returns cudaGetLastError().
int fb_refine_residual_info(int nx, int nu, int nc, int* info) {
  return launch_info(rr_launch(nx, nu, nc), rr_team(nx), kThreads, info);
}

// Launches the residual of B lanes on `stream` (RrArgs: the fields with
// their strides, the outputs, alpha). Returns cudaGetLastError().
int fb_refine_residual(int N, int nx, int nu, int nc, int B, RrArgs a,
                       void* stream) {
  const Launch<ResidualKernel> l = rr_launch(nx, nu, nc);
  const int teams = kThreads / rr_team(nx);
  const int blocks = (B + teams - 1) / teams;
  l.kernel<<<blocks, kThreads, (size_t)l.smem, (cudaStream_t)stream>>>(
      N, nx, nu, nc, B, a);
  return (int)cudaGetLastError();
}

}  // extern "C"

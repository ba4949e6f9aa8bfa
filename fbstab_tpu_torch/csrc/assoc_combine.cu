// K5: one level of the associative Riccati scan on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/assoc_riccati.py::
// _combine_bl_pallas (kernel body _make_combine_kernel): it combines M
// pairs of adjacent span elements of every instance, K = P22_l + P11_r,
// 2n + 1 Jacobi-equilibrated SPD solves against that one K, six small
// products and the symmetrized diagonal blocks (assoc_combine.cuh). The
// scan over the horizon (ops/assoc_riccati.py) launches it once per level.
//
// Design: a team of threads per (pair m, instance b) (a
// thread_block_tile, fbstab_common.cuh), teams filling a one-warp block,
// on instance-major spans: blocks (M, B, n, n) and vectors (M, B, n), so
// a team's loads and stores are consecutive floats. The team copies its
// operands into a stage block in shared memory (7 n^2 + 4 n floats: 9.4 KB
// at the copolymerization reactor's n = 18, 29.2 KB at n = 32), factors
// s K s there, solves the 2n + 1 right-hand sides a thread each against
// the shared factor, splits the products by output entry and writes the
// outputs with contiguous stores; it needs no device-memory scratch. One
// team a block, the stage block fits the default 48 KB of shared memory
// at every n <= 32. The kernel takes each operand's stride along the
// pair axis, so the stage-strided views the scan hands it (every other
// element of a level) need no copy; the inner (B, n, n) or (B, n) dims
// are contiguous. The TPU kernel's lane conditions (B >= 128, padding with
// 1.0) have no counterpart. n <= 32, as for the Pallas kernel.
//
// What bounds it: per (pair, instance) ~n^3 / 3 operations for the factor,
// 2 n^2 (2n + 1) for the solves and ~8 n^3 for the products (~7e4 at
// n = 18) against ~14 n^2 floats moved; the card's rates are far from the
// limit. The one thread per (pair, instance) this design replaces walked
// that chain alone, each operand a device-memory load: 2.567 ms at the
// widest level of the copolymerization reactor's scan (M = 40, B = 256,
// bound 0.037 ms; H100 80GB HBM3 at 700 W, PERF.md). Here the chain is the
// team's: n Cholesky columns, one solve of n^2 shared-memory steps a
// thread, and a few dozen dot products a thread; on the same card the
// level took 0.47 ms (72 registers, no spills; 22 blocks an SM, set by
// the shared memory, so the level's 10,240 teams run in 3.5 waves). Teams
// of 16 and 8 took 0.51 and 0.72 ms there; at the double integrator's
// n = 2 (the single-instance scan, host-bound) the team size moved nothing
// beyond the run-to-run spread, so one size serves every n.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "assoc_combine.cuh"

namespace {

namespace cg = cooperative_groups;

// Threads per (pair, instance), chosen on the card (PERF.md); teams fill
// a one-warp block.
constexpr int kTeam = 32;
constexpr int kThreads = 32;

struct SpanPtrs {
  const float *P11, *P12, *P22, *p1, *p2;
  long long sP11, sP12, sP22, sp1, sp2;  // strides along the pair axis
};

__device__ Span span_at(const SpanPtrs& e, int n, int m, long long b) {
  const long long nn = (long long)n * n;
  auto at = [&](const float* p, long long sm, long long k) {
    return Lane{const_cast<float*>(p) + m * sm + b * k, 1};
  };
  return Span{at(e.P11, e.sP11, nn), at(e.P12, e.sP12, nn),
              at(e.P22, e.sP22, nn), at(e.p1, e.sp1, n),
              at(e.p2, e.sp2, n)};
}

__global__ void __launch_bounds__(kThreads)
    assoc_combine_kernel(int n, int M, int B, SpanPtrs left, SpanPtrs right,
                         SpanPtrs out) {
  extern __shared__ float smem[];
  const Team<kTeam> tm{
      cg::tiled_partition<kTeam>(cg::this_thread_block())};
  const int t = threadIdx.x / kTeam;
  const long long g = (long long)blockIdx.x * (kThreads / kTeam) + t;
  if (g >= (long long)M * B) return;
  const int m = (int)(g / B);
  const long long b = g % B;
  const Lane st{smem + t * combine_layout(n, true).total, 1};
  assoc_combine_team(tm, n, span_at(left, n, m, b), span_at(right, n, m, b),
                     span_at(out, n, m, b), st);
}

// Dynamic shared bytes per block: each team's stage block.
long long k5_smem(int n) {
  return 4LL * (kThreads / kTeam) * combine_layout(n, true).total;
}

}  // namespace

extern "C" {

// K5's launch shape at this n, as fb_riccati_info gives K1's: info[0..5] =
// threads per team, teams per block, registers per thread, local (spill)
// bytes per thread, shared bytes per block, resident blocks per SM.
// Returns cudaGetLastError().
int fb_combine_info(int n, int* info) {
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, assoc_combine_kernel);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, assoc_combine_kernel, kThreads, (size_t)k5_smem(n));
  info[0] = kTeam;
  info[1] = kThreads / kTeam;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = (int)k5_smem(n);
  info[5] = blocks;
  return (int)cudaGetLastError();
}

// Launches K5 on `stream`: left and right are five arrays each (P11, P12,
// P22 as (M, B, n, n), p1, p2 as (M, B, n), each with contiguous inner
// dims), `strides` their ten strides along the pair axis in floats (left's
// five, then right's); out the five combined blocks, contiguous. Returns
// cudaGetLastError().
int fb_assoc_combine(int n, int M, int B, const long long* strides,
                     const float* lP11, const float* lP12, const float* lP22,
                     const float* lp1, const float* lp2, const float* rP11,
                     const float* rP12, const float* rP22, const float* rp1,
                     const float* rp2, float* oP11, float* oP12, float* oP22,
                     float* op1, float* op2, void* stream) {
  const long long mat = (long long)B * n * n, vec = (long long)B * n;
  const SpanPtrs left{lP11, lP12, lP22, lp1, lp2, strides[0], strides[1],
                      strides[2], strides[3], strides[4]};
  const SpanPtrs right{rP11, rP12, rP22, rp1, rp2, strides[5], strides[6],
                       strides[7], strides[8], strides[9]};
  const SpanPtrs out{oP11, oP12, oP22, op1, op2, mat, mat, mat, vec, vec};
  const long long teams = (long long)M * B, per_block = kThreads / kTeam;
  const int blocks = (int)((teams + per_block - 1) / per_block);
  assoc_combine_kernel<<<blocks, kThreads, (size_t)k5_smem(n),
                         (cudaStream_t)stream>>>(n, M, B, left, right, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

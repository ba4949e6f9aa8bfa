// P1: the stage-matvec probe on Hopper, in three forms.
//
// Replaces the three Pallas TPU kernels of bench.py's `run_mxu`
// (vpu_perlane bench.py:953, vpu_shared :963, mxu_shared :973, each
// launched by the pallas_call at bench.py:998; the same probe in
// scratch/tpu_mxu.py:104). Each applies, T times, w_s <- scale * M_s w_s
// to every stage s of every lane b: M is per lane, (N1, n, n, B), or
// shared, (N1, n, n); w is (N1 * n, B) with stage s in rows s*n .. s*n +
// n - 1. The question the probe answers: do matrix units beat vector code
// on the stage products at the copolymerization reactor's stage size
// (n = 18)?
//
//   form 0, cuda_perlane (vpu_perlane): per-lane M on the CUDA cores;
//   form 1, cuda_shared  (vpu_shared):  shared M on the CUDA cores;
//   form 2, tc_shared    (mxu_shared):  shared M as one TF32 tensor-core
//                                       product per stage (mma.sync
//                                       m16n8k8, n padded to 32 x 8k).
//
// The recurrence never mixes stages or lanes, so every team keeps its
// slice resident for all T applications and the T loop runs inside the
// kernel (the reference's fori_loop), one launch per call.
//
// What bounds the CUDA-core forms: operations, 2 n^2 N1 B T = 1.34 GFLOP
// at the probe's shape (N1 = 81, n = 18, B = 128, T = 200), 20.1 us at
// the float32 peak, against 14.9 MB (per lane) or 1.6 MB (shared) moved
// once (4.4 us or less). One application is only 3.36 M FMAs, ~200
// cycles of the 132 SMs' FP32 units, about 11 outputs per FP32 lane: too
// little work to hide latency behind more warps, so it is hidden inside
// each thread, and the FP32 units are kept fed by issuing little else.
//  - A team per (stage, c lanes) inside one warp (mxu_probe.cuh): each
//    thread holds r rows of M_s in registers, read once (per lane: M is
//    13.4 MB, 40% of the card's registers), and r x c independent
//    accumulators; each 16-byte broadcast load of the team's w buffer
//    feeds 4 r FMAs; the buffer is double-buffered, so one __syncwarp per
//    application, and the T loop is unrolled by two and has no branch, so
//    the loop body is the FMAs, the loads, the scale and the stores. Form 0: kPerlaneTeam threads per (stage, lane); form 1:
//    kSharedTeam threads per (stage, kSharedLanes lanes).
//  - n is a template parameter (1 .. kMxuMaxN): every loop has an exact
//    trip count and the arrays stay in registers.
//  - At n = 18 a team of 3 (6 rows a thread, 6 or 12 accumulators) packs
//    10 teams in a warp (30 of 32 lanes); with 4-warp blocks the whole
//    grid is resident at once (one wave: 260 blocks per lane, 130 shared)
//    and every scheduler of an SM gets the same share.
//  - What is left (H100 at 1980 MHz, PERF.md §6): one application
//    takes ~350 cycles against ~250 issue slots a scheduler and ~200 for
//    the FMAs alone at full lanes; the per-lane form's M (13.4 MB) adds
//    ~3 us before the first application.
//  - tc_shared: a block per (stage, 4 tiles of 8 lanes), a warp per tile.
//    The padded M_s (32 x 32, zeros beyond n) is loaded once and
//    converted to TF32 A fragments held in registers for all T; each warp
//    keeps its tile of w_s (32 x 8, rows >= n zero) in shared memory and
//    per application loads the B fragments, runs 2 (m) x ceil(n/8) (k)
//    MMAs, scales and writes rows < n back. Tiles are independent:
//    __syncwarp. Bound: 2.7 us at the TF32 tensor peak.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_probe.cuh"

namespace {

constexpr int kP1Warps = 4;     // warps per block, CUDA-core forms
constexpr int kMaxN = kMxuMaxN; // tc_shared pads M_s to kMaxN x kMaxN
constexpr int kTcWarps = 4;     // warps (8-lane tiles) per block, tc form

// The split of form 0 (kPerLane) or 1 at stage size N: C lanes and R rows
// a thread, G threads a team, P teams a warp; a block holds two copies of
// each team's buffer and of one spare buffer per warp, which its idle
// lanes (32 - P G < G of them) run on.
template <int N, bool kPerLane>
struct P1Split {
  static constexpr int C = kPerLane ? 1 : kSharedLanes;
  static constexpr int team = p1_team_size(
      N, kPerLane ? kPerlaneTeam : kSharedTeam, kPerLane ? C : 1);
  static constexpr int R = p1_rows(N, team), G = p1_threads(N, team);
  static constexpr int P = 32 / G, L = p1_buf_floats(N, C);
  static constexpr int teams_per_block = kP1Warps * P;
  static constexpr int slots = teams_per_block + kP1Warps;
  static_assert(2 * slots * L * 4 <= 48 * 1024,
                "w buffers beyond static shared memory");
};

struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};

// Lane (p G + k) of warp `warp` is thread k of team p; the block's teams
// are consecutive (stage, lane chunk) pairs, chunks fastest.
template <int N, bool kPerLane>
__global__ void __launch_bounds__(32 * kP1Warps)
    stage_matvec_team(int N1, int B, int T, float scale,
                      const float* __restrict__ M,
                      const float* __restrict__ w0, float* __restrict__ w) {
  using Sp = P1Split<N, kPerLane>;
  __shared__ __align__(16) float buf[2][Sp::slots][Sp::L];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = lane / Sp::G, k = lane % Sp::G;
  const int slot = p < Sp::P ? warp * Sp::P + p : Sp::teams_per_block + warp;
  const long long team =
      (long long)blockIdx.x * Sp::teams_per_block + warp * Sp::P + p;
  const int chunks = (B + Sp::C - 1) / Sp::C;
  const long long s = team / chunks;
  const int b0 = (int)(team % chunks) * Sp::C;
  const bool live = p < Sp::P && s < N1;
  p1_team<kPerLane>(P1Fixed<N, Sp::R, Sp::C>{}, WarpSync{}, live, k, s, b0,
                    B, T, scale, M, w0, w, buf[0][slot], buf[1][slot]);
}

template <int N, bool kPerLane>
int stage_matvec_team_blocks(int N1, int B) {
  using Sp = P1Split<N, kPerLane>;
  const long long teams = (long long)N1 * ((B + Sp::C - 1) / Sp::C);
  return (int)((teams + Sp::teams_per_block - 1) / Sp::teams_per_block);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D += A B for one m16n8k8 TF32 tile, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void stage_matvec_tensor_cores(int n, int B, int T, float scale,
                                          const float* __restrict__ M,
                                          const float* __restrict__ w0,
                                          float* __restrict__ w_out) {
  __shared__ float msh[kMaxN * kMaxN];            // padded M_s, row-major
  __shared__ float wsh[kTcWarps][kMaxN * 8];      // per warp: w tile (k, col)
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;       // groupID
  const int q = lane & 3;        // threadID_in_group
  const int col0 = (blockIdx.x * kTcWarps + warp) * 8;
  const int KT = (n + 7) / 8;

  for (int idx = threadIdx.x; idx < kMaxN * kMaxN; idx += blockDim.x) {
    const int r = idx / kMaxN, c = idx % kMaxN;
    msh[idx] = (r < n && c < n) ? M[((long long)s * n + r) * n + c] : 0.0f;
  }
  float* wt = wsh[warp];
  for (int idx = lane; idx < kMaxN * 8; idx += 32) {
    const int k = idx / 8, c = idx % 8;
    const int b = col0 + c;
    wt[idx] = (k < n && b < B) ? w0[((long long)s * n + k) * B + b] : 0.0f;
  }
  __syncthreads();

  // A fragments (PTX m16n8k8 .tf32 layout): a0 (g, q), a1 (g+8, q),
  // a2 (g, q+4), a3 (g+8, q+4) of the 16 x 8 tile (mt, kt).
  uint32_t a[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int r = mt * 16 + g, c = kt * 8 + q;
      a[mt][kt][0] = to_tf32(msh[r * kMaxN + c]);
      a[mt][kt][1] = to_tf32(msh[(r + 8) * kMaxN + c]);
      a[mt][kt][2] = to_tf32(msh[r * kMaxN + c + 4]);
      a[mt][kt][3] = to_tf32(msh[(r + 8) * kMaxN + c + 4]);
    }

  for (int t = 0; t < T; ++t) {
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt < KT) {
        // B fragment: b0 (row q, col g), b1 (row q+4, col g).
        const uint32_t b0 = to_tf32(wt[(kt * 8 + q) * 8 + g]);
        const uint32_t b1 = to_tf32(wt[(kt * 8 + q + 4) * 8 + g]);
        mma_tf32(d[0], a[0][kt], b0, b1);
        mma_tf32(d[1], a[1][kt], b0, b1);
      }
    }
    __syncwarp();
    // D fragment: d0 (g, 2q), d1 (g, 2q+1), d2 (g+8, 2q), d3 (g+8, 2q+1).
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      if (r0 < n) {
        wt[r0 * 8 + 2 * q] = d[mt][0] * scale;
        wt[r0 * 8 + 2 * q + 1] = d[mt][1] * scale;
      }
      if (r1 < n) {
        wt[r1 * 8 + 2 * q] = d[mt][2] * scale;
        wt[r1 * 8 + 2 * q + 1] = d[mt][3] * scale;
      }
    }
    __syncwarp();
  }
  for (int idx = lane; idx < n * 8; idx += 32) {
    const int k = idx / 8, c = idx % 8;
    const int b = col0 + c;
    if (b < B) w_out[((long long)s * n + k) * B + b] = wt[idx];
  }
}

// Calls f.template go<N>() for the stage size N = n in 1 .. kMxuMaxN.
template <int N = 1, class F>
int with_n(int n, const F& f) {
  if constexpr (N > kMxuMaxN)
    return (int)cudaErrorInvalidValue;
  else
    return n == N ? f.template go<N>() : with_n<N + 1>(n, f);
}

struct TeamLaunch {
  int form, N1, B, T;
  float scale;
  const float *M, *w0;
  float* w;
  cudaStream_t st;
  template <int N>
  int go() const {
    if (form == 0)
      stage_matvec_team<N, true>
          <<<stage_matvec_team_blocks<N, true>(N1, B), 32 * kP1Warps, 0,
             st>>>(N1, B, T, scale, M, w0, w);
    else
      stage_matvec_team<N, false>
          <<<stage_matvec_team_blocks<N, false>(N1, B), 32 * kP1Warps, 0,
             st>>>(N1, B, T, scale, M, w0, w);
    return (int)cudaGetLastError();
  }
};

template <class K>
void fill_info(K kernel, int threads, size_t dyn_smem, int* info) {
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                dyn_smem);
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = (int)(fa.sharedSizeBytes + dyn_smem);
  info[5] = blocks;
}

struct TeamInfo {
  int form, N1, B;
  int* info;
  template <int N>
  int go() const {
    auto put = [&](auto split, auto kernel, int blocks) {
      using Sp = decltype(split);
      info[0] = Sp::G;
      info[1] = Sp::teams_per_block;
      fill_info(kernel, 32 * kP1Warps, 0, info);
      info[6] = Sp::R;
      info[7] = Sp::C;
      info[8] = blocks;
    };
    if (form == 0)
      put(P1Split<N, true>{}, stage_matvec_team<N, true>,
          stage_matvec_team_blocks<N, true>(N1, B));
    else
      put(P1Split<N, false>{}, stage_matvec_team<N, false>,
          stage_matvec_team_blocks<N, false>(N1, B));
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// The largest stage size the probe kernels take.
int fb_mxu_max_n() { return kMxuMaxN; }

// The launch of form `form` at stage size n for N1 stages of B lanes:
// info[0] threads per team (a warp per 8-lane tile for form 2),
// info[1] teams per block, info[2] registers per thread, info[3] local
// (spill) bytes per thread, info[4] shared bytes per block, info[5]
// resident blocks per SM, info[6] rows and info[7] lanes a thread holds
// (0 for form 2), info[8] blocks of the grid. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a form or n the kernels do not take.
int fb_mxu_probe_info(int form, int n, int N1, int B, int* info) {
  if (n < 1 || n > kMxuMaxN || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  if (form < 2) return with_n(n, TeamInfo{form, N1, B, info});
  info[0] = 32;
  info[1] = kTcWarps;
  fill_info(stage_matvec_tensor_cores, 32 * kTcWarps, 0, info);
  info[6] = 0;
  info[7] = 0;
  info[8] = (B + 8 * kTcWarps - 1) / (8 * kTcWarps) * N1;
  return (int)cudaGetLastError();
}

// Launches form 0 (cuda_perlane), 1 (cuda_shared) or 2 (tc_shared) on
// `stream`: T applications of w_s <- scale * M_s w_s. M: (N1, n, n, B)
// for form 0, (N1, n, n) otherwise; w0 and w: (N1 * n, B). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a form or n it does
// not take.
int fb_mxu_probe(int form, int N1, int n, int B, int T, float scale,
                 const float* M, const float* w0, float* w, void* stream) {
  if (n < 1 || n > kMxuMaxN || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form < 2)
    return with_n(n, TeamLaunch{form, N1, B, T, scale, M, w0, w, st});
  const dim3 grid((B + 8 * kTcWarps - 1) / (8 * kTcWarps), N1);
  stage_matvec_tensor_cores<<<grid, 32 * kTcWarps, 0, st>>>(
      n, B, T, scale, M, w0, w);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//   form 2, tc_shared    (mxu_shared):  shared M on the TF32 tensor
//                                       cores (mma.sync m16n8k8, w in
//                                       registers for all T).
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
//  - tc_shared (mxu_probe.cuh, p1_tc_warp): a warp per (stage, 16 lanes)
//    computes w_s^T <- scale * (w_s^T M_s^T) on TF32 MMAs, n padded to
//    NT = ceil(n / 8) tiles (a template parameter, 1 .. 4). Its bound is
//    the same operations at the TF32 tensor peak, 2.7 us; but one
//    application is NT x NT MMAs a warp, and 200 of them in a row have a
//    latency floor far above that: T times one application's latency.
//    So the design shortens the chain an application: B (M_s^T) is
//    loaded once, in the contraction order pi, which makes D's registers
//    the next A fragment, and an application runs register to register
//    (the MMAs, the float32 scale, a cvt.rna.tf32 a value): no shared
//    memory, no shuffle, no sync. At the probe's shape, 648 warps, one
//    wave. What is left (H100 at 1980 MHz, PERF.md §6): an application
//    takes ~270 cycles for its 9 MMAs a warp, so T = 200 takes ~0.03 ms;
//    the MMAs' issue, not their dependence, sets it (a partial product
//    per k-tile, two tiles a warp, or wgmma from a warpgroup: all slower).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_probe.cuh"

namespace {

constexpr int kP1Warps = 4;  // warps per block, CUDA-core forms
constexpr int kTcWarps = 4;  // warps per block, tc_shared

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

// The warp's TF32 m16n8k8 on the thread's fragments: cvt.rna rounds a
// float32 to TF32 (10 mantissa bits, to nearest, ties away from zero).
struct TcMma {
  using Reg = uint32_t;
  __device__ __forceinline__ Reg cvt(float x) const {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
  }
  // d += a b, float32 sums.
  __device__ __forceinline__ void operator()(float (&d)[4], const Reg (&a)[4],
                                             const Reg (&b)[2]) const {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Warp w of the grid runs stage w / tc_warps_per_stage(B), its tile of
// lanes w % tc_warps_per_stage(B); a warp beyond the last stage returns
// whole (mma.sync is per warp).
template <int NT>
__global__ void __launch_bounds__(32 * kTcWarps)
    stage_matvec_tc(int N1, int n, int B, int T, float scale,
                    const float* __restrict__ M,
                    const float* __restrict__ w0, float* __restrict__ w) {
  const long long warp = (long long)blockIdx.x * kTcWarps + threadIdx.x / 32;
  const int tiles = tc_warps_per_stage(B);
  const long long s = warp / tiles;
  if (s >= N1) return;
  p1_tc_warp<NT>(TcMma{}, threadIdx.x % 32, s,
                 (int)(warp % tiles) * kTcLanes, n, B, T, scale, M, w0,
                 w);
}

int stage_matvec_tc_blocks(int N1, int B) {
  const long long warps = (long long)N1 * tc_warps_per_stage(B);
  return (int)((warps + kTcWarps - 1) / kTcWarps);
}

// Calls f.template go<N>() for the stage size N = n in 1 .. kMxuMaxN.
template <int N = 1, class F>
int with_n(int n, const F& f) {
  if constexpr (N > kMxuMaxN)
    return (int)cudaErrorInvalidValue;
  else
    return n == N ? f.template go<N>() : with_n<N + 1>(n, f);
}

struct TcLaunch {
  int N1, n, B, T;
  float scale;
  const float *M, *w0;
  float* w;
  cudaStream_t st;
  template <int NT>
  int go() const {
    stage_matvec_tc<NT><<<stage_matvec_tc_blocks(N1, B), 32 * kTcWarps, 0,
                          st>>>(N1, n, B, T, scale, M, w0, w);
    return (int)cudaGetLastError();
  }
};

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

struct TcInfo {
  int N1, B;
  int* info;
  template <int NT>
  int go() const {
    info[0] = 32;
    info[1] = kTcWarps;
    fill_info(stage_matvec_tc<NT>, 32 * kTcWarps, 0, info);
    info[6] = NT;
    info[7] = kTcLanes;
    info[8] = stage_matvec_tc_blocks(N1, B);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// The largest stage size the probe kernels take.
int fb_mxu_max_n() { return kMxuMaxN; }

// The launch of form `form` at stage size n for N1 stages of B lanes:
// info[0] threads per team (form 2: a warp), info[1] teams per block,
// info[2] registers per thread, info[3] local (spill) bytes per thread,
// info[4] shared bytes per block, info[5] resident blocks per SM, info[6]
// rows and info[7] lanes a thread holds (form 2: n-tiles NT and lanes a
// warp), info[8] blocks of the grid. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a form or n the kernels do not take.
int fb_mxu_probe_info(int form, int n, int N1, int B, int* info) {
  if (n < 1 || n > kMxuMaxN || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  if (form < 2) return with_n(n, TeamInfo{form, N1, B, info});
  return tc_with_nt(n, TcInfo{N1, B, info});
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
  return tc_with_nt(n, TcLaunch{N1, n, B, T, scale, M, w0, w, st});
}

}  // extern "C"

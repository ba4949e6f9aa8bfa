// The per-thread arithmetic of P1's two CUDA-core forms (mxu_probe.cu):
// T applications of w_s <- scale * M_s w_s to c neighbouring lanes of one
// stage s, run by a team of threads.
//
// Thread k of a team holds rows k r .. k r + r - 1 of M_s in registers
// (rows >= n are zeros, computed and not stored): one copy per lane for
// the per-lane form (r c n floats), one copy serving all c lanes for the
// shared form (r n floats); and r x c accumulators, one independent FMA
// chain each. The team keeps its lanes' w_s in a buffer of shared memory,
// element (j, l) at j c + l, padded to a multiple of 4 floats, twice: an
// application reads one copy and writes the other, so the team syncs once
// per application. It reads the buffer as 16-byte loads, all threads of the
// team the same address (a broadcast); each of a load's 4 values feeds r
// FMAs. Every row's sum is taken by one thread in the plain version's order
// (j ascending, then the scale), so every team gives the team of one's
// bits.
//
// The shape is a type: P1Fixed<n, r, c> in the kernels, where every loop
// has a trip count known when the kernel is compiled (no predicated dead
// iterations, arrays in registers); P1Dyn in the host replay
// (tests/torch_host_replay.cpp), where the same code runs with run-time
// counts. Plain C++ behind FB_DEV, as the other headers.
#pragma once

#include "fbstab_common.cuh"

#ifdef __CUDACC__
#define P1_UNROLL _Pragma("unroll")
#else
#define P1_UNROLL
#endif

// The largest stage size the probe kernels take.
constexpr int kMxuMaxN = 32;
// Threads per team: form 0 (cuda_perlane) runs one team per (stage, lane),
// form 1 (cuda_shared) one per (stage, kSharedLanes lanes). A team of at
// most `team` threads splits n rows evenly: r = ceil(n / team) rows a
// thread, ceil(n / r) threads (at n = 18, team 3: 6 rows each). Where a
// thread's rows of M would pass kMaxMFloats registers, the team grows.
// Chosen on an H100 at n = 18 against teams of 6 and 9 and 1 or 4 lanes
// (PERF.md §6).
constexpr int kPerlaneTeam = 3;
constexpr int kSharedTeam = 3;
constexpr int kSharedLanes = 2;
constexpr int kMaxMFloats = 128;

// The team size (at most) for stage size n: `team`, or more threads where
// a thread would hold more than kMaxMFloats floats of M (copies copies of
// each row: the lanes a thread holds per-lane M for).
FB_HD constexpr int p1_team_size(int n, int team, int copies) {
  return team * kMaxMFloats >= n * n * copies
             ? team
             : (n * n * copies + kMaxMFloats - 1) / kMaxMFloats;
}

// Rows a thread holds when a team of at most `team` threads splits n rows.
FB_HD constexpr int p1_rows(int n, int team) { return (n + team - 1) / team; }
// Threads such a team needs.
FB_HD constexpr int p1_threads(int n, int team) {
  return (n + p1_rows(n, team) - 1) / p1_rows(n, team);
}
// Floats of one copy of a team's w buffer: n c, padded to 16 bytes.
FB_HD constexpr int p1_buf_floats(int n, int c) { return (n * c + 3) / 4 * 4; }

template <int N, int R, int C>
struct P1Fixed {
  static constexpr int n = N, r = R, c = C;
  static constexpr int kN = N, kR = R, kC = C;
};

struct P1Dyn {
  int n, r, c;
  static constexpr int kN = kMxuMaxN, kR = kMxuMaxN, kC = 4;
};

#ifdef __CUDACC__
FB_DEV void p1_ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
#else
inline void p1_ld4(const float* p, float (&v)[4]) {
  for (int e = 0; e < 4; ++e) v[e] = p[e];
}
#endif

// Thread k of a team: its rows of M_s and its accumulators.
template <bool kPerLane, class S>
struct P1Thread {
  static constexpr int kML = kPerLane ? S::kC : 1;
  float m[S::kR][kML][S::kN];
  float acc[S::kR][S::kC];

  // Whether row `row0 + r` of a thread's rows lies in the stage: known when
  // the kernel is compiled where r divides n.
  FB_DEV static bool has_row(const S& d, int row0, int r) {
    return d.n % d.r == 0 || row0 + r < d.n;
  }

  // Loads rows row0 .. row0 + r - 1 of M_s and writes those rows of w0
  // into buf (lanes b0 .. b0 + c - 1; zeros for lanes >= B, and for
  // everything where the thread is not `live`).
  FB_DEV void load(const S& d, bool live, int row0, long long s, int b0,
                   int B, const float* M, const float* w0, float* buf) {
    const int n = d.n;
    P1_UNROLL
    for (int r = 0; r < d.r; ++r) {
      const int i = row0 + r;
      const long long row = s * n + i;
      const bool in = live && i < n;
      P1_UNROLL
      for (int l = 0; l < kML; ++l) {
        const bool lane = !kPerLane || b0 + l < B;
        P1_UNROLL
        for (int j = 0; j < d.n; ++j)
          m[r][l][j] = !(in && lane) ? 0.0f
                       : kPerLane    ? M[(row * n + j) * B + b0 + l]
                                     : M[row * n + j];
      }
      if (has_row(d, row0, r)) {
        P1_UNROLL
        for (int l = 0; l < d.c; ++l)
          buf[i * d.c + l] =
              in && b0 + l < B ? w0[row * B + b0 + l] : 0.0f;
      }
    }
  }

  // One application: out's rows row0 .. = scale * (M_s in)'s, each row's
  // sum over j ascending.
  FB_DEV void apply(const S& d, int row0, float scale, const float* in,
                    float* out) {
    const int nc = d.n * d.c;
    // All of w first, so that one load latency per application is exposed.
    float v[(S::kN * S::kC + 3) / 4][4];
    P1_UNROLL
    for (int q = 0; q < (nc + 3) / 4; ++q) p1_ld4(in + 4 * q, v[q]);
    P1_UNROLL
    for (int q = 0; q < (nc + 3) / 4; ++q) {
      P1_UNROLL
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * q + e, j = kk / d.c, l = kk % d.c;
        if (kk < nc) {
          P1_UNROLL
          for (int r = 0; r < d.r; ++r) {
            const float x = m[r][kPerLane ? l : 0][j];
            acc[r][l] = j == 0 ? x * v[q][e] : acc[r][l] + x * v[q][e];
          }
        }
      }
    }
    P1_UNROLL
    for (int r = 0; r < d.r; ++r) {
      if (has_row(d, row0, r)) {
        P1_UNROLL
        for (int l = 0; l < d.c; ++l)
          out[(row0 + r) * d.c + l] = acc[r][l] * scale;
      }
    }
  }
};

// One team's whole run, as thread k sees it: load its rows, apply T times
// between the two copies of the buffer (the loop unrolled by two, so each
// half reads and writes fixed copies), store its rows of w. A thread that
// is not `live` (an idle lane of a warp, a team beyond the last stage)
// runs the same loop on zeros in buffers that no live thread reads, and
// stores nothing: the loop has no branch. M: (N1, n, n, B) per lane or
// (N1, n, n) shared; w0, w: (N1 n, B).
template <bool kPerLane, class S, class Sync>
FB_DEV void p1_team(const S& d, const Sync& sync, bool live, int k,
                    long long s, int b0, int B, int T, float scale,
                    const float* M, const float* w0, float* w, float* buf0,
                    float* buf1) {
  P1Thread<kPerLane, S> th;
  const int row0 = k * d.r;
  th.load(d, live, row0, s, b0, B, M, w0, buf0);
  sync();
  int t = 0;
  for (; t + 2 <= T; t += 2) {
    th.apply(d, row0, scale, buf0, buf1);
    sync();
    th.apply(d, row0, scale, buf1, buf0);
    sync();
  }
  if (t < T) {
    th.apply(d, row0, scale, buf0, buf1);
    sync();
  }
  if (live) {
    const float* fin = (T & 1) ? buf1 : buf0;
    P1_UNROLL
    for (int r = 0; r < d.r; ++r) {
      const int i = row0 + r;
      if (i < d.n) {
        P1_UNROLL
        for (int l = 0; l < d.c; ++l)
          if (b0 + l < B) w[(s * d.n + i) * B + b0 + l] = fin[i * d.c + l];
      }
    }
  }
}

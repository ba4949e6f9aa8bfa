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

// ---------------------------------------------------------------------
// Form 2, tc_shared: the same recurrence on the TF32 tensor cores, the
// product transposed, w_s^T <- scale * (w_s^T M_s^T), per (stage s, tile of
// 16 lanes), one warp a tile, with mma.sync m16n8k8 (.row.col, TF32
// operands, float32 sums): A is w_s^T (16 lanes x k), B is M_s^T (k x
// outputs), D is 16 lanes x 8 outputs per n-tile; n is padded to NT =
// ceil(n / 8) tiles of 8, with zeros in M beyond n, so outputs >= n stay
// exactly zero for all T, and lanes >= B start at zero.
//
// The contraction order carries the layout. Thread (g, q) = (lane >> 2,
// lane & 3) of the warp holds D's outputs 2q, 2q + 1 of each n-tile for
// lanes g and g + 8; the next application's A fragment wants, in the
// hardware's order, columns q and q + 4 of each k-tile for the same lanes.
// Inside every block of 8, column (or B row) p of the hardware's tile
// stands for contraction index pi(p): 2p for p < 4, 2(p - 4) + 1 beyond.
// With B loaded in that order, D's registers are the next A fragment:
// a0 = d0, a1 = d2, a2 = d1, a3 = d3. An application is NT x NT MMAs, the
// scale (float32, after the sum, as the plain version) and a cvt.rna.tf32
// a value, register to register: no shuffle, no shared memory, no sync.
//
// The maps below give, for register r of thread (g, q), the (lane, k) of A,
// the (k, output) of B and the (lane, output) of D it holds inside one
// tile, k the contraction index after pi.

// Column (or B row) p of the hardware's k-tile stands for index pi(p).
FB_HD constexpr int tc_pi(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }
// A (m16 x k8, row): register r at row g + 8 (r & 1), column q + 4 (r >> 1).
FB_HD constexpr int tc_a_lane(int g, int r) { return g + 8 * (r & 1); }
FB_HD constexpr int tc_a_k(int q, int r) { return tc_pi(q + 4 * (r >> 1)); }
// B (k8 x n8, col): register r at row q + 4 r, column g.
FB_HD constexpr int tc_b_k(int q, int r) { return tc_pi(q + 4 * r); }
FB_HD constexpr int tc_b_out(int g) { return g; }
// D (m16 x n8): register r at row g + 8 (r >> 1), column 2 q + (r & 1).
FB_HD constexpr int tc_d_lane(int g, int r) { return g + 8 * (r >> 1); }
FB_HD constexpr int tc_d_out(int q, int r) { return 2 * q + (r & 1); }
// The register of D that holds what register r of A wants:
// (tc_d_lane, tc_d_out)(tc_a_from_d(r)) == (tc_a_lane, tc_a_k)(r).
FB_HD constexpr int tc_a_from_d(int r) { return 2 * (r & 1) + (r >> 1); }
FB_HD constexpr bool tc_d_is_next_a() {
  for (int lane = 0; lane < 32; ++lane)
    for (int r = 0; r < 4; ++r) {
      const int g = lane >> 2, q = lane & 3, rd = tc_a_from_d(r);
      if (tc_d_lane(g, rd) != tc_a_lane(g, r) || tc_d_out(q, rd) != tc_a_k(q, r))
        return false;
    }
  return true;
}
static_assert(tc_d_is_next_a(), "D's registers are not the next A fragment");

// Lanes a warp runs: one tile of 16, the NT k-tiles accumulated into one D.
// Chosen on an H100 at n = 18 (PERF.md §6) against two tiles a warp, and
// against a partial product per k-tile summed after the MMAs (one MMA deep):
// one application is ~270 cycles here, ~400 with either change.
constexpr int kTcLanes = 16;
// The most n-tiles: kMxuMaxN / 8.
constexpr int kTcMaxNT = kMxuMaxN / 8;

// Warps (tiles of kTcLanes lanes) a stage of B lanes needs.
FB_HD constexpr int tc_warps_per_stage(int B) {
  return (B + kTcLanes - 1) / kTcLanes;
}

// One warp's whole run, as lane `lane` sees it: B fragments of M_s once,
// w's fragments of lanes b0 .. b0 + kTcLanes - 1, T applications, w's
// fragments stored. `mma` is the warp's m16n8k8 (d += a b on the thread's
// registers, of type Mma::Reg) and its operand rounding `mma.cvt`.
// M: (N1, n, n); w0, w: (N1 n, B).
template <int NT, class Mma>
FB_DEV void p1_tc_warp(const Mma& mma, int lane, long long s, int b0, int n,
                       int B, int T, float scale, const float* M,
                       const float* w0, float* w) {
  using Reg = typename Mma::Reg;
  const int g = lane >> 2, q = lane & 3;
  Reg bm[NT][NT][2];  // [n-tile j][k-tile i][r]
  P1_UNROLL
  for (int j = 0; j < NT; ++j) {
    const int o = 8 * j + tc_b_out(g);
    P1_UNROLL
    for (int i = 0; i < NT; ++i) {
      P1_UNROLL
      for (int r = 0; r < 2; ++r) {
        const int k = 8 * i + tc_b_k(q, r);
        bm[j][i][r] = mma.cvt(o < n && k < n ? M[(s * n + o) * n + k] : 0.0f);
      }
    }
  }
  // x: the float32 iterate in D's layout, [n-tile][r].
  float x[NT][4];
  P1_UNROLL
  for (int i = 0; i < NT; ++i) {
    P1_UNROLL
    for (int r = 0; r < 4; ++r) {
      const int k = 8 * i + tc_d_out(q, r);
      const int b = b0 + tc_d_lane(g, r);
      x[i][r] = k < n && b < B ? w0[(s * n + k) * B + b] : 0.0f;
    }
  }
  for (int t = 0; t < T; ++t) {
    Reg a[NT][4];
    P1_UNROLL
    for (int i = 0; i < NT; ++i) {
      P1_UNROLL
      for (int r = 0; r < 4; ++r) a[i][r] = mma.cvt(x[i][tc_a_from_d(r)]);
    }
    P1_UNROLL
    for (int j = 0; j < NT; ++j) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      P1_UNROLL
      for (int i = 0; i < NT; ++i) mma(d, a[i], bm[j][i]);
      P1_UNROLL
      for (int r = 0; r < 4; ++r) x[j][r] = d[r] * scale;
    }
  }
  P1_UNROLL
  for (int i = 0; i < NT; ++i) {
    P1_UNROLL
    for (int r = 0; r < 4; ++r) {
      const int k = 8 * i + tc_d_out(q, r);
      const int b = b0 + tc_d_lane(g, r);
      if (k < n && b < B) w[(s * n + k) * B + b] = x[i][r];
    }
  }
}

// Calls f.template go<NT>() for NT = ceil(n / 8), n in 1 .. kMxuMaxN.
template <int NT = 1, class F>
int tc_with_nt(int n, const F& f) {
  if constexpr (NT > kTcMaxNT)
    return -1;
  else
    return (n + 7) / 8 == NT ? f.template go<NT>() : tc_with_nt<NT + 1>(n, f);
}

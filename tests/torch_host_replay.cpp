// The device code of the PyTorch port's CUDA kernels
// (fbstab_tpu_torch/csrc/*.cuh) compiled as host C++ in float64 (the
// double-float transforms of P3 and the refinement's residual in float32):
// one loop
// iteration per instance, each on the team of one, behind the C interface
// of the CUDA library with double in place of float, in the kernels'
// layouts (K3, K5 batch-last; K1, K2, K4 instance-major, with each
// instance's stage block in a buffer of its own where the kernels keep it
// in shared memory). K1-K5 also run on a team of T host threads
// (fb_replay_set_team): the kernels' split of the work, with a barrier for
// the tile's sync and the same xor-butterfly reductions; such a team stages
// each stage's operands as the card's teams do, or, after
// fb_replay_set_stages(0), works in place as K1's teams do at stages too
// large for a block's shared memory. P1's two CUDA-core forms run each
// (stage, lanes) team on the threads that a team of at most T threads
// needs (any T from 1 to 32), with a barrier for the warp's sync; its
// tensor-core form runs each warp on 32 host threads with a software MMA.
// tests/test_torch_device_code.py builds it with the host compiler and
// holds it lane for lane against the plain float64 versions of the
// kernels.
#include <math.h>

#include <barrier>
#include <thread>
#include <type_traits>
#include <vector>

// The double-float transforms of P3 and the refinement's residual stay in
// float32: their exactness is what is replayed. The host compiler sees
// doublefloat.cuh's plain operators, so the replay is built with
// -ffp-contract=off.
#include "doublefloat.cuh"
#include "refine_residual.cuh"

extern "C" int fb_df_probe(int R, int C, const float* a, const float* b,
                           float* s, float* e, float* p, float* pe,
                           float* dh, float* dl) {
  for (int c = 0; c < C; ++c) {
    float hi = 0.0f, lo = 0.0f;
    for (int r = 0; r < R; ++r) {
      const long long k = (long long)r * C + c;
      df_two_sum(a[k], b[k], s[k], e[k]);
      df_two_prod(a[k], b[k], p[k], pe[k]);
      df_dot_add(p[k], pe[k], hi, lo);
    }
    dh[c] = hi;
    dl[c] = lo;
  }
  return 0;
}

#define float double
#define sqrtf sqrt
#define fmaxf fmax
#define fminf fmin
#define fabsf fabs
// The smallest normal double (the plain version's finfo(float64).tiny).
#define FB_TINY 2.2250738585072014e-308

#include "assoc_combine.cuh"
#include "dense_solve.cuh"
#include "mpc_solve.cuh"
#include "mxu_probe.cuh"

// A team of T host threads standing in for Team<T> (fbstab_common.cuh).
// Every exchange of values goes through a slot per thread between two
// barriers.
template <int T, bool S>
struct HostTeam {
  static constexpr bool kStages = S;
  struct Shared {
    std::barrier<> bar{T};
    float slot[T];
  };
  Shared* sh;
  int r;
  static int size() { return T; }
  int rank() const { return r; }
  void sync() const { sh->bar.arrive_and_wait(); }
  float exchange(float x, int src) const {
    sync();
    sh->slot[r] = x;
    sync();
    return sh->slot[src];
  }
  float sum(float x) const {
    for (int o = T / 2; o > 0; o >>= 1) x += exchange(x, r ^ o);
    return x;
  }
  float max(float x) const {
    for (int o = T / 2; o > 0; o >>= 1) x = fmax(x, exchange(x, r ^ o));
    return x;
  }
  bool any(bool x) const { return sum(x ? 1.0 : 0.0) > 0.0; }
  float bcast(float x, int src) const { return exchange(x, src); }
};

// Runs body(team) on each of T threads of one team.
template <int T, bool S, class F>
void run_team(const F& body) {
  typename HostTeam<T, S>::Shared sh;
  std::vector<std::thread> threads;
  for (int r = 1; r < T; ++r)
    threads.emplace_back([&sh, &body, r] { body(HostTeam<T, S>{&sh, r}); });
  body(HostTeam<T, S>{&sh, 0});
  for (auto& t : threads) t.join();
}

// Runs body(team) for one instance on the team of g_team threads, which
// stages unless g_stages is 0.
static int g_team = 1;
static int g_stages = 1;

template <bool S, class F>
void on_team_staging(const F& body) {
  switch (g_team) {
    case 2: run_team<2, S>(body); break;
    case 4: run_team<4, S>(body); break;
    case 8: run_team<8, S>(body); break;
    case 16: run_team<16, S>(body); break;
    default: run_team<32, S>(body); break;
  }
}

template <class F>
void on_team(const F& body) {
  if (g_team == 1)
    body(Solo{});
  else if (g_stages)
    on_team_staging<true>(body);
  else
    on_team_staging<false>(body);
}

// Whether the replayed kernels' teams stage (the scratch then holds no
// stage block).
static bool replay_stages() { return g_team > 1 && g_stages; }

// Where a team keeps its stage block: the instance's buffer `stage` if it
// stages, its Riccati scratch w (laid out for the mode) otherwise.
template <class Tm>
Lane stage_block(const Tm&, std::vector<float>& stage, Lane w,
                 const MpcDims& D, bool lowmem) {
  return Tm::kStages ? Lane{stage.data(), 1}
                     : w.at(ric_layout(D, lowmem).stage);
}

// Calls f with the Riccati solve's mode as a compile-time flag: Store is
// true for the storing mode, false for the recompute-factors mode.
template <class F>
void in_mode(bool lowmem, const F& f) {
  if (lowmem)
    f(std::false_type{});
  else
    f(std::true_type{});
}

// TF32 rounding of a float64: 10 mantissa bits after the leading one, to
// nearest, ties away from zero (cvt.rna.tf32.f32).
static double tf32(double x) {
  if (x == 0.0 || !isfinite(x)) return x;
  int e;
  const double m = frexp(x, &e);  // x = m 2^e, 0.5 <= |m| < 1
  return ldexp(round(m * 2048.0), e - 11);
}

// A software mma.sync.aligned.m16n8k8.row.col for the 32 host threads of a
// warp: each deposits its fragments, and each takes its D entries from the
// hardware's layouts (PTX ISA, .tf32 m16n8k8), written out here apart from
// mxu_probe.cuh's maps: A register r of lane (g, q) = (lane >> 2,
// lane & 3) at (g + 8 (r & 1), q + 4 (r >> 1)), B register r at (q + 4 r,
// g), C and D register r at (g + 8 (r >> 1), 2 q + (r & 1)). Both operands
// are rounded to TF32 here and the products summed in float64.
struct HostWarpMma {
  using Reg = double;
  struct Shared {
    std::barrier<> bar{32};
    double a[32][4], b[32][2];
  };
  Shared* sh;
  int lane;
  Reg cvt(double x) const { return x; }
  void operator()(double (&d)[4], const Reg (&a)[4], const Reg (&b)[2]) const {
    for (int r = 0; r < 4; ++r) sh->a[lane][r] = a[r];
    for (int r = 0; r < 2; ++r) sh->b[lane][r] = b[r];
    sh->bar.arrive_and_wait();
    const int g = lane >> 2, q = lane & 3;
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r >> 1), col = 2 * q + (r & 1);
      double sum = 0.0;
      for (int k = 0; k < 8; ++k)
        sum += tf32(sh->a[4 * (row % 8) + k % 4][row / 8 + 2 * (k / 4)]) *
               tf32(sh->b[4 * col + k % 4][k / 4]);
      d[r] += sum;
    }
    sh->bar.arrive_and_wait();
  }
};

struct HostTcRun {
  int N1, n, B, T;
  double scale;
  const double *M, *w0;
  double* w;
  template <int NT>
  int go() const {
    HostWarpMma::Shared sh;
    const int tiles = tc_warps_per_stage(B);
    const auto body = [&](int lane) {
      for (long long wp = 0; wp < (long long)N1 * tiles; ++wp)
        p1_tc_warp<NT>(HostWarpMma{&sh, lane}, lane, wp / tiles,
                       (int)(wp % tiles) * kTcLanes, n, B, T, scale, M,
                       w0, w);
    };
    std::vector<std::thread> threads;
    for (int lane = 1; lane < 32; ++lane) threads.emplace_back(body, lane);
    body(0);
    for (auto& t : threads) t.join();
    return 0;
  }
};

extern "C" {

// The team size the kernels replay on: 1 (the default), 2, 4, ..., 32.
void fb_replay_set_team(int T) { g_team = T; }

// Whether a team of more than one thread stages (1, the default) or works
// in place (0).
void fb_replay_set_stages(int stages) { g_stages = stages; }

long long fb_riccati_ws_floats(int N, int nx, int nu, int nc, int lowmem) {
  return ric_ws_floats(MpcDims{N, nx, nu, nc}, lowmem != 0, replay_stages());
}

int fb_riccati_step(int N, int nx, int nu, int nc, int B, int lowmem,
                    float alpha, float om_alpha, const float* sigma,
                    const float* Q, const float* R, const float* S,
                    const float* A, const float* Bm, const float* E,
                    const float* L, const float* v, const float* y,
                    const float* vbar, const float* rz, const float* rl,
                    const float* rv, float* dz, float* dl, float* ws) {
  const MpcDims D{N, nx, nu, nc};
  const long long N1 = N + 1, ns = nx + nu;
  std::vector<float> stage(ric_layout(D, lowmem != 0).stage_floats);
  const long long wsf = fb_riccati_ws_floats(N, nx, nu, nc, lowmem);
  for (int b = 0; b < B; ++b) {
    MpcProb P{};
    P.Q = lane_im(Q, N1 * nx * nx, b);
    P.R = lane_im(R, N1 * nu * nu, b);
    P.S = lane_im(S, N1 * nu * nx, b);
    P.A = lane_im(A, (long long)N * nx * nx, b);
    P.B = lane_im(Bm, (long long)N * nx * nu, b);
    P.E = lane_im(E, N1 * nc * nx, b);
    P.L = lane_im(L, N1 * nc * nu, b);
    const Lane w = lane_im(ws, wsf, b);
    in_mode(lowmem != 0, [&](auto store) {
      on_team([&](const auto& tm) {
        riccati_factor_solve<decltype(store)::value>(
            tm, D, sigma[b], alpha, om_alpha, P, lane_im(v, N1 * nc, b),
            lane_im(y, N1 * nc, b), lane_im(vbar, N1 * nc, b),
            lane_im(rz, N1 * ns, b), lane_im(rl, N1 * nx, b),
            lane_im(rv, N1 * nc, b), lane_im(dz, N1 * ns, b),
            lane_im(dl, N1 * nx, b), w,
            stage_block(tm, stage, w, D, lowmem != 0));
      });
    });
  }
  return 0;
}

long long fb_solve_ws_floats(int N, int nx, int nu, int nc, int lowmem) {
  return solve_layout(MpcDims{N, nx, nu, nc}, lowmem != 0, replay_stages())
      .total;
}

long long fb_solve_smem_bytes(int N, int nx, int nu, int nc) {
  return solve_smem_bytes(MpcDims{N, nx, nu, nc});
}

int fb_mpc_solve(int N, int nx, int nu, int nc, int B, int lowmem,
                 SolveOpts o, const float* q, const float* r, const float* c,
                 const float* x0, const float* d, const float* Q,
                 const float* R, const float* S, const float* A,
                 const float* Bm, const float* E, const float* L,
                 const float* z0, const float* l0, const float* v0, float* z,
                 float* l, float* v, float* y, int* eflag, float* res,
                 int* newton, int* prox, float* res0, float* ws) {
  const MpcDims D{N, nx, nu, nc};
  const long long N1 = N + 1;
  const SolveLayout W = solve_layout(D, lowmem != 0, replay_stages());
  std::vector<float> stage(ric_layout(D, lowmem != 0).stage_floats);
  for (int b = 0; b < B; ++b) {
    const MpcProb P = mpc_prob_im(D, q, r, c, x0, d, Q, R, S, A, Bm, E, L, b);
    SolveOut out;
    out.x = mpc_vars_im(D, z, l, v, y, b);
    out.eflag = eflag + b;
    out.res = res + b;
    out.newton = newton + b;
    out.prox = prox + b;
    out.res0 = res0 + b;
    const Lane w = lane_im(ws, W.total, b);
    in_mode(lowmem != 0, [&](auto store) {
      on_team([&](const auto& tm) {
        fbstab_mpc_solve_lane<decltype(store)::value>(
            tm, D, o, P, lane_im(z0, N1 * (nx + nu), b),
            lane_im(l0, N1 * nx, b), lane_im(v0, N1 * nc, b), out,
            w.at(W.step),
            stage_block(tm, stage, w.at(W.step), D, lowmem != 0),
            w.at(W.xk));
      });
    });
  }
  return 0;
}

long long fb_dense_ws_floats(int n, int q, int nl) {
  return dense_solve_layout(DenseDims{n, q, nl}, false).total;
}

int fb_dense_solve(int n, int q, int nl, int B, SolveOpts o, const float* H,
                   const float* f, const float* G, const float* h,
                   const float* A, const float* b, const float* z0,
                   const float* l0, const float* v0, float* z, float* l,
                   float* v, float* y, int* eflag, float* res, int* newton,
                   int* prox, float* res0, float* ws) {
  const DenseDims D{n, q, nl};
  const long long wsf = fb_dense_ws_floats(n, q, nl);
  std::vector<float> stage(dense_stage_layout(D).total);
  for (int k = 0; k < B; ++k) {
    DenseProb P;
    P.H = lane_im(H, (long long)n * n, k);
    P.f = lane_im(f, n, k);
    P.G = lane_im(G, (long long)nl * n, k);
    P.h = lane_im(h, nl, k);
    P.A = lane_im(A, (long long)q * n, k);
    P.b = lane_im(b, q, k);
    SolveOut out;
    out.x = Vars{lane_im(z, n, k), lane_im(l, nl, k), lane_im(v, q, k),
                 lane_im(y, q, k)};
    out.eflag = eflag + k;
    out.res = res + k;
    out.newton = newton + k;
    out.prox = prox + k;
    out.res0 = res0 + k;
    const Lane w = lane_im(ws, wsf, k);
    on_team([&](const auto& tm) {
      using Tm = std::decay_t<decltype(tm)>;
      fbstab_dense_solve_lane(tm, D, o, P, lane_im(z0, n, k),
                              lane_im(l0, nl, k), lane_im(v0, q, k), out, w,
                              Tm::kStages ? Lane{stage.data(), 1} : w);
    });
  }
  return 0;
}

long long fb_subproblem_ws_floats(int N, int nx, int nu, int nc,
                                  int lowmem) {
  return subproblem_ws_floats(MpcDims{N, nx, nu, nc}, lowmem != 0,
                              replay_stages());
}

long long fb_subproblem_smem_bytes(int N, int nx, int nu, int nc) {
  return subproblem_smem_bytes(MpcDims{N, nx, nu, nc});
}

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
                      float* dxn, float* ws) {
  const MpcDims D{N, nx, nu, nc};
  const long long wsf = fb_subproblem_ws_floats(N, nx, nu, nc, lowmem);
  std::vector<float> stage(ric_layout(D, lowmem != 0).stage_floats);
  for (int b = 0; b < B; ++b) {
    const MpcProb P = mpc_prob_im(D, q, r, c, x0, d, Q, R, S, A, Bm, E, L, b);
    const Lane w = lane_im(ws, wsf, b);
    OuterStep s;
    in_mode(lowmem != 0, [&](auto store) {
      on_team([&](const auto& tm) {
        const OuterStep t = fbstab_mpc_subproblem_lane<decltype(store)::value>(
            tm, D, o, P, mpc_vars_im(D, zk, lk, vk, yk, b),
            mpc_vars_im(D, z, l, v, y, b), itol_prev[b], dxn_prev[b],
            newton0[b], done[b] != 0, w,
            stage_block(tm, stage, w, D, lowmem != 0));
        if (tm.rank() == 0) s = t;
      });
    });
    Eo[b] = s.Eo;
    newton[b] = s.newton;
    lfail[b] = s.lfail ? 1 : 0;
    Ek[b] = s.Ek;
    success[b] = s.success ? 1 : 0;
    itol[b] = s.itol;
    dxn[b] = s.dxn;
  }
  return 0;
}

// K5 without the kernel's scratch argument: a team that works in place
// keeps its stage block in a buffer of the replay's.
int fb_assoc_combine(int n, int M, int B, const long long* strides,
                     const float* lP11, const float* lP12, const float* lP22,
                     const float* lp1, const float* lp2, const float* rP11,
                     const float* rP12, const float* rP22, const float* rp1,
                     const float* rp2, float* oP11, float* oP12, float* oP22,
                     float* op1, float* op2) {
  const long long nn = (long long)n * n, MB = (long long)M * B;
  std::vector<float> stage(combine_layout(n, true).total),
      scratch(combine_layout(n, false).total);
  for (long long t = 0; t < MB; ++t) {
    const long long m = t / B, b = t % B;
    auto at = [&](const float* p, long long sm, long long k) {
      return Lane{const_cast<float*>(p) + m * sm + b * k, 1};
    };
    const Span l{at(lP11, strides[0], nn), at(lP12, strides[1], nn),
                 at(lP22, strides[2], nn), at(lp1, strides[3], n),
                 at(lp2, strides[4], n)};
    const Span r{at(rP11, strides[5], nn), at(rP12, strides[6], nn),
                 at(rP22, strides[7], nn), at(rp1, strides[8], n),
                 at(rp2, strides[9], n)};
    const Span o{at(oP11, B * nn, nn), at(oP12, B * nn, nn),
                 at(oP22, B * nn, nn), at(op1, B * n, n), at(op2, B * n, n)};
    on_team([&](const auto& tm) {
      using Tm = std::decay_t<decltype(tm)>;
      assoc_combine_team(tm, n, l, r, o,
                         Lane{(Tm::kStages ? stage : scratch).data(), 1});
    });
  }
  return 0;
}

// P1 without the stream argument. Forms 0 (per-lane M) and 1 (shared M):
// every (stage, lanes) team in turn on the host threads that a team of at
// most g_team threads needs, with the kernel's lanes per thread. Form 2
// (tc_shared): every warp in turn on 32 host threads, each thread's
// fragments as the kernel's, the warp's MMA in software.
int fb_mxu_probe(int form, int N1, int n, int B, int T, float scale,
                 const float* M, const float* w0, float* w) {
  if (n < 1 || n > kMxuMaxN || form < 0 || form > 2) return 1;
  if (form == 2)
    return tc_with_nt(n, HostTcRun{N1, n, B, T, scale, M, w0, w});
  const int c = form == 0 ? 1 : kSharedLanes;
  const P1Dyn d{n, p1_rows(n, g_team), c};
  const int G = p1_threads(n, g_team), chunks = (B + c - 1) / c;
  std::vector<float> buf(2 * p1_buf_floats(n, c));
  float* buf1 = buf.data() + p1_buf_floats(n, c);
  std::barrier<> bar(G);
  const auto sync = [&bar] { bar.arrive_and_wait(); };
  const auto body = [&](int k) {
    for (long long t = 0; t < (long long)N1 * chunks; ++t) {
      const long long s = t / chunks;
      const int b0 = (int)(t % chunks) * c;
      if (form == 0)
        p1_team<true>(d, sync, true, k, s, b0, B, T, scale, M, w0, w,
                      buf.data(), buf1);
      else
        p1_team<false>(d, sync, true, k, s, b0, B, T, scale, M, w0, w,
                       buf.data(), buf1);
    }
  };
  std::vector<std::thread> threads;
  for (int k = 1; k < G; ++k) threads.emplace_back(body, k);
  body(0);
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"

// The refinement's residual (refine_residual.cuh), in float32 as the
// kernel computes it, lane by lane on the team of fb_replay_set_team
// threads (staging unless fb_replay_set_stages(0); the team of one reads
// in place), behind the library's C interface; `float` is float again here.
#pragma push_macro("float")
#undef float
extern "C" int fb_refine_residual(int N, int nx, int nu, int nc, int B,
                                  RrArgs a, void* stream) {
  (void)stream;
  std::vector<float> stage(rr_stage_floats(nx, nu, nc));
  std::vector<double> part(4 * 32);
  for (long long b = 0; b < B; ++b)
    on_team([&](const auto& tm) {
      rr_lane(tm, N, nx, nu, nc, a, b, stage.data(), part.data());
    });
  return 0;
}
#pragma pop_macro("float")

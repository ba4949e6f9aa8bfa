// The MPC refinement's double-float residual for one instance, as device
// code shared by the kernel (refine_residual.cu) and the host replay: the
// composition of fbstab_tpu_torch/models/refine.py that it replaces
// (`_margin`, `_mpc_kkt_residual_df`, `_mpc_norms` and `df_to` of the
// blocks), operation for operation.
//
// At a double-float point (zx, zu, l, v) it computes, stage by stage:
// the margin y = -d - (E zx + L zu) as a pair; the KKT blocks
// rzx = q + (Q zx + S' zu) + ((-l + A' l+) + E' v),
// rzu = r + (S zx + R zu) + (B' l+ + L' v),
// rl = -(x0, c) - G z and the penalized FB block rv at (y, v), each
// rounded to float32 (the right-hand side of the correction); and the
// original-units penalized natural residual norm of the lane.
//
// Every sum of products runs as ops/doublefloat.py's df_matvec (over the
// columns j = 0, 1, ...) or df_matvec_T (over the rows), from (0, 0), with
// the pair operations of doublefloat.cuh, so y and the four blocks are bit
// for bit the PyTorch composition's. The norm sums the float32 squares of
// each block in float64 and adds the four sums in float32 in PyTorch's
// order: deterministic, within a few float32 roundings of torch.sum's.
//
// A team of threads runs one instance (fbstab_common.cuh): it walks the
// stages in order, copies a stage's operands into its stage block in one
// coalesced sweep (or reads them in place, for a team that does not
// stage), and splits the stage's outputs over its threads, one output
// element a thread, so each element is computed in the team of one's
// order. Stage i computes rl(i + 1) from A(i), B(i) and zx(i + 1), so that
// every stage matrix is read once. The team needs of its type only rank(),
// size(), sync() and kStages; this header includes nothing of
// fbstab_common.cuh, so the host replay compiles it in float32.
#pragma once

#include "doublefloat.cuh"

#if defined(__CUDACC__)
#define FB_RR_HD __host__ __device__ __forceinline__
#else
#define FB_RR_HD inline
#endif

// One field of the batch as PyTorch holds it: element (b, i, m, k) (batch,
// stage, row, column) at p[b sb + i ss + m sm + k sk], in floats. Vectors
// have no column, x0 no stage, kc neither; a stride of 0 is a broadcast
// (sb = 0: one plant for every lane).
struct RrField {
  const float* p;
  long long sb, ss, sm, sk;
};

// The kernel's arguments. The scaling (dx, du, de (B, N+1, n), kc (B,))
// converts the norm to original units; dx.p null: the data's own units.
// Outputs are instance-major and contiguous: y and y_lo (B, N+1, nc), rzx,
// rl (B, N+1, nx), rzu (B, N+1, nu), rv (B, N+1, nc); y null: the norm
// alone. om_alpha is the KKT block's 1 - alpha, rounded once; the norm's
// is 1 minus the rounded alpha, as `_mpc_norms` takes it.
struct RrArgs {
  RrField Q, R, S, A, B, E, L, q, r, c, d, x0;
  RrField zx, zx_lo, zu, zu_lo, l, l_lo, v, v_lo;
  RrField dx, du, de, kc;
  float *y, *y_lo, *rzx, *rzu, *rl, *rv, *res;
  float alpha, om_alpha;
};

// The team's view of an m x k operand of one stage.
struct RrView {
  const float* p;
  long long sm, sk;
  FB_DF_FN float at(int m, int k) const { return p[m * sm + k * sk]; }
  FB_DF_FN float operator[](int m) const { return p[m * sm]; }
};

// Floats of one team's stage block: the stage's Q, R, S, E, L, A, B, q, r,
// d, c, x0; the pairs zx, zu, l, v and the next stage's l and zx; the
// scaling's dx, du, de and the next stage's dx.
FB_RR_HD int rr_stage_floats(int nx, int nu, int nc) {
  return 2 * nx * nx + nu * nu + 2 * nu * nx + nc * nx + nc * nu + 13 * nx +
         4 * nu + 4 * nc;
}

// Field f at (lane b, stage i) as an m x k view: copied into the stage
// block at `cur` (advanced past it) by a team that stages, visible after
// the caller's next sync; in place otherwise.
template <class Tm>
FB_DF_FN RrView rr_take(const Tm& tm, const RrField& f, long long b,
                        long long i, int m, int k, float*& cur) {
  const float* src = f.p + b * f.sb + i * f.ss;
  if (!Tm::kStages) return RrView{src, f.sm, f.sk};
  float* dst = cur;
  cur += m * k;
  const int n = m * k;
  if ((k == 1 || f.sk == 1) && (m == 1 || f.sm == k)) {
    for (int e = tm.rank(); e < n; e += tm.size()) dst[e] = src[e];
  } else {
    for (int e = tm.rank(); e < n; e += tm.size())
      dst[e] = src[(e / k) * f.sm + (e % k) * f.sk];
  }
  return RrView{dst, k, 1};
}

// One row or column of a stage view as a strided vector: n entries at
// p[k s], and its compensated dot product with a pair vector, accumulated
// over k = 0, 1, ... from (0, 0): a row of df_matvec(M, x) (row m of M:
// rr_row) or an entry of df_matvec_T(M, x) (column j of M: rr_col).
struct RrLine {
  const float* p;
  long long s;
  int n;
};

FB_DF_FN RrLine rr_row(const RrView& M, int m, int n) {
  return RrLine{M.p + m * M.sm, M.sk, n};
}

FB_DF_FN RrLine rr_col(const RrView& M, int j, int n) {
  return RrLine{M.p + j * M.sk, M.sm, n};
}

FB_DF_FN DF rr_dot(const RrLine& M, const RrView& xh, const RrView& xl) {
  DF acc{0.0f, 0.0f};
  for (int k = 0; k < M.n; ++k)
    acc = df_mac(acc, M.p[k * M.s], DF{xh[k], xl[k]});
  return acc;
}

// A pair of df_scale, the exact power-of-two unscaling.
FB_DF_FN DF rr_scale(DF x, float f) {
  return DF{FB_DF_MUL(x.hi, f), FB_DF_MUL(x.lo, f)};
}

// The float32 square of a block entry, as PyTorch's df_to(p) ** 2.
FB_DF_FN double rr_sq(DF x) {
  const float t = df_to(x);
  return (double)FB_DF_MUL(t, t);
}

// The residual of lane b on team tm: blk is the team's stage block
// (rr_stage_floats; unused by a team that does not stage), part room for
// 4 size() doubles the team shares.
template <class Tm>
FB_DF_FN void rr_lane(const Tm& tm, int N, int nx, int nu, int nc,
                      const RrArgs& a, long long b, float* blk,
                      double* part) {
  const bool scaled = a.dx.p != nullptr, store = a.y != nullptr;
  const long long N1 = N + 1;
  const float kc = scaled ? a.kc.p[b * a.kc.sb] : 1.0f;
  // This thread's sums of squares: rzx, rzu, rl, the natural residual.
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = 0; i <= N; ++i) {
    const bool mid = i < N;
    float* cur = blk;
    const auto take = [&](const RrField& f, long long s, int m, int k) {
      return rr_take(tm, f, b, s, m, k, cur);
    };
    const RrView Q = take(a.Q, i, nx, nx), R = take(a.R, i, nu, nu),
                 S = take(a.S, i, nu, nx), E = take(a.E, i, nc, nx),
                 L = take(a.L, i, nc, nu), q = take(a.q, i, nx, 1),
                 r = take(a.r, i, nu, 1), d = take(a.d, i, nc, 1),
                 zx = take(a.zx, i, nx, 1), zxl = take(a.zx_lo, i, nx, 1),
                 zu = take(a.zu, i, nu, 1), zul = take(a.zu_lo, i, nu, 1),
                 l = take(a.l, i, nx, 1), ll = take(a.l_lo, i, nx, 1),
                 v = take(a.v, i, nc, 1), vl = take(a.v_lo, i, nc, 1);
    RrView A{}, Bm{}, c{}, l1{}, l1l{}, zx1{}, zx1l{}, x0{}, dx{}, du{},
        de{}, dx1{};
    if (mid) {
      A = take(a.A, i, nx, nx);
      Bm = take(a.B, i, nx, nu);
      c = take(a.c, i, nx, 1);
      l1 = take(a.l, i + 1, nx, 1);
      l1l = take(a.l_lo, i + 1, nx, 1);
      zx1 = take(a.zx, i + 1, nx, 1);
      zx1l = take(a.zx_lo, i + 1, nx, 1);
    }
    if (i == 0) x0 = take(a.x0, 0, nx, 1);
    if (scaled) {
      dx = take(a.dx, i, nx, 1);
      du = take(a.du, i, nu, 1);
      de = take(a.de, i, nc, 1);
      if (mid) dx1 = take(a.dx, i + 1, nx, 1);
    }
    tm.sync();
    // Outputs: rzx(i) (nx), rzu(i) (nu), y(i) and rv(i) (nc), rl(i + 1)
    // before the last stage (nx), rl(0) at the first (nx). Every output
    // takes up to four dot products, against zx, zu, l(i + 1) and v, in
    // the same code for every kind, so the threads of a warp that compute
    // different kinds run their products side by side.
    const int n_rl = (mid ? nx : 0) + (i == 0 ? nx : 0);
    const int tasks = nx + nu + nc + n_rl;
    for (int t = tm.rank(); t < tasks; t += tm.size()) {
      enum { kRzx, kRzu, kY, kRlNext, kRl0 } kind;
      int j = t;
      if (j < nx) {
        kind = kRzx;
      } else if ((j -= nx) < nu) {
        kind = kRzu;
      } else if ((j -= nu) < nc) {
        kind = kY;
      } else {
        j -= nc;
        kind = mid && j < nx ? kRlNext : kRl0;
        if (kind == kRl0 && mid) j -= nx;
      }
      const RrLine none{nullptr, 0, 0};
      RrLine mx = none, mu = none, ml = none, mv = none;
      switch (kind) {
        case kRzx:  // q + (Q zx + S' zu) + ((-l + A' l+) + E' v)
          mx = rr_row(Q, j, nx);
          mu = rr_col(S, j, nu);
          if (mid) ml = rr_col(A, j, nx);
          mv = rr_col(E, j, nc);
          break;
        case kRzu:  // r + (S zx + R zu) + (B' l+ + L' v)
          mx = rr_row(S, j, nx);
          mu = rr_row(R, j, nu);
          if (mid) ml = rr_col(Bm, j, nx);
          mv = rr_col(L, j, nc);
          break;
        case kY:  // -d - (E zx + L zu)
          mx = rr_row(E, j, nx);
          mu = rr_row(L, j, nu);
          break;
        case kRlNext:  // -c - ((A zx + B zu) - zx+)
          mx = rr_row(A, j, nx);
          mu = rr_row(Bm, j, nu);
          break;
        case kRl0:  // -x0 - (-zx)
          break;
      }
      const DF px = rr_dot(mx, zx, zxl), pu = rr_dot(mu, zu, zul),
               pl = rr_dot(ml, l1, l1l), pv = rr_dot(mv, v, vl);
      if (kind == kRzx || kind == kRzu) {
        const bool xrow = kind == kRzx;
        const DF g = xrow ? df_add(df_neg(DF{l[j], ll[j]}), pl) : pl;
        const DF rz = df_add(df_add(DF{xrow ? q[j] : r[j], 0.0f},
                                    df_add(px, pu)),
                             df_add(g, pv));
        if (store)
          (xrow ? a.rzx : a.rzu)[(b * N1 + i) * (xrow ? nx : nu) + j] =
              df_to(rz);
        const float f = scaled ? FB_DF_DIV(1.0f, FB_DF_MUL(
                                                     kc, xrow ? dx[j] : du[j]))
                               : 1.0f;
        acc[xrow ? 0 : 1] += rr_sq(scaled ? rr_scale(rz, f) : rz);
      } else if (kind == kY) {
        // The margin, the FB block rv and the natural residual's row.
        const DF y = df_add(DF{-d[j], 0.0f}, df_neg(df_add(px, pu)));
        const DF vj{v[j], vl[j]};
        if (store) {
          const long long o = (b * N1 + i) * nc + j;
          a.y[o] = y.hi;
          a.y_lo[o] = y.lo;
          const DF root = df_sqrt(df_add(df_mul(y, y), df_mul(vj, vj)));
          const DF fb = df_add(df_add(y, vj), df_neg(root));
          const DF pen = df_mul(df_max0(y), df_max0(vj));
          a.rv[o] = df_to(
              df_add(df_mul_f(fb, a.alpha), df_mul_f(pen, a.om_alpha)));
        }
        const DF ys = scaled ? rr_scale(y, FB_DF_DIV(1.0f, de[j])) : y;
        const DF vs = scaled ? rr_scale(vj, FB_DF_DIV(de[j], kc)) : vj;
        const DF pen = df_mul(df_max0(ys), df_max0(vs));
        acc[3] += rr_sq(df_add(df_mul_f(df_min(ys, vs), a.alpha),
                               df_mul_f(pen, FB_DF_SUB(1.0f, a.alpha))));
      } else {
        const bool next = kind == kRlNext;
        const DF rl =
            next ? df_add(DF{-c[j], 0.0f},
                          df_neg(df_add(df_add(px, pu),
                                        df_neg(DF{zx1[j], zx1l[j]}))))
                 : df_add(DF{-x0[j], 0.0f}, df_neg(df_neg(DF{zx[j], zxl[j]})));
        if (store) a.rl[(b * N1 + i + (next ? 1 : 0)) * nx + j] = df_to(rl);
        acc[2] += rr_sq(scaled ? rr_scale(rl, next ? dx1[j] : dx[j]) : rl);
      }
    }
    tm.sync();
  }
  // The lane's norm: the team's sums in rank order, in float64, each block's
  // rounded to float32 and added in PyTorch's order.
  for (int k = 0; k < 4; ++k) part[tm.rank() * 4 + k] = acc[k];
  tm.sync();
  if (tm.rank() == 0) {
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    for (int t = 0; t < tm.size(); ++t)
      for (int k = 0; k < 4; ++k) s[k] += part[t * 4 + k];
    const float sum = FB_DF_ADD(
        FB_DF_ADD(FB_DF_ADD((float)s[0], (float)s[1]), (float)s[2]),
        (float)s[3]);
    a.res[b] = FB_DF_SQRT(sum);
  }
}

// K3's problem class: the dense QP of one instance,
//   min 1/2 z'Hz + f'z  s.t.  Gz = h, Az <= b,
// with the quasi-definite block Newton step of models/dense_qp.py
// (dense_cholesky_solver.cc:32-127), for the shared FBstab loop of
// fbstab_solve.cuh, over the instance's team (fbstab_common.cuh): the
// residual, the forcing norm and the infeasibility certificates split by
// rows and ended by the team's reductions; in the Newton step the entries
// of E = H + sigma I + A' diag(gamma ./ mus) A and of S = sigma I + W'W
// split over the team, the Choleskys column by column, the rows of W' as
// independent triangular solves, one a thread, and the solves of the
// step on the team. Every entry of E, S, W' and of each factor is
// computed by one thread in the team of one's order. nl = 0 drops every
// equality-block term.
//
// A team that stages copies H, A and G into its stage block (in shared
// memory on the card) once, at the start of the solve, and keeps the
// Newton-step scratch (the factors, W', the PFB weights) there; a team
// that does not (the team of one) reads the data where it lies and keeps
// the Newton-step scratch in its device-memory scratch.
#pragma once

#include "fbstab_solve.cuh"

struct DenseDims {
  int n, q, nl;
};

// Dense data at one instance (row-major blocks):
// H (n, n), f (n), G (nl, n), h (nl), A (q, n), b (q).
struct DenseProb {
  Lane H, f, G, h, A, b;
};

// Offsets (floats per instance) of the Newton-step scratch: the factor Le
// of E (n x n, lower), W' = (Le^{-1} G')' (nl x n, row k is column k of
// W), the factor Ls of S (nl x nl, lower), the PFB weights gamma, mus and
// gamma ./ mus, and an n-vector.
struct DenseStepLayout {
  long long Le, Wt, Ls, gam, mus, w, u, total;
};

FB_HD DenseStepLayout dense_step_layout(const DenseDims& D) {
  long long n = D.n, q = D.q, nl = D.nl, o = 0;
  DenseStepLayout s;
  s.Le = o;  o += n * n;
  s.Wt = o;  o += nl * n;
  s.Ls = o;  o += nl * nl;
  s.gam = o; o += q;
  s.mus = o; o += q;
  s.w = o;   o += q;
  s.u = o;   o += n;
  s.total = o;
  return s;
}

// Offsets (floats) of the stage block of a team that stages: the copies
// of H, A and G, then the Newton-step scratch.
struct DenseStageLayout {
  long long H, A, G, step, total;
};

FB_HD DenseStageLayout dense_stage_layout(const DenseDims& D) {
  long long n = D.n, q = D.q, nl = D.nl, o = 0;
  DenseStageLayout s;
  s.H = o;    o += n * n;
  s.A = o;    o += q * n;
  s.G = o;    o += nl * n;
  s.step = o; o += dense_step_layout(D).total;
  s.total = o;
  return s;
}

// Entry t of the lower triangle (diagonal included) of a square block,
// row by row: (i, j) with j <= i.
FB_DEV void fb_tri_entry(int t, int& i, int& j) {
  int r = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// Row i of M z for the row-major block M (rows x n).
FB_DEV float dn_row(Lane M, int n, Lane z, int i) {
  Lane Mi = M.at((long long)i * n);
  float a = 0.0f;
  for (int j = 0; j < n; ++j) a += Mi[j] * z[j];
  return a;
}

// Row i of M' x for the row-major block M (rows x n).
FB_DEV float dn_row_T(Lane M, int rows, int n, Lane x, int i) {
  float a = 0.0f;
  for (int c = 0; c < rows; ++c) a += M[(long long)c * n + i] * x[c];
  return a;
}

// The dense problem class of fbstab_solve.cuh: data P of dims D,
// Newton-step scratch ws (dense_step_layout), run by team tm.
template <class Tm>
struct DenseSolveProb {
  Tm tm;
  DenseDims D;
  DenseProb P;
  Lane ws;

  FB_DEV Tm team() const { return tm; }
  FB_DEV long long nz() const { return D.n; }
  FB_DEV long long nl() const { return D.nl; }
  FB_DEV long long nv() const { return D.q; }

  FB_DEV float b(long long k) const { return P.b[k]; }
  FB_DEV float Az(Lane z, long long c) const {
    return dn_row(P.A, D.n, z, (int)c);
  }
  FB_DEV float forcing_sq() const {
    const int T = tm.size(), me = tm.rank();
    float fs = 0.0f;
    for (int i = me; i < D.n; i += T) fs += P.f[i] * P.f[i];
    for (int k = me; k < D.nl; k += T) fs += P.h[k] * P.h[k];
    for (int c = me; c < D.q; c += T) fs += P.b[c] * P.b[c];
    return tm.sum(fs);
  }

  // rz = f + Hz + G'l + A'v (+ sigma (z - zb)), rl = h - Gz
  // (+ sigma (l - lb)), rv = pfb(y + sigma (v - vb), v) or the penalized
  // natural residual row.
  FB_DEV float residual(const SolveOpts& o, const Vars& x, const Vars& xb,
                        bool inner, bool store, const Vars& r) const {
    const int n = D.n, q = D.q, nlc = D.nl, T = tm.size(), me = tm.rank();
    const float sg = o.sigma;
    float sz = 0.0f, sl = 0.0f, sv = 0.0f;
    for (int i = me; i < n; i += T) {
      float rr = P.f[i] + dn_row(P.H, n, x.z, i);
      if (nlc > 0) rr = rr + dn_row_T(P.G, nlc, n, x.l, i);
      rr = rr + dn_row_T(P.A, q, n, x.v, i);
      if (inner) rr = rr + sg * (x.z[i] - xb.z[i]);
      if (store) r.z[i] = -rr;
      sz += rr * rr;
    }
    for (int k = me; k < nlc; k += T) {
      float rr = P.h[k] - dn_row(P.G, n, x.z, k);
      if (inner) rr = rr + sg * (x.l[k] - xb.l[k]);
      if (store) r.l[k] = -rr;
      sl += rr * rr;
    }
    for (int c = me; c < q; c += T) {
      float yy = x.y[c], vv = x.v[c], rr;
      if (inner) {
        rr = fb_pfb(yy + sg * (vv - xb.v[c]), vv, o.alpha, o.om_alpha);
      } else {
        rr = o.alpha * fminf(yy, vv)
             + o.om_alpha * fmaxf(0.0f, yy) * fmaxf(0.0f, vv);
      }
      if (store) r.v[c] = -rr;
      sv += rr * rr;
    }
    const float total = tm.sum(sz + sl + sv);
    tm.sync();
    return sqrtf(total);
  }

  // The Newton step from the negated inner residual r:
  //   E = H + sigma I + A' diag(gamma ./ mus) A = Le Le',
  //   r1 = rz - A'(rv ./ mus); for nl > 0, W = Le^{-1} G',
  //   S = sigma I + W'W = Ls Ls', dl = S^{-1}(W' Le^{-1} r1 + rl),
  //   dz = E^{-1}(r1 - G' dl); dv = (rv + gamma A dz) ./ mus, dy = b - A dz.
  FB_DEV bool newton_step(const SolveOpts& o, const Vars& x,
                          const Vars& xbar, const Vars& r,
                          const Vars& d) const {
    const int n = D.n, q = D.q, nlc = D.nl, T = tm.size(), me = tm.rank();
    const float sg = o.sigma;
    const DenseStepLayout L = dense_step_layout(D);
    const Lane Le = ws.at(L.Le), Wt = ws.at(L.Wt), Ls = ws.at(L.Ls);
    const Lane gam = ws.at(L.gam), mus = ws.at(L.mus), w = ws.at(L.w);
    const Lane u = ws.at(L.u);

    for (int c = me; c < q; c += T) {
      float g, m;
      float ys = x.y[c] + sg * (x.v[c] - xbar.v[c]);
      fb_pfb_weights(ys, x.v[c], sg, o.alpha, o.om_alpha, g, m);
      gam[c] = g;
      mus[c] = m;
      w[c] = g / m;
    }
    tm.sync();
    // E, lower triangle by entries, then its Cholesky factor in place.
    for (int t = me; t < n * (n + 1) / 2; t += T) {
      int i, j;
      fb_tri_entry(t, i, j);
      float e = 0.0f;
      for (int c = 0; c < q; ++c) {
        long long cn = (long long)c * n;
        e += P.A[cn + i] * (w[c] * P.A[cn + j]);
      }
      float hij = P.H[(long long)i * n + j];
      if (i == j) hij = hij + sg;
      Le[(long long)i * n + j] = hij + e;
    }
    tm.sync();
    fb_chol(tm, Le, n);
    // r1 = rz - A'(rv ./ mus) into d.z (rv ./ mus in d.v for now).
    for (int c = me; c < q; c += T) d.v[c] = r.v[c] / mus[c];
    tm.sync();
    for (int i = me; i < n; i += T)
      d.z[i] = r.z[i] - dn_row_T(P.A, q, n, d.v, i);
    tm.sync();
    if (nlc > 0) {
      // W' rows: Le^{-1} times the rows of G, one a thread;
      // S = sigma I + W'W by entries.
      for (int k = me; k < nlc; k += T) {
        Lane wk = Wt.at((long long)k * n);
        for (int i = 0; i < n; ++i) wk[i] = P.G[(long long)k * n + i];
        fb_trsv_lower(Solo{}, Le, n, wk);
      }
      tm.sync();
      for (int t = me; t < nlc * (nlc + 1) / 2; t += T) {
        int k, m;
        fb_tri_entry(t, k, m);
        float s = 0.0f;
        for (int i = 0; i < n; ++i)
          s += Wt[(long long)k * n + i] * Wt[(long long)m * n + i];
        Ls[(long long)k * nlc + m] = (k == m) ? sg + s : s;
      }
      tm.sync();
      fb_chol(tm, Ls, nlc);
      // dl = S^{-1}(W'u + rl) with u = Le^{-1} r1.
      for (int i = me; i < n; i += T) u[i] = d.z[i];
      tm.sync();
      fb_trsv_lower(tm, Le, n, u);
      for (int k = me; k < nlc; k += T)
        d.l[k] = dn_row(Wt, n, u, k) + r.l[k];
      tm.sync();
      fb_cho_solve(tm, Ls, nlc, d.l);
      // r1 - G' dl.
      for (int i = me; i < n; i += T)
        d.z[i] = d.z[i] - dn_row_T(P.G, nlc, n, d.l, i);
      tm.sync();
    }
    fb_cho_solve(tm, Le, n, d.z);
    // Dual recovery (dense_cholesky_solver.cc:118-124).
    for (int c = me; c < q; c += T) {
      float adz = dn_row(P.A, n, d.z, c);
      d.v[c] = (r.v[c] + gam[c] * adz) / mus[c];
      d.y[c] = P.b[c] - adz;
    }
    bool bad = false;
    for (int i = me; i < n; i += T) bad = bad || isnan(d.z[i]);
    for (int k = me; k < nlc; k += T) bad = bad || isnan(d.l[k]);
    bad = tm.any(bad);
    tm.sync();
    return !bad;
  }

  // Infeasibility certificates at the step dx (full_feasibility.cc:29-77),
  // with the G terms only when nl > 0.
  FB_DEV void feasibility(const Vars& dx, float tol, bool& p_inf,
                          bool& d_inf) const {
    const int n = D.n, q = D.q, nlc = D.nl, T = tm.size(), me = tm.rank();
    float d1 = -INFINITY, d2 = 0.0f, d3 = 0.0f, d4 = 0.0f, wz = 0.0f;
    float p1 = 0.0f, p2h = 0.0f, p2b = 0.0f, nvm = 0.0f, nlm = 0.0f;
    for (int c = me; c < q; c += T) {
      d1 = fmaxf(d1, dn_row(P.A, n, dx.z, c));
      p2b += P.b[c] * dx.v[c];
      nvm = fmaxf(nvm, fabsf(dx.v[c]));
    }
    for (int k = me; k < nlc; k += T) {
      d2 = fmaxf(d2, fabsf(dn_row(P.G, n, dx.z, k)));
      p2h += P.h[k] * dx.l[k];
      nlm = fmaxf(nlm, fabsf(dx.l[k]));
    }
    for (int i = me; i < n; i += T) {
      d3 = fmaxf(d3, fabsf(dn_row(P.H, n, dx.z, i)));
      d4 += P.f[i] * dx.z[i];
      wz = fmaxf(wz, fabsf(dx.z[i]));
      float g = dn_row_T(P.A, q, n, dx.v, i);
      if (nlc > 0) g = g + dn_row_T(P.G, nlc, n, dx.l, i);
      p1 = fmaxf(p1, fabsf(g));
    }
    d1 = tm.max(d1);
    d2 = tm.max(d2);
    d3 = tm.max(d3);
    d4 = tm.sum(d4);
    wz = tm.max(wz);
    p1 = tm.max(p1);
    p2h = tm.sum(p2h);
    p2b = tm.sum(p2b);
    const float um = tm.max(fmaxf(nvm, nlm));
    d_inf = (d1 <= wz * tol) && (d2 <= tol * wz) && (d3 <= tol * wz)
            && (d4 < 0.0f) && (wz > 1e-14f);
    p_inf = (p1 <= tol * um) && ((p2h + p2b) < 0.0f);
  }
};

// Solver scratch per instance in device memory: the Newton-step scratch
// (for a team that does not stage), then the iterates.
FB_HD SolveLayout dense_solve_layout(const DenseDims& D, bool stages) {
  return fb_solve_layout(stages ? 0 : dense_step_layout(D).total,
                         fb_vars_floats(D.n, D.nl, D.q));
}

// The whole solve of one dense instance from (z0, l0, v0): the solver
// scratch in ws (dense_solve_layout), the stage block of a team that
// stages in st.
template <class Tm>
FB_DEV void fbstab_dense_solve_lane(const Tm& tm, const DenseDims& D,
                                    const SolveOpts& o, const DenseProb& P,
                                    Lane z0, Lane l0, Lane v0,
                                    const SolveOut& out, Lane ws, Lane st) {
  const long long n = D.n, q = D.q, nl = D.nl;
  const DenseStageLayout S = dense_stage_layout(D);
  const SolveLayout L = dense_solve_layout(D, Tm::kStages);
  DenseProb W = P;
  W.H = fb_stage_in(tm, st.at(S.H), P.H, n * n);
  W.A = fb_stage_in(tm, st.at(S.A), P.A, q * n);
  W.G = fb_stage_in(tm, st.at(S.G), P.G, nl * n);
  tm.sync();
  const DenseSolveProb<Tm> prob{
      tm, D, W, fb_work(tm, st.at(S.step), ws.at(L.step))};
  fbstab_solve_lane(prob, o, z0, l0, v0, out, ws.at(L.xk));
}

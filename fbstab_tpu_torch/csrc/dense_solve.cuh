// K3's problem class: the dense QP of one instance,
//   min 1/2 z'Hz + f'z  s.t.  Gz = h, Az <= b,
// with the quasi-definite block Newton step of models/dense_qp.py
// (dense_cholesky_solver.cc:32-127), for the shared FBstab loop of
// fbstab_solve.cuh. nl = 0 drops every equality-block term.
#pragma once

#include "fbstab_solve.cuh"

struct DenseDims {
  int n, q, nl;
};

// Batch-last dense data at one instance (row-major blocks):
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
// Newton-step scratch ws (dense_step_layout).
struct DenseSolveProb {
  DenseDims D;
  DenseProb P;
  Lane ws;

  FB_DEV Solo team() const { return Solo{}; }
  FB_DEV long long nz() const { return D.n; }
  FB_DEV long long nl() const { return D.nl; }
  FB_DEV long long nv() const { return D.q; }

  FB_DEV float b(long long k) const { return P.b[k]; }
  FB_DEV float Az(Lane z, long long c) const {
    return dn_row(P.A, D.n, z, (int)c);
  }
  FB_DEV float forcing_sq() const {
    float fs = 0.0f;
    for (int i = 0; i < D.n; ++i) fs += P.f[i] * P.f[i];
    for (int k = 0; k < D.nl; ++k) fs += P.h[k] * P.h[k];
    for (int c = 0; c < D.q; ++c) fs += P.b[c] * P.b[c];
    return fs;
  }

  // rz = f + Hz + G'l + A'v (+ sigma (z - zb)), rl = h - Gz
  // (+ sigma (l - lb)), rv = pfb(y + sigma (v - vb), v) or the penalized
  // natural residual row.
  FB_DEV float residual(const SolveOpts& o, const Vars& x, const Vars& xb,
                        bool inner, bool store, const Vars& r) const {
    const int n = D.n, q = D.q, nlc = D.nl;
    const float sg = o.sigma;
    float sz = 0.0f, sl = 0.0f, sv = 0.0f;
    for (int i = 0; i < n; ++i) {
      float rr = P.f[i] + dn_row(P.H, n, x.z, i);
      if (nlc > 0) rr = rr + dn_row_T(P.G, nlc, n, x.l, i);
      rr = rr + dn_row_T(P.A, q, n, x.v, i);
      if (inner) rr = rr + sg * (x.z[i] - xb.z[i]);
      if (store) r.z[i] = -rr;
      sz += rr * rr;
    }
    for (int k = 0; k < nlc; ++k) {
      float rr = P.h[k] - dn_row(P.G, n, x.z, k);
      if (inner) rr = rr + sg * (x.l[k] - xb.l[k]);
      if (store) r.l[k] = -rr;
      sl += rr * rr;
    }
    for (int c = 0; c < q; ++c) {
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
    return sqrtf(sz + sl + sv);
  }

  // The Newton step from the negated inner residual r:
  //   E = H + sigma I + A' diag(gamma ./ mus) A = Le Le',
  //   r1 = rz - A'(rv ./ mus); for nl > 0, W = Le^{-1} G',
  //   S = sigma I + W'W = Ls Ls', dl = S^{-1}(W' Le^{-1} r1 + rl),
  //   dz = E^{-1}(r1 - G' dl); dv = (rv + gamma A dz) ./ mus, dy = b - A dz.
  FB_DEV bool newton_step(const SolveOpts& o, const Vars& x,
                          const Vars& xbar, const Vars& r,
                          const Vars& d) const {
    const int n = D.n, q = D.q, nlc = D.nl;
    const float sg = o.sigma;
    const DenseStepLayout L = dense_step_layout(D);
    const Lane Le = ws.at(L.Le), Wt = ws.at(L.Wt), Ls = ws.at(L.Ls);
    const Lane gam = ws.at(L.gam), mus = ws.at(L.mus), w = ws.at(L.w);
    const Lane u = ws.at(L.u);

    for (int c = 0; c < q; ++c) {
      float g, m;
      float ys = x.y[c] + sg * (x.v[c] - xbar.v[c]);
      fb_pfb_weights(ys, x.v[c], sg, o.alpha, o.om_alpha, g, m);
      gam[c] = g;
      mus[c] = m;
      w[c] = g / m;
    }
    // E, lower triangle, then its Cholesky factor in place.
    for (int i = 0; i < n; ++i)
      for (int j = 0; j <= i; ++j) {
        float e = 0.0f;
        for (int c = 0; c < q; ++c) {
          long long cn = (long long)c * n;
          e += P.A[cn + i] * (w[c] * P.A[cn + j]);
        }
        float hij = P.H[(long long)i * n + j];
        if (i == j) hij = hij + sg;
        Le[(long long)i * n + j] = hij + e;
      }
    fb_chol(Solo{}, Le, n);
    // r1 = rz - A'(rv ./ mus) into d.z (rv ./ mus in d.v for now).
    for (int c = 0; c < q; ++c) d.v[c] = r.v[c] / mus[c];
    for (int i = 0; i < n; ++i)
      d.z[i] = r.z[i] - dn_row_T(P.A, q, n, d.v, i);
    if (nlc > 0) {
      // W' rows: Le^{-1} times the rows of G; S = sigma I + W'W.
      for (int k = 0; k < nlc; ++k) {
        Lane wk = Wt.at((long long)k * n);
        for (int i = 0; i < n; ++i) wk[i] = P.G[(long long)k * n + i];
        fb_trsv_lower(Solo{}, Le, n, wk);
      }
      for (int k = 0; k < nlc; ++k)
        for (int m = 0; m <= k; ++m) {
          float s = 0.0f;
          for (int i = 0; i < n; ++i)
            s += Wt[(long long)k * n + i] * Wt[(long long)m * n + i];
          Ls[(long long)k * nlc + m] = (k == m) ? sg + s : s;
        }
      fb_chol(Solo{}, Ls, nlc);
      // dl = S^{-1}(W'u + rl) with u = Le^{-1} r1.
      for (int i = 0; i < n; ++i) u[i] = d.z[i];
      fb_trsv_lower(Solo{}, Le, n, u);
      for (int k = 0; k < nlc; ++k) d.l[k] = dn_row(Wt, n, u, k) + r.l[k];
      fb_cho_solve(Solo{}, Ls, nlc, d.l);
      // r1 - G' dl.
      for (int i = 0; i < n; ++i)
        d.z[i] = d.z[i] - dn_row_T(P.G, nlc, n, d.l, i);
    }
    fb_cho_solve(Solo{}, Le, n, d.z);
    // Dual recovery (dense_cholesky_solver.cc:118-124).
    for (int c = 0; c < q; ++c) {
      float adz = dn_row(P.A, n, d.z, c);
      d.v[c] = (r.v[c] + gam[c] * adz) / mus[c];
      d.y[c] = P.b[c] - adz;
    }
    bool ok = true;
    for (int i = 0; i < n; ++i) ok = ok && !isnan(d.z[i]);
    for (int k = 0; k < nlc; ++k) ok = ok && !isnan(d.l[k]);
    return ok;
  }

  // Infeasibility certificates at the step dx (full_feasibility.cc:29-77),
  // with the G terms only when nl > 0.
  FB_DEV void feasibility(const Vars& dx, float tol, bool& p_inf,
                          bool& d_inf) const {
    const int n = D.n, q = D.q, nlc = D.nl;
    float d1 = -INFINITY, d2 = 0.0f, d3 = 0.0f, d4 = 0.0f, wz = 0.0f;
    float p1 = 0.0f, p2h = 0.0f, p2b = 0.0f, nvm = 0.0f, nlm = 0.0f;
    for (int c = 0; c < q; ++c) d1 = fmaxf(d1, dn_row(P.A, n, dx.z, c));
    for (int k = 0; k < nlc; ++k)
      d2 = fmaxf(d2, fabsf(dn_row(P.G, n, dx.z, k)));
    for (int i = 0; i < n; ++i) {
      d3 = fmaxf(d3, fabsf(dn_row(P.H, n, dx.z, i)));
      d4 += P.f[i] * dx.z[i];
      wz = fmaxf(wz, fabsf(dx.z[i]));
      float g = dn_row_T(P.A, q, n, dx.v, i);
      if (nlc > 0) g = g + dn_row_T(P.G, nlc, n, dx.l, i);
      p1 = fmaxf(p1, fabsf(g));
    }
    for (int k = 0; k < nlc; ++k) {
      p2h += P.h[k] * dx.l[k];
      nlm = fmaxf(nlm, fabsf(dx.l[k]));
    }
    for (int c = 0; c < q; ++c) {
      p2b += P.b[c] * dx.v[c];
      nvm = fmaxf(nvm, fabsf(dx.v[c]));
    }
    d_inf = (d1 <= wz * tol) && (d2 <= tol * wz) && (d3 <= tol * wz)
            && (d4 < 0.0f) && (wz > 1e-14f);
    float um = fmaxf(nvm, nlm);
    p_inf = (p1 <= tol * um) && ((p2h + p2b) < 0.0f);
  }
};

// Solver scratch per instance: the Newton-step scratch, then the iterates.
FB_HD SolveLayout dense_solve_layout(const DenseDims& D) {
  return fb_solve_layout(dense_step_layout(D).total,
                         fb_vars_floats(D.n, D.nl, D.q));
}

// The whole solve of one dense instance from (z0, l0, v0).
FB_DEV void fbstab_dense_solve_lane(const DenseDims& D, const SolveOpts& o,
                                    const DenseProb& P, Lane z0, Lane l0,
                                    Lane v0, const SolveOut& out, Lane ws) {
  const SolveLayout L = dense_solve_layout(D);
  const DenseSolveProb prob{D, P, ws.at(L.step)};
  fbstab_solve_lane(prob, o, z0, l0, v0, out, ws.at(L.xk));
}

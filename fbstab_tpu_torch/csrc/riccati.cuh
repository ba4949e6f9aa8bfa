// The Riccati factor-and-solve of one MPC Newton step, for one instance,
// as a device function shared by both kernels (the Newton-step kernel in
// riccati.cu and the fused solver in mpc_solve.cu), as the Pallas kernels
// share ops/riccati_pallas.py::riccati_factor_solve.
//
// It computes, with the recurrences of riccati_linear_solver.cc:77-344:
// PFB weights from (y, v, vbar, sigma); the barrier-augmented stage
// Hessians Qh = Q + sigma I + E'GE, Rh = R + sigma I + L'GL,
// Sh = S + L'GE; the forward Riccati matrix recursion with small
// Choleskys (L, M, SM, SG, AM, P per stage); the forward vector recursion
// (theta, h); and the backward substitution for (dz, dl). Failure of a
// Cholesky (a non-positive pivot) yields NaNs that propagate to dz, dl.
#pragma once

#include "fbstab_common.cuh"

// Offsets (in floats per instance) of the Newton-step scratch.
struct RicLayout {
  long long Lc, M, SM, SG, AM, P, th, h, gam, mus, r1;
  long long Qh, Rh, Sh, T, v0, v1, v2, v3, total;
};

FB_HD RicLayout ric_layout(const MpcDims& D) {
  long long N1 = D.N + 1, nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  long long nmax = nx > nu ? nx : nu;
  RicLayout w;
  long long o = 0;
  w.Lc = o; o += N1 * nx * nx;
  w.M = o;  o += N1 * nx * nx;
  w.SM = o; o += N1 * nu * nx;
  w.SG = o; o += N1 * nu * nu;
  w.AM = o; o += D.N * nx * nx;
  w.P = o;  o += D.N * nx * nu;
  w.th = o; o += N1 * nx;
  w.h = o;  o += N1 * nx;
  w.gam = o; o += N1 * nc;
  w.mus = o; o += N1 * nc;
  w.r1 = o; o += N1 * ns;
  w.Qh = o; o += nx * nx;
  w.Rh = o; o += nu * nu;
  w.Sh = o; o += nu * nx;
  w.T = o;  o += nx * nx;
  w.v0 = o; o += nmax;
  w.v1 = o; o += nmax;
  w.v2 = o; o += nmax;
  w.v3 = o; o += nmax;
  w.total = o;
  return w;
}

// Rows of Y = X inv(M)' for lower M (m x m) and X (rows x m), in place on
// X: row r of Y is inv(M) applied to row r of X.
FB_DEV void ric_right_solve_T(Lane X, int rows, Lane M, int m) {
  for (int r = 0; r < rows; ++r) fb_trsv_lower(M, m, X.at(r * m));
}

// Stage Hessians of stage i into w.Qh, w.Rh, w.Sh.
FB_DEV void ric_stage_hessians(const MpcDims& D, const MpcProb& P,
                               const RicLayout& o, Lane w, float sigma,
                               int i) {
  const int nx = D.nx, nu = D.nu, nc = D.nc;
  Lane E = P.E.at((long long)i * nc * nx), L = P.L.at((long long)i * nc * nu);
  Lane gam = w.at(o.gam + (long long)i * nc), mus = w.at(o.mus + (long long)i * nc);
  Lane Qh = w.at(o.Qh), Rh = w.at(o.Rh), Sh = w.at(o.Sh);
  Lane Q = P.Q.at((long long)i * nx * nx), R = P.R.at((long long)i * nu * nu),
       S = P.S.at((long long)i * nu * nx);
  for (int r = 0; r < nx; ++r)
    for (int c = 0; c < nx; ++c) {
      float s = 0.0f;
      for (int k = 0; k < nc; ++k)
        s += E[k * nx + r] * ((gam[k] / mus[k]) * E[k * nx + c]);
      Qh[r * nx + c] = (Q[r * nx + c] + (r == c ? sigma : 0.0f)) + s;
    }
  for (int r = 0; r < nu; ++r)
    for (int c = 0; c < nu; ++c) {
      float s = 0.0f;
      for (int k = 0; k < nc; ++k)
        s += L[k * nu + r] * ((gam[k] / mus[k]) * L[k * nu + c]);
      Rh[r * nu + c] = (R[r * nu + c] + (r == c ? sigma : 0.0f)) + s;
    }
  for (int r = 0; r < nu; ++r)
    for (int c = 0; c < nx; ++c) {
      float s = 0.0f;
      for (int k = 0; k < nc; ++k)
        s += L[k * nu + r] * ((gam[k] / mus[k]) * E[k * nx + c]);
      Sh[r * nx + c] = S[r * nx + c] + s;
    }
}

// M, SM, SG of stage i from the carried factor Lc[i]
// (riccati_linear_solver.cc:140-151, 191-209).
FB_DEV void ric_stage_factor(const MpcDims& D, const MpcProb& P,
                             const RicLayout& o, Lane w, float sigma, int i) {
  const int nx = D.nx, nu = D.nu;
  ric_stage_hessians(D, P, o, w, sigma, i);
  Lane Lf = w.at(o.Lc + (long long)i * nx * nx);
  Lane M = w.at(o.M + (long long)i * nx * nx);
  Lane SM = w.at(o.SM + (long long)i * nu * nx);
  Lane SG = w.at(o.SG + (long long)i * nu * nu);
  Lane T = w.at(o.T), Qh = w.at(o.Qh), Rh = w.at(o.Rh), Sh = w.at(o.Sh);
  Lane col = w.at(o.v0);
  // T = inv(Lf Lf'), column by column.
  for (int j = 0; j < nx; ++j) {
    for (int r = 0; r < nx; ++r) col[r] = (r == j) ? 1.0f : 0.0f;
    fb_cho_solve(Lf, nx, col);
    for (int r = 0; r < nx; ++r) T[r * nx + j] = col[r];
  }
  // M = chol(Qh + T).
  for (int k = 0; k < nx * nx; ++k) M[k] = Qh[k] + T[k];
  fb_chol(M, nx);
  // SM = Sh inv(M)'.
  for (int k = 0; k < nu * nx; ++k) SM[k] = Sh[k];
  ric_right_solve_T(SM, nu, M, nx);
  // SG = chol(Rh - SM SM').
  for (int r = 0; r < nu; ++r)
    for (int c = 0; c < nu; ++c) {
      float s = 0.0f;
      for (int k = 0; k < nx; ++k) s += SM[r * nx + k] * SM[c * nx + k];
      SG[r * nu + c] = Rh[r * nu + c] - s;
    }
  fb_chol(SG, nu);
}

// r1(i) = rz(i) - [E(i); L(i)]' (rv(i) ./ mus(i)) for every stage
// (riccati_linear_solver.cc:230-235), stage-major (N+1, nx+nu).
FB_DEV void ric_r1(const MpcDims& D, const MpcProb& P, const RicLayout& o,
                   Lane w, Lane rz, Lane rv) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  for (int i = 0; i <= D.N; ++i) {
    Lane E = P.E.at((long long)i * nc * nx), L = P.L.at((long long)i * nc * nu);
    Lane mus = w.at(o.mus + (long long)i * nc);
    Lane r1 = w.at(o.r1 + (long long)i * ns);
    for (int j = 0; j < nx; ++j) {
      float s = 0.0f;
      for (int c = 0; c < nc; ++c) s += E[c * nx + j] * (rv[i * nc + c] / mus[c]);
      r1[j] = rz[(long long)i * ns + j] - s;
    }
    for (int j = 0; j < nu; ++j) {
      float s = 0.0f;
      for (int c = 0; c < nc; ++c) s += L[c * nu + j] * (rv[i * nc + c] / mus[c]);
      r1[nx + j] = rz[(long long)i * ns + nx + j] - s;
    }
  }
}

// One Newton step for one instance.
//   sigma: this instance's proximal parameter; alpha, om_alpha = 1 - alpha.
//   v, y, vbar (N+1, nc): the iterate pieces;
//   rz (N+1, nx+nu), rl (N+1, nx), rv (N+1, nc): the NEGATED inner
//   residual; dz (N+1, nx+nu), dl (N+1, nx): outputs;
//   w: scratch laid out by ric_layout. After the call w.gam / w.mus hold
//   the PFB weights (the dual recovery dv, dy uses them).
FB_DEV void riccati_factor_solve(const MpcDims& D, float sigma, float alpha,
                                 float om_alpha, const MpcProb& P, Lane v,
                                 Lane y, Lane vbar, Lane rz, Lane rl, Lane rv,
                                 Lane dz, Lane dl, Lane w) {
  const int N = D.N, nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  const RicLayout o = ric_layout(D);
  const long long xx = (long long)nx * nx;

  for (int k = 0; k < (N + 1) * nc; ++k) {
    float ys = y[k] + sigma * (v[k] - vbar[k]);
    float g, m;
    fb_pfb_weights(ys, v[k], sigma, alpha, om_alpha, g, m);
    w[o.gam + k] = g;
    w[o.mus + k] = m;
  }

  // ---- Forward matrix recursion (cc:125-188). L(0) = sqrt(sigma) I. ----
  {
    Lane L0 = w.at(o.Lc);
    float sq = sqrtf(sigma);
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nx; ++c) L0[r * nx + c] = (r == c) ? sq : 0.0f;
  }
  for (int i = 0; i < N; ++i) {
    ric_stage_factor(D, P, o, w, sigma, i);
    Lane M = w.at(o.M + i * xx), SM = w.at(o.SM + (long long)i * nu * nx);
    Lane SG = w.at(o.SG + (long long)i * nu * nu);
    Lane AM = w.at(o.AM + i * xx), Pm = w.at(o.P + (long long)i * nx * nu);
    Lane A = P.A.at(i * xx), Bm = P.B.at((long long)i * nx * nu);
    // AM = A inv(M)'.
    for (int k = 0; k < nx * nx; ++k) AM[k] = A[k];
    ric_right_solve_T(AM, nx, M, nx);
    // P = (AM SM' - B) inv(SG)'.
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nu; ++c) {
        float s = 0.0f;
        for (int k = 0; k < nx; ++k) s += AM[r * nx + k] * SM[c * nx + k];
        Pm[r * nu + c] = s - Bm[r * nu + c];
      }
    ric_right_solve_T(Pm, nx, SG, nu);
    // L(i+1) = chol(sigma I + P P' + AM AM').
    Lane Ln = w.at(o.Lc + (i + 1) * xx);
    for (int r = 0; r < nx; ++r)
      for (int c = 0; c < nx; ++c) {
        float pp = 0.0f, aa = 0.0f;
        for (int k = 0; k < nu; ++k) pp += Pm[r * nu + k] * Pm[c * nu + k];
        for (int k = 0; k < nx; ++k) aa += AM[r * nx + k] * AM[c * nx + k];
        Ln[r * nx + c] = ((r == c ? sigma : 0.0f) + pp) + aa;
      }
    fb_chol(Ln, nx);
  }
  ric_stage_factor(D, P, o, w, sigma, N);

  // ---- Forward vector recursion (cc:239-262). ----
  ric_r1(D, P, o, w, rz, rv);
  Lane th = w.at(o.th), h = w.at(o.h), r1 = w.at(o.r1);
  Lane tx = w.at(o.v0), tu = w.at(o.v1);
  for (int j = 0; j < nx; ++j) th[j] = -rl[j];
  for (int j = 0; j < nx; ++j) h[j] = th[j];
  fb_cho_solve(w.at(o.Lc), nx, h);
  for (int j = 0; j < nx; ++j) h[j] = h[j] - r1[j];
  for (int i = 0; i < N; ++i) {
    Lane M = w.at(o.M + i * xx), SM = w.at(o.SM + (long long)i * nu * nx);
    Lane SG = w.at(o.SG + (long long)i * nu * nu);
    Lane AM = w.at(o.AM + i * xx), Pm = w.at(o.P + (long long)i * nx * nu);
    for (int j = 0; j < nx; ++j) tx[j] = h[i * nx + j];
    fb_trsv_lower(M, nx, tx);
    for (int j = 0; j < nu; ++j) {
      float s = 0.0f;
      for (int k = 0; k < nx; ++k) s += SM[j * nx + k] * tx[k];
      tu[j] = s + r1[(long long)i * ns + nx + j];
    }
    fb_trsv_lower(SG, nu, tu);
    Lane thn = th.at((long long)(i + 1) * nx), hn = h.at((long long)(i + 1) * nx);
    for (int j = 0; j < nx; ++j) {
      float pt = 0.0f, at = 0.0f;
      for (int k = 0; k < nu; ++k) pt += Pm[j * nu + k] * tu[k];
      for (int k = 0; k < nx; ++k) at += AM[j * nx + k] * tx[k];
      thn[j] = (pt + at) - rl[(long long)(i + 1) * nx + j];
      hn[j] = thn[j];
    }
    fb_cho_solve(w.at(o.Lc + (i + 1) * xx), nx, hn);
    for (int j = 0; j < nx; ++j) hn[j] = hn[j] - r1[(long long)(i + 1) * ns + j];
  }

  // ---- Backward recursion (cc:266-327). ----
  Lane t2 = w.at(o.v2), t3 = w.at(o.v3);
  for (int i = N; i >= 0; --i) {
    Lane M = w.at(o.M + i * xx), SM = w.at(o.SM + (long long)i * nu * nx);
    Lane SG = w.at(o.SG + (long long)i * nu * nu);
    Lane Lf = w.at(o.Lc + i * xx);
    Lane xi = dz.at((long long)i * ns), ui = dz.at((long long)i * ns + nx);
    Lane li = dl.at((long long)i * nx);
    // tx = inv(M) h; u = inv(SG)(SM tx + r1u).
    for (int j = 0; j < nx; ++j) tx[j] = h[(long long)i * nx + j];
    fb_trsv_lower(M, nx, tx);
    for (int j = 0; j < nu; ++j) {
      float s = 0.0f;
      for (int k = 0; k < nx; ++k) s += SM[j * nx + k] * tx[k];
      ui[j] = s + r1[(long long)i * ns + nx + j];
    }
    fb_trsv_lower(SG, nu, ui);
    if (i < N) {
      // u = inv(SG')(u + P' l(i+1)).
      Lane Pm = w.at(o.P + (long long)i * nx * nu);
      Lane ln = dl.at((long long)(i + 1) * nx);
      for (int j = 0; j < nu; ++j) {
        float s = 0.0f;
        for (int k = 0; k < nx; ++k) s += Pm[k * nu + j] * ln[k];
        ui[j] = ui[j] + s;
      }
    }
    fb_trsv_upperT(SG, nu, ui);
    // x = -inv(M')(tx + SM' u [+ AM' l(i+1)]).
    for (int j = 0; j < nx; ++j) {
      float s = 0.0f;
      for (int k = 0; k < nu; ++k) s += SM[k * nx + j] * ui[k];
      float acc = tx[j] + s;
      if (i < N) {
        Lane AM = w.at(o.AM + i * xx);
        Lane ln = dl.at((long long)(i + 1) * nx);
        float a = 0.0f;
        for (int k = 0; k < nx; ++k) a += AM[k * nx + j] * ln[k];
        acc = acc + a;
      }
      t2[j] = acc;
    }
    fb_trsv_upperT(M, nx, t2);
    for (int j = 0; j < nx; ++j) xi[j] = -t2[j];
    // l = -inv(L L')(theta + x).
    for (int j = 0; j < nx; ++j) t3[j] = th[(long long)i * nx + j] + xi[j];
    fb_cho_solve(Lf, nx, t3);
    for (int j = 0; j < nx; ++j) li[j] = -t3[j];
  }
}

// K2's problem class: the MPC QP of one instance (stage-major data, the
// Riccati Newton step of riccati.cuh) for the shared FBstab loop of
// fbstab_solve.cuh.
#pragma once

#include "fbstab_solve.cuh"
#include "riccati.cuh"

// (E z_x + L z_u) at stage s, row c.
FB_DEV float fb_gemvA_row(const MpcDims& D, const MpcProb& P, Lane z, int s,
                          int c) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  Lane E = P.E.at(((long long)s * nc + c) * nx);
  Lane L = P.L.at(((long long)s * nc + c) * nu);
  float ex = 0.0f, lu = 0.0f;
  for (int j = 0; j < nx; ++j) ex += E[j] * z[(long long)s * ns + j];
  for (int j = 0; j < nu; ++j) lu += L[j] * z[(long long)s * ns + nx + j];
  return ex + lu;
}

// (G z) at stage s, row i: -x(0) at s = 0, A x(s-1) + B u(s-1) - x(s).
FB_DEV float fb_gemvG_row(const MpcDims& D, const MpcProb& P, Lane z, int s,
                          int i) {
  const int nx = D.nx, nu = D.nu, ns = nx + nu;
  if (s == 0) return -z[i];
  Lane A = P.A.at(((long long)(s - 1) * nx + i) * nx);
  Lane Bm = P.B.at(((long long)(s - 1) * nx + i) * nu);
  float ax = 0.0f, bu = 0.0f;
  for (int j = 0; j < nx; ++j) ax += A[j] * z[(long long)(s - 1) * ns + j];
  for (int j = 0; j < nu; ++j) bu += Bm[j] * z[(long long)(s - 1) * ns + nx + j];
  return (ax + bu) - z[(long long)s * ns + i];
}

// Row j (0 <= j < nx + nu) of stage s of H z.
FB_DEV float fb_gemvH_row(const MpcDims& D, const MpcProb& P, Lane z, int s,
                          int j) {
  const int nx = D.nx, nu = D.nu, ns = nx + nu;
  Lane zx = z.at((long long)s * ns), zu = z.at((long long)s * ns + nx);
  float a = 0.0f, b = 0.0f;
  if (j < nx) {
    Lane Q = P.Q.at(((long long)s * nx + j) * nx);
    Lane S = P.S.at((long long)s * nu * nx);
    for (int k = 0; k < nx; ++k) a += Q[k] * zx[k];
    for (int k = 0; k < nu; ++k) b += S[k * nx + j] * zu[k];
  } else {
    int i = j - nx;
    Lane S = P.S.at(((long long)s * nu + i) * nx);
    Lane R = P.R.at(((long long)s * nu + i) * nu);
    for (int k = 0; k < nx; ++k) a += S[k] * zx[k];
    for (int k = 0; k < nu; ++k) b += R[k] * zu[k];
  }
  return a + b;
}

// Row j of stage s of G' l (x rows: -l(s) + A(s)' l(s+1); u rows:
// B(s)' l(s+1); the s+1 terms vanish at s = N).
FB_DEV float fb_gemvGT_row(const MpcDims& D, const MpcProb& P, Lane l, int s,
                           int j) {
  const int nx = D.nx, nu = D.nu;
  float g = 0.0f;
  if (s < D.N) {
    Lane ln = l.at((long long)(s + 1) * nx);
    if (j < nx) {
      Lane A = P.A.at((long long)s * nx * nx);
      for (int k = 0; k < nx; ++k) g += A[k * nx + j] * ln[k];
    } else {
      Lane Bm = P.B.at((long long)s * nx * nu);
      for (int k = 0; k < nx; ++k) g += Bm[k * nu + (j - nx)] * ln[k];
    }
  }
  if (j < nx) return -l[(long long)s * nx + j] + g;
  return g;
}

// Row j of stage s of A' v (x rows: E(s)' v(s); u rows: L(s)' v(s)).
FB_DEV float fb_gemvAT_row(const MpcDims& D, const MpcProb& P, Lane v, int s,
                           int j) {
  const int nx = D.nx, nu = D.nu, nc = D.nc;
  float a = 0.0f;
  if (j < nx) {
    Lane E = P.E.at((long long)s * nc * nx);
    for (int c = 0; c < nc; ++c) a += E[c * nx + j] * v[(long long)s * nc + c];
  } else {
    Lane L = P.L.at((long long)s * nc * nu);
    for (int c = 0; c < nc; ++c)
      a += L[c * nu + (j - nx)] * v[(long long)s * nc + c];
  }
  return a;
}

// f at stage s row j, h at stage s row i, b at stage s row c.
FB_DEV float fb_f(const MpcDims& D, const MpcProb& P, int s, int j) {
  return j < D.nx ? P.q[(long long)s * D.nx + j]
                  : P.r[(long long)s * D.nu + (j - D.nx)];
}
FB_DEV float fb_h(const MpcDims& D, const MpcProb& P, int s, int i) {
  return s == 0 ? -P.x0[i] : -P.c[(long long)(s - 1) * D.nx + i];
}

// Residual norm at x: the proximal inner residual about xb (inner) or
// the penalized natural residual (full_residual.cc:49-109). With `store`,
// the NEGATED residual goes to (r.z, r.l, r.v).
FB_DEV float fb_residual(const MpcDims& D, const SolveOpts& o,
                         const MpcProb& P, const Vars& x, const Vars& xb,
                         bool inner, bool store, const Vars& r) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  const float sg = o.sigma;
  float sz = 0.0f, sl = 0.0f, sv = 0.0f;
  for (int s = 0; s <= D.N; ++s) {
    for (int j = 0; j < ns; ++j) {
      long long k = (long long)s * ns + j;
      float rr = fb_f(D, P, s, j) + fb_gemvH_row(D, P, x.z, s, j);
      rr = rr + fb_gemvGT_row(D, P, x.l, s, j);
      rr = rr + fb_gemvAT_row(D, P, x.v, s, j);
      if (inner) rr = rr + sg * (x.z[k] - xb.z[k]);
      if (store) r.z[k] = -rr;
      sz += rr * rr;
    }
    for (int i = 0; i < nx; ++i) {
      long long k = (long long)s * nx + i;
      float rr = fb_h(D, P, s, i) - fb_gemvG_row(D, P, x.z, s, i);
      if (inner) rr = rr + sg * (x.l[k] - xb.l[k]);
      if (store) r.l[k] = -rr;
      sl += rr * rr;
    }
    for (int c = 0; c < nc; ++c) {
      long long k = (long long)s * nc + c;
      float yy = x.y[k], vv = x.v[k], rr;
      if (inner) {
        rr = fb_pfb(yy + sg * (vv - xb.v[k]), vv, o.alpha, o.om_alpha);
      } else {
        rr = o.alpha * fminf(yy, vv)
             + o.om_alpha * fmaxf(0.0f, yy) * fmaxf(0.0f, vv);
      }
      if (store) r.v[k] = -rr;
      sv += rr * rr;
    }
  }
  return sqrtf(sz + sl + sv);
}

// One Newton step at x about xbar: reads the negated inner residual from
// r, writes the step to d (dz, dl by the Riccati solve; dv, dy by the
// dual recovery, riccati_linear_solver.cc:329-342). Returns false when
// dz or dl holds a NaN (a failed factorization).
FB_DEV bool fb_newton_step(const MpcDims& D, const SolveOpts& o,
                           const MpcProb& P, const Vars& x, const Vars& xbar,
                           const Vars& r, const Vars& d, Lane ws) {
  riccati_factor_solve(D, o.sigma, o.alpha, o.om_alpha, P, x.v, x.y, xbar.v,
                       r.z, r.l, r.v, d.z, d.l, ws);
  const RicLayout rl = ric_layout(D);
  const int nc = D.nc;
  for (int s = 0; s <= D.N; ++s)
    for (int c = 0; c < nc; ++c) {
      long long k = (long long)s * nc + c;
      float adz = fb_gemvA_row(D, P, d.z, s, c);
      d.v[k] = (r.v[k] + ws[rl.gam + k] * adz) / ws[rl.mus + k];
      d.y[k] = -P.d[k] - adz;
    }
  bool ok = true;
  long long N1 = D.N + 1;
  for (long long k = 0; k < N1 * (D.nx + D.nu); ++k) ok = ok && !isnan(d.z[k]);
  for (long long k = 0; k < N1 * D.nx; ++k) ok = ok && !isnan(d.l[k]);
  return ok;
}

// Infeasibility certificates at the step dx (full_feasibility.cc:29-77).
FB_DEV void fb_feasibility(const MpcDims& D, const MpcProb& P,
                           const Vars& dx, float tol, bool& p_inf,
                           bool& d_inf) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  float d1 = -INFINITY, d2 = 0.0f, d3 = 0.0f, d4 = 0.0f, w = 0.0f;
  float p1 = 0.0f, p2h = 0.0f, p2b = 0.0f, nv = 0.0f, nl = 0.0f;
  for (int s = 0; s <= D.N; ++s) {
    for (int c = 0; c < nc; ++c) d1 = fmaxf(d1, fb_gemvA_row(D, P, dx.z, s, c));
    for (int i = 0; i < nx; ++i)
      d2 = fmaxf(d2, fabsf(fb_gemvG_row(D, P, dx.z, s, i)));
    for (int j = 0; j < ns; ++j) {
      long long k = (long long)s * ns + j;
      d3 = fmaxf(d3, fabsf(fb_gemvH_row(D, P, dx.z, s, j)));
      d4 += fb_f(D, P, s, j) * dx.z[k];
      w = fmaxf(w, fabsf(dx.z[k]));
      p1 = fmaxf(p1, fabsf(fb_gemvAT_row(D, P, dx.v, s, j)
                           + fb_gemvGT_row(D, P, dx.l, s, j)));
    }
    for (int i = 0; i < nx; ++i) {
      long long k = (long long)s * nx + i;
      p2h += fb_h(D, P, s, i) * dx.l[k];
      nl = fmaxf(nl, fabsf(dx.l[k]));
    }
    for (int c = 0; c < nc; ++c) {
      long long k = (long long)s * nc + c;
      p2b += -P.d[k] * dx.v[k];
      nv = fmaxf(nv, fabsf(dx.v[k]));
    }
  }
  d_inf = (d1 <= w * tol) && (d2 <= tol * w) && (d3 <= tol * w)
          && (d4 < 0.0f) && (w > 1e-14f);
  float u = fmaxf(nv, nl);
  p_inf = (p1 <= tol * u) && ((p2h + p2b) < 0.0f);
}

// The MPC problem class of fbstab_solve.cuh: data P of dims D, Riccati
// scratch ws.
struct MpcSolveProb {
  MpcDims D;
  MpcProb P;
  Lane ws;

  FB_DEV long long nz() const {
    return (long long)(D.N + 1) * (D.nx + D.nu);
  }
  FB_DEV long long nl() const { return (long long)(D.N + 1) * D.nx; }
  FB_DEV long long nv() const { return (long long)(D.N + 1) * D.nc; }

  FB_DEV float b(long long k) const { return -P.d[k]; }
  FB_DEV float Az(Lane z, long long k) const {
    return fb_gemvA_row(D, P, z, (int)(k / D.nc), (int)(k % D.nc));
  }
  FB_DEV float forcing_sq() const {
    const int nx = D.nx, nc = D.nc, ns = nx + D.nu;
    float fs = 0.0f;
    for (int s = 0; s <= D.N; ++s) {
      for (int j = 0; j < ns; ++j) {
        float a = fb_f(D, P, s, j);
        fs += a * a;
      }
      for (int i = 0; i < nx; ++i) {
        float a = fb_h(D, P, s, i);
        fs += a * a;
      }
      for (int c = 0; c < nc; ++c) {
        float a = P.d[(long long)s * nc + c];
        fs += a * a;
      }
    }
    return fs;
  }
  FB_DEV float residual(const SolveOpts& o, const Vars& x, const Vars& xb,
                        bool inner, bool store, const Vars& r) const {
    return fb_residual(D, o, P, x, xb, inner, store, r);
  }
  FB_DEV bool newton_step(const SolveOpts& o, const Vars& x,
                          const Vars& xbar, const Vars& r,
                          const Vars& d) const {
    return fb_newton_step(D, o, P, x, xbar, r, d, ws);
  }
  FB_DEV void feasibility(const Vars& dx, float tol, bool& p_inf,
                          bool& d_inf) const {
    fb_feasibility(D, P, dx, tol, p_inf, d_inf);
  }
};

// Solver scratch per instance: the Riccati scratch, then the iterates.
FB_HD SolveLayout solve_layout(const MpcDims& D) {
  long long N1 = D.N + 1;
  return fb_solve_layout(
      ric_layout(D).total,
      fb_vars_floats(N1 * (D.nx + D.nu), N1 * D.nx, N1 * D.nc));
}

// K4's scratch per instance: the Riccati scratch, then the step d, the
// trial point xt and the negated residual r (xk and xi are the kernel's
// input and output).
FB_HD long long subproblem_ws_floats(const MpcDims& D) {
  long long N1 = D.N + 1;
  return ric_layout(D).total
         + 3 * fb_vars_floats(N1 * (D.nx + D.nu), N1 * D.nx, N1 * D.nc);
}

// One outer iteration of one MPC instance about xk (K4), into xi.
FB_DEV OuterStep fbstab_mpc_subproblem_lane(const MpcDims& D,
                                            const SolveOpts& o,
                                            const MpcProb& P, const Vars& xk,
                                            const Vars& xi, float itol_prev,
                                            float dxn_prev, int newton,
                                            bool done, Lane ws) {
  const long long N1 = D.N + 1;
  const long long nz = N1 * (D.nx + D.nu), nl = N1 * D.nx, nv = N1 * D.nc;
  const long long nvar = fb_vars_floats(nz, nl, nv);
  const Lane its = ws.at(ric_layout(D).total);
  const MpcSolveProb prob{D, P, ws};
  return fb_outer_step(prob, o, xk, xi, fb_vars_at(its, nz, nl, nv),
                       fb_vars_at(its.at(nvar), nz, nl, nv),
                       fb_vars_at(its.at(2 * nvar), nz, nl, nv), itol_prev,
                       dxn_prev, newton, done);
}

// The whole solve of one MPC instance from (z0, l0, v0).
FB_DEV void fbstab_mpc_solve_lane(const MpcDims& D, const SolveOpts& o,
                                  const MpcProb& P, Lane z0, Lane l0, Lane v0,
                                  const SolveOut& out, Lane ws) {
  const SolveLayout L = solve_layout(D);
  const MpcSolveProb prob{D, P, ws.at(L.step)};
  fbstab_solve_lane(prob, o, z0, l0, v0, out, ws.at(L.xk));
}

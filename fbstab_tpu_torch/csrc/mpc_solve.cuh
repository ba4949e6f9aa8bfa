// K2's and K4's problem class: the MPC QP of one instance (stage-major
// data, the Riccati Newton step of riccati.cuh) for the shared FBstab loop
// of fbstab_solve.cuh, over the instance's team: the residual, the forcing
// norm and the infeasibility certificates split over (stage, row) pairs and
// end in one all-reduce each, the dual recovery elementwise.
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
  FB_UNROLL
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
  FB_UNROLL
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
    FB_UNROLL
    for (int k = 0; k < nx; ++k) a += Q[k] * zx[k];
    for (int k = 0; k < nu; ++k) b += S[k * nx + j] * zu[k];
  } else {
    int i = j - nx;
    Lane S = P.S.at(((long long)s * nu + i) * nx);
    Lane R = P.R.at(((long long)s * nu + i) * nu);
    FB_UNROLL
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
      FB_UNROLL
      for (int k = 0; k < nx; ++k) g += A[k * nx + j] * ln[k];
    } else {
      Lane Bm = P.B.at((long long)s * nx * nu);
      FB_UNROLL
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
    FB_UNROLL
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
template <class Tm>
FB_DEV float fb_residual(const Tm& tm, const MpcDims& D, const SolveOpts& o,
                         const MpcProb& P, const Vars& x, const Vars& xb,
                         bool inner, bool store, const Vars& r) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu, N1 = D.N + 1;
  const int T = tm.size(), me = tm.rank();
  const float sg = o.sigma;
  float sz = 0.0f, sl = 0.0f, sv = 0.0f;
  for (int k = me; k < N1 * ns; k += T) {
    const int s = k / ns, j = k % ns;
    float rr = fb_f(D, P, s, j) + fb_gemvH_row(D, P, x.z, s, j);
    rr = rr + fb_gemvGT_row(D, P, x.l, s, j);
    rr = rr + fb_gemvAT_row(D, P, x.v, s, j);
    if (inner) rr = rr + sg * (x.z[k] - xb.z[k]);
    if (store) r.z[k] = -rr;
    sz += rr * rr;
  }
  for (int k = me; k < N1 * nx; k += T) {
    const int s = k / nx, i = k % nx;
    float rr = fb_h(D, P, s, i) - fb_gemvG_row(D, P, x.z, s, i);
    if (inner) rr = rr + sg * (x.l[k] - xb.l[k]);
    if (store) r.l[k] = -rr;
    sl += rr * rr;
  }
  for (int k = me; k < N1 * nc; k += T) {
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
  const float total = tm.sum(sz + sl + sv);
  tm.sync();
  return sqrtf(total);
}

// One Newton step at x about xbar: reads the negated inner residual from
// r, writes the step to d (dz, dl by the Riccati solve; dv, dy by the
// dual recovery, riccati_linear_solver.cc:329-342). Returns false when
// dz or dl holds a NaN (a failed factorization). Store: the Riccati
// solve's storing mode or its recompute-factors mode (riccati.cuh).
template <bool Store, class Tm>
FB_DEV bool fb_newton_step(const Tm& tm, const MpcDims& D,
                           const SolveOpts& o, const MpcProb& P,
                           const Vars& x, const Vars& xbar, const Vars& r,
                           const Vars& d, Lane ws, Lane st) {
  riccati_factor_solve<Store>(tm, D, o.sigma, o.alpha, o.om_alpha, P, x.v,
                              x.y, xbar.v, r.z, r.l, r.v, d.z, d.l, ws, st);
  const RicLayout rl = ric_layout(D, !Store);
  const int nc = D.nc, T = tm.size(), me = tm.rank();
  const long long N1 = D.N + 1;
  for (int k = me; k < N1 * nc; k += T) {
    float adz = fb_gemvA_row(D, P, d.z, k / nc, k % nc);
    d.v[k] = (r.v[k] + ws[rl.gam + k] * adz) / ws[rl.mus + k];
    d.y[k] = -P.d[k] - adz;
  }
  bool bad = false;
  for (long long k = me; k < N1 * (D.nx + D.nu); k += T)
    bad = bad || isnan(d.z[k]);
  for (long long k = me; k < N1 * D.nx; k += T) bad = bad || isnan(d.l[k]);
  bad = tm.any(bad);
  tm.sync();
  return !bad;
}

// Infeasibility certificates at the step dx (full_feasibility.cc:29-77).
template <class Tm>
FB_DEV void fb_feasibility(const Tm& tm, const MpcDims& D, const MpcProb& P,
                           const Vars& dx, float tol, bool& p_inf,
                           bool& d_inf) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu, N1 = D.N + 1;
  const int T = tm.size(), me = tm.rank();
  float d1 = -INFINITY, d2 = 0.0f, d3 = 0.0f, d4 = 0.0f, w = 0.0f;
  float p1 = 0.0f, p2 = 0.0f, nv = 0.0f, nl = 0.0f;
  for (int k = me; k < N1 * nc; k += T) {
    d1 = fmaxf(d1, fb_gemvA_row(D, P, dx.z, k / nc, k % nc));
    p2 += -P.d[k] * dx.v[k];
    nv = fmaxf(nv, fabsf(dx.v[k]));
  }
  for (int k = me; k < N1 * nx; k += T) {
    const int s = k / nx, i = k % nx;
    d2 = fmaxf(d2, fabsf(fb_gemvG_row(D, P, dx.z, s, i)));
    p2 += fb_h(D, P, s, i) * dx.l[k];
    nl = fmaxf(nl, fabsf(dx.l[k]));
  }
  for (int k = me; k < N1 * ns; k += T) {
    const int s = k / ns, j = k % ns;
    d3 = fmaxf(d3, fabsf(fb_gemvH_row(D, P, dx.z, s, j)));
    d4 += fb_f(D, P, s, j) * dx.z[k];
    w = fmaxf(w, fabsf(dx.z[k]));
    p1 = fmaxf(p1, fabsf(fb_gemvAT_row(D, P, dx.v, s, j)
                         + fb_gemvGT_row(D, P, dx.l, s, j)));
  }
  d1 = tm.max(d1);
  d2 = tm.max(d2);
  d3 = tm.max(d3);
  d4 = tm.sum(d4);
  w = tm.max(w);
  p1 = tm.max(p1);
  p2 = tm.sum(p2);
  const float u = tm.max(fmaxf(nv, nl));
  d_inf = (d1 <= w * tol) && (d2 <= tol * w) && (d3 <= tol * w)
          && (d4 < 0.0f) && (w > 1e-14f);
  p_inf = (p1 <= tol * u) && (p2 < 0.0f);
}

// The MPC problem class of fbstab_solve.cuh: data P of dims D, the
// Riccati factors' scratch ws and the stage block st, run by team tm, the
// Riccati solve in its storing mode or (Store false) its recompute-factors
// mode.
template <class Tm, bool Store>
struct MpcSolveProb {
  Tm tm;
  MpcDims D;
  MpcProb P;
  Lane ws, st;

  FB_DEV Tm team() const { return tm; }
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
    const int nx = D.nx, nc = D.nc, ns = nx + D.nu, N1 = D.N + 1;
    const int T = tm.size(), me = tm.rank();
    float fs = 0.0f;
    for (int k = me; k < N1 * ns; k += T) {
      float a = fb_f(D, P, k / ns, k % ns);
      fs += a * a;
    }
    for (int k = me; k < N1 * nx; k += T) {
      float a = fb_h(D, P, k / nx, k % nx);
      fs += a * a;
    }
    for (int k = me; k < N1 * nc; k += T) {
      float a = P.d[k];
      fs += a * a;
    }
    return tm.sum(fs);
  }
  FB_DEV float residual(const SolveOpts& o, const Vars& x, const Vars& xb,
                        bool inner, bool store, const Vars& r) const {
    return fb_residual(tm, D, o, P, x, xb, inner, store, r);
  }
  FB_DEV bool newton_step(const SolveOpts& o, const Vars& x,
                          const Vars& xbar, const Vars& r,
                          const Vars& d) const {
    return fb_newton_step<Store>(tm, D, o, P, x, xbar, r, d, ws, st);
  }
  FB_DEV void feasibility(const Vars& dx, float tol, bool& p_inf,
                          bool& d_inf) const {
    fb_feasibility(tm, D, P, dx, tol, p_inf, d_inf);
  }
};

// Teams of K2 and K4: threads per instance, and teams per block (one
// warp). K2's team of 8 was chosen on the card (PERF.md).
constexpr int kK2Team = 8;
constexpr int kK4Team = 32;
constexpr int kK2TeamsPerBlock = 32 / kK2Team;
constexpr int kK4TeamsPerBlock = 32 / kK4Team;

// Floats per instance of one MPC primal-dual point.
FB_HD long long mpc_vars_floats(const MpcDims& D) {
  long long N1 = D.N + 1;
  return fb_vars_floats(N1 * (D.nx + D.nu), N1 * D.nx, N1 * D.nc);
}

// K2's scratch per instance in device memory: the Riccati factors (and the
// stage block for a team that does not stage), then the iterates.
FB_HD SolveLayout solve_layout(const MpcDims& D, bool lowmem, bool stages) {
  return fb_solve_layout(ric_ws_floats(D, lowmem, stages),
                         mpc_vars_floats(D));
}

// K4's scratch per instance in device memory: the Riccati factors (and the
// stage block for a team that does not stage), then the step d, the trial
// point xt and the negated residual r (xk and xi are the kernel's input
// and output).
FB_HD long long subproblem_ws_floats(const MpcDims& D, bool lowmem,
                                     bool stages) {
  return ric_ws_floats(D, lowmem, stages) + 3 * mpc_vars_floats(D);
}

// Shared memory a block of teams that stage asks for: each team's stage
// block, in float32 bytes (the same in both modes).
FB_HD long long solve_smem_bytes(const MpcDims& D) {
  return 4LL * kK2TeamsPerBlock * ric_layout(D, false).stage_floats;
}
FB_HD long long subproblem_smem_bytes(const MpcDims& D) {
  return 4LL * kK4TeamsPerBlock * ric_layout(D, false).stage_floats;
}

// One outer iteration of one MPC instance about xk (K4), into xi: ws is
// laid out by subproblem_ws_floats(D, !Store, Tm::kStages), st is the stage
// block.
template <bool Store, class Tm>
FB_DEV OuterStep fbstab_mpc_subproblem_lane(const Tm& tm, const MpcDims& D,
                                            const SolveOpts& o,
                                            const MpcProb& P, const Vars& xk,
                                            const Vars& xi, float itol_prev,
                                            float dxn_prev, int newton,
                                            bool done, Lane ws, Lane st) {
  const long long N1 = D.N + 1;
  const long long nz = N1 * (D.nx + D.nu), nl = N1 * D.nx, nv = N1 * D.nc;
  const long long nvar = fb_vars_floats(nz, nl, nv);
  const Lane its = ws.at(ric_ws_floats(D, !Store, Tm::kStages));
  const MpcSolveProb<Tm, Store> prob{tm, D, P, ws, st};
  return fb_outer_step(prob, o, xk, xi, fb_vars_at(its, nz, nl, nv),
                       fb_vars_at(its.at(nvar), nz, nl, nv),
                       fb_vars_at(its.at(2 * nvar), nz, nl, nv), itol_prev,
                       dxn_prev, newton, done);
}

// The whole solve of one MPC instance from (z0, l0, v0): Riccati factors
// in fac, the stage block in st, the five iterates in its.
template <bool Store, class Tm>
FB_DEV void fbstab_mpc_solve_lane(const Tm& tm, const MpcDims& D,
                                  const SolveOpts& o, const MpcProb& P,
                                  Lane z0, Lane l0, Lane v0,
                                  const SolveOut& out, Lane fac, Lane st,
                                  Lane its) {
  const MpcSolveProb<Tm, Store> prob{tm, D, P, fac, st};
  fbstab_solve_lane(prob, o, z0, l0, v0, out, its);
}

// The MPC data of instance b, instance-major (K2, K4): each array of the
// batch is (B, its floats per instance).
FB_DEV MpcProb mpc_prob_im(const MpcDims& D, const float* q, const float* r,
                           const float* c, const float* x0, const float* d,
                           const float* Q, const float* R, const float* S,
                           const float* A, const float* Bm, const float* E,
                           const float* L, long long b) {
  const long long N1 = D.N + 1, nx = D.nx, nu = D.nu, nc = D.nc;
  MpcProb P;
  P.Q = lane_im(Q, N1 * nx * nx, b);
  P.R = lane_im(R, N1 * nu * nu, b);
  P.S = lane_im(S, N1 * nu * nx, b);
  P.q = lane_im(q, N1 * nx, b);
  P.r = lane_im(r, N1 * nu, b);
  P.A = lane_im(A, D.N * nx * nx, b);
  P.B = lane_im(Bm, D.N * nx * nu, b);
  P.c = lane_im(c, D.N * nx, b);
  P.E = lane_im(E, N1 * nc * nx, b);
  P.L = lane_im(L, N1 * nc * nu, b);
  P.d = lane_im(d, N1 * nc, b);
  P.x0 = lane_im(x0, nx, b);
  return P;
}

// A primal-dual point of instance b, instance-major.
FB_DEV Vars mpc_vars_im(const MpcDims& D, const float* z, const float* l,
                        const float* v, const float* y, long long b) {
  const long long N1 = D.N + 1;
  return Vars{lane_im(z, N1 * (D.nx + D.nu), b), lane_im(l, N1 * D.nx, b),
              lane_im(v, N1 * D.nc, b), lane_im(y, N1 * D.nc, b)};
}

// The whole FBstab MPC algorithm for one instance: the outer proximal
// loop, the inner semismooth Newton loop on riccati_factor_solve, the
// nonmonotone backtracking linesearch, the infeasibility checks and the
// exit flags, in the order of checks of core/algorithm.py (reference
// fbstab_algorithm-impl.h:113-304). A transcription of
// `vmap(fbstab_solve)` for one lane: each instance runs its own loops, so
// nothing is masked.
#pragma once

#include "riccati.cuh"

// Options baked into the solve (fields of Options.validated(); float
// constants rounded once to float32, as the JAX solvers round theirs).
struct SolveOpts {
  float sigma, alpha, om_alpha, beta, eta, delta;
  float abs_tol, rel_tol, stall_tol, infeas_tol;
  float inner_tol_max, inner_tol_min, inner_stall_tol, om_stall;
  int max_newton, max_prox, max_inner, max_ls;
  int check_feasibility, nonmonotone;
};

// Exit flags (solver_out.py ExitFlag).
enum {
  FB_SUCCESS = 0,
  FB_MAXITERATIONS = 2,
  FB_PRIMAL_INFEASIBLE = 3,
  FB_DUAL_INFEASIBLE = 4,
  FB_PRIMAL_DUAL_INFEASIBLE = 5,
  FB_LINEAR_SOLVER_FAILED = 6,
};

#define FB_MERIT_DEPTH 5  // NONMONOTONE_DEPTH

// Offsets (floats per instance) of the solver scratch: the Newton-step
// scratch, then the iterates xk, xi, the step d, the trial point xt and
// the negated residual r (z, l, v parts).
struct SolveLayout {
  long long ric, xk, xi, d, xt, r, total;
};

FB_HD long long fb_vars_floats(const MpcDims& D) {
  long long N1 = D.N + 1;
  return N1 * (D.nx + D.nu) + N1 * D.nx + 2 * N1 * D.nc;
}

FB_HD SolveLayout solve_layout(const MpcDims& D) {
  SolveLayout s;
  long long nvar = fb_vars_floats(D);
  s.ric = 0;
  s.xk = ric_layout(D).total;
  s.xi = s.xk + nvar;
  s.d = s.xi + nvar;
  s.xt = s.d + nvar;
  s.r = s.xt + nvar;
  s.total = s.r + nvar;
  return s;
}

FB_DEV Vars vars_at(const MpcDims& D, Lane base) {
  long long N1 = D.N + 1, nz = N1 * (D.nx + D.nu), nl = N1 * D.nx,
            nv = N1 * D.nc;
  return Vars{base, base.at(nz), base.at(nz + nl), base.at(nz + nl + nv)};
}

FB_DEV void vars_copy(const MpcDims& D, const Vars& dst, const Vars& src) {
  long long N1 = D.N + 1;
  for (long long k = 0; k < N1 * (D.nx + D.nu); ++k) dst.z[k] = src.z[k];
  for (long long k = 0; k < N1 * D.nx; ++k) dst.l[k] = src.l[k];
  for (long long k = 0; k < N1 * D.nc; ++k) {
    dst.v[k] = src.v[k];
    dst.y[k] = src.y[k];
  }
}

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

FB_DEV float fb_pnr_norm(const MpcDims& D, const SolveOpts& o,
                         const MpcProb& P, const Vars& x) {
  return fb_residual(D, o, P, x, x, false, false, x);
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

// xt = x + t d with the margin rule y <- y + t (dy - b), b = -d_data
// (full_variable.cc:55-65).
FB_DEV void fb_axpy(const MpcDims& D, const MpcProb& P, const Vars& xt,
                    float t, const Vars& dx, const Vars& x) {
  long long N1 = D.N + 1;
  for (long long k = 0; k < N1 * (D.nx + D.nu); ++k)
    xt.z[k] = x.z[k] + t * dx.z[k];
  for (long long k = 0; k < N1 * D.nx; ++k) xt.l[k] = x.l[k] + t * dx.l[k];
  for (long long k = 0; k < N1 * D.nc; ++k) {
    xt.v[k] = x.v[k] + t * dx.v[k];
    xt.y[k] = x.y[k] + t * (dx.y[k] + P.d[k]);
  }
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

// Semismooth Newton on the proximal subproblem about xk (impl.h:229-304).
// xi enters equal to xk. Returns Eo; updates newton and lfail.
FB_DEV float fb_subproblem(const MpcDims& D, const SolveOpts& o,
                           const MpcProb& P, const Vars& xk, const Vars& xi,
                           const Vars& d, const Vars& xt, const Vars& r,
                           Lane ws, float tol, float Eouter, int& newton,
                           bool& lfail) {
  float Eo = 0.0f;
  float buf[FB_MERIT_DEPTH];
  for (int k = 0; k < FB_MERIT_DEPTH; ++k) buf[k] = 0.0f;
  float Ei_best = INFINITY;
  int stall = 0;
  for (int i = 0; i < o.max_inner; ++i) {
    float Ei = fb_residual(D, o, P, xi, xk, true, true, r);
    Eo = fb_pnr_norm(D, o, P, xi);
    bool brk = ((Ei <= tol) && (Eo < Eouter)) || (Ei <= o.inner_tol_min)
               || (newton >= o.max_newton);
    if (o.inner_stall_tol > 0.0f) {
      bool improved = Ei < Ei_best * o.om_stall;
      stall = improved ? 0 : stall + 1;
      brk = brk || (stall >= 3);
    }
    Ei_best = fminf(Ei_best, Ei);
    if (brk) break;

    if (!fb_newton_step(D, o, P, xi, xk, r, d, ws)) {
      lfail = true;  // impl.h:263-267: no newton_iters++ on failure
      break;
    }
    // Nonmonotone merit history (impl.h:277-280).
    float cm = 0.5f * Ei * Ei;
    for (int k = FB_MERIT_DEPTH - 1; k > 0; --k) buf[k] = buf[k - 1];
    buf[0] = cm;
    float m0 = cm;
    if (o.nonmonotone) {
      m0 = buf[0];
      for (int k = 1; k < FB_MERIT_DEPTH; ++k) m0 = fmaxf(m0, buf[k]);
    }
    // Backtracking linesearch (impl.h:283-297).
    float t = 1.0f;
    for (int j = 0; j < o.max_ls; ++j) {
      fb_axpy(D, P, xt, t, d, xi);
      float np = fb_residual(D, o, P, xt, xk, true, false, r);
      float mp = 0.5f * np * np;
      if (mp <= m0 - 2.0f * t * o.eta * cm) break;
      t = t * o.beta;
    }
    fb_axpy(D, P, xi, t, d, xi);
    newton += 1;
  }
  // Project duals (impl.h:301).
  long long nv = (long long)(D.N + 1) * D.nc;
  for (long long k = 0; k < nv; ++k) xi.v[k] = fmaxf(xi.v[k], 0.0f);
  return Eo;
}

// Outputs of one instance.
struct SolveOut {
  Vars x;       // z, l, v, y
  int* eflag;   // one entry per instance, already offset to this lane
  float* res;
  int* newton;
  int* prox;
  float* res0;
};

// The whole solve of one instance from (z0, l0, v0).
FB_DEV void fbstab_mpc_solve_lane(const MpcDims& D, const SolveOpts& o,
                                  const MpcProb& P, Lane z0, Lane l0, Lane v0,
                                  const SolveOut& out, Lane ws) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  const long long N1 = D.N + 1;
  const SolveLayout L = solve_layout(D);
  const Vars xk = vars_at(D, ws.at(L.xk)), xi = vars_at(D, ws.at(L.xi));
  const Vars d = vars_at(D, ws.at(L.d)), xt = vars_at(D, ws.at(L.xt));
  const Vars r = vars_at(D, ws.at(L.r));
  Lane ric = ws.at(L.ric);

  // combo_tol = abs_tol + rel_tol (1 + |(f, h, b)|).
  float fs = 0.0f;
  for (int s = 0; s <= D.N; ++s) {
    for (int j = 0; j < ns; ++j) { float a = fb_f(D, P, s, j); fs += a * a; }
    for (int i = 0; i < nx; ++i) { float a = fb_h(D, P, s, i); fs += a * a; }
    for (int c = 0; c < nc; ++c) { float a = P.d[(long long)s * nc + c]; fs += a * a; }
  }
  const float combo_tol = o.abs_tol + o.rel_tol * (1.0f + sqrtf(fs));

  // Initialization (impl.h:139-149): y = b - A z0.
  for (long long k = 0; k < N1 * ns; ++k) xk.z[k] = z0[k];
  for (long long k = 0; k < N1 * nx; ++k) xk.l[k] = l0[k];
  for (int s = 0; s <= D.N; ++s)
    for (int c = 0; c < nc; ++c) {
      long long k = (long long)s * nc + c;
      xk.v[k] = v0[k];
      xk.y[k] = -P.d[k] - fb_gemvA_row(D, P, xk.z, s, c);
    }
  float dxn = sqrtf((float)(N1 * ns) + (float)(N1 * nx) + (float)(N1 * nc));
  const float E0 = fb_pnr_norm(D, o, P, xk);
  *out.res0 = E0;
  float itol = fminf(fmaxf(E0, o.inner_tol_min), o.inner_tol_max);

  int newton = 0, prox = 0, eflag = FB_MAXITERATIONS;
  float Ek = E0, out_res = E0;
  bool done = false;
  // out_x is written into the output arrays on exit; `src` picks it.
  const Vars* src = &xk;
  for (int k = 0; k < o.max_prox && !done; ++k) {
    Ek = fb_pnr_norm(D, o, P, xk);
    bool success = (Ek <= combo_tol) || (dxn <= o.stall_tol);
    itol = fminf(fmaxf(itol * o.delta, o.inner_tol_min), Ek);

    vars_copy(D, xi, xk);
    float Eo = 0.0f;
    bool lfail = false;
    if (!success)
      Eo = fb_subproblem(D, o, P, xk, xi, d, xt, r, ric, itol, Ek, newton,
                         lfail);

    // dx = xi - xk with the margin identity (impl.h:201-203), into d.
    float s2 = 0.0f;
    for (long long q = 0; q < N1 * ns; ++q) {
      d.z[q] = xi.z[q] - xk.z[q];
      s2 += d.z[q] * d.z[q];
    }
    for (long long q = 0; q < N1 * nx; ++q) {
      d.l[q] = xi.l[q] - xk.l[q];
      s2 += d.l[q] * d.l[q];
    }
    for (long long q = 0; q < N1 * nc; ++q) {
      d.v[q] = xi.v[q] - xk.v[q];
      d.y[q] = xi.y[q] - xk.y[q] - P.d[q];
      s2 += d.v[q] * d.v[q];
    }
    dxn = sqrtf(s2);

    if (success) {
      eflag = FB_SUCCESS; src = &xk; out_res = Ek; done = true;
    } else if (lfail) {
      eflag = FB_LINEAR_SOLVER_FAILED; src = &xk; out_res = Ek; done = true;
    } else if (newton >= o.max_newton) {
      // Newton budget (impl.h:188-199): the better of xi / xk.
      src = (Eo < Ek) ? &xi : &xk;
      out_res = fb_pnr_norm(D, o, P, *src);
      eflag = FB_MAXITERATIONS; done = true;
    } else {
      bool p_inf = false, d_inf = false;
      if (o.check_feasibility)
        fb_feasibility(D, P, d, o.infeas_tol, p_inf, d_inf);
      if (p_inf || d_inf) {
        eflag = (p_inf && d_inf) ? FB_PRIMAL_DUAL_INFEASIBLE
                : (p_inf ? FB_PRIMAL_INFEASIBLE : FB_DUAL_INFEASIBLE);
        src = &d; out_res = Ek; done = true;
      }
    }
    if (!done) {
      vars_copy(D, xk, xi);  // x(k+1) = xi (impl.h:215-216)
      prox += 1;
    }
  }
  if (!done) {
    // Proximal budget exhausted (impl.h:219-223).
    src = &xk; out_res = Ek; eflag = FB_MAXITERATIONS;
  }
  vars_copy(D, out.x, *src);
  *out.eflag = eflag;
  *out.res = out_res;
  *out.newton = newton;
  *out.prox = prox;
}

// The FBstab algorithm for one instance, generic over the QP class: the
// outer proximal loop, the inner semismooth Newton loop, the nonmonotone
// backtracking linesearch with the float32 stall guard, the infeasibility
// checks and the exit flags, in the order of checks of core/algorithm.py
// (reference fbstab_algorithm-impl.h:113-304). A transcription of
// `vmap(fbstab_solve)` for one lane: each instance runs its own loops on
// its own team, so nothing is masked. K2 (mpc_solve.cuh) and K3
// (dense_solve.cuh) each instantiate it with their problem class; K4
// (mpc_subproblem.cu) runs one outer iteration of it per launch
// (fb_outer_step).
//
// A problem class `Prob` holds one instance's data and Newton-step
// scratch and provides:
//   team() const;                               the instance's team
//   long long nz(), nl(), nv() const;          sizes of z, l and v (= y)
//   float b(long long k) const;                 inequality rhs b
//   float Az(Lane z, long long k) const;        row k of A z
//   float forcing_sq() const;                   |f|^2 + |h|^2 + |b|^2
//   float residual(o, x, xb, inner, store, r) const;
//       the proximal inner residual about xb (inner) or the penalized
//       natural residual (full_residual.cc:49-109), returning its norm;
//       with `store`, the NEGATED residual goes to (r.z, r.l, r.v);
//   bool newton_step(o, x, xbar, r, d) const;
//       the Newton step at x about xbar from the negated residual r into
//       d (dz, dl, dv, dy = b - A dz); false when dz or dl holds a NaN;
//   void feasibility(dx, tol, p_inf, d_inf) const;
//       the infeasibility certificates at dx (full_feasibility.cc:29-77).
// Each method is called by the whole team, returns the same value on
// every thread of it, and leaves what it wrote visible to the team.
// Here the team splits the vector passes elementwise, thread `rank`
// taking elements rank, rank + size, ...; every decision is taken on
// values the team's reductions made equal on all its threads.
#pragma once

#include "fbstab_common.cuh"

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

// Floats per instance of one primal-dual point (z, l, v, y).
FB_HD long long fb_vars_floats(long long nz, long long nl, long long nv) {
  return nz + nl + 2 * nv;
}

// Offsets (floats per instance) of the solver scratch: the Newton-step
// scratch, then the iterates xk, xi, the step d, the trial point xt and
// the negated residual r.
struct SolveLayout {
  long long step, xk, xi, d, xt, r, total;
};

FB_HD SolveLayout fb_solve_layout(long long step_floats, long long nvar) {
  SolveLayout s;
  s.step = 0;
  s.xk = step_floats;
  s.xi = s.xk + nvar;
  s.d = s.xi + nvar;
  s.xt = s.d + nvar;
  s.r = s.xt + nvar;
  s.total = s.r + nvar;
  return s;
}

FB_DEV Vars fb_vars_at(Lane base, long long nz, long long nl, long long nv) {
  return Vars{base, base.at(nz), base.at(nz + nl), base.at(nz + nl + nv)};
}

template <class Prob>
FB_DEV void fb_vars_copy(const Prob& P, const Vars& dst, const Vars& src) {
  const auto tm = P.team();
  const int T = tm.size(), me = tm.rank();
  for (long long k = me; k < P.nz(); k += T) dst.z[k] = src.z[k];
  for (long long k = me; k < P.nl(); k += T) dst.l[k] = src.l[k];
  for (long long k = me; k < P.nv(); k += T) {
    dst.v[k] = src.v[k];
    dst.y[k] = src.y[k];
  }
  tm.sync();
}

// xt = x + t d with the margin rule y <- y + t (dy - b)
// (full_variable.cc:55-65).
template <class Prob>
FB_DEV void fb_axpy(const Prob& P, const Vars& xt, float t, const Vars& dx,
                    const Vars& x) {
  const auto tm = P.team();
  const int T = tm.size(), me = tm.rank();
  for (long long k = me; k < P.nz(); k += T) xt.z[k] = x.z[k] + t * dx.z[k];
  for (long long k = me; k < P.nl(); k += T) xt.l[k] = x.l[k] + t * dx.l[k];
  for (long long k = me; k < P.nv(); k += T) {
    xt.v[k] = x.v[k] + t * dx.v[k];
    xt.y[k] = x.y[k] + t * (dx.y[k] - P.b(k));
  }
  tm.sync();
}

// |xi - xk| over (z, l, v), the dx norm of the stall test; with `keep`,
// dx = xi - xk with the margin identity (impl.h:201-203) goes to d.
template <class Prob>
FB_DEV float fb_step_norm(const Prob& P, const Vars& xi, const Vars& xk,
                          bool keep, const Vars& d) {
  const auto tm = P.team();
  const int T = tm.size(), me = tm.rank();
  float s2 = 0.0f;
  for (long long q = me; q < P.nz(); q += T) {
    float e = xi.z[q] - xk.z[q];
    if (keep) d.z[q] = e;
    s2 += e * e;
  }
  for (long long q = me; q < P.nl(); q += T) {
    float e = xi.l[q] - xk.l[q];
    if (keep) d.l[q] = e;
    s2 += e * e;
  }
  for (long long q = me; q < P.nv(); q += T) {
    float e = xi.v[q] - xk.v[q];
    if (keep) {
      d.v[q] = e;
      d.y[q] = xi.y[q] - xk.y[q] + P.b(q);
    }
    s2 += e * e;
  }
  s2 = tm.sum(s2);
  tm.sync();
  return sqrtf(s2);
}

template <class Prob>
FB_DEV float fb_pnr(const Prob& P, const SolveOpts& o, const Vars& x) {
  return P.residual(o, x, x, false, false, x);
}

// Semismooth Newton on the proximal subproblem about xk (impl.h:229-304).
// xi enters equal to xk. Returns Eo; updates newton and lfail.
template <class Prob>
FB_DEV float fb_subproblem(const Prob& P, const SolveOpts& o, const Vars& xk,
                           const Vars& xi, const Vars& d, const Vars& xt,
                           const Vars& r, float tol, float Eouter,
                           int& newton, bool& lfail) {
  float Eo = 0.0f;
  float buf[FB_MERIT_DEPTH];
  for (int k = 0; k < FB_MERIT_DEPTH; ++k) buf[k] = 0.0f;
  float Ei_best = INFINITY;
  int stall = 0;
  for (int i = 0; i < o.max_inner; ++i) {
    float Ei = P.residual(o, xi, xk, true, true, r);
    Eo = fb_pnr(P, o, xi);
    bool brk = ((Ei <= tol) && (Eo < Eouter)) || (Ei <= o.inner_tol_min)
               || (newton >= o.max_newton);
    if (o.inner_stall_tol > 0.0f) {
      bool improved = Ei < Ei_best * o.om_stall;
      stall = improved ? 0 : stall + 1;
      brk = brk || (stall >= 3);
    }
    Ei_best = fminf(Ei_best, Ei);
    if (brk) break;

    if (!P.newton_step(o, xi, xk, r, d)) {
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
      fb_axpy(P, xt, t, d, xi);
      float np = P.residual(o, xt, xk, true, false, r);
      float mp = 0.5f * np * np;
      if (mp <= m0 - 2.0f * t * o.eta * cm) break;
      t = t * o.beta;
    }
    fb_axpy(P, xi, t, d, xi);
    newton += 1;
  }
  // Project duals (impl.h:301).
  const auto tm = P.team();
  for (long long k = tm.rank(); k < P.nv(); k += tm.size())
    xi.v[k] = fmaxf(xi.v[k], 0.0f);
  tm.sync();
  return Eo;
}

// One outer proximal iteration of one instance, for a loop that runs on
// the host (K4): the head of the outer iteration (Ek, the success / stall
// test, the inner tolerance, impl.h:162-180), then for a lane that is
// neither done on entry nor successful the inner Newton loop from xi = xk
// and the norm of xi - xk for the next stall test (impl.h:164, 203). A
// lane that is done or successful leaves with xi = xk, Eo = 0, newton
// unchanged, lfail false and dxn unchanged: the skip branch of the host
// loop's per-lane select (mpc_solve_pallas.py:1296-1314). Ek, success and
// itol are returned for every lane, so that the host loop's exits read the
// arithmetic of this iteration and no other. fbstab_solve_lane keeps its
// own copy of the head: calling this function from it cost the
// one-thread K2 1.2% in an A/B on an H100 (spills at the register cap).
struct OuterStep {
  float Eo, Ek, itol, dxn;
  int newton;
  bool lfail, success;
};

template <class Prob>
FB_DEV OuterStep fb_outer_step(const Prob& P, const SolveOpts& o,
                               const Vars& xk, const Vars& xi, const Vars& d,
                               const Vars& xt, const Vars& r, float itol_prev,
                               float dxn_prev, int newton, bool done) {
  const float combo_tol =
      o.abs_tol + o.rel_tol * (1.0f + sqrtf(P.forcing_sq()));
  OuterStep s;
  s.Ek = fb_pnr(P, o, xk);
  s.success = (s.Ek <= combo_tol) || (dxn_prev <= o.stall_tol);
  s.itol = fminf(fmaxf(itol_prev * o.delta, o.inner_tol_min), s.Ek);
  s.Eo = 0.0f;
  s.newton = newton;
  s.lfail = false;
  s.dxn = dxn_prev;
  fb_vars_copy(P, xi, xk);
  if (done || s.success) return s;
  s.Eo = fb_subproblem(P, o, xk, xi, d, xt, r, s.itol, s.Ek, s.newton,
                       s.lfail);
  s.dxn = fb_step_norm(P, xi, xk, false, d);
  return s;
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

// The whole solve of one instance from (z0, l0, v0). `its` holds the five
// iterates (fb_solve_layout from xk on).
template <class Prob>
FB_DEV void fbstab_solve_lane(const Prob& P, const SolveOpts& o, Lane z0,
                              Lane l0, Lane v0, const SolveOut& out,
                              Lane its) {
  const auto tm = P.team();
  const int T = tm.size(), me = tm.rank();
  const long long nz = P.nz(), nl = P.nl(), nv = P.nv();
  const long long nvar = fb_vars_floats(nz, nl, nv);
  const Vars xk = fb_vars_at(its, nz, nl, nv);
  const Vars xi = fb_vars_at(its.at(nvar), nz, nl, nv);
  const Vars d = fb_vars_at(its.at(2 * nvar), nz, nl, nv);
  const Vars xt = fb_vars_at(its.at(3 * nvar), nz, nl, nv);
  const Vars r = fb_vars_at(its.at(4 * nvar), nz, nl, nv);

  // combo_tol = abs_tol + rel_tol (1 + |(f, h, b)|).
  const float combo_tol =
      o.abs_tol + o.rel_tol * (1.0f + sqrtf(P.forcing_sq()));

  // Initialization (impl.h:139-149): y = b - A z0.
  for (long long k = me; k < nz; k += T) xk.z[k] = z0[k];
  for (long long k = me; k < nl; k += T) xk.l[k] = l0[k];
  tm.sync();
  for (long long k = me; k < nv; k += T) {
    xk.v[k] = v0[k];
    xk.y[k] = P.b(k) - P.Az(xk.z, k);
  }
  tm.sync();
  float dxn = sqrtf((float)nz + (float)nl + (float)nv);
  const float E0 = fb_pnr(P, o, xk);
  if (me == 0) *out.res0 = E0;
  float itol = fminf(fmaxf(E0, o.inner_tol_min), o.inner_tol_max);

  int newton = 0, prox = 0, eflag = FB_MAXITERATIONS;
  float Ek = E0, out_res = E0;
  bool done = false;
  // out_x is written into the output arrays on exit; `src` picks it
  // (0: xk, 1: xi, 2: d; an index, not a pointer, keeps the iterates'
  // views out of local memory).
  int src = 0;
  for (int k = 0; k < o.max_prox && !done; ++k) {
    Ek = fb_pnr(P, o, xk);
    bool success = (Ek <= combo_tol) || (dxn <= o.stall_tol);
    itol = fminf(fmaxf(itol * o.delta, o.inner_tol_min), Ek);

    fb_vars_copy(P, xi, xk);
    float Eo = 0.0f;
    bool lfail = false;
    if (!success)
      Eo = fb_subproblem(P, o, xk, xi, d, xt, r, itol, Ek, newton, lfail);

    // dx = xi - xk with the margin identity (impl.h:201-203), into d.
    dxn = fb_step_norm(P, xi, xk, true, d);

    if (success) {
      eflag = FB_SUCCESS; src = 0; out_res = Ek; done = true;
    } else if (lfail) {
      eflag = FB_LINEAR_SOLVER_FAILED; src = 0; out_res = Ek; done = true;
    } else if (newton >= o.max_newton) {
      // Newton budget (impl.h:188-199): the better of xi / xk.
      src = (Eo < Ek) ? 1 : 0;
      out_res = fb_pnr(P, o, src ? xi : xk);
      eflag = FB_MAXITERATIONS; done = true;
    } else {
      bool p_inf = false, d_inf = false;
      if (o.check_feasibility) P.feasibility(d, o.infeas_tol, p_inf, d_inf);
      if (p_inf || d_inf) {
        eflag = (p_inf && d_inf) ? FB_PRIMAL_DUAL_INFEASIBLE
                : (p_inf ? FB_PRIMAL_INFEASIBLE : FB_DUAL_INFEASIBLE);
        src = 2; out_res = Ek; done = true;
      }
    }
    if (!done) {
      fb_vars_copy(P, xk, xi);  // x(k+1) = xi (impl.h:215-216)
      prox += 1;
    }
  }
  if (!done) {
    // Proximal budget exhausted (impl.h:219-223).
    src = 0; out_res = Ek; eflag = FB_MAXITERATIONS;
  }
  fb_vars_copy(P, out.x, src == 0 ? xk : (src == 1 ? xi : d));
  if (me == 0) {
    *out.eflag = eflag;
    *out.res = out_res;
    *out.newton = newton;
    *out.prox = prox;
  }
}

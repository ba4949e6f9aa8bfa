// The Riccati factor-and-solve of one MPC Newton step, for one instance,
// as a device function shared by both kernels (the Newton-step kernel in
// riccati.cu and the fused solvers in mpc_solve.cu and mpc_subproblem.cu),
// as the Pallas kernels share ops/riccati_pallas.py::riccati_factor_solve.
//
// It computes, with the recurrences of riccati_linear_solver.cc:77-344:
// PFB weights from (y, v, vbar, sigma); the barrier-augmented stage
// Hessians Qh = Q + sigma I + E'GE, Rh = R + sigma I + L'GL,
// Sh = S + L'GE; the forward Riccati matrix recursion with small
// Choleskys (L, M, SM, SG, AM, P per stage); the forward vector recursion
// (theta, h); and the backward substitution for (dz, dl). Failure of a
// Cholesky (a non-positive pivot) yields NaNs that propagate to dz, dl.
//
// The work of a stage is split over the instance's team (fbstab_common.cuh):
// the weights elementwise, the Hessians and the products over their
// (row, column) entries, T = inv(Lf Lf') over its columns, the right
// solves over their rows, the Choleskys column by column, the triangular
// solves of the vector recursions sequential in k with the rows below
// updated by the team. Every entry is computed by one thread in the order
// the team of one computes it, so the factors and the step are bit for bit
// the same for any team size.
//
// A team that stages (K1, K2, K4) works on the current stage in shared
// memory: it copies E, L (factor pass) or the stage's factors (vector
// passes) into its stage block in one coalesced sweep, computes the
// stage's factors there and writes them to device memory in one sweep, so
// the dependent chains of the solves wait on shared memory, not on device
// memory. A team that does not stage (a kernel at stages too large for a
// block's shared memory, and the team of one) reads and writes everything
// in place, its stage block in its device-memory scratch.
//
// Two modes, a compile-time parameter `Store` (riccati_pallas.py::
// riccati_factor_solve's store_factors and store_AP): the storing mode
// keeps every stage's M, SM, SG, AM and P in the scratch for the vector
// passes; the recompute-factors ("lowmem") mode keeps only the carried
// factors Lc and recomputes stage i's M, SM, SG, AM and P from Lc[i] in
// the stage block before each vector pass uses them, with the forward
// pass's own code on the same inputs, so the step is bit for bit the
// storing mode's. It trades about twice the factor work for
// N1 (nx^2 + nu nx + nu^2) + N (nx^2 + nx nu) floats of scratch.
#pragma once

#include "fbstab_common.cuh"

// Offsets (in floats per instance) of the Newton-step scratch: the stage
// factors (Lc, and in the storing mode M, SM, SG, AM, P) and vectors, then
// the stage block, whose offsets Qh ... P count from its start: the current
// stage's Hessians, T, the weights' ratio gamma ./ mus, four vector
// temporaries, and the staged operands (E, L, the carried factor Lf and the
// next one Ln, M, SM, SG, AM, P). A team that stages keeps the stage block
// in shared memory; one that does not, in its scratch at `stage`. The
// recompute-factors layout (lowmem) has no M ... P in the scratch (their
// offsets are 0 and never read): each stage's lie in the stage block.
struct RicLayout {
  int Lc, M, SM, SG, AM, P, th, h, gam, mus, r1, stage;
  int Qh, Rh, Sh, T, gr, v0, v1, v2, v3;
  int sE, sL, sLf, sLn, sM, sSM, sSG, sAM, sP, stage_floats;
  int total;
};

FB_HD RicLayout ric_layout(const MpcDims& D, bool lowmem) {
  int N1 = D.N + 1, nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  int nmax = nx > nu ? nx : nu;
  RicLayout w;
  int o = 0;
  w.Lc = o; o += N1 * nx * nx;
  w.M = w.SM = w.SG = w.AM = w.P = 0;
  if (!lowmem) {
    w.M = o;  o += N1 * nx * nx;
    w.SM = o; o += N1 * nu * nx;
    w.SG = o; o += N1 * nu * nu;
    w.AM = o; o += D.N * nx * nx;
    w.P = o;  o += D.N * nx * nu;
  }
  w.th = o; o += N1 * nx;
  w.h = o;  o += N1 * nx;
  w.gam = o; o += N1 * nc;
  w.mus = o; o += N1 * nc;
  w.r1 = o; o += N1 * ns;
  w.stage = o;
  o = 0;
  w.Qh = o; o += nx * nx;
  w.Rh = o; o += nu * nu;
  w.Sh = o; o += nu * nx;
  w.T = o;  o += nx * nx;
  w.gr = o; o += nc;
  w.v0 = o; o += nmax;
  w.v1 = o; o += nmax;
  w.v2 = o; o += nmax;
  w.v3 = o; o += nmax;
  w.sE = o;  o += nc * nx;
  w.sL = o;  o += nc * nu;
  w.sLf = o; o += nx * nx;
  w.sLn = o; o += nx * nx;
  w.sM = o;  o += nx * nx;
  w.sSM = o; o += nu * nx;
  w.sSG = o; o += nu * nu;
  w.sAM = o; o += nx * nx;
  w.sP = o;  o += nx * nu;
  w.stage_floats = o;
  w.total = w.stage + w.stage_floats;
  return w;
}

// Floats of Newton-step scratch per instance in device memory: the factors
// and vectors, and the stage block too for a team that does not stage.
FB_HD long long ric_ws_floats(const MpcDims& D, bool lowmem, bool stages) {
  const RicLayout o = ric_layout(D, lowmem);
  return stages ? o.stage : o.total;
}

// The working views of one stage's factors: in the stage block for a team
// that stages and in the recompute-factors mode, in the scratch at stage i
// otherwise.
struct StageFactors {
  Lane M, SM, SG, AM, P;
};

template <bool Store, class Tm>
FB_DEV StageFactors ric_factors_at(const Tm& tm, const MpcDims& D,
                                   const RicLayout& o, Lane w, Lane st,
                                   int i) {
  const long long nx = D.nx, nu = D.nu;
  if (!Store)
    return StageFactors{st.at(o.sM), st.at(o.sSM), st.at(o.sSG),
                        st.at(o.sAM), st.at(o.sP)};
  return StageFactors{
      fb_work(tm, st.at(o.sM), w.at(o.M + i * nx * nx)),
      fb_work(tm, st.at(o.sSM), w.at(o.SM + i * nu * nx)),
      fb_work(tm, st.at(o.sSG), w.at(o.SG + i * nu * nu)),
      fb_work(tm, st.at(o.sAM), w.at(o.AM + i * nx * nx)),
      fb_work(tm, st.at(o.sP), w.at(o.P + i * nx * nu))};
}

// Stage i's stored factors (M, SM, SG and, before the last stage, AM and
// P; none in the recompute-factors mode, which has them in the stage block
// already) and the factor Lc at stage `j` into the stage block (Lc at sLf),
// for a team that stages; visible after the caller's next sync.
template <bool Store, class Tm>
FB_DEV void ric_stage_in(const Tm& tm, const MpcDims& D, const RicLayout& o,
                         Lane w, Lane st, int i, int j) {
  const long long nx = D.nx, nu = D.nu;
  if (Store) {
    fb_stage_in(tm, st.at(o.sM), w.at(o.M + i * nx * nx), nx * nx);
    fb_stage_in(tm, st.at(o.sSM), w.at(o.SM + i * nu * nx), nu * nx);
    fb_stage_in(tm, st.at(o.sSG), w.at(o.SG + i * nu * nu), nu * nu);
    if (i < D.N) {
      fb_stage_in(tm, st.at(o.sAM), w.at(o.AM + i * nx * nx), nx * nx);
      fb_stage_in(tm, st.at(o.sP), w.at(o.P + i * nx * nu), nx * nu);
    }
  }
  fb_stage_in(tm, st.at(o.sLf), w.at(o.Lc + j * nx * nx), nx * nx);
}

// Stage i's factors from the stage block to the scratch (the last stage
// has no AM, P); nothing in the recompute-factors mode.
template <bool Store, class Tm>
FB_DEV void ric_stage_out(const Tm& tm, const MpcDims& D, const RicLayout& o,
                          Lane w, Lane st, int i) {
  if (!Store) return;
  const long long nx = D.nx, nu = D.nu;
  fb_stage_out(tm, w.at(o.M + i * nx * nx), st.at(o.sM), nx * nx);
  fb_stage_out(tm, w.at(o.SM + i * nu * nx), st.at(o.sSM), nu * nx);
  fb_stage_out(tm, w.at(o.SG + i * nu * nu), st.at(o.sSG), nu * nu);
  if (i < D.N) {
    fb_stage_out(tm, w.at(o.AM + i * nx * nx), st.at(o.sAM), nx * nx);
    fb_stage_out(tm, w.at(o.P + i * nx * nu), st.at(o.sP), nx * nu);
  }
}

// M, SM, SG of stage i (riccati_linear_solver.cc:140-151, 191-209) into
// F from the carried factor Lf = Lc[i], by way of the stage Hessians
// Qh, Rh, Sh in the stage block.
template <class Tm>
FB_DEV void ric_stage_factor(const Tm& tm, const MpcDims& D,
                             const MpcProb& P, const RicLayout& o, Lane w,
                             Lane st, float sigma, int i, Lane Lf,
                             const StageFactors& F) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, T = tm.size();
  const Lane E = fb_stage_in(tm, st.at(o.sE),
                             P.E.at((long long)i * nc * nx), nc * nx);
  const Lane L = fb_stage_in(tm, st.at(o.sL),
                             P.L.at((long long)i * nc * nu), nc * nu);
  Lane gam = w.at(o.gam + (long long)i * nc), mus = w.at(o.mus + (long long)i * nc);
  Lane Qh = st.at(o.Qh), Rh = st.at(o.Rh), Sh = st.at(o.Sh), gr = st.at(o.gr);
  Lane Q = P.Q.at((long long)i * nx * nx), R = P.R.at((long long)i * nu * nu),
       S = P.S.at((long long)i * nu * nx);
  for (int k = tm.rank(); k < nc; k += T) gr[k] = gam[k] / mus[k];
  tm.sync();
  // The stage Hessians.
  const int nxx = nx * nx, nuu = nu * nu;
  for (int t = tm.rank(); t < nxx + nuu + nu * nx; t += T) {
    float s = 0.0f;
    if (t < nxx) {
      const int r = t / nx, c = t % nx;
      for (int k = 0; k < nc; ++k)
        s += E[k * nx + r] * (gr[k] * E[k * nx + c]);
      Qh[t] = (Q[t] + (r == c ? sigma : 0.0f)) + s;
    } else if (t < nxx + nuu) {
      const int u = t - nxx, r = u / nu, c = u % nu;
      for (int k = 0; k < nc; ++k)
        s += L[k * nu + r] * (gr[k] * L[k * nu + c]);
      Rh[u] = (R[u] + (r == c ? sigma : 0.0f)) + s;
    } else {
      const int u = t - nxx - nuu, r = u / nx, c = u % nx;
      for (int k = 0; k < nc; ++k)
        s += L[k * nu + r] * (gr[k] * E[k * nx + c]);
      Sh[u] = S[u] + s;
    }
  }
  // T = inv(Lf Lf'), one column per thread.
  Lane Tb = st.at(o.T);
  for (int j = tm.rank(); j < nx; j += T) {
    Lane col = fb_col(Tb, nx, j);
    for (int r = 0; r < nx; ++r) col[r] = (r == j) ? 1.0f : 0.0f;
    fb_cho_solve(Solo{}, Lf, nx, col);
  }
  tm.sync();
  // M = chol(Qh + T).
  for (int k = tm.rank(); k < nx * nx; k += T) F.M[k] = Qh[k] + Tb[k];
  tm.sync();
  fb_chol(tm, F.M, nx);
  // SM = Sh inv(M)'.
  for (int r = tm.rank(); r < nu; r += T) {
    for (int k = 0; k < nx; ++k) F.SM[r * nx + k] = Sh[r * nx + k];
    fb_trsv_lower(Solo{}, F.M, nx, F.SM.at(r * nx));
  }
  tm.sync();
  // SG = chol(Rh - SM SM').
  for (int t = tm.rank(); t < nu * nu; t += T) {
    const int r = t / nu, c = t % nu;
    float s = 0.0f;
    for (int k = 0; k < nx; ++k) s += F.SM[r * nx + k] * F.SM[c * nx + k];
    F.SG[t] = Rh[t] - s;
  }
  tm.sync();
  fb_chol(tm, F.SG, nu);
}

// AM = A inv(M)', then P = (AM SM' - B) inv(SG)' of stage i < N into F,
// a row per thread.
template <class Tm>
FB_DEV void ric_stage_AP(const Tm& tm, const MpcDims& D, const MpcProb& P,
                         int i, const StageFactors& F) {
  const int nx = D.nx, nu = D.nu, T = tm.size();
  Lane A = P.A.at((long long)i * nx * nx),
       Bm = P.B.at((long long)i * nx * nu);
  for (int r = tm.rank(); r < nx; r += T) {
    for (int k = 0; k < nx; ++k) F.AM[r * nx + k] = A[r * nx + k];
    fb_trsv_lower(Solo{}, F.M, nx, F.AM.at(r * nx));
    for (int c = 0; c < nu; ++c) {
      float s = 0.0f;
      for (int k = 0; k < nx; ++k) s += F.AM[r * nx + k] * F.SM[c * nx + k];
      F.P[r * nu + c] = s - Bm[r * nu + c];
    }
    fb_trsv_lower(Solo{}, F.SG, nu, F.P.at(r * nu));
  }
  tm.sync();
}

// The recompute-factors mode's stage i: M, SM, SG (and AM, P before the
// last stage) into the stage block from the stored Lc[i] (staged at sLn),
// by the forward pass's own code, so bit for bit its values.
template <class Tm>
FB_DEV void ric_recompute(const Tm& tm, const MpcDims& D, const MpcProb& P,
                          const RicLayout& o, Lane w, Lane st, float sigma,
                          int i, const StageFactors& F) {
  const long long xx = (long long)D.nx * D.nx;
  const Lane Lf = fb_stage_in(tm, st.at(o.sLn), w.at(o.Lc + i * xx), xx);
  tm.sync();
  ric_stage_factor(tm, D, P, o, w, st, sigma, i, Lf, F);
  if (i < D.N) ric_stage_AP(tm, D, P, i, F);
}

// r1(i) = rz(i) - [E(i); L(i)]' (rv(i) ./ mus(i)) for every stage
// (riccati_linear_solver.cc:230-235), stage-major (N+1, nx+nu).
template <class Tm>
FB_DEV void ric_r1(const Tm& tm, const MpcDims& D, const MpcProb& P,
                   const RicLayout& o, Lane w, Lane rz, Lane rv) {
  const int nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  const int rows = (D.N + 1) * ns;
  for (int t = tm.rank(); t < rows; t += tm.size()) {
    const int i = t / ns, j = t % ns;
    Lane mus = w.at(o.mus + (long long)i * nc);
    float s = 0.0f;
    if (j < nx) {
      Lane E = P.E.at((long long)i * nc * nx);
      for (int c = 0; c < nc; ++c) s += E[c * nx + j] * (rv[i * nc + c] / mus[c]);
    } else {
      Lane L = P.L.at((long long)i * nc * nu);
      for (int c = 0; c < nc; ++c)
        s += L[c * nu + (j - nx)] * (rv[i * nc + c] / mus[c]);
    }
    w[o.r1 + t] = rz[t] - s;
  }
  tm.sync();
}

// One Newton step for one instance.
//   sigma: this instance's proximal parameter; alpha, om_alpha = 1 - alpha.
//   v, y, vbar (N+1, nc): the iterate pieces;
//   rz (N+1, nx+nu), rl (N+1, nx), rv (N+1, nc): the NEGATED inner
//   residual; dz (N+1, nx+nu), dl (N+1, nx): outputs;
//   w: scratch laid out by ric_layout(D, !Store); st: the stage block.
//   After the call w.gam / w.mus hold the PFB weights (the dual recovery
//   dv, dy uses them). Vector element j belongs to thread j % size
//   throughout the vector recursions (the ownership of fb_trsv_lower), so a
//   thread's writes there feed its own triangular solves without a sync.
//   Store: the storing mode (true) or the recompute-factors mode.
template <bool Store, class Tm>
FB_DEV void riccati_factor_solve(const Tm& tm, const MpcDims& D, float sigma,
                                 float alpha, float om_alpha,
                                 const MpcProb& P, Lane v, Lane y, Lane vbar,
                                 Lane rz, Lane rl, Lane rv, Lane dz, Lane dl,
                                 Lane w, Lane st) {
  const int N = D.N, nx = D.nx, nu = D.nu, nc = D.nc, ns = nx + nu;
  const int T = tm.size(), me = tm.rank();
  const RicLayout o = ric_layout(D, !Store);
  const long long xx = (long long)nx * nx;

  for (int k = me; k < (N + 1) * nc; k += T) {
    float ys = y[k] + sigma * (v[k] - vbar[k]);
    float g, m;
    fb_pfb_weights(ys, v[k], sigma, alpha, om_alpha, g, m);
    w[o.gam + k] = g;
    w[o.mus + k] = m;
  }

  // ---- Forward matrix recursion (cc:125-188). L(0) = sqrt(sigma) I. ----
  // Lf carries Lc[i]; a staging team swaps its two stage-block copies.
  Lane Lf = fb_work(tm, st.at(o.sLf), w.at(o.Lc));
  Lane Lnb = st.at(o.sLn);
  {
    float sq = sqrtf(sigma);
    for (int t = me; t < nx * nx; t += T) {
      Lf[t] = (t / nx == t % nx) ? sq : 0.0f;
    }
    fb_stage_out(tm, w.at(o.Lc), Lf, nx * nx);
  }
  tm.sync();
  for (int i = 0; i < N; ++i) {
    const StageFactors F = ric_factors_at<Store>(tm, D, o, w, st, i);
    ric_stage_factor(tm, D, P, o, w, st, sigma, i, Lf, F);
    ric_stage_AP(tm, D, P, i, F);
    // L(i+1) = chol(sigma I + P P' + AM AM') (its lower triangle).
    Lane Ln = fb_work(tm, Lnb, w.at(o.Lc + (i + 1) * xx));
    for (int t = me; t < nx * nx; t += T) {
      const int r = t / nx, c = t % nx;
      if (c > r) continue;
      float pp = 0.0f, aa = 0.0f;
      for (int k = 0; k < nu; ++k) pp += F.P[r * nu + k] * F.P[c * nu + k];
      for (int k = 0; k < nx; ++k) aa += F.AM[r * nx + k] * F.AM[c * nx + k];
      Ln[t] = ((r == c ? sigma : 0.0f) + pp) + aa;
    }
    tm.sync();
    fb_chol(tm, Ln, nx);
    ric_stage_out<Store>(tm, D, o, w, st, i);
    fb_stage_out(tm, w.at(o.Lc + (i + 1) * xx), Ln, nx * nx);
    Lnb = Lf;
    Lf = Ln;
  }
  ric_stage_factor(tm, D, P, o, w, st, sigma, N, Lf,
                   ric_factors_at<Store>(tm, D, o, w, st, N));
  ric_stage_out<Store>(tm, D, o, w, st, N);
  // The recompute-factors mode's vector passes stage Lc[i] at sLn, which
  // the last forward stage may still be reading.
  if (!Store) tm.sync();

  // ---- Forward vector recursion (cc:239-262). ----
  ric_r1(tm, D, P, o, w, rz, rv);
  Lane th = w.at(o.th), h = w.at(o.h), r1 = w.at(o.r1);
  Lane tx = st.at(o.v0), tu = st.at(o.v1);
  for (int j = me; j < nx; j += T) {
    th[j] = -rl[j];
    h[j] = th[j];
  }
  Lf = fb_stage_in(tm, st.at(o.sLf), w.at(o.Lc), nx * nx);
  tm.sync();
  fb_cho_solve(tm, Lf, nx, h);
  for (int j = me; j < nx; j += T) h[j] = h[j] - r1[j];
  for (int i = 0; i < N; ++i) {
    const StageFactors F = ric_factors_at<Store>(tm, D, o, w, st, i);
    if (!Store) ric_recompute(tm, D, P, o, w, st, sigma, i, F);
    ric_stage_in<Store>(tm, D, o, w, st, i, i + 1);
    Lf = fb_work(tm, st.at(o.sLf), w.at(o.Lc + (i + 1) * xx));
    for (int j = me; j < nx; j += T) tx[j] = h[i * nx + j];
    tm.sync();
    fb_trsv_lower(tm, F.M, nx, tx);
    for (int j = me; j < nu; j += T) {
      float s = 0.0f;
      for (int k = 0; k < nx; ++k) s += F.SM[j * nx + k] * tx[k];
      tu[j] = s + r1[(long long)i * ns + nx + j];
    }
    fb_trsv_lower(tm, F.SG, nu, tu);
    Lane thn = th.at((long long)(i + 1) * nx), hn = h.at((long long)(i + 1) * nx);
    for (int j = me; j < nx; j += T) {
      float pt = 0.0f, at = 0.0f;
      for (int k = 0; k < nu; ++k) pt += F.P[j * nu + k] * tu[k];
      for (int k = 0; k < nx; ++k) at += F.AM[j * nx + k] * tx[k];
      thn[j] = (pt + at) - rl[(long long)(i + 1) * nx + j];
      hn[j] = thn[j];
    }
    fb_cho_solve(tm, Lf, nx, hn);
    for (int j = me; j < nx; j += T)
      hn[j] = hn[j] - r1[(long long)(i + 1) * ns + j];
  }
  tm.sync();

  // ---- Backward recursion (cc:266-327). ----
  Lane t2 = st.at(o.v2), t3 = st.at(o.v3);
  for (int i = N; i >= 0; --i) {
    const StageFactors F = ric_factors_at<Store>(tm, D, o, w, st, i);
    if (!Store) ric_recompute(tm, D, P, o, w, st, sigma, i, F);
    ric_stage_in<Store>(tm, D, o, w, st, i, i);
    Lf = fb_work(tm, st.at(o.sLf), w.at(o.Lc + i * xx));
    Lane xi = dz.at((long long)i * ns), ui = dz.at((long long)i * ns + nx);
    Lane li = dl.at((long long)i * nx);
    // tx = inv(M) h; u = inv(SG)(SM tx + r1u).
    for (int j = me; j < nx; j += T) tx[j] = h[(long long)i * nx + j];
    tm.sync();
    fb_trsv_lower(tm, F.M, nx, tx);
    for (int j = me; j < nu; j += T) {
      float s = 0.0f;
      for (int k = 0; k < nx; ++k) s += F.SM[j * nx + k] * tx[k];
      ui[j] = s + r1[(long long)i * ns + nx + j];
    }
    fb_trsv_lower(tm, F.SG, nu, ui);
    if (i < N) {
      // u = inv(SG')(u + P' l(i+1)).
      Lane ln = dl.at((long long)(i + 1) * nx);
      for (int j = me; j < nu; j += T) {
        float s = 0.0f;
        for (int k = 0; k < nx; ++k) s += F.P[k * nu + j] * ln[k];
        ui[j] = ui[j] + s;
      }
    }
    fb_trsv_upperT(tm, F.SG, nu, ui);
    // x = -inv(M')(tx + SM' u [+ AM' l(i+1)]).
    for (int j = me; j < nx; j += T) {
      float s = 0.0f;
      for (int k = 0; k < nu; ++k) s += F.SM[k * nx + j] * ui[k];
      float acc = tx[j] + s;
      if (i < N) {
        Lane ln = dl.at((long long)(i + 1) * nx);
        float a = 0.0f;
        for (int k = 0; k < nx; ++k) a += F.AM[k * nx + j] * ln[k];
        acc = acc + a;
      }
      t2[j] = acc;
    }
    fb_trsv_upperT(tm, F.M, nx, t2);
    // l = -inv(L L')(theta + x).
    for (int j = me; j < nx; j += T) {
      xi[j] = -t2[j];
      t3[j] = th[(long long)i * nx + j] + xi[j];
    }
    fb_cho_solve(tm, Lf, nx, t3);
    for (int j = me; j < nx; j += T) li[j] = -t3[j];
    tm.sync();
  }
}

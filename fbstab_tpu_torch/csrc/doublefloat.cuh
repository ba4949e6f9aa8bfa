// Double-float error-free transforms in device code: Knuth's two_sum,
// Dekker's two_prod and a compensated dot product, in the form of
// fbstab_tpu_torch/ops/doublefloat.py (and scratch/tpu_df_kernel.py), and
// the double-float (hi, lo) pair operations of that module, operation for
// operation (refine_residual.cuh).
//
// The transforms are exact only if every operation rounds on its own. The
// library is built with nvcc's default --fmad=true, which lets the compiler
// contract a product and a sum into one FFMA; in Dekker's split
// (c * a - a) and in the error term (a_hi * b_hi - p) that changes the
// result. So every operation here is a rounding intrinsic, __fadd_rn,
// __fsub_rn or __fmul_rn, which nvcc never contracts or reassociates,
// whatever the flags. They were chosen over fmaf(a, b, -p) for the error
// term because they keep the exact operation sequence of the plain PyTorch
// version, so kernel and plain version agree bit for bit, also where
// Dekker's split and an FMA would round differently (at the edge of the
// float range). Define FB_DF_PLAIN_OPS to compile the same code with the
// plain operators (the question whether nvcc contracts them); host
// compilers see plain operators and must be run with -ffp-contract=off.
#pragma once

#if defined(__CUDACC__)
#define FB_DF_FN __device__ __forceinline__
#else
#define FB_DF_FN inline
#endif

#if defined(__CUDACC__) && !defined(FB_DF_PLAIN_OPS)
#define FB_DF_ADD(a, b) __fadd_rn((a), (b))
#define FB_DF_SUB(a, b) __fsub_rn((a), (b))
#define FB_DF_MUL(a, b) __fmul_rn((a), (b))
#define FB_DF_DIV(a, b) __fdiv_rn((a), (b))
#define FB_DF_SQRT(a) __fsqrt_rn(a)
#else
#define FB_DF_ADD(a, b) ((a) + (b))
#define FB_DF_SUB(a, b) ((a) - (b))
#define FB_DF_MUL(a, b) ((a) * (b))
#define FB_DF_DIV(a, b) ((a) / (b))
#define FB_DF_SQRT(a) sqrtf(a)
#endif

// s + e == a + b exactly, s = fl(a + b).
FB_DF_FN void df_two_sum(float a, float b, float& s, float& e) {
  s = FB_DF_ADD(a, b);
  const float bb = FB_DF_SUB(s, a);
  e = FB_DF_ADD(FB_DF_SUB(a, FB_DF_SUB(s, bb)), FB_DF_SUB(b, bb));
}

// p + e == a * b exactly, p = fl(a * b) (Dekker, split 2^12 + 1).
FB_DF_FN void df_two_prod(float a, float b, float& p, float& e) {
  const float c = 4097.0f;
  p = FB_DF_MUL(a, b);
  const float a_big = FB_DF_MUL(c, a);
  const float a_hi = FB_DF_SUB(a_big, FB_DF_SUB(a_big, a));
  const float a_lo = FB_DF_SUB(a, a_hi);
  const float b_big = FB_DF_MUL(c, b);
  const float b_hi = FB_DF_SUB(b_big, FB_DF_SUB(b_big, b));
  const float b_lo = FB_DF_SUB(b, b_hi);
  e = FB_DF_ADD(
      FB_DF_ADD(FB_DF_ADD(FB_DF_SUB(FB_DF_MUL(a_hi, b_hi), p),
                          FB_DF_MUL(a_hi, b_lo)),
                FB_DF_MUL(a_lo, b_hi)),
      FB_DF_MUL(a_lo, b_lo));
}

// One step of the compensated dot product, (hi, lo) += a * b, given a * b
// as two_prod's pair (ph, pl) = df_two_prod(a, b): the caller that also
// needs the pair computes it once.
FB_DF_FN void df_dot_add(float ph, float pl, float& hi, float& lo) {
  float e1, e2;
  df_two_sum(hi, ph, hi, e1);
  lo = FB_DF_ADD(lo, FB_DF_ADD(e1, pl));
  df_two_sum(hi, lo, hi, e2);
  lo = e2;
}

// A double-float value hi + lo, and the operations of ops/doublefloat.py on
// it, each the same sequence of roundings as the PyTorch function of the
// same name, so the two agree bit for bit (signed zeros and NaNs too).
struct DF {
  float hi, lo;
};

FB_DF_FN DF df_neg(DF x) { return DF{-x.hi, -x.lo}; }

// The nearest single float, hi + lo.
FB_DF_FN float df_to(DF x) { return FB_DF_ADD(x.hi, x.lo); }

// s + e == a + b exactly, assuming |a| >= |b|.
FB_DF_FN DF df_fast_two_sum(float a, float b) {
  const float s = FB_DF_ADD(a, b);
  return DF{s, FB_DF_SUB(b, FB_DF_SUB(s, a))};
}

FB_DF_FN DF df_add(DF x, DF y) {
  float s, e;
  df_two_sum(x.hi, y.hi, s, e);
  return df_fast_two_sum(s, FB_DF_ADD(FB_DF_ADD(e, x.lo), y.lo));
}

// DF * float.
FB_DF_FN DF df_mul_f(DF x, float a) {
  float p, e;
  df_two_prod(x.hi, a, p, e);
  return df_fast_two_sum(p, FB_DF_ADD(e, FB_DF_MUL(x.lo, a)));
}

FB_DF_FN DF df_mul(DF x, DF y) {
  float p, e;
  df_two_prod(x.hi, y.hi, p, e);
  const float cross = FB_DF_ADD(FB_DF_MUL(x.hi, y.lo), FB_DF_MUL(x.lo, y.hi));
  return df_fast_two_sum(p, FB_DF_ADD(e, cross));
}

// sqrt(DF) by one Newton step from the correctly rounded root of hi.
FB_DF_FN DF df_sqrt(DF x) {
  const float s = FB_DF_SQRT(x.hi);
  float p, e;
  df_two_prod(s, s, p, e);
  const DF r = df_add(x, DF{-p, -e});
  const float corr = s > 0.0f ? FB_DF_DIV(df_to(r), FB_DF_MUL(2.0f, s)) : 0.0f;
  return df_fast_two_sum(s, corr);
}

// max(0, DF) and the lexicographic min, as torch.where selects them.
FB_DF_FN DF df_max0(DF x) {
  const bool pos = x.hi > 0.0f || (x.hi == 0.0f && x.lo > 0.0f);
  return pos ? x : DF{0.0f, 0.0f};
}

FB_DF_FN DF df_min(DF x, DF y) {
  const bool take_x = x.hi < y.hi || (x.hi == y.hi && x.lo <= y.lo);
  return take_x ? x : y;
}

// acc + m * x, one column of df_matvec (one row of df_matvec_T): the
// product's pair two_prod(m, x.hi) with m first, its error plus m * x.lo
// rounded twice, added to acc.
FB_DF_FN DF df_mac(DF acc, float m, DF x) {
  float p, e;
  df_two_prod(m, x.hi, p, e);
  return df_add(acc, DF{p, FB_DF_ADD(e, FB_DF_MUL(m, x.lo))});
}

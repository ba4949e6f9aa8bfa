// K5: one level of the associative Riccati scan on Hopper.
//
// Replaces the Pallas TPU kernel fbstab_tpu/ops/assoc_riccati.py::
// _combine_bl_pallas (kernel body _make_combine_kernel): it combines M
// pairs of adjacent span elements of every instance, K = P22_l + P11_r,
// three Jacobi-equilibrated SPD solves against that one K, six small
// products and the symmetrized diagonal blocks (assoc_combine.cuh). The
// scan over the horizon (ops/assoc_riccati.py) launches it once per level.
//
// Design: one thread per (pair m, instance b). The span blocks are
// stage-stacked with the batch last, (M, n, n, B) and (M, n, B), so the 32
// threads of a warp (32 consecutive instances of one pair) read 32
// consecutive floats on every access; the factor and the three solves live
// in a batch-last scratch the wrapper allocates. The TPU kernel's lane
// conditions (B >= 128, padding with 1.0) have no counterpart: the last
// block masks its idle threads. n <= 32, as for the Pallas kernel.
//
// What bounds it: per thread ~n^3 / 3 for the factor, 2 n^2 (2n + 1) for
// the solves and ~8 n^3 for the products (~7e4 operations at n = 18) in a
// dependent chain of loads, against ~14 n^2 floats moved; latency, not
// bandwidth or arithmetic, sets the time.
#include <cuda_runtime.h>

#include "assoc_combine.cuh"

namespace {

constexpr int kThreads = 128;

struct SpanPtrs {
  const float *P11, *P12, *P22, *p1, *p2;
};

struct OutPtrs {
  float *P11, *P12, *P22, *p1, *p2;
};

__device__ Span span_at(const SpanPtrs& e, int n, int B, int m, int b) {
  const long long mat = (long long)m * n * n * B, vec = (long long)m * n * B;
  return Span{lane_of(e.P11 + mat, B, b), lane_of(e.P12 + mat, B, b),
              lane_of(e.P22 + mat, B, b), lane_of(e.p1 + vec, B, b),
              lane_of(e.p2 + vec, B, b)};
}

__global__ void assoc_combine_kernel(int n, int M, int B, SpanPtrs left,
                                     SpanPtrs right, OutPtrs out, float* ws) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)M * B) return;
  const int m = (int)(t / B), b = (int)(t % B);
  const SpanPtrs o{out.P11, out.P12, out.P22, out.p1, out.p2};
  assoc_combine_lane(n, span_at(left, n, B, m, b), span_at(right, n, B, m, b),
                     span_at(o, n, B, m, b),
                     lane_of(ws, (long long)M * B, t));
}

}  // namespace

extern "C" {

// Floats of K5's scratch per (pair, instance).
long long fb_combine_ws_floats(int n) { return assoc_combine_ws_floats(n); }

// Launches K5 on `stream`: left and right are five arrays each (P11, P12,
// P22 as (M, n, n, B), p1, p2 as (M, n, B)), out the five combined blocks;
// ws is (fb_combine_ws_floats(n), M * B). Returns cudaGetLastError().
int fb_assoc_combine(int n, int M, int B, const float* lP11,
                     const float* lP12, const float* lP22, const float* lp1,
                     const float* lp2, const float* rP11, const float* rP12,
                     const float* rP22, const float* rp1, const float* rp2,
                     float* oP11, float* oP12, float* oP22, float* op1,
                     float* op2, float* ws, void* stream) {
  const long long threads = (long long)M * B;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  assoc_combine_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, M, B, SpanPtrs{lP11, lP12, lP22, lp1, lp2},
      SpanPtrs{rP11, rP12, rP22, rp1, rp2},
      OutPtrs{oP11, oP12, oP22, op1, op2}, ws);
  return (int)cudaGetLastError();
}

}  // extern "C"

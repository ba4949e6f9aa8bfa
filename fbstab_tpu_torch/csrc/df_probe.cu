// P3: the double-float probe on Hopper.
//
// Replaces the Pallas TPU kernel of scratch/tpu_df_kernel.py (kernel
// :45-65, pallas_call :77), which asked whether the error-free transforms
// survive the TPU compiler. Here the question is nvcc's: on a and b of
// shape (R, C) the kernel writes two_sum (s, e) and two_prod (p, pe)
// elementwise and the compensated dot product down axis 0, (1, C) hi and
// lo, with the transforms of doublefloat.cuh.
//
// Design: one thread per column walks its R rows in order (the dot is a
// sequential accumulation, as in the reference), and the dot step takes
// the elementwise two_prod's pair instead of forming it again. What bounds
// it: the bytes, 2 R C floats in and 4 R C + 2 C out, a few KB, 7.6 ns at
// the memory rate. Measured on an H100 (PERF.md §6): on the device (CUDA
// graph replays) a launch is within 1 us of the card's launch floor,
// ~1.3 us; the wrapper called back to back takes 30-60 us a call, all of
// it the host's. Unrolled by R, so that the rows' loads overlap, the
// kernel ran 0.5 us slower a launch.
#include <cuda_runtime.h>

#include "doublefloat.cuh"

namespace {

__global__ void df_probe_kernel(int R, int C, const float* __restrict__ a,
                                const float* __restrict__ b, float* s,
                                float* e, float* p, float* pe, float* dh,
                                float* dl) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float hi = 0.0f, lo = 0.0f;
  for (int r = 0; r < R; ++r) {
    const long long k = (long long)r * C + c;
    const float x = a[k], y = b[k];
    float sx, ex, px, pex;
    df_two_sum(x, y, sx, ex);
    df_two_prod(x, y, px, pex);
    df_dot_add(px, pex, hi, lo);
    s[k] = sx;
    e[k] = ex;
    p[k] = px;
    pe[k] = pex;
  }
  dh[c] = hi;
  dl[c] = lo;
}

}  // namespace

extern "C" {

// Launches the probe on `stream`; every array row-major. Returns
// cudaGetLastError().
int fb_df_probe(int R, int C, const float* a, const float* b, float* s,
                float* e, float* p, float* pe, float* dh, float* dl,
                void* stream) {
  const int threads = 128;
  df_probe_kernel<<<(C + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(R, C, a, b, s, e, p, pe, dh, dl);
  return (int)cudaGetLastError();
}

}  // extern "C"

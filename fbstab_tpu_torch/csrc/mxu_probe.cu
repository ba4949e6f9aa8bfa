// P1: the stage-matvec probe on Hopper, in three forms.
//
// Replaces the three Pallas TPU kernels of bench.py's `run_mxu` (kernel
// bodies bench.py:953-985, pallas_call bench.py:998; the same probe in
// scratch/tpu_mxu.py:104). Each applies, T times, w_s <- scale * M_s w_s
// to every stage s of every lane b: M is per lane, (N1, n, n, B), or shared,
// (N1, n, n); w is (N1 * n, B) with stage s in rows s*n .. s*n + n - 1.
// The question the probe answers: do matrix units beat vector code on the
// stage products at the copolymerization reactor's stage size (n = 18)?
//
//   form 0, cuda_perlane (vpu_perlane): per-lane M on the CUDA cores;
//   form 1, cuda_shared  (vpu_shared):  shared M on the CUDA cores;
//   form 2, tc_shared    (mxu_shared):  shared M as one TF32 tensor-core
//                                       product per stage (mma.sync
//                                       m16n8k8, n padded to 32 x 8k).
//
// Design: the recurrence never mixes stages or lanes, so each block keeps
// its slice resident for all T applications and the T loop runs inside the
// kernel (the reference's fori_loop), one launch per call.
//  - CUDA-core forms: a block per (stage, 32 lanes), a thread per (row i,
//    lane); the thread holds row i of M_s in registers (read once: the
//    shared form's loads are warp broadcasts), the block holds the 32
//    lanes' w_s in shared memory (a warp is one row of 32 lanes, so its
//    reads are conflict-free). Each application: n FMAs per thread, two
//    barriers.
//  - tc_shared: a block per (stage, 4 tiles of 8 lanes), a warp per tile.
//    The padded M_s (32 x 32, zeros beyond n) is loaded once and converted
//    to TF32 A fragments held in registers for all T; each warp keeps its
//    tile of w_s (32 x 8, rows >= n zero) in shared memory and per
//    application loads the B fragments, runs 2 (m) x ceil(n/8) (k) MMAs,
//    scales and writes rows < n back. Tiles are independent: __syncwarp.
//
// What bounds it: operations, 2 n^2 N1 B T = 1.34 GFLOP at the probe's
// size (20 us on the CUDA cores' float32 peak, 2.7 us on the TF32 tensor
// peak) against 16.4 MB of M and w moved once (4.9 us): latency of the
// n-long dependent FMA chain and the two barriers per application are
// what the design leaves on the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;      // lanes per block, CUDA-core forms
constexpr int kMaxN = 32;       // rows of a stage held in registers
constexpr int kTcWarps = 4;     // warps (8-lane tiles) per block, tc form

template <bool kPerLane>
__global__ void stage_matvec_cuda_cores(int n, int B, int T, float scale,
                                        const float* __restrict__ M,
                                        const float* __restrict__ w0,
                                        float* __restrict__ w_out) {
  extern __shared__ float ws[];   // (n, kLanes): ws[j * kLanes + lane]
  const int lane = threadIdx.x;
  const int i = threadIdx.y;
  const int s = blockIdx.y;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < B;
  const long long row = (long long)s * n + i;

  float m[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    float mij = 0.0f;
    if (j < n && live)
      mij = kPerLane ? M[(row * n + j) * B + b] : M[row * n + j];
    m[j] = mij;
  }
  ws[i * kLanes + lane] = live ? w0[row * B + b] : 0.0f;
  __syncthreads();
  float acc = ws[i * kLanes + lane];
  for (int t = 0; t < T; ++t) {
    acc = m[0] * ws[lane];
#pragma unroll
    for (int j = 1; j < kMaxN; ++j)
      if (j < n) acc = acc + m[j] * ws[j * kLanes + lane];
    acc = acc * scale;
    __syncthreads();
    ws[i * kLanes + lane] = acc;
    __syncthreads();
  }
  if (live) w_out[row * B + b] = acc;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D += A B for one m16n8k8 TF32 tile, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void stage_matvec_tensor_cores(int n, int B, int T, float scale,
                                          const float* __restrict__ M,
                                          const float* __restrict__ w0,
                                          float* __restrict__ w_out) {
  __shared__ float msh[kMaxN * kMaxN];            // padded M_s, row-major
  __shared__ float wsh[kTcWarps][kMaxN * 8];      // per warp: w tile (k, col)
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;       // groupID
  const int q = lane & 3;        // threadID_in_group
  const int col0 = (blockIdx.x * kTcWarps + warp) * 8;
  const int KT = (n + 7) / 8;

  for (int idx = threadIdx.x; idx < kMaxN * kMaxN; idx += blockDim.x) {
    const int r = idx / kMaxN, c = idx % kMaxN;
    msh[idx] = (r < n && c < n) ? M[((long long)s * n + r) * n + c] : 0.0f;
  }
  float* wt = wsh[warp];
  for (int idx = lane; idx < kMaxN * 8; idx += 32) {
    const int k = idx / 8, c = idx % 8;
    const int b = col0 + c;
    wt[idx] = (k < n && b < B) ? w0[((long long)s * n + k) * B + b] : 0.0f;
  }
  __syncthreads();

  // A fragments (PTX m16n8k8 .tf32 layout): a0 (g, q), a1 (g+8, q),
  // a2 (g, q+4), a3 (g+8, q+4) of the 16 x 8 tile (mt, kt).
  uint32_t a[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int r = mt * 16 + g, c = kt * 8 + q;
      a[mt][kt][0] = to_tf32(msh[r * kMaxN + c]);
      a[mt][kt][1] = to_tf32(msh[(r + 8) * kMaxN + c]);
      a[mt][kt][2] = to_tf32(msh[r * kMaxN + c + 4]);
      a[mt][kt][3] = to_tf32(msh[(r + 8) * kMaxN + c + 4]);
    }

  for (int t = 0; t < T; ++t) {
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt < KT) {
        // B fragment: b0 (row q, col g), b1 (row q+4, col g).
        const uint32_t b0 = to_tf32(wt[(kt * 8 + q) * 8 + g]);
        const uint32_t b1 = to_tf32(wt[(kt * 8 + q + 4) * 8 + g]);
        mma_tf32(d[0], a[0][kt], b0, b1);
        mma_tf32(d[1], a[1][kt], b0, b1);
      }
    }
    __syncwarp();
    // D fragment: d0 (g, 2q), d1 (g, 2q+1), d2 (g+8, 2q), d3 (g+8, 2q+1).
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      if (r0 < n) {
        wt[r0 * 8 + 2 * q] = d[mt][0] * scale;
        wt[r0 * 8 + 2 * q + 1] = d[mt][1] * scale;
      }
      if (r1 < n) {
        wt[r1 * 8 + 2 * q] = d[mt][2] * scale;
        wt[r1 * 8 + 2 * q + 1] = d[mt][3] * scale;
      }
    }
    __syncwarp();
  }
  for (int idx = lane; idx < n * 8; idx += 32) {
    const int k = idx / 8, c = idx % 8;
    const int b = col0 + c;
    if (b < B) w_out[((long long)s * n + k) * B + b] = wt[idx];
  }
}

}  // namespace

extern "C" {

// The largest stage size the probe kernels take.
int fb_mxu_max_n() { return kMaxN; }

// Launches form 0 (cuda_perlane), 1 (cuda_shared) or 2 (tc_shared) on
// `stream`: T applications of w_s <- scale * M_s w_s. M: (N1, n, n, B)
// for form 0, (N1, n, n) otherwise; w0 and w: (N1 * n, B). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a form or n it does
// not take.
int fb_mxu_probe(int form, int N1, int n, int B, int T, float scale,
                 const float* M, const float* w0, float* w, void* stream) {
  if (n < 1 || n > kMaxN || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 2) {
    const dim3 grid((B + 8 * kTcWarps - 1) / (8 * kTcWarps), N1);
    stage_matvec_tensor_cores<<<grid, 32 * kTcWarps, 0, st>>>(
        n, B, T, scale, M, w0, w);
  } else {
    const dim3 grid((B + kLanes - 1) / kLanes, N1);
    const dim3 block(kLanes, n);
    const size_t shmem = sizeof(float) * n * kLanes;
    if (form == 0)
      stage_matvec_cuda_cores<true><<<grid, block, shmem, st>>>(
          n, B, T, scale, M, w0, w);
    else
      stage_matvec_cuda_cores<false><<<grid, block, shmem, st>>>(
          n, B, T, scale, M, w0, w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

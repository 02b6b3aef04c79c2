// Kernel A: Palmer C(t) lag sums for Hopper (sm_90a).
//
// Replaces the TPU kernel spinrelax_tpu/ops/pallas_acf.py:acf_sums_pallas
// (body _acf_kernel2), which reaches the same numbers through a two-stage
// matmul DFT in compensated bf16 with centering corrections.  This kernel
// computes the contract directly:
//
//     s[d, b] = sum_{t < F - d} (v_b(t) . v_b(t + d))^2,   d = 1..D,
//
// written lag-major as out[(d - 1) * B + b].
//
// Design.  One block per bond.  The block stages the bond's F x 3 floats
// in shared memory as three padded planes (x, y, z), zero-filled past F
// so that a lag reaching beyond the chunk reads zeros and adds nothing:
// no per-term bounds test.  Each thread owns LAGS consecutive lags and
// keeps the LAGS partner vectors v(t + d) in registers as a sliding
// window: per frame it reads v(t) (a shared-memory broadcast) and ONE new
// partner vector, then does 4 FMA-class instructions per (t, d) term.
// Thread i's new partner sits at word t + 1 + LAGS * i (+const); a pad
// word every 32 words makes those LAGS-strided reads across a warp hit
// 32 distinct banks.
//
// Accuracy.  Each thread sums TBLK frames in f32 and adds the partial to
// an f64 accumulator, so the rounding error of the ~F-term sum stays at
// the level of a TBLK-term f32 sum (far inside the 1e-6 bound on
// C(t) = -0.5 + 1.5 s / (F - d) against a float64 reference).
//
// What bounds it.  FP32 FMA throughput: 4 FMA-class instructions per
// (t, d) term and B * sum_d (F - d) terms, about 5e10 instructions for
// 32 x 1024 bonds of 1000 frames, growing as F^2.  Shared-memory traffic
// is 6 loads per LAGS terms, below the FMA rate for LAGS = 8; device
// memory traffic is one read of the input.  Reading one bond per block is
// uncoalesced in layouts whose frame stride is large (the pretiled
// (nTiles, 3, F, 128) layout, or the (nRep, F, nRes, 3) chunk layout):
// neighbouring blocks share those sectors through L2.  A tensor-core DFT
// formulation and several bonds per block are later work.
//
// Addressing.  Bond b = (b / n_inner, b % n_inner) with element strides
// (s_outer, s_inner) and per-frame / per-component strides (s_t, s_c),
// so the contiguous (B, F, 3), the pretiled (nTiles, 3, F, 128) and the
// (nRep, F, nRes, 3) chunk layouts are all read in place.

#include <cuda_runtime.h>

namespace {

constexpr int LAGS = 8;   // consecutive lags per thread (register window)
constexpr int TBLK = 32;  // frames per f32 partial sum

__host__ __device__ inline int phys(int a) { return a + (a >> 5); }

__host__ __device__ inline int n_staged(int F) { return F + TBLK + LAGS; }

__host__ __device__ inline int plane_words(int F) {
  return phys(n_staged(F)) + 1;
}

__global__ void acf_lag_sums_kernel(const float* __restrict__ v,
                                    float* __restrict__ out, int B, int F,
                                    int D, int n_inner, long long s_outer,
                                    long long s_inner, long long s_t,
                                    long long s_c) {
  extern __shared__ float smem[];
  const int pw = plane_words(F);
  float* sx = smem;
  float* sy = smem + pw;
  float* sz = smem + 2 * pw;

  const int b = blockIdx.x;
  const long long base =
      (long long)(b / n_inner) * s_outer + (long long)(b % n_inner) * s_inner;
  const int ns = n_staged(F);
  for (int t = threadIdx.x; t < ns; t += blockDim.x) {
    float x = 0.f, y = 0.f, z = 0.f;
    if (t < F) {
      const float* p = v + base + (long long)t * s_t;
      x = p[0];
      y = p[s_c];
      z = p[2 * s_c];
    }
    const int q = phys(t);
    sx[q] = x;
    sy[q] = y;
    sz[q] = z;
  }
  __syncthreads();

  for (int lag_base = 1; lag_base <= D; lag_base += blockDim.x * LAGS) {
    const int lag0 = lag_base + threadIdx.x * LAGS;
    if (lag0 > D) continue;
    // Window: w[j] = v(t + lag0 + j) for the current frame t.
    float wx[LAGS], wy[LAGS], wz[LAGS];
#pragma unroll
    for (int j = 0; j < LAGS; ++j) {
      const int q = phys(lag0 + j);
      wx[j] = sx[q];
      wy[j] = sy[q];
      wz[j] = sz[q];
    }
    double acc[LAGS];
#pragma unroll
    for (int j = 0; j < LAGS; ++j) acc[j] = 0.0;

    // Frames of the thread's longest lag; later lags read zero partners
    // once t + d >= F.  Reads stay below n_staged(F) (see n_staged).
    const int n_t = F - lag0;
    for (int t0 = 0; t0 < n_t; t0 += TBLK) {
      float part[LAGS];
#pragma unroll
      for (int j = 0; j < LAGS; ++j) part[j] = 0.f;
      const int q0 = phys(t0);  // t0 % 32 == 0: frames t0..t0+31 are contiguous
#pragma unroll
      for (int u = 0; u < TBLK; ++u) {
        const float ax = sx[q0 + u], ay = sy[q0 + u], az = sz[q0 + u];
#pragma unroll
        for (int j = 0; j < LAGS; ++j) {
          float d = ax * wx[j];
          d = fmaf(ay, wy[j], d);
          d = fmaf(az, wz[j], d);
          part[j] = fmaf(d, d, part[j]);
        }
#pragma unroll
        for (int j = 0; j < LAGS - 1; ++j) {
          wx[j] = wx[j + 1];
          wy[j] = wy[j + 1];
          wz[j] = wz[j + 1];
        }
        const int qn = phys(t0 + u + lag0 + LAGS);
        wx[LAGS - 1] = sx[qn];
        wy[LAGS - 1] = sy[qn];
        wz[LAGS - 1] = sz[qn];
      }
#pragma unroll
      for (int j = 0; j < LAGS; ++j) acc[j] += (double)part[j];
    }
#pragma unroll
    for (int j = 0; j < LAGS; ++j) {
      const int d = lag0 + j;
      if (d <= D) out[(long long)(d - 1) * B + b] = (float)acc[j];
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs for F frames (mirrored by
// spinrelax_tpu_torch/ops/cuda_acf.py:smem_bytes).
inline int smem_bytes(int F) { return 3 * plane_words(F) * (int)sizeof(float); }

extern "C" {

// v: strided f32 bond vectors (see Addressing); out: (D, B) f32.
// Returns cudaGetLastError() after the launch.
int acf_lag_sums_f32(const float* v, float* out, int B, int F, int D,
                     int n_inner, long long s_outer, long long s_inner,
                     long long s_t, long long s_c, void* stream) {
  if (B <= 0 || D <= 0 || D >= F || n_inner <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        acf_lag_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  // Enough threads for all lags in one pass, in whole warps, at most 256.
  int threads = (D + LAGS - 1) / LAGS;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  acf_lag_sums_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      v, out, B, F, D, n_inner, s_outer, s_inner, s_t, s_c);
  return (int)cudaGetLastError();
}

}  // extern "C"

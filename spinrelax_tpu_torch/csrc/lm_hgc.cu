// Kernels B and C: per-iteration evaluation of the batched multi-exponential
// Levenberg-Marquardt fit, for Hopper (sm_90a).
//
// Replace the TPU kernels spinrelax_tpu/ops/pallas_lm.py:hgc (body
// _hgc_kernel) and pallas_lm.py:cost (body _cost_kernel).  For each problem
// b and the model
//
//     m(t) = S2 + sum_k C_k exp(-t / tau_k)    (S2 = 1 - sum_k C_k if fixed)
//     r(t) = (m(t) - y(t)) * isg(t)
//
// lm_hgc writes, lag sums over t, the packed upper triangle of J^T J (rows
// (i, j >= i) in row-major order), then J^T r, then 0.5 ||r||^2 -- the
// row layout of the TPU kernel's output -- and lm_cost writes 0.5 ||r||^2.
// The Jacobian columns are closed-form scalings of the K exponentials:
// (E_k or E_k - 1) * isg, C_k / tau_k^2 * t * E_k * isg, and isg for a free
// S2.  Parameters are rows of p (P, B): C_0..C_{K-1}, tau_0..tau_{K-1},
// (S2).  Operands are lag-major: y, isg (T, B) and dt (T,); out (rows, B).
// Lags with isg = 0 add nothing.
//
// Design.  One thread per problem, b the fastest index of every operand
// so loads coalesce; each thread loops over T with its (at most 55) sums
// in registers, templated on (K, s2_free) so every loop unrolls.  Sums run
// in f32 over blocks of TBLK lags and are then added to f32 totals (a
// two-level sum), keeping the rounding error of a T-term sum near that of
// a TBLK-term one.
//
// What bounds it.  Device-memory bandwidth: 8 bytes read per (t, b) for
// about 3K + P(P+3)/2 FMA-class operations and K expf.  At the forward's
// size (B = 1024 problems, T = 500 lags) only 1024 threads run and the
// launch overhead dominates; the (B, P, P) unpack and the P <= 9 Cholesky
// solve stay in PyTorch, as they stay in XLA on the TPU.

#include <cuda_runtime.h>

namespace {

constexpr int TBLK = 32;
constexpr int THREADS = 128;

template <int K, bool S2F>
struct Model {
  static constexpr int P = 2 * K + (S2F ? 1 : 0);
  static constexpr int NT = P * (P + 1) / 2;
  static constexpr int NH = NT + P + 1;

  // ninv = -1 / tau once per problem: one IEEE division per thread instead
  // of K per lag.
  float C[K], ninv[K], coef[K], S2;

  __device__ Model(const float* __restrict__ p, int B, int b) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      C[k] = p[(long long)k * B + b];
      const float tau = p[(long long)(K + k) * B + b];
      ninv[k] = -1.f / tau;
      coef[k] = C[k] / (tau * tau);
    }
    if (S2F) {
      S2 = p[(long long)(2 * K) * B + b];
    } else {
      S2 = 1.f;
#pragma unroll
      for (int k = 0; k < K; ++k) S2 -= C[k];
    }
  }

  // Residual at one lag; E receives the K exponentials.
  __device__ float residual(float d, float y, float is, float* E) const {
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      E[k] = expf(d * ninv[k]);
      m = fmaf(C[k], E[k], m);
    }
    return (S2 + m - y) * is;
  }
};

template <int K, bool S2F>
__global__ void __launch_bounds__(THREADS)
lm_hgc_kernel(const float* __restrict__ p, const float* __restrict__ y,
              const float* __restrict__ isg, const float* __restrict__ dt,
              float* __restrict__ out, int T, int B) {
  using M = Model<K, S2F>;
  constexpr int P = M::P, NT = M::NT, NH = M::NH;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const M mod(p, B, b);

  float tot[NH];
#pragma unroll
  for (int q = 0; q < NH; ++q) tot[q] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TBLK) {
    float part[NH];
#pragma unroll
    for (int q = 0; q < NH; ++q) part[q] = 0.f;
    const int t1 = min(T, t0 + TBLK);
    for (int t = t0; t < t1; ++t) {
      const float d = __ldg(dt + t);
      const long long o = (long long)t * B + b;
      const float is = __ldg(isg + o);
      float E[K];
      const float r = mod.residual(d, __ldg(y + o), is, E);
      float pl[P];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        pl[k] = (S2F ? E[k] : E[k] - 1.f) * is;
        pl[K + k] = mod.coef[k] * d * E[k] * is;
      }
      if (S2F) pl[P - 1] = is;
      int q = 0;
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = i; j < P; ++j, ++q) part[q] = fmaf(pl[i], pl[j], part[q]);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) part[NT + i] = fmaf(pl[i], r, part[NT + i]);
      part[NT + P] = fmaf(r, r, part[NT + P]);
    }
#pragma unroll
    for (int q = 0; q < NH; ++q) tot[q] += part[q];
  }
  tot[NH - 1] *= 0.5f;
#pragma unroll
  for (int q = 0; q < NH; ++q) out[(long long)q * B + b] = tot[q];
}

template <int K, bool S2F>
__global__ void __launch_bounds__(THREADS)
lm_cost_kernel(const float* __restrict__ p, const float* __restrict__ y,
               const float* __restrict__ isg, const float* __restrict__ dt,
               float* __restrict__ out, int T, int B) {
  using M = Model<K, S2F>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const M mod(p, B, b);
  float tot = 0.f;
  for (int t0 = 0; t0 < T; t0 += TBLK) {
    float part = 0.f;
    const int t1 = min(T, t0 + TBLK);
    for (int t = t0; t < t1; ++t) {
      const long long o = (long long)t * B + b;
      float E[K];
      const float r = mod.residual(__ldg(dt + t), __ldg(y + o), __ldg(isg + o), E);
      part = fmaf(r, r, part);
    }
    tot += part;
  }
  out[b] = 0.5f * tot;
}

template <template <int, bool> class Kern>
int launch(const float* p, const float* y, const float* isg, const float* dt,
           float* out, int T, int B, int K, int s2_free, cudaStream_t s) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS);
  switch (K * 2 + (s2_free ? 1 : 0)) {
    case 2: Kern<1, false>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 3: Kern<1, true>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 4: Kern<2, false>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 5: Kern<2, true>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 6: Kern<3, false>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 7: Kern<3, true>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 8: Kern<4, false>::run(grid, s, p, y, isg, dt, out, T, B); break;
    case 9: Kern<4, true>::run(grid, s, p, y, isg, dt, out, T, B); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int K, bool S2F>
struct Hgc {
  static void run(dim3 g, cudaStream_t s, const float* p, const float* y,
                  const float* isg, const float* dt, float* out, int T, int B) {
    lm_hgc_kernel<K, S2F><<<g, THREADS, 0, s>>>(p, y, isg, dt, out, T, B);
  }
};

template <int K, bool S2F>
struct Cost {
  static void run(dim3 g, cudaStream_t s, const float* p, const float* y,
                  const float* isg, const float* dt, float* out, int T, int B) {
    lm_cost_kernel<K, S2F><<<g, THREADS, 0, s>>>(p, y, isg, dt, out, T, B);
  }
};

}  // namespace

extern "C" {

// p (2K[+1], B), y/isg (T, B), dt (T,) f32 -> out (P(P+1)/2 + P + 1, B).
// Returns cudaGetLastError() after the launch.
int lm_hgc_f32(const float* p, const float* y, const float* isg,
               const float* dt, float* out, int T, int B, int K, int s2_free,
               void* stream) {
  return launch<Hgc>(p, y, isg, dt, out, T, B, K, s2_free,
                     (cudaStream_t)stream);
}

// Same operands -> out (B,) = 0.5 ||r||^2.
int lm_cost_f32(const float* p, const float* y, const float* isg,
                const float* dt, float* out, int T, int B, int K, int s2_free,
                void* stream) {
  return launch<Cost>(p, y, isg, dt, out, T, B, K, s2_free,
                      (cudaStream_t)stream);
}

}  // extern "C"

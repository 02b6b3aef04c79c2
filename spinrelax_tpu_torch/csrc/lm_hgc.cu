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
// lm_hgc writes, lag sums over t, H = J^T J whole and symmetric (B, P, P),
// then g = J^T r (B, P), then 0.5 ||r||^2 (B,), problem-major, into one
// buffer -- what pallas_lm.hgc returns after its unpack -- and lm_cost
// writes 0.5 ||r||^2 (B,).  The Jacobian columns are closed-form scalings
// of the K exponentials: (E_k or E_k - 1) * isg, C_k / tau_k^2 * t * E_k *
// isg, and isg for a free S2.  Parameters are rows of p (P, B):
// C_0..C_{K-1}, tau_0..tau_{K-1}, (S2).  Operands are lag-major: y, isg
// (T, B) and dt (T,).  Lags with isg = 0 add nothing.
//
// What bounds it.  8 bytes of y and isg per (t, b) for about 3K + P(P+3)/2
// FMA-class operations and K expf: the bytes, at the forward's B = 1024,
// T = 500 (4.1 MB, 1.2 us at 3.35 TB/s), and they stay in the 50 MB L2
// across the LM's iterations; there the practical floor is launch latency
// and the latency of one pass of dependent loads.  At a ladder rung
// (B = 10 000, K = 4) the 40 MB and ~145 flop per (t, b) bound it alike;
// there lm_hgc takes about lm_cost's time plus its FMAs at the issue rate,
// so its short-lived blocks overlap loads and arithmetic poorly.
//
// Design.  A block takes a tile of TILE = 8 consecutive problems (one
// 32-byte sector of a lag row) and all lags; its threads are NS lag slices
// x 8 problems, slice s taking lags s, s + NS, ... in order, so a warp's
// load covers 4 lag rows x 8 problems = 4 whole sectors and each thread
// walks T / NS lags instead of T.  At B = 1024 that is 128 blocks for the
// card's 132 SMs.  dt is staged per TCHUNK lags in shared memory.  The up
// to 55 sums stay in registers, in f32, templated on (K, s2_free) so every
// loop unrolls.  Slices reduce in a fixed order -- two xor shuffles inside
// a warp, then a fixed pairwise tree over the warps in shared memory, no
// atomics -- so results are bitwise reproducible.  lm_cost is the same
// template with only the r^2 sum, reduced along the same path, so for
// equal p its cost equals lm_hgc's bit for bit (the LM's accept gate
// compares the two).  The epilogue writes H, g and cost straight from the
// reduction, in the layout the engine consumes.
//
// Tiling, chosen on an H100 (times in PERF.md): NS = 32 (256 threads) for
// K <= 2; NS = 16 (128 threads) for K >= 3, whose up to 55 sums need more
// registers (ptxas: lm_hgc 58 at K = 2 S2 free, 96 at K = 4 S2 free;
// lm_cost 40; no spills).  Loads are not software-pipelined: prefetching
// 2 to 8 lags ahead slowed the forward's shape.
//
// K = 5..K_MAX (lm_kernel_wide).  Up to P = 33 parameters give 594 sums
// per problem: no thread can hold them in registers.  A block still takes
// TILE problems and 32 lag slices (256 threads), and walks the lags in
// chunks of WCHUNK = 32: each thread evaluates one (lag, problem) --
// residual and Jacobian row, the same arithmetic as Model -- adds r^2 to
// its own f32 sum, and writes the row, widened to f64, into a
// shared-memory tile J[lag][column][problem] (column P is r).  Then each
// thread adds its slots of the packed upper triangle of J^T J and J^T r
// over the chunk's lags, in lag order, in f64 (a product of two floats is
// exact there); a thread runs only the ns = ceil(sums x TILE / 256) slots
// that are live at this P (3 at K = 5), the same count for every thread.
// Every H and g sum has one owner thread and one order; the r^2 sums
// reduce across slices by the narrow template's fixed path, and lm_cost's
// wide variant is the same code without the tile, so its cost equals
// lm_hgc's bit for bit and relaunches repeat bit for bit.  The tile takes
// 2 KB a column (up to 70 KB at P = 33, dynamic shared memory).  Times in
// PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8;       // problems per block
constexpr int TCHUNK = 1024;  // lags of dt in shared memory at a time
constexpr int K_NARROW = 4;   // lm_kernel instantiated for K = 1..K_NARROW
constexpr int K_MAX = 16;     // lm_kernel_wide takes K = K_NARROW+1..K_MAX
constexpr int WTHREADS = 256;  // lm_kernel_wide: threads per block
constexpr int WCHUNK = WTHREADS / TILE;  // lm_kernel_wide: lags per chunk

__host__ __device__ constexpr int n_slices(int K) { return K <= 2 ? 32 : 16; }

template <int K, bool S2F>
struct Model {
  static constexpr int P = 2 * K + (S2F ? 1 : 0);
  static constexpr int NT = P * (P + 1) / 2;

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

  // Residual at one lag; E receives the K exponentials.  The _rn
  // intrinsics are never contracted, so both kernels round it alike.
  __device__ float residual(float d, float y, float is, float* E) const {
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      E[k] = expf(__fmul_rn(d, ninv[k]));
      m = fmaf(C[k], E[k], m);
    }
    return __fmul_rn(__fsub_rn(__fadd_rn(S2, m), y), is);
  }
};

// FULL: lm_hgc's NT + P + 1 sums; otherwise lm_cost's one.  The r^2 sum is
// always the last.
template <int K, bool S2F, bool FULL>
__global__ void __launch_bounds__(n_slices(K) * TILE)
lm_kernel(const float* __restrict__ p, const float* __restrict__ y,
          const float* __restrict__ isg, const float* __restrict__ dt,
          float* __restrict__ out, int T, int B) {
  using M = Model<K, S2F>;
  constexpr int P = M::P, NT = M::NT;
  constexpr int NA = FULL ? NT + P + 1 : 1;
  constexpr int NS = n_slices(K), NTHR = NS * TILE, NW = NTHR / 32;
  __shared__ float sdt[TCHUNK];
  __shared__ float red[NW][NA][TILE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = threadIdx.x / TILE;
  const int b0 = blockIdx.x * TILE, b = b0 + threadIdx.x % TILE;
  const bool live = b < B;
  const M mod(p, B, live ? b : b0);

  float acc[NA];
#pragma unroll
  for (int q = 0; q < NA; ++q) acc[q] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TCHUNK) {
    const int n = min(TCHUNK, T - t0);
    __syncthreads();  // the previous chunk's dt is read
    for (int i = threadIdx.x; i < n; i += NTHR) sdt[i] = __ldg(dt + t0 + i);
    __syncthreads();
    if (live) {
      const float* yc = y + (long long)t0 * B + b;
      const float* ic = isg + (long long)t0 * B + b;
#pragma unroll 4
      for (int t = slice; t < n; t += NS) {
        const long long o = (long long)t * B;
        const float d = sdt[t], is = __ldg(ic + o);
        float E[K];
        const float r = mod.residual(d, __ldg(yc + o), is, E);
        if constexpr (FULL) {
          float jc[P];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            jc[k] = (S2F ? E[k] : E[k] - 1.f) * is;
            jc[K + k] = mod.coef[k] * d * E[k] * is;
          }
          if constexpr (S2F) jc[P - 1] = is;
          int q = 0;
#pragma unroll
          for (int i = 0; i < P; ++i) {
#pragma unroll
            for (int j = i; j < P; ++j, ++q) acc[q] = fmaf(jc[i], jc[j], acc[q]);
          }
#pragma unroll
          for (int i = 0; i < P; ++i) acc[NT + i] = fmaf(jc[i], r, acc[NT + i]);
        }
        acc[NA - 1] = fmaf(r, r, acc[NA - 1]);
      }
    }
  }

  // Slices -> one sum per problem.  Lanes l, l ^ 8, l ^ 16, l ^ 24 of a warp
  // hold one problem; after two xor shuffles each holds the same sum.
#pragma unroll
  for (int q = 0; q < NA; ++q) {
    float v = acc[q];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < TILE) red[warp][q][lane] = v;
  }
  __syncthreads();
  // Warps -> the block, by the same fixed pairwise tree for every sum.
  float* fin = &red[0][0][0];  // fin[q * TILE + problem] once reduced
  for (int e = threadIdx.x; e < NA * TILE; e += NTHR) {
    float s[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) s[w] = (&red[w][0][0])[e];
#pragma unroll
    for (int h = NW / 2; h > 0; h /= 2) {
#pragma unroll
      for (int w = 0; w < h; ++w) s[w] += s[w + h];
    }
    fin[e] = s[0];  // only this thread reads column e
  }
  __syncthreads();

  const int nb = min(TILE, B - b0);
  if constexpr (FULL) {
    float* H = out + (long long)b0 * P * P;
    for (int e = threadIdx.x; e < nb * P * P; e += NTHR) {
      const int i = e / P % P, j = e % P;
      const int lo = min(i, j), hi = max(i, j);  // packed upper-triangle row
      H[e] = fin[(lo * P - lo * (lo - 1) / 2 + hi - lo) * TILE + e / (P * P)];
    }
    float* g = out + (long long)B * P * P + (long long)b0 * P;
    for (int e = threadIdx.x; e < nb * P; e += NTHR)
      g[e] = fin[(NT + e % P) * TILE + e / P];
    out += (long long)B * P * (P + 1);
  }
  if (threadIdx.x < nb) out[b0 + threadIdx.x] = 0.5f * fin[(NA - 1) * TILE + threadIdx.x];
}

// Columns of lm_kernel_wide's Jacobian tile: P + 1 (r last), rounded up to
// odd, so a warp's tile writes (4 lags x 8 problems) spread over the banks.
__host__ __device__ constexpr int wide_cols(int P) { return (P + 1) | 1; }
// Bytes of that f64 tile: WCHUNK lags x wide_cols(P) columns x TILE problems.
__host__ __device__ constexpr int wide_smem(int P) {
  return WCHUNK * wide_cols(P) * TILE * (int)sizeof(double);
}
constexpr int P_MAX = 2 * K_MAX + 1;
// J^T J's packed upper triangle and J^T r (r.r is summed apart).
__host__ __device__ constexpr int wide_sums(int P) { return (P + 1) * (P + 2) / 2 - 1; }
constexpr int WSUMS = (wide_sums(P_MAX) * TILE + WTHREADS - 1) / WTHREADS;  // slots a thread has
constexpr int WWARPS = WTHREADS / 32;

// K = K_NARROW+1..K_MAX, S2 free or fixed, at run time (see the header).
// FULL: lm_hgc's sums; otherwise lm_cost's r.r alone.
template <bool FULL>
__global__ void __launch_bounds__(WTHREADS)
lm_kernel_wide(const float* __restrict__ p, const float* __restrict__ y,
               const float* __restrict__ isg, const float* __restrict__ dt,
               float* __restrict__ out, int T, int B, int K, bool s2f) {
  extern __shared__ double J[];  // FULL: J[(lag * ncol + column) * TILE + problem]
  __shared__ float sC[K_MAX][TILE], sninv[K_MAX][TILE], scoef[K_MAX][TILE], sS2[TILE];
  __shared__ float red[WWARPS][TILE];
  const int P = 2 * K + (s2f ? 1 : 0);
  const int ncol = wide_cols(P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * TILE;

  // The tile's parameters, as Model computes them (a problem past B reads
  // the tile's first, and its sums are not written).
  if (tid < TILE) {
    const int b = min(b0 + tid, B - 1);
    float S2 = 1.f;
    for (int k = 0; k < K; ++k) {
      const float C = p[(long long)k * B + b];
      const float tau = p[(long long)(K + k) * B + b];
      sC[k][tid] = C;
      sninv[k][tid] = -1.f / tau;
      scoef[k][tid] = C / (tau * tau);
      S2 -= C;
    }
    sS2[tid] = s2f ? p[(long long)(2 * K) * B + b] : S2;
  }

  // FULL: the slots of this thread.  Item e = tid + m * WTHREADS is problem
  // e % TILE and entry e / TILE of the packed upper triangle over columns
  // 0..P less (P, P), held as the two tile offsets (i * TILE + problem,
  // j * TILE + problem) packed into one int.  Only the first ns slots are
  // live (ns is the same for every thread, so the loops below leave in
  // step); items past the triangle read offset 0 and are not written.
  const int nq = wide_sums(P) * TILE;
  const int ns = FULL ? (nq + WTHREADS - 1) / WTHREADS : 0;
  int offs[WSUMS];
  double acc[WSUMS];
#pragma unroll
  for (int m = 0; m < WSUMS; ++m) {
    const int e = tid + m * WTHREADS;
    acc[m] = 0.0;
    offs[m] = 0;
    if (m < ns && e < nq) {
      const int pr = e % TILE;
      int q = e / TILE, i = 0;
      while (q >= P + 1 - i) {
        q -= P + 1 - i;
        ++i;
      }
      offs[m] = (i * TILE + pr) | (((i + q) * TILE + pr) << 16);
    }
  }

  // Thread (lag slice l, problem pr) evaluates lags l, l + WCHUNK, ... in
  // order: its r^2 sum (the cost, in both kernels alike) and, FULL, the
  // chunk's Jacobian row into the tile.
  const int l = tid / TILE, pr = tid % TILE, b = b0 + pr;
  float rr = 0.f;
  for (int t0 = 0; t0 < T; t0 += WCHUNK) {
    if (FULL || t0 == 0) __syncthreads();  // parameters staged; the last chunk summed
    const int t = t0 + l;
    double* row = J + l * ncol * TILE + pr;
    if (t < T && b < B) {
      const float d = __ldg(dt + t);
      const float is = __ldg(isg + (long long)t * B + b);
      const float yv = __ldg(y + (long long)t * B + b);
      float m = 0.f;
      for (int k = 0; k < K; ++k) {
        const float E = expf(__fmul_rn(d, sninv[k][pr]));
        m = fmaf(sC[k][pr], E, m);
        if (FULL) {
          row[k * TILE] = (s2f ? E : E - 1.f) * is;
          row[(K + k) * TILE] = scoef[k][pr] * d * E * is;
        }
      }
      const float r = __fmul_rn(__fsub_rn(__fadd_rn(sS2[pr], m), yv), is);
      rr = fmaf(r, r, rr);
      if (FULL) {
        if (s2f) row[(P - 1) * TILE] = is;
        row[P * TILE] = r;
      }
    } else if (FULL) {
      for (int c = 0; c <= P; ++c) row[c * TILE] = 0.0;
    }
    if (FULL) {
      __syncthreads();
      const int n = min(WCHUNK, T - t0);
      for (int u = 0; u < n; ++u) {
        const double* ru = J + u * ncol * TILE;
#pragma unroll
        for (int m = 0; m < WSUMS; ++m) {
          if (m >= ns) break;
          acc[m] = fma(ru[offs[m] & 0xffff], ru[offs[m] >> 16], acc[m]);
        }
      }
    }
  }

  // The cost: lag slices -> one sum per problem, by the narrow template's
  // path (two xor shuffles, then a fixed pairwise tree over the warps).
  float v = rr;
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  if (lane < TILE) red[warp][lane] = v;
  __syncthreads();
  if (tid < TILE && b0 + tid < B) {
    float s[WWARPS];
#pragma unroll
    for (int w = 0; w < WWARPS; ++w) s[w] = red[w][tid];
#pragma unroll
    for (int h = WWARPS / 2; h > 0; h /= 2) {
#pragma unroll
      for (int w = 0; w < h; ++w) s[w] += s[w + h];
    }
    out[(FULL ? (long long)B * P * (P + 1) : 0) + b0 + tid] = 0.5f * s[0];
  }

  // Each owned sum straight out: H both halves, g.
  if constexpr (FULL) {
#pragma unroll
    for (int m = 0; m < WSUMS; ++m) {
      if (m >= ns) break;
      const int e = tid + m * WTHREADS;
      const int bo = b0 + e % TILE;
      if (e >= nq || bo >= B) continue;
      const int i = (offs[m] & 0xffff) / TILE, j = (offs[m] >> 16) / TILE;
      if (j < P) {
        out[(long long)bo * P * P + i * P + j] = (float)acc[m];
        out[(long long)bo * P * P + j * P + i] = (float)acc[m];
      } else {
        out[(long long)B * P * P + (long long)bo * P + i] = (float)acc[m];
      }
    }
  }
}

template <int K, bool S2F, bool FULL>
void run(const float* p, const float* y, const float* isg, const float* dt,
         float* out, int T, int B, cudaStream_t s) {
  lm_kernel<K, S2F, FULL><<<(B + TILE - 1) / TILE, n_slices(K) * TILE, 0, s>>>(
      p, y, isg, dt, out, T, B);
}

template <bool FULL>
int launch(const float* p, const float* y, const float* isg, const float* dt,
           float* out, int T, int B, int K, int s2_free, cudaStream_t s) {
  if (B <= 0 || T <= 0 || K < 1 || K > K_MAX) return (int)cudaErrorInvalidValue;
  if (K > K_NARROW) {
    const int smem = FULL ? wide_smem(2 * K + (s2_free ? 1 : 0)) : 0;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lm_kernel_wide<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    lm_kernel_wide<FULL><<<(B + TILE - 1) / TILE, WTHREADS, smem, s>>>(
        p, y, isg, dt, out, T, B, K, s2_free != 0);
    return (int)cudaGetLastError();
  }
  switch (K * 2 + (s2_free ? 1 : 0)) {
    case 2: run<1, false, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 3: run<1, true, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 4: run<2, false, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 5: run<2, true, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 6: run<3, false, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 7: run<3, true, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 8: run<4, false, FULL>(p, y, isg, dt, out, T, B, s); break;
    case 9: run<4, true, FULL>(p, y, isg, dt, out, T, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p (2K[+1], B), y/isg (T, B), dt (T,) f32 -> out (B * (P^2 + P + 1),):
// H (B, P, P), then g (B, P), then cost (B,).  Returns cudaGetLastError()
// after the launch.
int lm_hgc_f32(const float* p, const float* y, const float* isg,
               const float* dt, float* out, int T, int B, int K, int s2_free,
               void* stream) {
  return launch<true>(p, y, isg, dt, out, T, B, K, s2_free, (cudaStream_t)stream);
}

// Same operands -> out (B,) = 0.5 ||r||^2.
int lm_cost_f32(const float* p, const float* y, const float* isg,
                const float* dt, float* out, int T, int B, int K, int s2_free,
                void* stream) {
  return launch<false>(p, y, isg, dt, out, T, B, K, s2_free, (cudaStream_t)stream);
}

}  // extern "C"

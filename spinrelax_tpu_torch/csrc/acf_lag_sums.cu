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
// What bounds it.  FP32 issue: each (t, d) term is 4 FMA-class
// instructions (a 3-term dot and its square added in), and there are
// B * sum_d (F - d) terms: 1.228e10 terms, 1.283 ms at 67 TFLOP/s for the
// forward's 32 x 1024 bonds of 1000 frames (D = 500).  Device memory
// traffic is one read of the input and one write of the output (0.14 ms).
//
// Design.
//  * Register windows.  A thread keeps LAGS consecutive partner vectors
//    v(t + d) in registers as a sliding window: per frame it reads v(t)
//    (a shared-memory broadcast) and ONE new partner, then does the LAGS
//    terms.  A pad word every 32 words (phys) makes the LAGS-strided
//    partner reads of a warp hit 32 distinct banks.
//  * The folded lag triangle.  Window i (lags 8i+1..8i+8) walks F - 8i - 1
//    frames, so threads owning one window each would walk from F down to
//    F - D.  Instead thread p owns window p AND window nW - 1 - p, walked
//    one after the other in one loop (so the warp stays converged): every
//    thread walks ~2F - D frames, for any D.  An odd nW leaves the middle
//    window alone.  At D = 500 a bond is one warp of 32 threads.  Every
//    lag still belongs to exactly one thread: no reduction across threads.
//  * Several bonds per block.  nb bonds (a power of two up to NB_MAX,
//    chosen by the launch plan from F and D) share one block, each with
//    its own bank-padded x/y/z planes, zero-filled past F so that no term
//    needs a bounds test.
//  * Coalesced staging.  The block reads its nb bonds x 3 components x F
//    frames with the dimension of smallest stride fastest (components and
//    frames for the contiguous (B, F, 3) layout, bonds for the chunk and
//    pretiled layouts), STAGE_UNROLL independent loads in flight a thread.
//  * Coalesced stores.  The results pass through a (D, nb) tile in the
//    block's planes (dead once every thread has walked its windows) and
//    leave as rows of nb consecutive floats per lag.
//  * More than MAX_THREADS / 32 warps of pairs (D > 8184) are walked in
//    rounds; a round before the last stores straight from registers.
//
// Accuracy.  Each thread sums TBLK frames in f32 and adds the partial to
// an f64 accumulator, so the rounding error of the ~F-term sum stays at
// the level of a TBLK-term f32 sum (far inside the 1e-6 bound on
// C(t) = -0.5 + 1.5 s / (F - d) against a float64 reference).  The order
// of every sum is fixed: launches repeat bit for bit.
//
// Addressing.  Bond b = (b / n_inner, b % n_inner) with element strides
// (s_outer, s_inner) and per-frame / per-component strides (s_t, s_c),
// so the contiguous (B, F, 3), the pretiled (nTiles, 3, F, 128) and the
// (nRep, F, nRes, 3) chunk layouts are all read in place.
//
// The launch plan (nb, threads, shared bytes) is computed by
// spinrelax_tpu_torch/ops/cuda_acf.py:launch_plan and checked here.
//
// Long chunks (the slab plan).  A bond whose three planes do not fit in
// one block's shared memory (F > 18 743 at D = F / 2) goes to
// acf_lag_sums_slab_kernel instead: a block owns one bond and one block of
// SLAB_LAGS lags d0..d0+SLAB_LAGS-1 (LAGS per thread, register windows as
// above), and walks the frames in slabs of SLAB: for each slab t0 it
// stages frames [t0, t0 + SLAB) and the partners [t0 + d0, t0 + d0 + SLAB
// + SLAB_LAGS) (zero past F), then every thread adds its terms.  Partial
// sums are the same TBLK-frame f32 blocks into f64, added slab after slab
// in one fixed order, so launches repeat bit for bit here too.  This plan
// is written to be right for any 1 <= D < F, not fast: it reads each
// bond's frames once per lag block.

#include <cuda_runtime.h>

#include <cstdlib>

namespace {

constexpr int LAGS = 8;           // consecutive lags per thread (register window)
constexpr int TBLK = 32;          // frames per f32 partial sum
constexpr int NB_MAX = 4;         // bonds per block at most (4 timed fastest of 1, 2, 4, 8)
constexpr int MAX_THREADS = 512;  // threads per block (launch bounds: <= 128 registers)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may use
constexpr int STAGE_UNROLL = 8;   // independent staging loads per thread
constexpr int SLAB_THREADS = 128; // slab plan: threads per block
constexpr int SLAB = 512;         // slab plan: frames per slab (a multiple of TBLK)
constexpr int SLAB_LAGS = LAGS * SLAB_THREADS;  // slab plan: lags per block

__host__ __device__ inline int phys(int a) { return a + (a >> 5); }

__host__ __device__ inline int n_staged(int F) { return F + TBLK + LAGS; }

__host__ __device__ inline int plane_words(int F) {
  return phys(n_staged(F)) + 1;
}

__host__ __device__ inline int n_windows(int D) { return (D + LAGS - 1) / LAGS; }

// Threads per bond: one per window pair, in whole warps, at most MAX_THREADS.
inline int bond_threads(int D) {
  const int t = ((n_windows(D) + 1) / 2 + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// Dynamic shared memory of a block of nb bonds: nb bond offsets (8 bytes
// each), then 3 planes per bond.
inline long long smem_bytes(int F, int nb) {
  return (long long)nb * (8 + 3LL * plane_words(F) * (long long)sizeof(float));
}

__device__ __forceinline__ void load_window(const float* sx, const float* sy,
                                            const float* sz, int lag0,
                                            float (&wx)[LAGS], float (&wy)[LAGS],
                                            float (&wz)[LAGS]) {
#pragma unroll
  for (int j = 0; j < LAGS; ++j) {
    const int q = phys(lag0 + j);
    wx[j] = sx[q];
    wy[j] = sy[q];
    wz[j] = sz[q];
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    acf_lag_sums_kernel(const float* __restrict__ v, float* __restrict__ out,
                        int B, int F, int D, int n_inner, long long s_outer,
                        long long s_inner, long long s_t, long long s_c, int nb,
                        int pos_slot, int pos_c) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  long long* base = reinterpret_cast<long long*>(smem_raw);
  float* planes = reinterpret_cast<float*>(base + nb);
  const int pw = plane_words(F);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * nb;

  // Element offset of each bond of the block; -1 past B (staged as zeros).
  if (tid < nb) {
    const int b = b0 + tid;
    base[tid] = b < B ? (long long)(b / n_inner) * s_outer +
                            (long long)(b % n_inner) * s_inner
                      : -1;
  }
  // Zero frames F..n_staged(F)-1 of every plane: partners past the chunk.
  const int n_pad = n_staged(F) - F;
  for (int e = tid; e < 3 * nb * n_pad; e += nthr)
    planes[(e / n_pad) * pw + phys(F + e % n_pad)] = 0.f;
  __syncthreads();

  // Stage (bond slot, component, frame), position 0 fastest: the host
  // orders the three by stride, so neighbouring threads read neighbouring
  // addresses.
  const int pos_t = 3 - pos_slot - pos_c;
  const int n0 = pos_slot == 0 ? nb : (pos_c == 0 ? 3 : F);
  const int n1 = pos_slot == 1 ? nb : (pos_c == 1 ? 3 : F);
  const int n_el = 3 * nb * F;
  for (int e0 = tid; e0 < n_el; e0 += STAGE_UNROLL * nthr) {
    float val[STAGE_UNROLL];
    int dst[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int e = e0 + u * nthr;
      val[u] = 0.f;
      dst[u] = -1;
      if (e < n_el) {
        const int i0 = e % n0, r = e / n0, i1 = r % n1, i2 = r / n1;
        const int slot = pos_slot == 0 ? i0 : (pos_slot == 1 ? i1 : i2);
        const int c = pos_c == 0 ? i0 : (pos_c == 1 ? i1 : i2);
        const int t = pos_t == 0 ? i0 : (pos_t == 1 ? i1 : i2);
        const long long off = base[slot];
        dst[u] = (slot * 3 + c) * pw + phys(t);
        if (off >= 0) val[u] = __ldg(v + off + (long long)t * s_t + (long long)c * s_c);
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u)
      if (dst[u] >= 0) planes[dst[u]] = val[u];
  }
  __syncthreads();

  const int bt = nthr / nb;  // threads per bond, whole warps
  const int slot = tid / bt;
  const int j = tid % bt;
  const int b = b0 + slot;
  const float* sx = planes + slot * 3 * pw;
  const float* sy = sx + pw;
  const float* sz = sy + pw;
  const int nW = n_windows(D);
  const int nP = (nW + 1) / 2;

  // Sums of the thread's two windows (first lags lag_a, lag_b; 0: none).
  float ra[LAGS], rb[LAGS];
  int lag_a = 0, lag_b = 0;
  for (int p0 = 0; p0 < nP; p0 += bt) {
    // A round before the last stores its sums straight from registers.
#pragma unroll
    for (int k = 0; k < LAGS; ++k) {
      if (lag_a > 0 && lag_a + k <= D && b < B) out[(long long)(lag_a + k - 1) * B + b] = ra[k];
      if (lag_b > 0 && lag_b + k <= D && b < B) out[(long long)(lag_b + k - 1) * B + b] = rb[k];
    }
    const int p = p0 + j;
    int n_a = 0, n_b = 0;
    lag_a = lag_b = 0;
    if (p < nP) {
      lag_a = 1 + LAGS * p;
      n_a = (F - lag_a + TBLK - 1) / TBLK;
      if (nW - 1 - p != p) {
        lag_b = 1 + LAGS * (nW - 1 - p);
        n_b = (F - lag_b + TBLK - 1) / TBLK;
      }
    }
    // Window: w[k] = v(t + lag0 + k) for the current frame t.
    float wx[LAGS], wy[LAGS], wz[LAGS];
    double acc[LAGS];
    int lag0 = lag_a;
    load_window(sx, sy, sz, lag0, wx, wy, wz);
#pragma unroll
    for (int k = 0; k < LAGS; ++k) acc[k] = 0.0;
    // Frames of each window's first lag in TBLK blocks; later lags read
    // zero partners once t + d >= F.  Reads stay below n_staged(F).
    int t0 = 0;
    for (int kb = 0; kb < n_a + n_b; ++kb) {
      if (kb == n_a) {  // window A done: keep its sums, start window B at t = 0
#pragma unroll
        for (int k = 0; k < LAGS; ++k) {
          ra[k] = (float)acc[k];
          acc[k] = 0.0;
        }
        lag0 = lag_b;
        t0 = 0;
        load_window(sx, sy, sz, lag0, wx, wy, wz);
      }
      float part[LAGS];
#pragma unroll
      for (int k = 0; k < LAGS; ++k) part[k] = 0.f;
      const int q0 = phys(t0);  // t0 % 32 == 0: frames t0..t0+31 are contiguous
#pragma unroll
      for (int u = 0; u < TBLK; ++u) {
        const float ax = sx[q0 + u], ay = sy[q0 + u], az = sz[q0 + u];
#pragma unroll
        for (int k = 0; k < LAGS; ++k) {
          float d = ax * wx[k];
          d = fmaf(ay, wy[k], d);
          d = fmaf(az, wz[k], d);
          part[k] = fmaf(d, d, part[k]);
        }
#pragma unroll
        for (int k = 0; k < LAGS - 1; ++k) {
          wx[k] = wx[k + 1];
          wy[k] = wy[k + 1];
          wz[k] = wz[k + 1];
        }
        const int qn = phys(t0 + u + lag0 + LAGS);
        wx[LAGS - 1] = sx[qn];
        wy[LAGS - 1] = sy[qn];
        wz[LAGS - 1] = sz[qn];
      }
#pragma unroll
      for (int k = 0; k < LAGS; ++k) acc[k] += (double)part[k];
      t0 += TBLK;
    }
#pragma unroll
    for (int k = 0; k < LAGS; ++k) {
      if (n_b > 0)
        rb[k] = (float)acc[k];
      else
        ra[k] = (float)acc[k];
    }
  }

  // The last round's sums (its pairs own windows p_last..nW-1-p_last, so
  // lags d_lo..d_hi) through a (D, nb) tile in the dead planes, then out
  // as rows of nb consecutive floats per lag.
  const int p_last = (nP - 1) / bt * bt;
  const int d_lo = 1 + LAGS * p_last;
  const int d_hi = min(D, LAGS * (nW - p_last));
  __syncthreads();
  float* tile = planes;
#pragma unroll
  for (int k = 0; k < LAGS; ++k) {
    if (lag_a > 0 && lag_a + k <= D) tile[phys((lag_a + k - 1) * nb + slot)] = ra[k];
    if (lag_b > 0 && lag_b + k <= D) tile[phys((lag_b + k - 1) * nb + slot)] = rb[k];
  }
  __syncthreads();
  for (int i = (d_lo - 1) * nb + tid; i < d_hi * nb; i += nthr) {
    const int bb = b0 + i % nb;
    if (bb < B) out[(long long)(i / nb) * B + bb] = tile[phys(i)];
  }
}

// Slab plan: words of the partner planes (frames t0 + d0 .. t0 + d0 + SLAB
// + SLAB_LAGS - 1, bank padded) and the block's dynamic shared memory (three
// unpadded SLAB-frame planes, then three partner planes).
__host__ __device__ inline int slab_partner_words() {
  return phys(SLAB + SLAB_LAGS) + 1;
}

inline long long slab_smem_bytes() {
  return 3LL * (SLAB + slab_partner_words()) * (long long)sizeof(float);
}

__global__ void __launch_bounds__(SLAB_THREADS)
    acf_lag_sums_slab_kernel(const float* __restrict__ v, float* __restrict__ out,
                             int B, int F, int D, int n_inner, long long s_outer,
                             long long s_inner, long long s_t, long long s_c) {
  extern __shared__ float slab_smem[];
  const int pw = slab_partner_words();
  float* a_planes = slab_smem;               // 3 x SLAB: v(t0 + u)
  float* b_planes = slab_smem + 3 * SLAB;    // 3 x pw: v(t0 + d0 + u), padded
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int d0 = 1 + blockIdx.y * SLAB_LAGS;  // first lag of the block
  const int off = LAGS * tid;                 // thread's first lag is d0 + off
  const int lag0 = d0 + off;
  const long long base =
      (long long)(b / n_inner) * s_outer + (long long)(b % n_inner) * s_inner;
  const int t_end = F - d0;  // frames t with a partner t + d0 < F
  constexpr int NB = SLAB + SLAB_LAGS;

  double acc[LAGS];
#pragma unroll
  for (int k = 0; k < LAGS; ++k) acc[k] = 0.0;
  for (int t0 = 0; t0 < t_end; t0 += SLAB) {
    __syncthreads();  // the previous slab is read
    for (int e = tid; e < 3 * SLAB; e += SLAB_THREADS) {
      const int c = e / SLAB, u = e % SLAB, t = t0 + u;
      a_planes[e] = t < F ? __ldg(v + base + (long long)t * s_t + (long long)c * s_c) : 0.f;
    }
    for (int e = tid; e < 3 * NB; e += SLAB_THREADS) {
      const int c = e / NB, u = e % NB;
      const long long t = (long long)t0 + d0 + u;
      b_planes[c * pw + phys(u)] =
          t < F ? __ldg(v + base + t * s_t + (long long)c * s_c) : 0.f;
    }
    __syncthreads();
    if (lag0 > D) continue;
    // TBLK blocks of this slab that hold frames t < F - lag0 (the thread's
    // first lag); later lags of the window read zero partners past F.
    const int n_left = F - lag0 - t0;
    const int n_blk = min(SLAB / TBLK, max(0, (n_left + TBLK - 1) / TBLK));
    const float* sx = b_planes;
    const float* sy = sx + pw;
    const float* sz = sy + pw;
    float wx[LAGS], wy[LAGS], wz[LAGS];
    load_window(sx, sy, sz, off, wx, wy, wz);
    for (int kb = 0; kb < n_blk; ++kb) {
      float part[LAGS];
#pragma unroll
      for (int k = 0; k < LAGS; ++k) part[k] = 0.f;
#pragma unroll
      for (int u = 0; u < TBLK; ++u) {
        const int uu = kb * TBLK + u;
        const float ax = a_planes[uu], ay = a_planes[SLAB + uu],
                    az = a_planes[2 * SLAB + uu];
#pragma unroll
        for (int k = 0; k < LAGS; ++k) {
          float d = ax * wx[k];
          d = fmaf(ay, wy[k], d);
          d = fmaf(az, wz[k], d);
          part[k] = fmaf(d, d, part[k]);
        }
#pragma unroll
        for (int k = 0; k < LAGS - 1; ++k) {
          wx[k] = wx[k + 1];
          wy[k] = wy[k + 1];
          wz[k] = wz[k + 1];
        }
        const int qn = phys(uu + off + LAGS);
        wx[LAGS - 1] = sx[qn];
        wy[LAGS - 1] = sy[qn];
        wz[LAGS - 1] = sz[qn];
      }
#pragma unroll
      for (int k = 0; k < LAGS; ++k) acc[k] += (double)part[k];
    }
  }
#pragma unroll
  for (int k = 0; k < LAGS; ++k)
    if (lag0 + k <= D) out[(long long)(lag0 + k - 1) * B + b] = (float)acc[k];
}

}  // namespace

extern "C" {

// v: strided f32 bond vectors (see Addressing); out: (D, B) f32.
// (nb, threads, smem): the launch plan of ops/cuda_acf.py:launch_plan for
// (F, D); anything inconsistent returns cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch.
int acf_lag_sums_f32(const float* v, float* out, int B, int F, int D,
                     int n_inner, long long s_outer, long long s_inner,
                     long long s_t, long long s_c, int nb, int threads,
                     int smem, void* stream) {
  if (B <= 0 || D <= 0 || D >= F || n_inner <= 0 || nb < 1 || nb > NB_MAX ||
      (nb & (nb - 1)) != 0 || threads != nb * bond_threads(D) ||
      threads > MAX_THREADS || smem != smem_bytes(F, nb) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // Staging order: (bond slot, component, frame) by increasing |stride|,
  // ties to the earlier of the three.
  const long long s[3] = {std::llabs(n_inner > 1 ? s_inner : s_outer),
                          std::llabs(s_c), std::llabs(s_t)};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    pos[i] = 0;
    for (int k = 0; k < 3; ++k)
      if (k != i && (s[k] < s[i] || (s[k] == s[i] && k < i))) ++pos[i];
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        acf_lag_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + nb - 1) / nb;
  acf_lag_sums_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      v, out, B, F, D, n_inner, s_outer, s_inner, s_t, s_c, nb, pos[0], pos[1]);
  return (int)cudaGetLastError();
}

// The slab plan for chunks whose planes do not fit one block: same operands;
// (threads, slab, smem): ops/cuda_acf.py:launch_plan's SlabPlan, checked.
int acf_lag_sums_slab_f32(const float* v, float* out, int B, int F, int D,
                          int n_inner, long long s_outer, long long s_inner,
                          long long s_t, long long s_c, int threads, int slab,
                          int smem, void* stream) {
  const long long n_lag_blocks = ((long long)D + SLAB_LAGS - 1) / SLAB_LAGS;
  if (B <= 0 || D <= 0 || D >= F || n_inner <= 0 || threads != SLAB_THREADS ||
      slab != SLAB || smem != slab_smem_bytes() || n_lag_blocks > 65535 ||
      (long long)F + SLAB + SLAB_LAGS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)n_lag_blocks);
  acf_lag_sums_slab_kernel<<<grid, SLAB_THREADS, smem, (cudaStream_t)stream>>>(
      v, out, B, F, D, n_inner, s_outer, s_inner, s_t, s_c);
  return (int)cudaGetLastError();
}

}  // extern "C"

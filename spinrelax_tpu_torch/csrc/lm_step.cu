// Kernels D and E: the multi-exponential Levenberg-Marquardt step around
// kernels B and C, for Hopper (sm_90a).
//
// No Pallas twin: they replace the XLA fusions of the loop body of
// spinrelax_tpu/fit/engine.py:_engine_jit (body, :181-229), everything
// between and after its two Pallas calls pallas_lm.hgc and pallas_lm.cost.
// One step of fit.engine.fit_multiexp_engine on the card is then
//
//     B (H_p, g_p, c_old) -> D (solve) -> C (c_new) -> E (gates)
//
// four launches from one CUDA graph, in place of ~215 elementwise torch
// kernels (the unrolled Cholesky alone is O(P^3) of them).
//
// lm_step_solve (D), per lane b of (B, P) parameters t (unconstrained):
//     s = 1 / (1 + exp(-t)),  D = span s (1 - s)       (the sigmoid box)
//     H = H_p D_i D_j,  g = g_p D,  diag = max(diag H, 1e-12)
//     A = H + lam diag I,  step = -A^-1 g (Cholesky, two substitutions)
//     t_new = t + step,  p_trial = lo + span sigmoid(t_new)  (P, B) for C
//     stats = (max |step|, ||step||, ||t||)  (3, B)
// and clears the live flag that E sets again.
//
// lm_step_gate (E), per lane, in place: the trust-region and convergence
// gates of fit.engine (improved, lam x0.33 / x3 in [1e-12, 1e10], xtol,
// ftol, xtol_rel while lam <= lam0, the stall window while lam <= 100
// lam0, lam_stuck, max_iter), frozen lanes untouched; t and the (P, B)
// constrained parameters of the next B move to t_new and p_trial where the
// step is taken (so the step needs no separate sigmoid pass), and any lane
// still live stores 1 into live (plain stores of one value: no atomics,
// deterministic).
//
// What bounds them.  Bytes and latency, not operations: per lane D reads
// H_p's lower triangle, g_p, t and lam (P(P+1)/2 + 2P + 1 floats) and
// writes 2P + 3; at K = 2, S2 free (P = 5) and B = 1024 that is 0.15 MB,
// 45 ns at 3.35 TB/s, and ~300 flops and 10 exps a lane.  E reads and
// writes ~2P + 10 words a lane.  A launch is a few microseconds of latency
// either way: the point of D and E is to replace ~211 launches a step with
// 2.
//
// Design.  One thread a lane: the lanes are independent, and P <= 33.
// For P <= 9 (K <= 4, every rung of the default ladder and the forward)
// lm_step_solve_kernel<P> keeps A, its factor and the substitutions in
// registers (every loop unrolls); for P = 10..33 (K 5..16) the runtime-P
// instance keeps each lane's arrays in shared memory, one 32-lane warp a
// block, element e of lane l at [e * 32 + l] (no bank conflicts; up to
// 84 KB a block), so nothing spills to local memory.  Every operation of
// the solve is the plain version's (ops/cuda_lm.step_solve_plain, i.e.
// fit.lm._chol_solve_small) in its order, written with the _rn intrinsics
// that nvcc never contracts into an FMA, with IEEE division and square
// root (no --use_fast_math): a non-positive-definite A gives NaN as the
// plain version does, so the step is refused and lam triples.  D differs
// from the plain version only through expf's rounding and the norms'
// summation order.  E is selects, compares and single multiplies and adds
// on the plain version's operands: it equals the plain version bit for
// bit.  A lane's bits depend on nothing but that lane.

#include <cuda_runtime.h>

namespace {

constexpr int P_NARROW = 9;    // lm_step_solve_kernel<P> for P = 2..9
constexpr int P_MAX = 33;      // the runtime-P instance: P = 10..33
constexpr int D_THREADS = 128;  // lanes a block, register instances
constexpr int W_LANES = 32;     // lanes a block, the runtime-P instance
constexpr int E_THREADS = 256;

__host__ __device__ constexpr int tri(int P) { return P * (P + 1) / 2; }
// Shared floats a runtime-P lane keeps: the packed lower triangle, then
// t, the chain-rule factors D, and g / y / x.
__host__ __device__ constexpr int wide_floats(int P) { return tri(P) + 3 * P; }

// fit.lm._sigmoid: 1 / (1 + exp(-t)), each operation rounded on its own.
__device__ __forceinline__ float sigmoid(float t) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-t)));
}

// Register arrays (PT > 0: every index a constant once the loops unroll).
template <int N>
struct Regs {
  float v[N];
  __device__ float& operator[](int e) { return v[e]; }
};

// One lane's slice of the block's shared memory.
struct Strided {
  float* base;  // smem + lane
  __device__ float& operator[](int e) { return base[e * W_LANES]; }
};

// The solve of one lane (see the header).  L holds tri(P) floats (A, then
// its factor in place, row-packed lower triangle: (i, j) at i(i+1)/2 + j),
// tv, dv, x P floats each.  PT > 0 is P at compile time.
template <int PT, class ArrT, class ArrV>
__device__ __forceinline__ void solve_lane(
    ArrT& L, ArrV& tv, ArrV& dv, ArrV& x, int P_rt, long long b, int B,
    const float* __restrict__ Hp, const float* __restrict__ gp,
    const float* __restrict__ t, const float* __restrict__ lam,
    const float* __restrict__ lo, const float* __restrict__ span,
    float* __restrict__ t_new, float* __restrict__ pt, float* __restrict__ stats) {
  const int P = PT > 0 ? PT : P_rt;
  const float lb = lam[b];
  const float* Hb = Hp + b * P * P;
  float nt2 = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float tj = t[b * P + j], s = sigmoid(tj);
    tv[j] = tj;
    dv[j] = __fmul_rn(__fmul_rn(span[j], s), __fsub_rn(1.f, s));
    nt2 = __fadd_rn(nt2, __fmul_rn(tj, tj));
  }
  // A = H + ((lam I) diag) I, column by column: diag_j = max(H_jj, 1e-12)
  // (NaN stays NaN, as torch.clamp), and an off-diagonal entry adds
  // lam * 0 * diag_j * 0, NaN where lam or diag_j is not finite.
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float hjj = __fmul_rn(__fmul_rn(Hb[j * P + j], dv[j]), dv[j]);
    const float dg = isnan(hjj) ? hjj : fmaxf(hjj, (float)1e-12);
    L[tri(j) + j] = __fadd_rn(hjj, __fmul_rn(__fmul_rn(__fmul_rn(lb, 1.f), dg), 1.f));
    const float off = __fmul_rn(__fmul_rn(__fmul_rn(lb, 0.f), dg), 0.f);
#pragma unroll
    for (int i = j + 1; i < P; ++i)
      L[tri(i) + j] = __fadd_rn(__fmul_rn(__fmul_rn(Hb[i * P + j], dv[i]), dv[j]), off);
    x[j] = __fmul_rn(gp[b * P + j], dv[j]);
  }
  // Cholesky, fit.lm._chol_factor_small's order.
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = L[tri(j) + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(j) + k], L[tri(j) + k]));
    const float d = __fsqrt_rn(s), inv = __fdiv_rn(1.f, d);
    L[tri(j) + j] = d;
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float s2 = L[tri(i) + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = __fsub_rn(s2, __fmul_rn(L[tri(i) + k], L[tri(j) + k]));
      L[tri(i) + j] = __fmul_rn(s2, inv);
    }
  }
  // fit.lm._chol_subst: L y = g, then L^T x = y, in place.
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(i) + k], x[k]));
    x[i] = __fdiv_rn(s, L[tri(i) + i]);
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(k) + i], x[k]));
    x[i] = __fdiv_rn(s, L[tri(i) + i]);
  }
  // step = -x; t_new, the trial parameters of C, and the gates' norms.
  float amax = 0.f, ns2 = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float st = -x[j], a = fabsf(st);
    amax = (isnan(a) || a > amax) ? a : amax;  // NaN propagates, as torch.amax
    ns2 = __fadd_rn(ns2, __fmul_rn(st, st));
    const float tn = __fadd_rn(tv[j], st);
    t_new[b * P + j] = tn;
    pt[(long long)j * B + b] = __fadd_rn(lo[j], __fmul_rn(span[j], sigmoid(tn)));
  }
  stats[b] = amax;
  stats[B + b] = __fsqrt_rn(ns2);
  stats[2LL * B + b] = __fsqrt_rn(nt2);
}

template <int PT>
__global__ void __launch_bounds__(D_THREADS)
lm_step_solve_kernel(const float* __restrict__ Hp, const float* __restrict__ gp,
                     const float* __restrict__ t, const float* __restrict__ lam,
                     const float* __restrict__ lo, const float* __restrict__ span,
                     float* __restrict__ t_new, float* __restrict__ pt,
                     float* __restrict__ stats, bool* __restrict__ live, int B) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *live = false;  // E sets it again
  const long long b = (long long)blockIdx.x * D_THREADS + threadIdx.x;
  if (b >= B) return;
  Regs<tri(PT)> L;
  Regs<PT> tv, dv, x;
  solve_lane<PT>(L, tv, dv, x, PT, b, B, Hp, gp, t, lam, lo, span, t_new, pt, stats);
}

__global__ void __launch_bounds__(W_LANES)
lm_step_solve_wide_kernel(const float* __restrict__ Hp, const float* __restrict__ gp,
                          const float* __restrict__ t, const float* __restrict__ lam,
                          const float* __restrict__ lo, const float* __restrict__ span,
                          float* __restrict__ t_new, float* __restrict__ pt,
                          float* __restrict__ stats, bool* __restrict__ live, int B, int P) {
  extern __shared__ float sm[];  // wide_floats(P) x W_LANES
  if (blockIdx.x == 0 && threadIdx.x == 0) *live = false;
  const long long b = (long long)blockIdx.x * W_LANES + threadIdx.x;
  if (b >= B) return;
  float* lane = sm + threadIdx.x;
  Strided L{lane}, tv{lane + tri(P) * W_LANES}, dv{lane + (tri(P) + P) * W_LANES},
      x{lane + (tri(P) + 2 * P) * W_LANES};
  solve_lane<0>(L, tv, dv, x, P, b, B, Hp, gp, t, lam, lo, span, t_new, pt, stats);
}

__global__ void __launch_bounds__(E_THREADS)
lm_step_gate_kernel(const float* __restrict__ c_new, const float* __restrict__ c_old,
                    const float* __restrict__ t_new, const float* __restrict__ pt_trial,
                    const float* __restrict__ stats, float* __restrict__ t,
                    float* __restrict__ lam, int* __restrict__ it,
                    float* __restrict__ c_best, float* __restrict__ c_mark,
                    bool* __restrict__ done, bool* __restrict__ live, float* __restrict__ pt,
                    int B, int P, int max_iter, int window, float xtol, float ftol,
                    float ftol_window, float xtol_rel, float lam0, float lam_mark,
                    float lam_stuck) {
  const long long b = (long long)blockIdx.x * E_THREADS + threadIdx.x;
  if (b >= B) return;
  bool dn = done[b];
  int itb = it[b];
  const bool frozen = dn || itb >= max_iter;
  if (!frozen) {
    const float cn = c_new[b], co = c_old[b], lb = lam[b], cb = c_best[b], cm = c_mark[b];
    const bool improved = cn < co && isfinite(cn);
    const float up = __fmul_rn(lb, (float)0.33), down = __fmul_rn(lb, (float)3.0);
    const float lam_next = improved ? (isnan(up) ? up : fmaxf(up, (float)1e-12))
                                    : (isnan(down) ? down : fminf(down, (float)1e10));
    const bool small = stats[b] < xtol;
    const bool flat = improved && __fsub_rn(co, cn) <= __fmul_rn(co, ftol);
    const bool small_rel = improved && lb <= lam0
        && stats[B + b] < __fmul_rn(__fadd_rn(stats[2LL * B + b], xtol_rel), xtol_rel);
    // torch.minimum: NaN wins.
    const float m1 = isfinite(co) ? co : cb, m2 = isfinite(cn) ? cn : cb;
    const float mm = isnan(cb) ? cb : (isnan(m1) ? m1 : fminf(cb, m1));
    const float cbn = isnan(mm) ? mm : (isnan(m2) ? m2 : fminf(mm, m2));
    const bool at_window = (itb + 1) % window == 0;
    const bool stalled = at_window && isfinite(cm) && lam_next <= lam_mark
        && __fsub_rn(cm, cbn) <= __fmul_rn(cbn, ftol_window);
    dn = (improved && small) || flat || small_rel || stalled || lam_next >= lam_stuck;
    itb += 1;
    if (at_window) c_mark[b] = cbn;
    c_best[b] = cbn;
    lam[b] = lam_next;
    it[b] = itb;
    done[b] = dn;
    if (improved) {
      for (int j = 0; j < P; ++j) {
        t[b * P + j] = t_new[b * P + j];
        pt[(long long)j * B + b] = pt_trial[(long long)j * B + b];
      }
    }
  }
  if (!dn && itb < max_iter) *live = true;
}

}  // namespace

extern "C" {

// Hp (B, P, P), gp (B, P), t (B, P), lam (B,), lo / span (P,) f32 ->
// t_new (B, P), pt (P, B), stats (3, B); live (bool) = false.  P = 2..33.
// Returns cudaGetLastError() after the launch.
int lm_step_solve_f32(const float* Hp, const float* gp, const float* t, const float* lam,
                      const float* lo, const float* span, float* t_new, float* pt,
                      float* stats, bool* live, int B, int P, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || P < 2 || P > P_MAX) return (int)cudaErrorInvalidValue;
  if (P > P_NARROW) {
    const int smem = wide_floats(P) * W_LANES * (int)sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lm_step_solve_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    lm_step_solve_wide_kernel<<<(B + W_LANES - 1) / W_LANES, W_LANES, smem, s>>>(
        Hp, gp, t, lam, lo, span, t_new, pt, stats, live, B, P);
    return (int)cudaGetLastError();
  }
  const int grid = (B + D_THREADS - 1) / D_THREADS;
#define SOLVE(PP)                                                        \
  case PP:                                                               \
    lm_step_solve_kernel<PP><<<grid, D_THREADS, 0, s>>>(                 \
        Hp, gp, t, lam, lo, span, t_new, pt, stats, live, B);            \
    break;
  switch (P) {
    SOLVE(2) SOLVE(3) SOLVE(4) SOLVE(5) SOLVE(6) SOLVE(7) SOLVE(8) SOLVE(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SOLVE
  return (int)cudaGetLastError();
}

// c_new, c_old (B,), t_new (B, P), pt_trial (P, B), stats (3, B) -> in
// place t (B, P), lam (B,), it (B,) int32, c_best, c_mark (B,), done (B,)
// bool, pt (P, B); live (bool) = true if a lane is still live (D cleared
// it).  Thresholds as float32, as the plain version compares them.
int lm_step_gate_f32(const float* c_new, const float* c_old, const float* t_new,
                     const float* pt_trial, const float* stats, float* t, float* lam,
                     int* it, float* c_best, float* c_mark, bool* done, bool* live,
                     float* pt, int B, int P, int max_iter, int window, float xtol,
                     float ftol, float ftol_window, float xtol_rel, float lam0,
                     float lam_mark, float lam_stuck, void* stream) {
  if (B <= 0 || P < 1 || P > P_MAX || window < 1) return (int)cudaErrorInvalidValue;
  lm_step_gate_kernel<<<(B + E_THREADS - 1) / E_THREADS, E_THREADS, 0, (cudaStream_t)stream>>>(
      c_new, c_old, t_new, pt_trial, stats, t, lam, it, c_best, c_mark, done, live, pt, B, P,
      max_iter, window, xtol, ftol, ftol_window, xtol_rel, lam0, lam_mark, lam_stuck);
  return (int)cudaGetLastError();
}

}  // extern "C"

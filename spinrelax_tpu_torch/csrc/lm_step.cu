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
// step is taken (so the step needs no separate sigmoid pass), and live is
// set to 1 if any lane is still live (plain stores of one value: no
// atomics, deterministic).
//
// What bounds them.  Latency, not bytes or operations: per lane D reads
// H_p's lower triangle, g_p, t and lam (P(P+1)/2 + 2P + 1 floats) and
// writes 2P + 3; at K = 2, S2 free (P = 5) and B = 1024 that is 0.15 MB,
// 45 ns at 3.35 TB/s, and ~300 flops and 10 exps a lane.  E reads and
// writes ~2P + 10 words a lane.  D's time is one lane's chain of dependent
// IEEE square roots and divisions (P of each in the factor, P in each
// substitution) and, at B 10 000, the instructions every warp issues for
// its lanes; E's is the launch and its memory round trips.
//
// Design of D: a lane group of G threads a lane, thread r of the group
// owning rows r, r + G, .. (at most ROWS) of the lane's matrix, G the
// smallest power of two >= G_MIN with P <= ROWS G (group_of: G 4 for
// P <= 16, 8 for P <= 32, 16 at P 33), so a group stays inside one warp
// and a warp holds 32 / G lanes.  G >= P (one row a thread) was measured
// and lost at B 10 000: every warp issues its lanes' whole sequential
// chain of divisions and square roots, for 2 lanes at G 16 where G 4
// serves 8 (PERF.md, section 6).
// A block of D_THREADS threads holds D_THREADS / G consecutive lanes.  P
// is a template parameter: every loop unrolls and a thread keeps its rows
// of A (then L), y and x in registers.
//   - Staging.  The block's lanes' H_p slabs are one contiguous run; the
//     block copies it into shared memory with 16-byte loads (scalar at the
//     run's unaligned ends) while each thread loads its rows' t and g_p (a
//     warp's loads fall in one contiguous run of each) and lam, span, lo,
//     so no global round trip follows the barrier.  Each thread then
//     builds its rows of A from the slab.  (Staging t and g_p through
//     shared memory as well was slower at every P tried.)
//   - Cholesky, row-parallel in fit.lm._chol_factor_small's order.  For
//     column j every row i >= j forms A_ij - sum_{k<j} L_ik L_jk, k
//     ascending, with row j's entries shuffled from its thread; every
//     thread takes d_j and 1 / d_j from row j's sum (shuffled), so the
//     group needs no branch.
//   - Forward substitution as a wavefront: each row keeps its running sum
//     and subtracts L_ik y_k as y_k = sum_k / d_k is shuffled out, k
//     ascending (the plain order); every thread then holds every y_k.
//   - Back substitution, every thread alike: x_i = (y_i - sum_{k>i} L_ki
//     x_k) / d_i, k ascending (the plain order has no order-keeping
//     parallel form), column i of L shuffled from its rows.
//   - The thread of row j does parameter j's sigmoid, chain-rule factor,
//     t_new and trial parameter; thread 0 sums the norms in j order.
// Every operation of the solve is the plain version's
// (ops/cuda_lm.step_solve_plain, i.e. fit.lm._chol_solve_small) in its
// order, written with the _rn intrinsics that nvcc never contracts into an
// FMA, with IEEE division, reciprocal and square root (no
// --use_fast_math): a non-positive-definite A gives NaN as the plain
// version does, so the step is refused and lam triples.  D differs from
// the plain version only through expf's rounding and the norms' summation
// order.
//
// Design of E: one thread a lane in blocks of E_THREADS, P a template
// parameter, one global round trip.  Every load is issued before any
// loaded value is used: the lane's scalars, its column of the (P, B) trial
// parameters and, by the warp, the warp's t_new rows (one contiguous run
// of 32 P floats, read coalesced), whether or not the lane takes its step.
// A lane that takes its step stores its column; the warp stores element e
// of its t run where lane e / P takes its step (the flags from one
// __ballot_sync); every live lane stores live.  One thread a lane reading
// done and it, then a live lane's scalars, then an improved lane's rows
// was three dependent round trips: in the engine's LM, where E ends each
// replay of the step's graph and at B 10 000 follows C's stream through
// L2, they cost more than the loads a frozen or refused lane now makes in
// vain; launched back to back on a state in L2 the one-trip E is the
// slower (PERF.md, section 6).  E is selects, compares and single
// multiplies and adds on the plain version's operands: it equals the
// plain version bit for bit.  A lane's bits in D and E depend on nothing
// but that lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P_MAX = 33;
constexpr int G_MIN = 4;    // lane-group sizes: G_MIN, 2 G_MIN, .., G_MAX
constexpr int G_MAX = 32;
constexpr int ROWS = 4;     // rows a thread owns at most: P_MAX <= ROWS * G_MAX
constexpr int D_THREADS = 64;
constexpr int E_THREADS = 64;
constexpr unsigned FULL = 0xffffffffu;
static_assert(P_MAX <= ROWS * G_MAX, "a thread owns at most ROWS rows");

// The group size at P: the smallest G >= G_MIN whose threads own at most
// ROWS rows each (G 4 for P <= 16, 8 for P <= 32, 16 at P 33).
__host__ __device__ constexpr int group_of(int P) {
  int g = G_MIN;
  while (g * ROWS < P && g < G_MAX) g *= 2;
  return g;
}

// Shared floats for a staged run of n: 3 of slack (the run keeps its
// source's 16-byte phase), in whole float4s.
__host__ __device__ constexpr int run_floats(int n) { return (n + 3 + 3) / 4 * 4; }

// fit.lm._sigmoid: 1 / (1 + exp(-t)), each operation rounded on its own
// (__frcp_rn(x) is 1 / x correctly rounded: __fdiv_rn(1, x)'s bits).
__device__ __forceinline__ float sigmoid(float t) {
  return __frcp_rn(__fadd_rn(1.f, expf(-t)));
}

// Copies src[0, n) into the run at buf (16-byte aligned, run_floats(n)
// floats) with 16-byte loads where src's alignment allows, all D_THREADS
// threads of the block taking every D_THREADS-th element; returns where
// element 0 landed (buf plus src's phase).
__device__ __forceinline__ const float* stage(float* buf, const float* __restrict__ src, int n) {
  const int phase = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = buf + phase;
  const int head = min(n, (4 - phase) & 3);
  const int quads = (n - head) >> 2;
  for (int e = threadIdx.x; e < head; e += D_THREADS) dst[e] = __ldg(src + e);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int e = threadIdx.x; e < quads; e += D_THREADS) d4[e] = __ldg(s4 + e);
  for (int e = head + 4 * quads + threadIdx.x; e < n; e += D_THREADS) dst[e] = __ldg(src + e);
  return dst;
}

// Value v of the group's thread that owns row j (row j / G of thread j % G).
template <int G, int R>
__device__ __forceinline__ float row_of(const float (&v)[R], int j) {
  return __shfl_sync(FULL, v[j / G], j % G, G);
}

template <int P, int G>
__global__ void __launch_bounds__(D_THREADS)
lm_step_solve_kernel(const float* __restrict__ Hp, const float* __restrict__ gp,
                     const float* __restrict__ t, const float* __restrict__ lam,
                     const float* __restrict__ lo, const float* __restrict__ span,
                     float* __restrict__ t_new, float* __restrict__ pt,
                     float* __restrict__ stats, bool* __restrict__ live, int B) {
  constexpr int NL = D_THREADS / G, R = (P + G - 1) / G;
  __shared__ float4 sm4[run_floats(NL * P * P) / 4];  // the lanes' H_p slabs
  __shared__ float ts[NL * P];                         // their t rows, for ||t||
  if (blockIdx.x == 0 && threadIdx.x == 0) *live = false;  // E sets it again
  const int r = threadIdx.x % G, l = threadIdx.x / G;
  const long long b0 = (long long)blockIdx.x * NL, b = b0 + l;
  const int nl = (int)min((long long)NL, (long long)B - b0);
  const bool real = l < nl;  // a lane past B solves the identity and stores nothing
  // This thread's scalars, loaded with the staging so that no global round
  // trip follows the barrier: lam, and t, g_p, span and lo of its rows (a
  // warp's loads of t and of g_p fall in one contiguous run each).
  const float lb = real ? __ldg(lam + b) : 0.f;
  float tq[R], gq[R], sp[R], lw[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = r + q * G < P ? r + q * G : 0;
    const bool own = real && r + q * G < P;
    tq[q] = own ? __ldg(t + b * P + i) : 0.f;
    gq[q] = own ? __ldg(gp + b * P + i) : 0.f;
    sp[q] = __ldg(span + i);
    lw[q] = __ldg(lo + i);
  }
  const float* H = stage(reinterpret_cast<float*>(sm4), Hp + b0 * P * P, nl * P * P) + l * P * P;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (r + q * G < P) ts[l * P + r + q * G] = tq[q];
  __syncthreads();

  // Row i = r + q G of the lane (q < R), where i < P: the chain-rule
  // factor D_i, A's row i (zero right of the diagonal), and g_i D_i.
  float a[R][P], di[R], off[R], f[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = r + q * G, ii = i < P ? i : 0;
    const bool own = real && i < P;
    const float s = sigmoid(tq[q]);
    di[q] = __fmul_rn(__fmul_rn(sp[q], s), __fsub_rn(1.f, s));
    // diag_i = max(H_ii, 1e-12) (NaN stays NaN, as torch.clamp); the
    // entries of column i below it add lam * 0 * diag_i * 0, NaN where lam
    // or diag_i is not finite.
    const float hii = __fmul_rn(__fmul_rn(own ? H[ii * P + ii] : 1.f, di[q]), di[q]);
    const float dg = isnan(hii) ? hii : fmaxf(hii, (float)1e-12);
    off[q] = __fmul_rn(__fmul_rn(__fmul_rn(lb, 0.f), dg), 0.f);
    a[q][0] = __fadd_rn(hii, __fmul_rn(__fmul_rn(__fmul_rn(lb, 1.f), dg), 1.f));  // A_ii, for now
    f[q] = __fmul_rn(gq[q], di[q]);
  }
#pragma unroll
  for (int j = P - 1; j >= 0; --j) {
    const float dj = row_of<G>(di, j), offj = row_of<G>(off, j);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = r + q * G;
      const float h = real && i < P ? H[(i < P ? i : 0) * P + j] : 0.f;
      const float aij = __fadd_rn(__fmul_rn(__fmul_rn(h, di[q]), dj), offj);
      a[q][j] = j < i ? aij : (j == i ? a[q][0] : 0.f);
    }
  }

  // Cholesky, fit.lm._chol_factor_small's order, one column at a time:
  // every row i >= j forms A_ij - sum_{k<j} L_ik L_jk (k ascending) with
  // row j's entries shuffled from its thread; every thread takes d_j and
  // 1 / d_j from row j's sum, so the group needs no branch.
  float dd[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s[R];
#pragma unroll
    for (int q = 0; q < R; ++q) s[q] = a[q][j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const float ljk = __shfl_sync(FULL, a[j / G][k], j % G, G);
#pragma unroll
      for (int q = 0; q < R; ++q) s[q] = __fsub_rn(s[q], __fmul_rn(a[q][k], ljk));
    }
    const float d = __fsqrt_rn(row_of<G>(s, j)), inv = __frcp_rn(d);
    dd[j] = d;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = r + q * G;
      a[q][j] = i == j ? d : (i > j ? __fmul_rn(s[q], inv) : a[q][j]);
    }
  }

  // fit.lm._chol_subst: L y = g as a wavefront (y_k from row k's running
  // sum, k ascending; every thread then holds every y_k) ...
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    v[k] = __fdiv_rn(row_of<G>(f, k), dd[k]);
#pragma unroll
    for (int q = 0; q < R; ++q) f[q] = __fsub_rn(f[q], __fmul_rn(a[q][k], v[k]));
  }
  // ... then L^T x = y, every thread alike, column i of L shuffled from
  // its rows (k = i+1 .. P-1 ascending, the plain order).
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = v[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k)
      s = __fsub_rn(s, __fmul_rn(__shfl_sync(FULL, a[k / G][i], k % G, G), v[k]));
    v[i] = __fdiv_rn(s, dd[i]);
  }
  if (!real) return;

  // step = -x; t_new and the trial parameters of C, one parameter a thread.
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = r + q * G;
    if (j < P) {
      float xj = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k) xj = k == j ? v[k] : xj;
      const float tn = __fadd_rn(tq[q], -xj);
      t_new[b * P + j] = tn;
      pt[(long long)j * B + b] = __fadd_rn(lw[q], __fmul_rn(sp[q], sigmoid(tn)));
    }
  }
  // The gates' norms, summed in j order.
  if (r == 0) {
    float amax = 0.f, ns2 = 0.f, nt2 = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float st = -v[j], a_ = fabsf(st), tj = ts[l * P + j];
      amax = (isnan(a_) || a_ > amax) ? a_ : amax;  // NaN propagates, as torch.amax
      ns2 = __fadd_rn(ns2, __fmul_rn(st, st));
      nt2 = __fadd_rn(nt2, __fmul_rn(tj, tj));
    }
    stats[b] = amax;
    stats[B + b] = __fsqrt_rn(ns2);
    stats[2LL * B + b] = __fsqrt_rn(nt2);
  }
}

template <int P>
__global__ void __launch_bounds__(E_THREADS)
lm_step_gate_kernel(const float* __restrict__ c_new, const float* __restrict__ c_old,
                    const float* __restrict__ t_new, const float* __restrict__ pt_trial,
                    const float* __restrict__ stats, float* __restrict__ t,
                    float* __restrict__ lam, int* __restrict__ it,
                    float* __restrict__ c_best, float* __restrict__ c_mark,
                    bool* __restrict__ done, bool* __restrict__ live, float* __restrict__ pt,
                    int B, int max_iter, int window, float xtol, float ftol,
                    float ftol_window, float xtol_rel, float lam0, float lam_mark,
                    float lam_stuck) {
  const int b = blockIdx.x * E_THREADS + threadIdx.x, lane = threadIdx.x % 32;
  const bool in = b < B;
  // One round trip: every load is issued before any loaded value is used.
  // The lane's scalars and its column of C's trial parameters, and the
  // warp's t_new rows (one contiguous run of n floats, element lane + 32 k
  // in tr[k]), whether or not the lane will take its step.
  const long long w0 = (long long)(b - lane) * P;
  const int n = max(0, min(32, B - (b - lane))) * P;
  bool dn = true;
  int itb = 0;
  float cn = 0.f, co = 0.f, lb = 0.f, cb = 0.f, cm = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (in) {
    dn = done[b];
    itb = it[b];
    cn = c_new[b];
    co = c_old[b];
    lb = lam[b];
    cb = c_best[b];
    cm = c_mark[b];
    s0 = stats[b];
    s1 = stats[B + b];
    s2 = stats[2LL * B + b];
  }
  float pc[P], tr[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    pc[k] = in ? pt_trial[(long long)k * B + b] : 0.f;
    tr[k] = lane + 32 * k < n ? t_new[w0 + lane + 32 * k] : 0.f;
  }

  bool take = false;  // this lane takes its step
  if (in && !(dn || itb >= max_iter)) {  // not frozen
    const bool improved = cn < co && isfinite(cn);
    const float up = __fmul_rn(lb, (float)0.33), down = __fmul_rn(lb, (float)3.0);
    const float lam_next = improved ? (isnan(up) ? up : fmaxf(up, (float)1e-12))
                                    : (isnan(down) ? down : fminf(down, (float)1e10));
    const bool small = s0 < xtol;
    const bool flat = improved && __fsub_rn(co, cn) <= __fmul_rn(co, ftol);
    const bool small_rel = improved && lb <= lam0
        && s1 < __fmul_rn(__fadd_rn(s2, xtol_rel), xtol_rel);
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
    take = improved;
  }
  // The lane's column of B's next parameters where it takes its step, and
  // by the warp its t row: element e of the run where lane e / P does.
  const unsigned takes = __ballot_sync(FULL, take);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (take) pt[(long long)k * B + b] = pc[k];
    const int e = lane + 32 * k;
    if (e < n && (takes >> (e / P)) & 1u) t[w0 + e] = tr[k];
  }
  if (in && !dn && itb < max_iter) *live = true;
}

template <int P>
cudaError_t launch_solve(const float* Hp, const float* gp, const float* t, const float* lam,
                         const float* lo, const float* span, float* t_new, float* pt,
                         float* stats, bool* live, int B, int p, cudaStream_t s) {
  if constexpr (P > P_MAX) {
    return cudaErrorInvalidValue;
  } else {
    if (p != P)
      return launch_solve<P + 1>(Hp, gp, t, lam, lo, span, t_new, pt, stats, live, B, p, s);
    constexpr int NL = D_THREADS / group_of(P);
    lm_step_solve_kernel<P, group_of(P)><<<(B + NL - 1) / NL, D_THREADS, 0, s>>>(
        Hp, gp, t, lam, lo, span, t_new, pt, stats, live, B);
    return cudaGetLastError();
  }
}

template <int P>
cudaError_t launch_gate(const float* c_new, const float* c_old, const float* t_new,
                        const float* pt_trial, const float* stats, float* t, float* lam, int* it,
                        float* c_best, float* c_mark, bool* done, bool* live, float* pt, int B,
                        int p, int max_iter, int window, float xtol, float ftol,
                        float ftol_window, float xtol_rel, float lam0, float lam_mark,
                        float lam_stuck, cudaStream_t s) {
  if constexpr (P > P_MAX) {
    return cudaErrorInvalidValue;
  } else {
    if (p != P)
      return launch_gate<P + 1>(c_new, c_old, t_new, pt_trial, stats, t, lam, it, c_best, c_mark,
                                done, live, pt, B, p, max_iter, window, xtol, ftol, ftol_window,
                                xtol_rel, lam0, lam_mark, lam_stuck, s);
    lm_step_gate_kernel<P><<<(B + E_THREADS - 1) / E_THREADS, E_THREADS, 0, s>>>(
        c_new, c_old, t_new, pt_trial, stats, t, lam, it, c_best, c_mark, done, live, pt, B,
        max_iter, window, xtol, ftol, ftol_window, xtol_rel, lam0, lam_mark, lam_stuck);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// Hp (B, P, P), gp (B, P), t (B, P), lam (B,), lo / span (P,) f32 ->
// t_new (B, P), pt (P, B), stats (3, B); live (bool) = false.  P = 2..33.
// Returns cudaGetLastError() after the launch.
int lm_step_solve_f32(const float* Hp, const float* gp, const float* t, const float* lam,
                      const float* lo, const float* span, float* t_new, float* pt,
                      float* stats, bool* live, int B, int P, void* stream) {
  if (B <= 0 || P < 2 || P > P_MAX) return (int)cudaErrorInvalidValue;
  return (int)launch_solve<2>(Hp, gp, t, lam, lo, span, t_new, pt, stats, live, B, P,
                              (cudaStream_t)stream);
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
  return (int)launch_gate<1>(c_new, c_old, t_new, pt_trial, stats, t, lam, it, c_best, c_mark,
                             done, live, pt, B, P, max_iter, window, xtol, ftol, ftol_window,
                             xtol_rel, lam0, lam_mark, lam_stuck, (cudaStream_t)stream);
}

}  // extern "C"

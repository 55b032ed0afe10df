// The LTE turbo constituent code's trellis and the max-log-MAP steps that
// the kernels of this directory share (turbo_map.cu and turbo_v3.cu take the
// single-chain steps; turbo_fused.cu, turbo_sweep.cu and turbo_emit.cu the
// paired ones; turbo_fused16.cu the trellis functions, with steps of its own
// on packed state pairs).
//
// RSC code g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3.  State
// s = (r1 << 2) | (r2 << 1) | r3, r1 the newest register.  Every function
// is constexpr or takes compile-time state indices inside unrolled loops, so
// the trellis resolves to register moves.
//
// The steps add their gamma terms in the order of the JAX package's kernels
// (srsran_4g_tpu/ops/pallas/turbo_map.py _make_kernel, _make_kernel_v6/_v7,
// _make_kernel_v5, _make_emit_kernel), which the plain torch versions in
// ops/cuda/turbo_map.py repeat, so kernel and plain version agree to float
// rounding.
//
// Metric type M: float, or __nv_bfloat16 for the 16-bit kernels.  In bf16
// every addition and subtraction rounds to bf16 (round to nearest even:
// __hadd/__hsub, never contracted), as torch and XLA round each bf16 op, so
// a bf16 kernel that keeps its TPU kernel's order of operations reproduces
// it exactly.  Gammas and initial metrics arrive as f32 and are rounded on
// load (from_f32); the max is exact in either type.

#pragma once

#include <cuda_bf16.h>

namespace trellis {

// ---- metric arithmetic -----------------------------------------------------
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hadd(a, b);
}
__device__ __forceinline__ __nv_bfloat16 sub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hsub(a, b);
}
__device__ __forceinline__ __nv_bfloat16 mx(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmax(a, b);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class M>
__device__ __forceinline__ M from_f32(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int feedback(int s, int u) {
  return u ^ ((s >> 1) & 1) ^ (s & 1);
}
__host__ __device__ constexpr int next_state(int s, int u) {
  return (feedback(s, u) << 2) | (((s >> 2) & 1) << 1) | ((s >> 1) & 1);
}
__host__ __device__ constexpr int parity(int s, int u) {
  return feedback(s, u) ^ ((s >> 2) & 1) ^ (s & 1);
}
// The two predecessors j = 0, 1 of state t, their input and parity bits.
__host__ __device__ constexpr int pred_state(int t, int j) {
  return (((t >> 1) & 1) << 2) | ((t & 1) << 1) | j;
}
__host__ __device__ constexpr int pred_input(int t, int j) {
  return (t >> 2) ^ (t & 1) ^ j;
}
__host__ __device__ constexpr int pred_parity(int t, int j) {
  return (t >> 2) ^ ((t >> 1) & 1) ^ j;
}
// The state p with next_state(p, u) == t.
__host__ __device__ constexpr int prev_state(int t, int u) {
  return (((t >> 1) & 1) << 2) | ((t & 1) << 1) | ((t >> 2) ^ u ^ (t & 1));
}

// Radix-4 paths, labelled j = (u1 << 1) | u2 by their two inputs.  Alpha:
// the state two steps before target s; beta: the state two steps after
// source s; k = (p1 << 1) | p2 names the path's two parity bits.
__host__ __device__ constexpr int r4_pred(int s, int j) {
  return prev_state(prev_state(s, j & 1), j >> 1);
}
__host__ __device__ constexpr int r4_pred_k(int s, int j) {
  return (parity(r4_pred(s, j), j >> 1) << 1) |
         parity(prev_state(s, j & 1), j & 1);
}
__host__ __device__ constexpr int r4_next(int s, int j) {
  return next_state(next_state(s, j >> 1), j & 1);
}
__host__ __device__ constexpr int r4_next_k(int s, int j) {
  return (parity(s, j >> 1) << 1) | parity(next_state(s, j >> 1), j & 1);
}

// One pair of gamma rows (2i, 2i+1) of one lane.
template <class M>
struct PairT {
  M s0, p0, s1, p1;
};
using Pair = PairT<float>;

template <class M = float>
__device__ __forceinline__ PairT<M> load_pair(const float* gsl,
                                              const float* gpl, int row,
                                              size_t ns) {
  const size_t r = (size_t)row * ns;
  return PairT<M>{from_f32<M>(gsl[r]), from_f32<M>(gpl[r]),
                  from_f32<M>(gsl[r + ns]), from_f32<M>(gpl[r + ns])};
}

// m + u*gs + p*gp for 0/1 coefficients, added left to right (the v1 steps
// and the v5 emission).
template <class M>
__device__ __forceinline__ M branch(M m, int u, int p, M gs, M gp) {
  if (u) m = add(m, gs);
  if (p) m = add(m, gp);
  return m;
}

// m plus the branch term u*gs + p*gp, added as one row (gs, gp or gs + gp)
// as the states-as-registers kernels do.
template <class M>
__device__ __forceinline__ M add_combo(M m, int u, int p, M gs, M gp, M gsp) {
  return u ? (p ? add(m, gsp) : add(m, gs)) : (p ? add(m, gp) : m);
}

// Radix-2 alpha step a -> n, unnormalised.
template <class M>
__device__ __forceinline__ void astep2(const M a[8], M n[8], M gs, M gp) {
  const M gsp = add(gs, gp);
#pragma unroll
  for (int t = 0; t < 8; ++t)
    n[t] = mx(add_combo(a[pred_state(t, 0)], pred_input(t, 0),
                        pred_parity(t, 0), gs, gp, gsp),
              add_combo(a[pred_state(t, 1)], pred_input(t, 1),
                        pred_parity(t, 1), gs, gp, gsp));
}

// Radix-2 beta step b (at k+1) -> n (at k), unnormalised.
template <class M>
__device__ __forceinline__ void bstep2(const M b[8], M n[8], M gs, M gp) {
  const M gsp = add(gs, gp);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    n[s] = mx(add_combo(b[next_state(s, 0)], 0, parity(s, 0), gs, gp, gsp),
              add_combo(b[next_state(s, 1)], 1, parity(s, 1), gs, gp, gsp));
}

// Subtract state 0's metric (the paired kernels' normalisation).
template <class M>
__device__ __forceinline__ void norm0(M x[8]) {
  const M z = x[0];
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = sub(x[s], z);
}

template <class M>
__device__ __forceinline__ void copy8(const M src[8], M dst[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) dst[s] = src[s];
}

// LLR at step k from alpha_k, beta_{k+1} and the gammas, as the fused
// kernels emit it: max_s(a[s] + (b1[ns] + p*gp)), then (m1 + gs) - m0.
template <class M>
__device__ __forceinline__ M emit2(const M a[8], const M b1[8], M gs, M gp) {
  M m0 = add(a[0], parity(0, 0) ? add(b1[next_state(0, 0)], gp)
                                : b1[next_state(0, 0)]);
  M m1 = add(a[0], parity(0, 1) ? add(b1[next_state(0, 1)], gp)
                                : b1[next_state(0, 1)]);
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    m0 = mx(m0, add(a[s], parity(s, 0) ? add(b1[next_state(s, 0)], gp)
                                       : b1[next_state(s, 0)]));
    m1 = mx(m1, add(a[s], parity(s, 1) ? add(b1[next_state(s, 1)], gp)
                                       : b1[next_state(s, 1)]));
  }
  return sub(add(m1, gs), m0);
}

// ---- the single-chain (v1) steps: metrics minus their max every step -----

template <class M>
__device__ __forceinline__ void normalise(M x[8]) {
  const M m = mx(mx(mx(x[0], x[1]), mx(x[2], x[3])),
                 mx(mx(x[4], x[5]), mx(x[6], x[7])));
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = sub(x[s], m);
}

template <class M>
__device__ __forceinline__ void alpha_step(M a[8], M gs, M gp) {
  M n[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    n[t] = mx(branch(a[pred_state(t, 0)], pred_input(t, 0), pred_parity(t, 0),
                     gs, gp),
              branch(a[pred_state(t, 1)], pred_input(t, 1), pred_parity(t, 1),
                     gs, gp));
  normalise(n);
  copy8(n, a);
}

template <class M>
__device__ __forceinline__ void beta_step(M b[8], M gs, M gp) {
  M n[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    n[s] = mx(branch(b[next_state(s, 0)], 0, parity(s, 0), gs, gp),
              branch(b[next_state(s, 1)], 1, parity(s, 1), gs, gp));
  normalise(n);
  copy8(n, b);
}

// LLR of the input bit at step k from alpha_k, beta_{k+1} and the gammas:
// (max_s t1 + gs) - max_s t0.  AB_FIRST adds alpha and beta first, then the
// parity term (t = (a + b) + p*gp, the order of the JAX v1 kernel,
// _make_kernel); otherwise t = (a + p*gp) + b (turbo_map.cu's f32 kernel
// and its plain version).
template <bool AB_FIRST, class M>
__device__ __forceinline__ M llr(const M a[8], const M b[8], M gs, M gp) {
  M m[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const M bn = b[next_state(s, u)];
      const M t = AB_FIRST ? branch(add(a[s], bn), 0, parity(s, u), gs, gp)
                           : add(branch(a[s], 0, parity(s, u), gs, gp), bn);
      m[u] = s ? mx(m[u], t) : t;
    }
  }
  return sub(add(m[1], gs), m[0]);
}

// Radix-4 candidate: m plus the path's input row u[j] (j = 1: gs1, 2: gs0,
// 3: gs0 + gs1) and parity row p[k] (likewise from the parity gammas).
// GROUPED adds them as one sum (v7/v8); otherwise parity first, then input
// (v5).  Index 0 of either row means no term.
template <bool GROUPED>
__device__ __forceinline__ float r4_branch(float m, int j, int k,
                                           const float u[4],
                                           const float p[4]) {
  if (GROUPED) {
    if (j && k) return m + (u[j] + p[k]);
    if (j) return m + u[j];
    if (k) return m + p[k];
    return m;
  }
  const float x = k ? m + p[k] : m;
  return j ? x + u[j] : x;
}

__device__ __forceinline__ void r4_rows(const Pair& g, float u[4],
                                        float p[4]) {
  u[0] = 0.f;
  u[1] = g.s1;
  u[2] = g.s0;
  u[3] = g.s0 + g.s1;
  p[0] = 0.f;
  p[1] = g.p1;
  p[2] = g.p0;
  p[3] = g.p0 + g.p1;
}

// Radix-4 alpha step over rows (2i, 2i+1): alpha(2i) -> alpha(2i+2),
// unnormalised.
template <bool GROUPED>
__device__ __forceinline__ void astep4(const float a[8], float n[8],
                                       const Pair& g) {
  float u[4], p[4];
  r4_rows(g, u, p);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = r4_branch<GROUPED>(a[r4_pred(s, j)], j, r4_pred_k(s, j), u, p);
    n[s] = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  }
}

// Radix-4 beta step over rows (2i, 2i+1): beta(2i+2) -> beta(2i),
// unnormalised.
template <bool GROUPED>
__device__ __forceinline__ void bstep4(const float b[8], float n[8],
                                       const Pair& g) {
  float u[4], p[4];
  r4_rows(g, u, p);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = r4_branch<GROUPED>(b[r4_next(s, j)], j, r4_next_k(s, j), u, p);
    n[s] = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  }
}

}  // namespace trellis

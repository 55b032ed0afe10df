// The LTE turbo constituent code's trellis and the max-log-MAP steps that
// the kernels of this directory share (turbo_map.cu takes the trellis and
// `branch`; turbo_fused.cu, turbo_sweep.cu and turbo_emit.cu the rest).
//
// RSC code g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3.  State
// s = (r1 << 2) | (r2 << 1) | r3, r1 the newest register.  Every function
// is constexpr or takes compile-time state indices inside unrolled loops, so
// the trellis resolves to register moves.
//
// The steps add their gamma terms in the order of the JAX package's
// states-as-registers kernels (srsran_4g_tpu/ops/pallas/turbo_map.py
// _make_kernel_v6/_v7, _make_kernel_v5, _make_emit_kernel), which the plain
// torch versions in ops/cuda/turbo_map.py repeat, so kernel and plain version
// agree to float rounding.

#pragma once

namespace trellis {

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
struct Pair {
  float s0, p0, s1, p1;
};

__device__ __forceinline__ Pair load_pair(const float* gsl, const float* gpl,
                                          int row, size_t ns) {
  const size_t r = (size_t)row * ns;
  return Pair{gsl[r], gpl[r], gsl[r + ns], gpl[r + ns]};
}

// m + u*gs + p*gp for 0/1 coefficients, added left to right (turbo_map.cu's
// steps and the v5 emission).
__device__ __forceinline__ float branch(float m, int u, int p, float gs,
                                        float gp) {
  if (u) m += gs;
  if (p) m += gp;
  return m;
}

// m plus the branch term u*gs + p*gp, added as one row (gs, gp or gs + gp)
// as the states-as-registers kernels do.
__device__ __forceinline__ float add_combo(float m, int u, int p, float gs,
                                          float gp, float gsp) {
  return u ? (p ? m + gsp : m + gs) : (p ? m + gp : m);
}

// Radix-2 alpha step a -> n, unnormalised.
__device__ __forceinline__ void astep2(const float a[8], float n[8], float gs,
                                       float gp) {
  const float gsp = gs + gp;
#pragma unroll
  for (int t = 0; t < 8; ++t)
    n[t] = fmaxf(add_combo(a[pred_state(t, 0)], pred_input(t, 0),
                           pred_parity(t, 0), gs, gp, gsp),
                 add_combo(a[pred_state(t, 1)], pred_input(t, 1),
                           pred_parity(t, 1), gs, gp, gsp));
}

// Radix-2 beta step b (at k+1) -> n (at k), unnormalised.
__device__ __forceinline__ void bstep2(const float b[8], float n[8], float gs,
                                       float gp) {
  const float gsp = gs + gp;
#pragma unroll
  for (int s = 0; s < 8; ++s)
    n[s] = fmaxf(add_combo(b[next_state(s, 0)], 0, parity(s, 0), gs, gp, gsp),
                 add_combo(b[next_state(s, 1)], 1, parity(s, 1), gs, gp, gsp));
}

// Subtract state 0's metric (the paired kernels' normalisation).
__device__ __forceinline__ void norm0(float x[8]) {
  const float z = x[0];
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] -= z;
}

__device__ __forceinline__ void copy8(const float src[8], float dst[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) dst[s] = src[s];
}

// LLR at step k from alpha_k, beta_{k+1} and the gammas, as the fused
// kernels emit it: max_s(a[s] + (b1[ns] + p*gp)), then (m1 + gs) - m0.
__device__ __forceinline__ float emit2(const float a[8], const float b1[8],
                                       float gs, float gp) {
  float m0 = a[0] + (parity(0, 0) ? b1[next_state(0, 0)] + gp
                                  : b1[next_state(0, 0)]);
  float m1 = a[0] + (parity(0, 1) ? b1[next_state(0, 1)] + gp
                                  : b1[next_state(0, 1)]);
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    m0 = fmaxf(m0, a[s] + (parity(s, 0) ? b1[next_state(s, 0)] + gp
                                        : b1[next_state(s, 0)]));
    m1 = fmaxf(m1, a[s] + (parity(s, 1) ? b1[next_state(s, 1)] + gp
                                        : b1[next_state(s, 1)]));
  }
  return (m1 + gs) - m0;
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

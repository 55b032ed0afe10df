// Micro-benchmarks of the max-log-MAP add-compare-select (ACS) recursion on
// NVIDIA Hopper (sm_90a): the H100 counterparts of the TPU probes
//   probe2_*  tools/turbo_probe2.py run (pallas_call :40), bodies make (:59)
//             and make2 (:148): the per-step cost of a radix-4 alpha sweep
//             split into gamma loads, ACS arithmetic and alpha stores;
//   probe6_*  tools/turbo_probe6.py make_full (:111), make_skel (:144),
//             make_bf16 (:231): the radix-4 alpha+beta pair, its serial
//             skeleton without gamma arithmetic, and the pair in bf16 with
//             two lane groups packed;
//   probe7_*  tools/turbo_probe7.py run (:66), body make_kernel (:38): the
//             radix-2 ACS op mix in f32 against packed bf16.
// Each kernel computes what its TPU body computes, in the same order of
// operations, so the plain torch versions in ops/cuda/probes.py (and the
// Pallas bodies in interpret mode) agree with it to float rounding, exactly
// in bf16.
//
// Design: one thread per lane, the 8 state metrics in registers, loads
// coalesced along lanes ([row][lane] layouts).  In bf16x2 one thread runs
// two lane groups as one __nv_bfloat162 per state (__hadd2, __hsub2,
// __hmax2; each half rounds to nearest even, as torch and XLA round each
// bf16 op).  Where the TPU body kept a store in VMEM scratch (probe 2's
// astore), the store is a device-memory buffer, as in turbo_fused.cu.
// Nothing here is forced against the compiler: a body whose work nvcc
// removes (fixedrow's loop-invariant loads, the unread states of addchain,
// addpar and load1x) is reported as folded, as the TPU probe measured what
// Mosaic kept.
//
// What bounds them on the H100: compute.  Every probe reads a few bytes per
// trellis step of each lane and does 20-60 add/max/sub operations per step;
// at one operation per lane per cycle (132 SMs x 128 lanes x 1.98 GHz =
// 33.5 T op/s; two bf16 elements per bf16x2 instruction) the operations
// outweigh the bytes at 3.35 TB/s by 5-30x, except probe 2's loadsonly,
// load1, load1x, empty and astore bodies, which the bytes bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include <type_traits>

#include "trellis.cuh"

namespace trellis {
// packed pairs of lane groups
__device__ __forceinline__ __nv_bfloat162 add(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hadd2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 sub(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hsub2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 mx(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hmax2(a, b);
}
}  // namespace trellis

namespace {

using namespace trellis;

// f(std::integral_constant<int, I>) for I in [B, E), unrolled at compile time
// so that every trellis index is a constant and the metrics stay registers.
template <int B, int E, class F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    unroll<B + 1, E>(f);
  }
}

// ---- probe 2: turbo_probe2.py's alpha_r4 ---------------------------------
// Its radix-4 tables number the four two-step predecessors p of state s in
// the order they are found (p ascending, then u1, then u2; _tables_r4's
// a_pred) and add the gamma terms u1*gs0 + p1*gp0 + u2*gs1 + p2*gp1 left to
// right before adding them to alpha[p].
struct FillPath {
  int pred, u1, p1, u2, p2;
};

__host__ __device__ constexpr FillPath fill_path(int s, int j) {
  int k = 0;
  for (int p = 0; p < 8; ++p)
    for (int u1 = 0; u1 < 2; ++u1)
      for (int u2 = 0; u2 < 2; ++u2) {
        const int m = next_state(p, u1);
        if (next_state(m, u2) == s) {
          if (k == j) return FillPath{p, u1, parity(p, u1), u2, parity(m, u2)};
          ++k;
        }
      }
  return FillPath{0, 0, 0, 0, 0};
}

// The left-to-right sum of the present terms of (a, b, c, d); false when
// none is present (the TPU body then adds a zero, which changes no value).
__device__ __forceinline__ bool sum4(bool ha, float a, bool hb, float b,
                                     bool hc, float c, bool hd, float d,
                                     float& out) {
  bool any = false;
  if (ha) { out = a; any = true; }
  if (hb) { out = any ? out + b : b; any = true; }
  if (hc) { out = any ? out + c : c; any = true; }
  if (hd) { out = any ? out + d : d; any = true; }
  return any;
}

// alpha(2i) -> alpha(2i+2) over rows (2i, 2i+1), minus the max over states.
__device__ __forceinline__ void probe2_acs(float a[8], float g0s, float g0p,
                                           float g1s, float g1p) {
  float n[8];
  unroll<0, 8>([&](auto s_) {
    constexpr int S = decltype(s_)::value;
    float c[4];
    unroll<0, 4>([&](auto j_) {
      constexpr FillPath P = fill_path(S, decltype(j_)::value);
      float t = 0.f;
      const bool any = sum4(P.u1, g0s, P.p1, g0p, P.u2, g1s, P.p2, g1p, t);
      c[decltype(j_)::value] = any ? a[P.pred] + t : a[P.pred];
    });
    n[S] = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  });
  normalise(n);  // minus the max of the 8 states, as jnp.max(new, axis=0)
  copy8(n, a);
}

enum Probe2 {
  FULL, FIXEDROW, BLOCK8, LOADSONLY, ACSONLY, UNROLL4, ASTORE,
  EMPTY, LOAD1, ADDCHAIN, ADDPAR, LOAD1X
};

// gs, gp (rows, N) gamma rows (the probe passes one array as both), a0
// (8, N); out (out_rows, N) gets row 0 only, as the TPU body writes it;
// astore (store_rows, 8, N) is ASTORE's scratch.  n_steps radix-4 steps.
template <int V>
__global__ void __launch_bounds__(128)
    probe2_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                  const float* __restrict__ a0, float* __restrict__ out,
                  float* __restrict__ astore, int n, int n_steps,
                  int store_rows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* gsl = gs + lane;
  const float* gpl = gp + lane;
  float a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = a0[s * ns + lane];
  if constexpr (V == FULL || V == ASTORE) {
    for (int i = 0; i < n_steps; ++i) {
      if constexpr (V == ASTORE) {
        float* st = astore + (size_t)(i % store_rows) * 8 * ns + lane;
#pragma unroll
        for (int s = 0; s < 8; ++s) st[s * ns] = a[s];
      }
      const size_t r = (size_t)(2 * i) * ns;
      probe2_acs(a, gsl[r], gpl[r], gsl[r + ns], gpl[r + ns]);
    }
  } else if constexpr (V == FIXEDROW) {
    for (int i = 0; i < n_steps; ++i)
      probe2_acs(a, gsl[0], gpl[0], gsl[ns], gpl[ns]);
  } else if constexpr (V == BLOCK8) {
    for (int j = 0; j < n_steps / 4; ++j) {
      float bs[8], bp[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        bs[r] = gsl[(size_t)(8 * j + r) * ns];
        bp[r] = gpl[(size_t)(8 * j + r) * ns];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        probe2_acs(a, bs[2 * u], bp[2 * u], bs[2 * u + 1], bp[2 * u + 1]);
    }
  } else if constexpr (V == LOADSONLY) {
    float acc = a[0];
    for (int i = 0; i < n_steps; ++i) {
      const size_t r = (size_t)(2 * i) * ns;
      acc = acc + gsl[r] + gpl[r] + gsl[r + ns] + gpl[r + ns];
    }
    a[0] = acc;
  } else if constexpr (V == ACSONLY) {
    const float row = gsl[0];
    for (int i = 0; i < n_steps; ++i) probe2_acs(a, row, row, row, row);
  } else if constexpr (V == UNROLL4) {
    for (int j = 0; j < n_steps / 4; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t r = (size_t)(8 * j + 2 * u) * ns;
        probe2_acs(a, gsl[r], gpl[r], gsl[r + ns], gpl[r + ns]);
      }
    }
  } else if constexpr (V == EMPTY) {
    a[0] = gsl[0];
  } else if constexpr (V == LOAD1) {
    float acc = a[0];
    for (int i = 0; i < n_steps; ++i) acc = acc + gsl[(size_t)(2 * i) * ns];
    a[0] = acc;
  } else if constexpr (V == ADDCHAIN) {
    const float row = gsl[0];
    for (int i = 0; i < n_steps; ++i) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int s = 0; s < 8; ++s) a[s] = a[s] + row;
      }
    }
  } else if constexpr (V == ADDPAR) {
    // four (2, N) carries a0[0:2], [2:4], [4:6], [6:8], two adds each
    const float row = gsl[0];
    for (int i = 0; i < n_steps; ++i) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int s = 0; s < 8; ++s) a[s] = a[s] + row;
      }
    }
  } else if constexpr (V == LOAD1X) {
    for (int i = 0; i < n_steps; ++i) {
      const float x = gsl[(size_t)(2 * i) * ns];
#pragma unroll
      for (int s = 0; s < 8; ++s) a[s] = a[s] + x;
    }
  }
  out[lane] = a[0];
}

// ---- probe 6: turbo_probe6.py's v5 radix-4 pair --------------------------
// Path-labelled tables (j = (u1 << 1) | u2): candidate j of alpha state s is
// (alpha[r4_pred(s, j)] + (p1*gp0 + p2*gp1)) + u-row j, with u-rows
// (none, gs1, gs0, gs0 + gs1); beta the same over r4_next.  Both chains are
// normalised to state 0 after every step; in bf16x2 both lane groups are
// normalised to group 0's state 0, as make_bf16 broadcasts new[0:1] over all
// 16 sublanes.
template <bool BETA, class M>
__device__ __forceinline__ void probe6_acs(M x[8], M g0s, M g0p, M g1s, M g1p) {
  const M u3 = add(g0s, g1s);
  const M p3 = add(g0p, g1p);
  M n[8];
  unroll<0, 8>([&](auto s_) {
    constexpr int S = decltype(s_)::value;
    M c[4];
    unroll<0, 4>([&](auto j_) {
      constexpr int J = decltype(j_)::value;
      constexpr int P = BETA ? r4_next(S, J) : r4_pred(S, J);
      constexpr int K = BETA ? r4_next_k(S, J) : r4_pred_k(S, J);
      M v = x[P];
      if constexpr (K == 3) v = add(v, p3);
      if constexpr (K == 2) v = add(v, g0p);
      if constexpr (K == 1) v = add(v, g1p);
      if constexpr (J == 3) v = add(v, u3);
      if constexpr (J == 2) v = add(v, g0s);
      if constexpr (J == 1) v = add(v, g1s);
      c[J] = v;
    });
    n[S] = mx(mx(c[0], c[1]), mx(c[2], c[3]));
  });
  M z;
  if constexpr (std::is_same<M, float>::value)
    z = n[0];
  else
    z = __bfloat162bfloat162(__low2bfloat16(n[0]));
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = sub(n[s], z);
}

// f32: g2s, g2p (steps, 2, N): [i][0] = row 2i, [i][1] = row 2i+1; a0, b0,
// aout, bout (8, N).  bf16x2 (two lane groups): g2s, g2p (steps, 2, 2, H)
// bf16 [i][row][group][h]; a0, b0, aout, bout (16, H) bf16, rows 0-7 group
// 0's states, 8-15 group 1's; one thread per h, the two groups packed.
__device__ __forceinline__ float load_m(const float* p, size_t) { return *p; }
__device__ __forceinline__ __nv_bfloat162 load_m(const __nv_bfloat16* p,
                                                 size_t group_stride) {
  return __halves2bfloat162(p[0], p[group_stride]);
}
__device__ __forceinline__ void store_m(float* p, size_t, float v) { *p = v; }
__device__ __forceinline__ void store_m(__nv_bfloat16* p, size_t group_stride,
                                        __nv_bfloat162 v) {
  p[0] = __low2bfloat16(v);
  p[group_stride] = __high2bfloat16(v);
}

// E: the element type in memory (float or __nv_bfloat16); M: the metric
// type in registers (float or __nv_bfloat162).  G = 1 or 2 lane groups.
template <class E, class M, int G>
__global__ void __launch_bounds__(128)
    probe6_full_kernel(const E* __restrict__ g2s, const E* __restrict__ g2p,
                       const E* __restrict__ a0, const E* __restrict__ b0,
                       E* __restrict__ aout, E* __restrict__ bout, int n,
                       int steps) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= n) return;
  const size_t ns = (size_t)n;
  const size_t row = G * ns;  // one gamma row of every group
  const size_t mg = 8 * ns;   // group stride of the metric arrays
  M a[8], b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[s] = load_m(a0 + s * ns + h, mg);
    b[s] = load_m(b0 + s * ns + h, mg);
  }
  for (int i = 0; i < steps; ++i) {
    const size_t ra = (size_t)i * 2 * row + h;
    const size_t rb = (size_t)(steps - 1 - i) * 2 * row + h;
    probe6_acs<false>(a, load_m(g2s + ra, ns), load_m(g2p + ra, ns),
                      load_m(g2s + ra + row, ns), load_m(g2p + ra + row, ns));
    probe6_acs<true>(b, load_m(g2s + rb, ns), load_m(g2p + rb, ns),
                     load_m(g2s + rb + row, ns), load_m(g2p + rb + row, ns));
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    store_m(aout + s * ns + h, mg, a[s]);
    store_m(bout + s * ns + h, mg, b[s]);
  }
}

// make_skel: candidate j of state s is x[pred] + j (no gamma), then max and
// minus state 0.
template <bool BETA>
__device__ __forceinline__ void skel_acs(float x[8]) {
  float n[8];
  unroll<0, 8>([&](auto s_) {
    constexpr int S = decltype(s_)::value;
    float c[4];
    unroll<0, 4>([&](auto j_) {
      constexpr int J = decltype(j_)::value;
      c[J] = x[BETA ? r4_next(S, J) : r4_pred(S, J)] + (float)J;
    });
    n[S] = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  });
  const float z = n[0];
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = n[s] - z;
}

__global__ void __launch_bounds__(128)
    probe6_skel_kernel(const float* __restrict__ a0, const float* __restrict__ b0,
                       float* __restrict__ aout, float* __restrict__ bout,
                       int n, int steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  float a[8], b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[s] = a0[s * ns + lane];
    b[s] = b0[s * ns + lane];
  }
  for (int i = 0; i < steps; ++i) {
    skel_acs<false>(a);
    skel_acs<true>(b);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    aout[s * ns + lane] = a[s];
    bout[s * ns + lane] = b[s];
  }
}

// ---- probe 7: turbo_probe7.py's v7 radix-2 op mix ------------------------
// State s takes max(cand(A_SRC[s][0], A_CMB[s][0]), cand(A_SRC[s][1],
// A_CMB[s][1])), cand(p, c) = a[p] + combo c (c = 0: a[p] alone), combos
// (none, g0, g1, g0 + g1); two steps, then every state minus state 0.
__host__ __device__ constexpr int p7_src(int s, int k) {
  constexpr int t[8][2] = {{0, 4}, {4, 0}, {1, 5}, {5, 1},
                           {2, 6}, {6, 2}, {3, 7}, {7, 3}};
  return t[s][k];
}
__host__ __device__ constexpr int p7_cmb(int s, int k) {
  constexpr int t[8][2] = {{0, 3}, {3, 0}, {3, 0}, {0, 3},
                           {1, 2}, {2, 1}, {2, 1}, {1, 2}};
  return t[s][k];
}

template <class M>
__device__ __forceinline__ void p7_step(M a[8], M g0, M g1, M g01) {
  M n[8];
  unroll<0, 8>([&](auto s_) {
    constexpr int S = decltype(s_)::value;
    M c[2];
    unroll<0, 2>([&](auto k_) {
      constexpr int K = decltype(k_)::value;
      constexpr int C = p7_cmb(S, K);
      const M v = a[p7_src(S, K)];
      c[K] = C == 0 ? v : add(v, C == 1 ? g0 : (C == 2 ? g1 : g01));
    });
    n[S] = mx(c[0], c[1]);
  });
  copy8(n, a);
}

// g (2, n), a0 and out (8, n) of M elements (n lanes of f32, or n pairs of
// bf16 lanes).
template <class M>
__global__ void __launch_bounds__(128)
    probe7_kernel(const M* __restrict__ g, const M* __restrict__ a0,
                  M* __restrict__ out, int n, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t ns = (size_t)n;
  const M g0 = g[t], g1 = g[ns + t];
  const M g01 = add(g0, g1);
  M a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = a0[s * ns + t];
  for (int i = 0; i < iters; ++i) {
    p7_step(a, g0, g1, g01);
    p7_step(a, g0, g1, g01);
    const M z = a[0];
#pragma unroll
    for (int s = 0; s < 8; ++s) a[s] = sub(a[s], z);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) out[s * ns + t] = a[s];
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// variant: the Probe2 enum (0 full ... 11 load1x, the order of
// ops/cuda/probes.PROBE2_VARIANTS).
extern "C" int probe2(const float* gs, const float* gp, const float* a0,
                      float* out, float* astore, int n, int n_steps,
                      int store_rows, int variant, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_for(n);
  switch (variant) {
#define PROBE2_CASE(V)                                                    \
  case V:                                                                 \
    probe2_kernel<V><<<blocks, kThreads, 0, st>>>(gs, gp, a0, out, astore, \
                                                  n, n_steps, store_rows); \
    break;
    PROBE2_CASE(FULL)
    PROBE2_CASE(FIXEDROW)
    PROBE2_CASE(BLOCK8)
    PROBE2_CASE(LOADSONLY)
    PROBE2_CASE(ACSONLY)
    PROBE2_CASE(UNROLL4)
    PROBE2_CASE(ASTORE)
    PROBE2_CASE(EMPTY)
    PROBE2_CASE(LOAD1)
    PROBE2_CASE(ADDCHAIN)
    PROBE2_CASE(ADDPAR)
    PROBE2_CASE(LOAD1X)
#undef PROBE2_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int probe6_full(const float* g2s, const float* g2p, const float* a0,
                           const float* b0, float* aout, float* bout, int n,
                           int steps, void* stream) {
  if (n <= 0) return 0;
  probe6_full_kernel<float, float, 1><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      g2s, g2p, a0, b0, aout, bout, n, steps);
  return (int)cudaGetLastError();
}

// h: lanes per group (one thread each, both groups packed)
extern "C" int probe6_bf16(const __nv_bfloat16* g2s, const __nv_bfloat16* g2p,
                           const __nv_bfloat16* a0, const __nv_bfloat16* b0,
                           __nv_bfloat16* aout, __nv_bfloat16* bout, int h,
                           int steps, void* stream) {
  if (h <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  probe6_full_kernel<__nv_bfloat16, __nv_bfloat162, 2><<<blocks_for(h), kThreads, 0, st>>>(
      g2s, g2p, a0, b0, aout, bout, h, steps);
  return (int)cudaGetLastError();
}

extern "C" int probe6_skel(const float* a0, const float* b0, float* aout,
                           float* bout, int n, int steps, void* stream) {
  if (n <= 0) return 0;
  probe6_skel_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a0, b0, aout, bout, n, steps);
  return (int)cudaGetLastError();
}

// n f32 lanes, one per thread
extern "C" int probe7_f32(const float* g, const float* a0, float* out, int n,
                          int iters, void* stream) {
  if (n <= 0) return 0;
  probe7_kernel<float><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      g, a0, out, n, iters);
  return (int)cudaGetLastError();
}

// n pairs of bf16 lanes, one __nv_bfloat162 per thread
extern "C" int probe7_bf16(const __nv_bfloat162* g, const __nv_bfloat162* a0,
                           __nv_bfloat162* out, int n, int iters, void* stream) {
  if (n <= 0) return 0;
  probe7_kernel<__nv_bfloat162><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      g, a0, out, n, iters);
  return (int)cudaGetLastError();
}

// Sweep half of the split max-log-MAP half-iteration: the alpha and beta
// recursions, interleaved, storing the even-position metrics, for NVIDIA
// Hopper (sm_90a).  turbo_emit.cu turns the stores into LLRs.
//
// Replaces the TPU kernels map_windowed_pallas_v5
// (srsran_4g_tpu/ops/pallas/turbo_map.py:426, body _make_kernel_v5 :318;
// radix 4 here) and the sweep half of map_windowed_pallas_v6 (:1022, body
// _make_kernel_v6 :501; radix 2 here).  Each instance keeps its TPU kernel's
// schedule exactly, so the stores, not only the LLRs, can be held against it:
//   radix 4 (v5): one fused two-step ACS per pair of rows, parity term added
//     before the input term, metrics minus state 0 after every step,
//     training included;
//   radix 2 (v6): two radix-2 steps per pair, no normalisation in training,
//     minus state 0 after every body pair.
//
// Contract (the Pallas entries' own, prepared by ops/turbo.py):
//   gs, gp          (L+2T, N) f32  gamma rows, lane = window*B + block
//   a0, b0          (8, N)    f32  initial alpha / beta metrics
//   astore, bstore  (L/2, 8, N) f32  alpha at k_rel = 2i, beta at 2i+2
// L and T even.  Alpha trains on rows [0, T), frozen on window-0 lanes
// (lane < B); beta trains on rows L+2T-1 down to L+T, frozen on last-window
// lanes (lane >= (W-1)*B).
//
// Design: one thread per lane, the 8 alpha and 8 beta metrics in registers;
// alpha advances forward and beta backward in the same loop iteration, two
// independent dependence chains per thread.  Stores are [pos][state][lane],
// so a warp's stores coalesce; each iteration's four gamma rows are loaded
// one iteration ahead.
//
// What bounds it on the H100: it reads 2*(L+2T)*N*4 B of gamma and writes
// 2*(L/2)*8*N*4 B of stores (414 MB at the 20 MHz bench shape, L = 208,
// T = 32, N = 46,592), against about 39 f32 operations per trellis step per
// chain, so the bytes bound it.  The stores are 8x the LLRs the
// half-iteration returns: the split dataflow trades that traffic for a
// serial chain with no emission on it.

#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

// Alpha over one row pair: alpha(2i) -> alpha(2i+2).
template <int RADIX>
__device__ __forceinline__ void advance_a(float a[8], const Pair& g) {
  float n[8];
  if (RADIX == 4) {
    astep4<false>(a, n, g);
    norm0(n);
    copy8(n, a);
  } else {
    float m[8];
    astep2(a, m, g.s0, g.p0);
    astep2(m, a, g.s1, g.p1);
  }
}

// Beta over one row pair: beta(2i+2) -> beta(2i).
template <int RADIX>
__device__ __forceinline__ void advance_b(float b[8], const Pair& g) {
  float n[8];
  if (RADIX == 4) {
    bstep4<false>(b, n, g);
    norm0(n);
    copy8(n, b);
  } else {
    float m[8];
    bstep2(b, m, g.s1, g.p1);
    bstep2(m, b, g.s0, g.p0);
  }
}

template <int RADIX>
__global__ void __launch_bounds__(128)
sweep_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
             const float* __restrict__ a0, const float* __restrict__ b0,
             float* __restrict__ astore, float* __restrict__ bstore, int n,
             int t_train, int l_win, int nof_b, int nof_w) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* gsl = gs + lane;
  const float* gpl = gp + lane;
  const int t2 = t_train / 2, l2 = l_win / 2, s_all = l_win + 2 * t_train;
  const bool m_a = lane >= nof_b, m_b = lane < (nof_w - 1) * nof_b;

  float a[8], b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[s] = a0[s * ns + lane];
    b[s] = b0[s * ns + lane];
  }

  // ---- training, both chains, each frozen on its boundary window ----------
  for (int i = 0; i < t2; ++i) {
    const Pair ga = load_pair(gsl, gpl, 2 * i, ns);
    const Pair gb = load_pair(gsl, gpl, s_all - 2 - 2 * i, ns);
    float na[8], nb[8];
    copy8(a, na);
    copy8(b, nb);
    advance_a<RADIX>(na, ga);
    advance_b<RADIX>(nb, gb);
    if (m_a) copy8(na, a);
    if (m_b) copy8(nb, b);
  }

  // ---- body: store the even-position metrics, advance both chains ---------
  Pair ga = load_pair(gsl, gpl, t_train, ns);
  Pair gb = load_pair(gsl, gpl, t_train + l_win - 2, ns);
  for (int j = 0; j < l2; ++j) {
    Pair na = ga, nb = gb;
    if (j + 1 < l2) {
      na = load_pair(gsl, gpl, t_train + 2 * j + 2, ns);
      nb = load_pair(gsl, gpl, t_train + l_win - 4 - 2 * j, ns);
    }
    float* sa = astore + (size_t)j * 8 * ns + lane;
    float* sb = bstore + (size_t)(l2 - 1 - j) * 8 * ns + lane;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      sa[s * ns] = a[s];
      sb[s * ns] = b[s];
    }
    advance_a<RADIX>(a, ga);
    advance_b<RADIX>(b, gb);
    if (RADIX == 2) {
      norm0(a);
      norm0(b);
    }
    ga = na;
    gb = nb;
  }
}

}  // namespace

extern "C" int turbo_sweep(const float* gs, const float* gp, const float* a0,
                           const float* b0, float* astore, float* bstore, int n,
                           int t_train, int l_win, int nof_b, int nof_w,
                           int radix, void* stream) {
  if (n <= 0 || l_win <= 0) return 0;
  if (radix != 2 && radix != 4) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (radix == 4)
    sweep_kernel<4><<<blocks, threads, 0, st>>>(gs, gp, a0, b0, astore, bstore,
                                                n, t_train, l_win, nof_b, nof_w);
  else
    sweep_kernel<2><<<blocks, threads, 0, st>>>(gs, gp, a0, b0, astore, bstore,
                                                n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

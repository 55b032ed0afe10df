// One windowed max-log-MAP half-iteration with the fused two-phase dataflow
// (alpha and beta interleaved, emission against half-depth stores), for
// NVIDIA Hopper (sm_90a), in f32.
//
// Replaces the TPU kernel map_windowed_pallas_v7
// (srsran_4g_tpu/ops/pallas/turbo_map.py:872, body _make_kernel_v7 :641):
//   turbo_map_fused, radix 2: v7 (no normalisation in training);
//   turbo_map_fused, radix 4: v8 (radix4=True: one fused two-step ACS per
//     row pair, the input and parity terms added as one sum).
// Both normalise to state 0 after every body pair.  The same body at bf16
// with train_norm (v9, map_windowed_pallas_v9 :942) is turbo_fused16.cu,
// which keeps its stores in shared memory.
//
// Contract (the Pallas entry's own, prepared by ops/turbo.py):
//   gs, gp          (L+2T, N) f32  gamma rows, lane = window*B + block
//   a0, b0          (8, N)    f32  initial alpha / beta metrics
//   astore, bstore  (L/4, 8, N) f32 scratch for phase 1
//   out             (L, N)    f32  a-posteriori LLRs
// L % 4 == 0 and T even.  Alpha trains on rows [0, T), frozen on window-0
// lanes (lane < B); beta trains on rows L+2T-1 down to L+T, frozen on
// last-window lanes (lane >= (W-1)*B).
//
// Design: one thread per lane, the 8 alpha and 8 beta metrics in registers,
// alpha advancing forward and beta backward in the same iteration (two
// independent dependence chains per thread).  Phase 1 (pairs j < L/4) stores
// alpha(2j) and beta(L-2j); phase 2 keeps both chains going and emits four
// LLRs per iteration: the pair (2j, 2j+1) against the stored beta(2j+2), and
// the pair (L-2j-2, L-2j-1) against the stored alpha(L-2j-2), each with one
// radix-2 step off the chains for the odd position (_make_kernel_v7
// :825-867).  Each iteration's gamma rows and stored metrics are loaded one
// iteration ahead.
//
// Where the stores live: in a device-memory scratch, [pos][state][lane] so a
// warp's accesses coalesce, 2*(L/4)*8*N*4 B (155 MB at the 20 MHz bench
// shape, L = 208, N = 46,592).  Shared memory would need 3,328 B per lane
// at L = 208, so 64 lanes per block and one block per SM: 2 warps per SM,
// and the 46,592 lanes in 5.5 waves of one serial chain each.  With the
// scratch in device memory every lane is resident at once (about 3 blocks
// of 128 per SM), which hides the chain's latency better; the cost is the
// scratch round trip, 310 MB, half that of turbo_map.cu's full-depth alpha
// store.
//
// What bounds it on the H100: the function must read 2*(L+2T)*N*4 B of
// gamma and 2*8*N*4 B of initial metrics and write L*N*4 B of LLRs (143 MB
// at the bench shape) against
// about 39 operations per trellis step per chain and 40 per emitted LLR, so
// the bytes bound it.

#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

// Alpha over one row pair, alpha(2i) -> alpha(2i+2), unnormalised.
template <int RADIX, class M>
__device__ __forceinline__ void advance_a(M a[8], const PairT<M>& g) {
  M m[8];
  if constexpr (RADIX == 4) {
    astep4<true>(a, m, g);
    copy8(m, a);
  } else {
    astep2(a, m, g.s0, g.p0);
    astep2(m, a, g.s1, g.p1);
  }
}

// Beta over one row pair, beta(2i+2) -> beta(2i), unnormalised.
template <int RADIX, class M>
__device__ __forceinline__ void advance_b(M b[8], const PairT<M>& g) {
  M m[8];
  if constexpr (RADIX == 4) {
    bstep4<true>(b, m, g);
    copy8(m, b);
  } else {
    bstep2(b, m, g.s1, g.p1);
    bstep2(m, b, g.s0, g.p0);
  }
}

template <class M>
__device__ __forceinline__ void load8(const M* p, size_t ns, M x[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = p[s * ns];
}

template <class M>
__device__ __forceinline__ void store8(M* p, size_t ns, const M x[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) p[s * ns] = x[s];
}

// M: metric and store type.
template <int RADIX, class M>
__global__ void __launch_bounds__(128)
fused_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
             const float* __restrict__ a0, const float* __restrict__ b0,
             M* __restrict__ astore, M* __restrict__ bstore,
             float* __restrict__ out, int n, int t_train, int l_win, int nof_b,
             int nof_w) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* gsl = gs + lane;
  const float* gpl = gp + lane;
  M* astl = astore + lane;
  M* bstl = bstore + lane;
  float* outl = out + lane;
  const int t2 = t_train / 2, l2 = l_win / 2, h = l2 / 2;
  const int s_all = l_win + 2 * t_train;
  const bool m_a = lane >= nof_b, m_b = lane < (nof_w - 1) * nof_b;

  M a[8], b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[s] = from_f32<M>(a0[s * ns + lane]);
    b[s] = from_f32<M>(b0[s * ns + lane]);
  }

  // ---- training, both chains, each frozen on its boundary window ----------
  for (int i = 0; i < t2; ++i) {
    const PairT<M> ga = load_pair<M>(gsl, gpl, 2 * i, ns);
    const PairT<M> gb = load_pair<M>(gsl, gpl, s_all - 2 - 2 * i, ns);
    M na[8], nb[8];
    copy8(a, na);
    copy8(b, nb);
    advance_a<RADIX>(na, ga);
    advance_b<RADIX>(nb, gb);
    if (m_a) copy8(na, a);
    if (m_b) copy8(nb, b);
  }

  // ---- phase 1: store alpha(2j) and beta(L-2j), advance both chains -------
  PairT<M> ga = load_pair<M>(gsl, gpl, t_train, ns);
  PairT<M> gb = load_pair<M>(gsl, gpl, t_train + l_win - 2, ns);
  for (int j = 0; j < h; ++j) {
    const PairT<M> na = load_pair<M>(gsl, gpl, t_train + 2 * j + 2, ns);
    const PairT<M> nb = load_pair<M>(gsl, gpl, t_train + l_win - 4 - 2 * j, ns);
    store8(astl + (size_t)j * 8 * ns, ns, a);
    store8(bstl + (size_t)j * 8 * ns, ns, b);
    advance_a<RADIX>(a, ga);
    advance_b<RADIX>(b, gb);
    norm0(a);
    norm0(b);
    ga = na;
    gb = nb;
  }

  // ---- phase 2: advance both chains, emit four LLRs per iteration ---------
  // alpha side: a = alpha(2j); beta side: b = beta(e+2), e = L-2j-2.  The
  // stores of pair index l2-1-j hold beta(2j+2) and alpha(e).
  M bsl[8], asl[8];
  load8(bstl + (size_t)(l2 - 1 - h) * 8 * ns, ns, bsl);
  load8(astl + (size_t)(l2 - 1 - h) * 8 * ns, ns, asl);
  for (int j = h; j < l2; ++j) {
    const int e = l_win - 2 * j - 2;
    PairT<M> na = ga, nb = gb;
    M nbsl[8], nasl[8];
    copy8(bsl, nbsl);
    copy8(asl, nasl);
    if (j + 1 < l2) {
      na = load_pair<M>(gsl, gpl, t_train + 2 * j + 2, ns);
      nb = load_pair<M>(gsl, gpl, t_train + e - 2, ns);
      load8(bstl + (size_t)(l2 - 2 - j) * 8 * ns, ns, nbsl);
      load8(astl + (size_t)(l2 - 2 - j) * 8 * ns, ns, nasl);
    }
    M b1[8], ao[8];
    bstep2(bsl, b1, ga.s1, ga.p1);  // beta(2j+1)
    outl[(size_t)(2 * j) * ns] = to_f32(emit2(a, b1, ga.s0, ga.p0));
    astep2(a, ao, ga.s0, ga.p0);  // alpha(2j+1)
    outl[(size_t)(2 * j + 1) * ns] = to_f32(emit2(ao, bsl, ga.s1, ga.p1));

    M b1b[8], aob[8];
    bstep2(b, b1b, gb.s1, gb.p1);  // beta(e+1)
    outl[(size_t)e * ns] = to_f32(emit2(asl, b1b, gb.s0, gb.p0));
    astep2(asl, aob, gb.s0, gb.p0);  // alpha(e+1)
    outl[(size_t)(e + 1) * ns] = to_f32(emit2(aob, b, gb.s1, gb.p1));

    if constexpr (RADIX == 4) {
      advance_a<4>(a, ga);
      advance_b<4>(b, gb);
    } else {
      astep2(ao, a, ga.s1, ga.p1);
      bstep2(b1b, b, gb.s0, gb.p0);
    }
    norm0(a);
    norm0(b);
    ga = na;
    gb = nb;
    copy8(nbsl, bsl);
    copy8(nasl, asl);
  }
}

}  // namespace

extern "C" int turbo_map_fused(const float* gs, const float* gp,
                               const float* a0, const float* b0, float* astore,
                               float* bstore, float* out, int n, int t_train,
                               int l_win, int nof_b, int nof_w, int radix,
                               void* stream) {
  if (n <= 0 || l_win <= 0) return 0;
  if (radix != 2 && radix != 4) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (radix == 4)
    fused_kernel<4, float><<<blocks, threads, 0, st>>>(
        gs, gp, a0, b0, astore, bstore, out, n, t_train, l_win, nof_b, nof_w);
  else
    fused_kernel<2, float><<<blocks, threads, 0, st>>>(
        gs, gp, a0, b0, astore, bstore, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

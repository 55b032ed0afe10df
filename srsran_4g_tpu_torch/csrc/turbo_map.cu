// One windowed max-log-MAP (BCJR) half-iteration of the LTE 8-state RSC
// turbo constituent code, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels map_windowed_pallas_v9
// (srsran_4g_tpu/ops/pallas/turbo_map.py:942, body _make_kernel_v7) and
// map_windowed_pallas_r4 (:272, body _make_kernel_v4).  Both compute the same
// function; this radix-2 kernel takes any window L and training length T,
// so it also covers the odd-L/T shapes of map_windowed_pallas (:1423) and,
// at L = K, T = 0, one window, the exact full-length recursion.
//
// Contract (the Pallas entries' own, prepared by ops/turbo.py):
//   gs, gp   (L+2T, N) f32  gamma rows; row r of lane w*B+b is trellis index
//                           w*L - T + r (clamped) of block b
//   a0, b0   (8, N)    f32  initial alpha / beta metrics
//   astore   (L, 8, N) f32  scratch for the body alphas
//   out      (L, N)    f32  a-posteriori LLRs
// Alpha trains on rows [0, T), frozen on window-0 lanes (lane < B); beta
// trains on rows L+2T-1 down to L+T, frozen on last-window lanes
// (lane >= (W-1)*B); both bodies cover rows [T, T+L).
//
// Design: one thread per lane, the 8 alpha and 8 beta metrics in registers.
// Alpha runs forward through training and body and writes every body alpha
// to astore, laid out [pos][state][lane] so a warp's stores coalesce; beta
// then runs backward and emits each LLR against the stored alpha.  Metrics
// are f32 and renormalised to their max every step, exactly as the plain
// version (ops/cuda/turbo_map.py map_windowed_ref) does, in the same order of
// additions, so the two agree to float rounding (held to atol 1e-3).  v9 on
// the TPU keeps its metrics in bf16 because the VPU packs 16 sublanes; that
// reason does not carry over to Hopper, and f32 meets both v9's 16-bit bar
// against the JAX default and the tighter f32 one.
//
// What bounds it on the H100: the function must read 2*(L+2T)*N*4 B of
// gamma and write L*N*4 B of LLRs (about 143 MB at the 20 MHz bench shape,
// N = 46,592 lanes, L = 208, T = 32), against about 39 f32 operations per
// trellis step per chain and 40 per emitted LLR, so the bytes bound it
// (chip_smoke.py prints both bounds).  This first design adds the astore
// round trip, 2*L*8*N*4 B (620 MB at the bench shape) through device memory,
// and one dependent chain of ~T+L steps per thread; each step's gamma (and
// in the backward pass the stored alpha) is loaded one step ahead so the
// load latency overlaps the previous step's arithmetic.
//
// Left for later work: keeping the stores in shared memory (or storing every
// other alpha and recomputing the odd ones), a 16-bit packed-metric variant,
// and reading the (K, B) LLRs directly instead of the 1.31x window
// expansion.  The interleaved two-chain dataflow of v7/v8 is turbo_fused.cu.

#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

__device__ __forceinline__ void normalise(float x[8]) {
  const float m = fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])),
                        fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7])));
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] -= m;
}

__device__ __forceinline__ void alpha_step(float a[8], float gs, float gp) {
  float n[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float c0 = branch(a[pred_state(t, 0)], pred_input(t, 0),
                            pred_parity(t, 0), gs, gp);
    const float c1 = branch(a[pred_state(t, 1)], pred_input(t, 1),
                            pred_parity(t, 1), gs, gp);
    n[t] = fmaxf(c0, c1);
  }
  normalise(n);
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = n[s];
}

__device__ __forceinline__ void beta_step(float b[8], float gs, float gp) {
  float n[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float c0 = branch(b[next_state(s, 0)], 0, parity(s, 0), gs, gp);
    const float c1 = branch(b[next_state(s, 1)], 1, parity(s, 1), gs, gp);
    n[s] = fmaxf(c0, c1);
  }
  normalise(n);
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = n[s];
}

// LLR of the input bit at step k from alpha_k, beta_{k+1} and the gammas.
__device__ __forceinline__ float llr(const float a[8], const float b[8],
                                     float gs, float gp) {
  const float neg_inf = -__int_as_float(0x7f800000);
  float m0 = neg_inf, m1 = neg_inf;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    m0 = fmaxf(m0, branch(a[s], 0, parity(s, 0), gs, gp) + b[next_state(s, 0)]);
    m1 = fmaxf(m1, branch(a[s], 0, parity(s, 1), gs, gp) + b[next_state(s, 1)]);
  }
  return (m1 + gs) - m0;
}

__global__ void __launch_bounds__(128)
map_windowed_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                    const float* __restrict__ a0, const float* __restrict__ b0,
                    float* __restrict__ astore, float* __restrict__ out, int n,
                    int t_train, int l_win, int nof_b, int nof_w) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* gsl = gs + lane;
  const float* gpl = gp + lane;

  // ---- alpha: training (frozen on window 0), then the body --------------
  float a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = a0[s * ns + lane];
  if (lane >= nof_b) {
    for (int r = 0; r < t_train; ++r) alpha_step(a, gsl[r * ns], gpl[r * ns]);
  }
  float g_s = gsl[(size_t)t_train * ns], g_p = gpl[(size_t)t_train * ns];
  for (int pos = 0; pos < l_win; ++pos) {
    float* st = astore + (size_t)pos * 8 * ns + lane;
#pragma unroll
    for (int s = 0; s < 8; ++s) st[s * ns] = a[s];
    if (pos + 1 < l_win) {  // the alpha after the last body row is unused
      const size_t nxt = (size_t)(t_train + pos + 1) * ns;
      const float n_s = gsl[nxt], n_p = gpl[nxt];
      alpha_step(a, g_s, g_p);
      g_s = n_s;
      g_p = n_p;
    }
  }

  // ---- beta: training (frozen on the last window), then body + LLRs -----
  float b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = b0[s * ns + lane];
  if (lane < (nof_w - 1) * nof_b) {
    for (int r = l_win + 2 * t_train - 1; r >= l_win + t_train; --r)
      beta_step(b, gsl[r * ns], gpl[r * ns]);
  }
  int pos = l_win - 1;
  g_s = gsl[(size_t)(t_train + pos) * ns];
  g_p = gpl[(size_t)(t_train + pos) * ns];
  float al[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) al[s] = astore[((size_t)pos * 8 + s) * ns + lane];
  for (; pos >= 0; --pos) {
    float n_s = 0.f, n_p = 0.f, n_al[8];
    if (pos > 0) {  // prefetch the next (earlier) position
      const size_t prv = (size_t)(t_train + pos - 1) * ns;
      n_s = gsl[prv];
      n_p = gpl[prv];
#pragma unroll
      for (int s = 0; s < 8; ++s)
        n_al[s] = astore[((size_t)(pos - 1) * 8 + s) * ns + lane];
    }
    out[(size_t)pos * ns + lane] = llr(al, b, g_s, g_p);
    if (pos > 0) {
      beta_step(b, g_s, g_p);
      g_s = n_s;
      g_p = n_p;
#pragma unroll
      for (int s = 0; s < 8; ++s) al[s] = n_al[s];
    }
  }
}

}  // namespace

extern "C" int turbo_map_windowed(const float* gs, const float* gp,
                                  const float* a0, const float* b0,
                                  float* astore, float* out, int n,
                                  int t_train, int l_win, int nof_b,
                                  int nof_w, void* stream) {
  if (n <= 0 || l_win <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  map_windowed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gs, gp, a0, b0, astore, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

// One windowed max-log-MAP (BCJR) half-iteration of the LTE 8-state RSC
// turbo constituent code with bf16 metrics, single chain per lane, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the 16-bit body of the TPU kernel map_windowed_pallas
// (srsran_4g_tpu/ops/pallas/turbo_map.py:1423, _make_kernel(dtype=bf16)
// :1323), which TURBO_KERNEL=bf16 selects (:1464-1471), as
// turbo_map_windowed16.  Any window L and training length T.  The f32 body
// of the same entry, map_windowed_pallas_r4 and _make_kernel_v3 moved to
// turbo_windowed.cu (map_windowed, map_v3); this kernel keeps the first
// design until its own redesign.
//
// Contract (the Pallas entry's own, prepared by ops/turbo.py):
//   gs, gp   (L+2T, N) f32  gamma rows; row r of lane w*B+b is trellis index
//                           w*L - T + r (clamped) of block b
//   a0, b0   (8, N)    f32  initial alpha / beta metrics
//   astore   (L, 8, N) bf16 scratch for the body alphas
//   out      (L, N)    f32  a-posteriori LLRs (bf16 values)
// Alpha trains on rows [0, T), frozen on window-0 lanes (lane < B); beta
// trains on rows L+2T-1 down to L+T, frozen on last-window lanes
// (lane >= (W-1)*B); both bodies cover rows [T, T+L).
//
// Design: one thread per lane, the 8 alpha and 8 beta metrics in registers.
// Alpha runs forward through training and body and writes every body alpha
// to astore, laid out [pos][state][lane] so a warp's stores coalesce; beta
// then runs backward and emits each LLR against the stored alpha.  Metrics
// are renormalised to their max every step.  Gammas and initial metrics
// rounded to bf16, every add/subtract rounded, the alpha store in bf16, the
// LLR added as (a + b) + p*gp, then (m1 + gs) - m0, in bf16: the TPU
// kernel's own operations, so it matches map_windowed16_ref and the Pallas
// body exactly.
//
// What bounds it on the H100: the function must read 2*(L+2T)*N*4 B of
// gamma and write L*N*4 B of LLRs (about 143 MB at the 20 MHz bench shape,
// N = 46,592 lanes, L = 208, T = 32), against about 39 operations per
// trellis step per chain and 40 per emitted LLR, so the bytes bound it
// (chip_smoke.py prints both bounds).  This design adds the astore round
// trip, 2*L*8*N*2 B (310 MB at the bench shape) through device memory, and
// one dependent chain of ~2(T+L) steps per thread; each step's gamma (and in
// the backward pass the stored alpha) is loaded one step ahead so the load
// latency overlaps the previous step's arithmetic.

#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

// M: the metric type (__nv_bfloat16); the alpha store holds M.  AB_FIRST:
// the LLR's order of additions (see trellis::llr).
template <class M, bool AB_FIRST>
__global__ void __launch_bounds__(128)
map_windowed_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                    const float* __restrict__ a0, const float* __restrict__ b0,
                    M* __restrict__ astore, float* __restrict__ out, int n,
                    int t_train, int l_win, int nof_b, int nof_w) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* gsl = gs + lane;
  const float* gpl = gp + lane;

  // ---- alpha: training (frozen on window 0), then the body --------------
  M a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = from_f32<M>(a0[s * ns + lane]);
  if (lane >= nof_b) {
    for (int r = 0; r < t_train; ++r)
      alpha_step(a, from_f32<M>(gsl[r * ns]), from_f32<M>(gpl[r * ns]));
  }
  M g_s = from_f32<M>(gsl[(size_t)t_train * ns]);
  M g_p = from_f32<M>(gpl[(size_t)t_train * ns]);
  for (int pos = 0; pos < l_win; ++pos) {
    M* st = astore + (size_t)pos * 8 * ns + lane;
#pragma unroll
    for (int s = 0; s < 8; ++s) st[s * ns] = a[s];
    if (pos + 1 < l_win) {  // the alpha after the last body row is unused
      const size_t nxt = (size_t)(t_train + pos + 1) * ns;
      const M n_s = from_f32<M>(gsl[nxt]), n_p = from_f32<M>(gpl[nxt]);
      alpha_step(a, g_s, g_p);
      g_s = n_s;
      g_p = n_p;
    }
  }

  // ---- beta: training (frozen on the last window), then body + LLRs -----
  M b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = from_f32<M>(b0[s * ns + lane]);
  if (lane < (nof_w - 1) * nof_b) {
    for (int r = l_win + 2 * t_train - 1; r >= l_win + t_train; --r)
      beta_step(b, from_f32<M>(gsl[r * ns]), from_f32<M>(gpl[r * ns]));
  }
  int pos = l_win - 1;
  g_s = from_f32<M>(gsl[(size_t)(t_train + pos) * ns]);
  g_p = from_f32<M>(gpl[(size_t)(t_train + pos) * ns]);
  M al[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) al[s] = astore[((size_t)pos * 8 + s) * ns + lane];
  for (; pos >= 0; --pos) {
    M n_s = g_s, n_p = g_p, n_al[8];
    if (pos > 0) {  // prefetch the next (earlier) position
      const size_t prv = (size_t)(t_train + pos - 1) * ns;
      n_s = from_f32<M>(gsl[prv]);
      n_p = from_f32<M>(gpl[prv]);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        n_al[s] = astore[((size_t)(pos - 1) * 8 + s) * ns + lane];
    }
    out[(size_t)pos * ns + lane] = to_f32(llr<AB_FIRST>(al, b, g_s, g_p));
    if (pos > 0) {
      beta_step(b, g_s, g_p);
      g_s = n_s;
      g_p = n_p;
#pragma unroll
      for (int s = 0; s < 8; ++s) al[s] = n_al[s];
    }
  }
}

template <class M, bool AB_FIRST>
int launch(const float* gs, const float* gp, const float* a0, const float* b0,
           M* astore, float* out, int n, int t_train, int l_win, int nof_b,
           int nof_w, void* stream) {
  if (n <= 0 || l_win <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  map_windowed_kernel<M, AB_FIRST><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gs, gp, a0, b0, astore, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

}  // namespace

// The 16-bit body of map_windowed_pallas (_make_kernel(dtype=bf16)):
// astore (L, 8, N) bf16; the LLRs are bf16 values written as f32.
extern "C" int turbo_map_windowed16(const float* gs, const float* gp,
                                    const float* a0, const float* b0,
                                    __nv_bfloat16* astore, float* out, int n,
                                    int t_train, int l_win, int nof_b,
                                    int nof_w, void* stream) {
  return launch<__nv_bfloat16, true>(gs, gp, a0, b0, astore, out, n, t_train,
                                     l_win, nof_b, nof_w, stream);
}

// LLR emission of the split max-log-MAP half-iteration: a-posteriori LLRs
// from the stored even-position metrics, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels emit_llr_pallas
// (srsran_4g_tpu/ops/pallas/turbo_map.py:1150, body _make_emit_kernel :1109),
// which follows map_windowed_pallas_v5, and the emission half of
// map_windowed_pallas_v6 (:1022, body _make_emit_kernel_v6 :586).  Both
// compute the same function; this kernel adds its terms in
// _make_emit_kernel's order, and the v6 emission agrees with it to float
// rounding.
//
// Contract (after turbo_sweep.cu):
//   g2s, g2p  (L/2, 2, N) f32  body gamma rows, pair j = rows (2j, 2j+1)
//   astore    (L/2, 8, N) f32  alpha at k_rel = 2j
//   bstore    (L/2, 8, N) f32  beta at k_rel = 2j+2
//   out       (L/2, 2, N) f32  LLRs at k_rel = 2j, 2j+1
// Pair j's odd-position metrics come from one radix-2 step each:
// alpha(2j+1) from alpha(2j), beta(2j+1) from beta(2j+2); then
// LLR(2j) = f(alpha(2j), beta(2j+1)) and LLR(2j+1) = f(alpha(2j+1),
// beta(2j+2)).
//
// Design: one thread per (pair, lane), no serial chain; blockIdx.y is the
// pair and the 128 threads of a block take neighbouring lanes, so every load
// and store of a warp is one coalesced 128-byte row segment.
//
// What bounds it on the H100: it reads 2*L*N*4 B of gamma and 2*(L/2)*8*N*4 B
// of stores and writes L*N*4 B of LLRs (426 MB at the 20 MHz bench shape,
// L = 208, N = 46,592) against about 160 f32 operations per pair, so the
// bytes bound it.  The stores it reads are what the split dataflow adds:
// 310 MB, 8x the LLRs it writes.

#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

// max_s((a[s] + b1[ns(s, u)]) + p(s, u)*gp) for input u.
__device__ __forceinline__ float path_max(const float a[8], const float b1[8],
                                          int u, float gp) {
  float m = branch(a[0] + b1[next_state(0, u)], 0, parity(0, u), 0.f, gp);
#pragma unroll
  for (int s = 1; s < 8; ++s)
    m = fmaxf(m, branch(a[s] + b1[next_state(s, u)], 0, parity(s, u), 0.f, gp));
  return m;
}

__global__ void __launch_bounds__(128)
emit_kernel(const float* __restrict__ g2s, const float* __restrict__ g2p,
            const float* __restrict__ astore, const float* __restrict__ bstore,
            float* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const size_t j = blockIdx.y;
  const float ges = g2s[(2 * j) * ns + lane], gos = g2s[(2 * j + 1) * ns + lane];
  const float gep = g2p[(2 * j) * ns + lane], gop = g2p[(2 * j + 1) * ns + lane];
  float ae[8], be[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    ae[s] = astore[(j * 8 + s) * ns + lane];
    be[s] = bstore[(j * 8 + s) * ns + lane];
  }
  float ao[8], bo[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    ao[t] = fmaxf(branch(ae[pred_state(t, 0)], pred_input(t, 0),
                         pred_parity(t, 0), ges, gep),
                  branch(ae[pred_state(t, 1)], pred_input(t, 1),
                         pred_parity(t, 1), ges, gep));
#pragma unroll
  for (int s = 0; s < 8; ++s)
    bo[s] = fmaxf(branch(be[next_state(s, 0)], 0, parity(s, 0), gos, gop),
                  branch(be[next_state(s, 1)], 1, parity(s, 1), gos, gop));
  out[(2 * j) * ns + lane] =
      (path_max(ae, bo, 1, gep) + ges) - path_max(ae, bo, 0, gep);
  out[(2 * j + 1) * ns + lane] =
      (path_max(ao, be, 1, gop) + gos) - path_max(ao, be, 0, gop);
}

}  // namespace

extern "C" int turbo_emit(const float* g2s, const float* g2p,
                          const float* astore, const float* bstore, float* out,
                          int n, int l2, void* stream) {
  if (n <= 0 || l2 <= 0) return 0;
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads, l2);
  emit_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(g2s, g2p, astore,
                                                          bstore, out, n);
  return (int)cudaGetLastError();
}

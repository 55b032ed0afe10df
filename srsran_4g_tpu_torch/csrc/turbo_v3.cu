// One windowed max-log-MAP half-iteration, f32, as two independent chains
// per thread on a pair of lanes, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel body _make_kernel_v3
// (srsran_4g_tpu/ops/pallas/turbo_map.py:1189), which map_windowed_pallas
// (:1423) runs under TURBO_KERNEL=v3 (:1459-1463): v1's arithmetic, the
// lanes split in two halves A and B, and in each phase one chain per half:
//   phase 1: alpha of A (training, then the body, storing every alpha) and
//            beta of B (training, then the body, storing every beta);
//   phase 2: beta of A, emitting each LLR against A's stored alpha, and
//            alpha of B, emitting each LLR against B's stored beta.
// Its LLRs are v1's: each lane sees the steps and additions of turbo_map.cu
// (trellis::alpha_step, beta_step, llr<false>), so the two kernels agree
// exactly, and both match the plain version map_windowed_ref (which
// map_v3_ref names).
//
// Contract (map_windowed's, prepared by ops/turbo.py):
//   gs, gp   (L+2T, N) f32  gamma rows, lane = window*B + block
//   a0, b0   (8, N)    f32  initial alpha / beta metrics
//   store    (L, 8, N) f32  scratch: alpha of A lanes, beta of B lanes
//   out      (L, N)    f32  a-posteriori LLRs
// Alpha trains on rows [0, T), frozen on window-0 lanes (lane < B); beta
// trains on rows L+2T-1 down to L+T, frozen on last-window lanes.
//
// Design: thread i takes lane A = i and lane B = i + ceil(N/2) (none when
// N is odd and i is the last thread), so a warp's loads and stores of
// either half coalesce.  One (L, 8, N) scratch serves both halves: alpha(A)
// at [pos][state][A], and at [pos][state][B] the beta that enters body row
// pos, i.e. beta_{pos+1}.  Two chains per thread and half the threads of
// turbo_map.cu: the same work and the same scratch round trip (620 MB at
// the 20 MHz bench shape, L = 208, T = 32, N = 46,592), with twice the
// independent instructions per thread to cover the ACS latency and half
// the resident chains.  It is bound by the same 143 MB of compulsory bytes.

#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

__device__ __forceinline__ void load8(const float* p, size_t ns, float x[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = p[s * ns];
}

__device__ __forceinline__ void store8(float* p, size_t ns, const float x[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) p[s * ns] = x[s];
}

__global__ void __launch_bounds__(128)
v3_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
          const float* __restrict__ a0, const float* __restrict__ b0,
          float* __restrict__ store, float* __restrict__ out, int n,
          int t_train, int l_win, int nof_b, int nof_w) {
  const int half = (n + 1) / 2;
  const int la = blockIdx.x * blockDim.x + threadIdx.x;
  if (la >= half) return;
  const int lb = la + half;
  const bool has_b = lb < n;
  const size_t ns = (size_t)n;
  const int s_all = l_win + 2 * t_train;
  const int last = (nof_w - 1) * nof_b;  // first lane of the last window

  // ---- phase 1: alpha(A) forward, beta(B) backward, both stored ---------
  float a[8], b[8];
  load8(a0 + la, ns, a);
  if (has_b) load8(b0 + lb, ns, b);
  for (int i = 0; i < t_train; ++i) {
    if (la >= nof_b) alpha_step(a, gs[i * ns + la], gp[i * ns + la]);
    if (has_b && lb < last) {
      const size_t r = (size_t)(s_all - 1 - i) * ns + lb;
      beta_step(b, gs[r], gp[r]);
    }
  }
  for (int j = 0; j < l_win; ++j) {
    store8(store + (size_t)j * 8 * ns + la, ns, a);
    if (has_b) store8(store + (size_t)(l_win - 1 - j) * 8 * ns + lb, ns, b);
    if (j + 1 < l_win) {
      const size_t ra = (size_t)(t_train + j) * ns;
      alpha_step(a, gs[ra + la], gp[ra + la]);
      if (has_b) {
        const size_t rb = (size_t)(t_train + l_win - 1 - j) * ns + lb;
        beta_step(b, gs[rb], gp[rb]);
      }
    }
  }

  // ---- phase 2: beta(A) + LLRs against alpha(A), alpha(B) + LLRs against
  // beta(B) ---------------------------------------------------------------
  load8(b0 + la, ns, b);
  if (has_b) load8(a0 + lb, ns, a);
  for (int i = 0; i < t_train; ++i) {
    if (la < last) {
      const size_t r = (size_t)(s_all - 1 - i) * ns + la;
      beta_step(b, gs[r], gp[r]);
    }
    if (has_b && lb >= nof_b) alpha_step(a, gs[i * ns + lb], gp[i * ns + lb]);
  }
  for (int j = 0; j < l_win; ++j) {
    const int q = l_win - 1 - j;  // A's position, going down
    float st[8];
    load8(store + (size_t)q * 8 * ns + la, ns, st);
    const size_t ra = (size_t)(t_train + q) * ns + la;
    out[(size_t)q * ns + la] = llr<false>(st, b, gs[ra], gp[ra]);
    if (q > 0) beta_step(b, gs[ra], gp[ra]);
    if (has_b) {  // B's position j, going up
      load8(store + (size_t)j * 8 * ns + lb, ns, st);
      const size_t rb = (size_t)(t_train + j) * ns + lb;
      out[(size_t)j * ns + lb] = llr<false>(a, st, gs[rb], gp[rb]);
      if (j + 1 < l_win) alpha_step(a, gs[rb], gp[rb]);
    }
  }
}

}  // namespace

extern "C" int turbo_map_v3(const float* gs, const float* gp, const float* a0,
                            const float* b0, float* store, float* out, int n,
                            int t_train, int l_win, int nof_b, int nof_w,
                            void* stream) {
  if (n <= 0 || l_win <= 0) return 0;
  const int threads = 128;
  const int blocks = ((n + 1) / 2 + threads - 1) / threads;
  v3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gs, gp, a0, b0, store, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

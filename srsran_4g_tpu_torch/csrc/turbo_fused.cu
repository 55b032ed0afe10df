// One windowed max-log-MAP half-iteration in the fused two-phase dataflow in
// f32, for NVIDIA Hopper (sm_90a), with the phase-1 metrics checkpointed in
// shared memory.
//
// Replaces the TPU kernel map_windowed_pallas_v7
// (srsran_4g_tpu/ops/pallas/turbo_map.py:872, pallas_call :925, body
// _make_kernel_v7 :641):
//   turbo_map_fused, radix 2: v7 (no normalisation in training);
//   turbo_map_fused, radix 4: v8 (radix4=True: one fused two-step ACS per
//     row pair, the input and parity terms added as one sum).
// Both subtract state 0 after every body pair, and emit the odd position of
// each pair with one radix-2 step off the chains (_make_kernel_v7
// :825-867).  Every step is the trellis.cuh function the plain version
// map_fused_ref (ops/cuda/turbo_map.py) repeats, on the same rows, so the
// LLRs are equal (max |diff| 0).  The same dataflow at bf16 with
// normalisation in training (v9) is turbo_fused16.cu.
//
// Contract (the Pallas entry's own, prepared by ops/turbo.py):
//   gs, gp   (L+2T, N) f32  gamma rows, lane = window*B + block
//   a0, b0   (8, N)    f32  initial alpha / beta metrics
//   out      (L, N)    f32  a-posteriori LLRs
// L % 4 == 0 and T even.  Alpha trains on rows [0, T), frozen on window-0
// lanes (lane < B); beta trains on rows L+2T-1 down to L+T, frozen on
// last-window lanes (lane >= (W-1)*B).
//
// What bounds it on the H100: the function must read 2*(L+2T)*N*4 B of
// gamma and 2*8*N*4 B of initial metrics and write L*N*4 B of LLRs (143 MB
// at the 20 MHz bench shape, L = 208, T = 32, N = 46,592: 0.0427 ms at
// 3.35 TB/s) against about 39 operations per trellis step per chain and 40
// per emitted LLR (chip_smoke.py prints both bounds).  The kernel this
// replaces ran both chains of a lane in one thread and kept its phase-1
// stores, 2*(L/4)*8*N*4 B (155 MB at the bench shape), in device memory:
// 310 MB of round trip on top of the function's own 143 MB.
//
// Design (turbo_fused16.cu's dataflow, with turbo_windowed.cu's
// checkpoints, since an f32 metric is 32 B):
// - A block is a tile of lanes and runs one thread per chain: threads
//   [0, tile) carry alpha, [tile, 2*tile) beta.  Phase 1 (pairs j < L/4)
//   advances each chain over its first L/4 row pairs; phase 2 keeps each
//   chain going and reads only the other chain's phase-1 metrics, so one
//   __syncthreads() separates the phases.  In phase 2 the alpha thread emits
//   positions [L/2, L), the pair (2j, 2j+1) against beta(2j+2), and the beta
//   thread positions [0, L/2), the pair (L-2j-2, L-2j-1) against
//   alpha(L-2j-2).  Lanes past N (a ragged last tile) skip their loads,
//   arithmetic and stores but reach the barrier.
// - Checkpoints in shared memory, never device memory.  Phase 1 cuts each
//   chain's L/4 pairs into chunks of c pairs and stores the metric at the
//   start of each chunk, 8 f32 (32 B): 64*ceil(L/(4c)) B a lane.  In phase 2
//   the reader takes a segment (the c pairs of one of the other chain's
//   chunks, which are the reader's own next c row pairs, so no byte is read
//   twice for it), rebuilds the other chain's c metrics from the checkpoint
//   with that chain's step and norm0 over those rows, holds them in
//   registers and emits the segment: the same operations on the same values,
//   so the same metrics.  It costs (c-1)/c pair steps a pair.  c = 1 stores
//   every metric, c = 2 every other (turbo_fused16.cu's choice at bf16); the
//   host picks c and the tile (ops/cuda/turbo_map.fused_geometry): c = 4 at
//   radix 2, and c = 2 at radix 4, whose rebuild step is the costlier one
//   (at the bench shape 4 blocks an SM, against 6 at c = 4).
// - Each chain's row pairs stream through a ring of kStages (4) slots in
//   shared memory filled by cp.async, one commit group a pair; a chain takes
//   up to c pairs at a time (wait, read them into registers, refill their
//   slots kStages pairs ahead).  At c = 4 a take waits for the whole ring:
//   the next chunk's loads run under this chunk's arithmetic.  A full chunk runs straight-line; a partial one
//   (the last chunk of training and of phase 1, the first segment of phase
//   2) computes a full chunk and keeps only its valid pairs (selects).
// - Shared memory a block: [alpha checkpoints | beta checkpoints | ring],
//   each checkpoint [index][16-byte half][lane], so a warp's access is 512
//   contiguous bytes.  Its bytes, tile * (64*ceil(L/(4c)) + 128), fit the
//   232,448 B an H100 block may opt into for every L % 4 == 0 up to 6144 at
//   the tile the host picks; the entry checks them and opts in.
//
// Build-time variants, for tools/fused_split.py only (the defaults are the
// kernel): FUSED_STAGES ring slots a chain (a power of two, >= 4 and >= c);
// FUSED_MIN_BLOCKS, the blocks an SM the register budget must allow (6);
// FUSED_LOADS_ONLY (two adds a pair and a position in place of the trellis
// arithmetic); FUSED_COMPUTE_ONLY (the ring never filled).  c and the tile
// are arguments of the entry.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

#ifndef FUSED_STAGES
#define FUSED_STAGES 4
#endif
constexpr int kStages = FUSED_STAGES;  // row pairs in flight per chain
static_assert(kStages >= 4 && (kStages & (kStages - 1)) == 0,
              "the ring's slot is k & (kStages-1), and holds a whole chunk");
#ifndef FUSED_MIN_BLOCKS
#define FUSED_MIN_BLOCKS 6
#endif
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in limit
constexpr int kMaxTile = 32;      // lanes a block

// cp.async.wait_group N: every commit group but the newest N is complete.
template <int N>
__device__ __forceinline__ void wait_groups() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Up to C row pairs of one chain, in its stream order at [C-n, C); the
// slots before hold 0.
template <int C>
struct Pairs {
  Pair g[C];
};

// One chain's row pairs: step i of its stream is the pair at row row0 +
// drow*i (rows r and r+1), and slot i & (kStages-1) of the ring holds it, as
// (gs r, gp r, gs r+1, gp r+1) at base[(4*slot + q) * stride], stride = the
// block's threads.  One commit group per pair (an empty one past the last
// step).  Before each take the groups of steps up to k + kStages - 1 are
// committed, so waiting for all but the newest kStages - C leaves the pairs
// of steps k .. k+C-1 complete.
struct Ring {
  const float* gs;  // this lane's column
  const float* gp;
  float* base;
  int stride;
  size_t ns;  // N
  int row0, drow, steps, k;

  __device__ __forceinline__ void fetch(int i) {
#ifndef FUSED_COMPUTE_ONLY
    if (i < steps) {
      const size_t r = (size_t)(row0 + drow * i) * ns;
      float* d = base + (size_t)(i & (kStages - 1)) * 4 * stride;
      __pipeline_memcpy_async(d, gs + r, sizeof(float));
      __pipeline_memcpy_async(d + stride, gp + r, sizeof(float));
      __pipeline_memcpy_async(d + 2 * stride, gs + r + ns, sizeof(float));
      __pipeline_memcpy_async(d + 3 * stride, gp + r + ns, sizeof(float));
    }
#endif
    __pipeline_commit();
  }

  __device__ __forceinline__ void start() {
    for (int i = 0; i < kStages; ++i) fetch(i);
    k = 0;
  }

  // The next n (1 <= n <= C) pairs into g, then their slots refilled with
  // the pairs kStages steps ahead.
  template <int C>
  __device__ __forceinline__ void take(int n, Pairs<C>& g) {
    wait_groups<kStages - C>();
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const float* d = base + (size_t)((k + u - (C - n)) & (kStages - 1)) * 4 * stride;
      const bool in = u >= C - n;
      g.g[u] = in ? Pair{d[0], d[stride], d[2 * stride], d[3 * stride]}
                  : Pair{0.f, 0.f, 0.f, 0.f};
    }
    for (int q = 0; q < n; ++q) fetch(k + kStages + q);
    k += n;
  }
};

// ---- the chains' steps -----------------------------------------------------

struct F32 {
  float x[8];
};

// One chain over one row pair, unnormalised: alpha(2i) -> alpha(2i+2), or
// beta(2i+2) -> beta(2i).
template <bool BETA, int RADIX>
__device__ __forceinline__ void advance(F32& m, const Pair& g) {
#ifdef FUSED_LOADS_ONLY
  m.x[0] += g.s0 + g.s1;
  m.x[1] += g.p0 + g.p1;
#else
  float n[8];
  if (RADIX == 4) {
    if (BETA)
      bstep4<true>(m.x, n, g);
    else
      astep4<true>(m.x, n, g);
    copy8(n, m.x);
  } else if (BETA) {
    bstep2(m.x, n, g.s1, g.p1);
    bstep2(n, m.x, g.s0, g.p0);
  } else {
    astep2(m.x, n, g.s0, g.p0);
    astep2(n, m.x, g.s1, g.p1);
  }
#endif
}

__device__ __forceinline__ void normalise(F32& m) {
#ifndef FUSED_LOADS_ONLY
  norm0(m.x);
#endif
}

__device__ __forceinline__ void select(F32& x, const F32& y, bool use) {
#pragma unroll
  for (int s = 0; s < 8; ++s) x.x[s] = use ? y.x[s] : x.x[s];
}

// Checkpoint idx of a lane: two float4 at ck[idx*2*tile] and ck[idx*2*tile + tile].
__device__ __forceinline__ void put(float4* ck, int tile, int idx, const F32& m) {
  float4 lo, hi;
  lo.x = m.x[0], lo.y = m.x[1], lo.z = m.x[2], lo.w = m.x[3];
  hi.x = m.x[4], hi.y = m.x[5], hi.z = m.x[6], hi.w = m.x[7];
  ck[(size_t)idx * 2 * tile] = lo;
  ck[(size_t)idx * 2 * tile + tile] = hi;
}
__device__ __forceinline__ void get(const float4* ck, int tile, int idx, F32& m) {
  const float4 lo = ck[(size_t)idx * 2 * tile], hi = ck[(size_t)idx * 2 * tile + tile];
  m.x[0] = lo.x, m.x[1] = lo.y, m.x[2] = lo.z, m.x[3] = lo.w;
  m.x[4] = hi.x, m.x[5] = hi.y, m.x[6] = hi.z, m.x[7] = hi.w;
}

// x advanced over the chunk's valid pairs (those at [C-n, C)), each
// followed by norm0 if NORM (phase 1; training does not normalise); `on`
// false keeps x (a frozen training).  FULL (n == C and on): the plain
// steps.  Otherwise straight-line, the invalid pairs dropped by selects.
template <int C, bool BETA, int RADIX, bool NORM, bool FULL>
__device__ __forceinline__ void steps(F32& x, const Pairs<C>& g, int n, bool on) {
#pragma unroll
  for (int u = 0; u < C; ++u) {
    F32 y = x;
    advance<BETA, RADIX>(y, g.g[u]);
    if (NORM) normalise(y);
    if (FULL)
      x = y;
    else
      select(x, y, on && u >= C - n);
  }
}
template <int C, bool BETA, int RADIX, bool NORM>
__device__ __forceinline__ void chunk(F32& x, const Pairs<C>& g, int n, bool on) {
  if (!on) return;
  if (n == C)
    steps<C, BETA, RADIX, NORM, true>(x, g, n, on);
  else
    steps<C, BETA, RADIX, NORM, false>(x, g, n, on);
}

__device__ __forceinline__ float llr(const F32& a, const F32& b1, float gs, float gp) {
#ifdef FUSED_LOADS_ONLY
  return a.x[0] + b1.x[1] + gs + gp;
#else
  return emit2(a.x, b1.x, gs, gp);
#endif
}
__device__ __forceinline__ void astep(const F32& a, F32& n, float gs, float gp) {
#ifdef FUSED_LOADS_ONLY
  n = a;
  n.x[0] += gs;
#else
  astep2(a.x, n.x, gs, gp);
#endif
}
__device__ __forceinline__ void bstep(const F32& b, F32& n, float gs, float gp) {
#ifdef FUSED_LOADS_ONLY
  n = b;
  n.x[1] += gp;
#else
  bstep2(b.x, n.x, gs, gp);
#endif
}

// Phase 2, one pair step of the reader x over its row pair g against the
// other chain's metric o at the same pair, as _make_kernel_v7 emits:
// alpha (x = alpha(2j), o = beta(2j+2)) writes positions 2j, 2j+1; beta
// (x = beta(e+2), o = alpha(e), e = L-2j-2) writes e, e+1; then x advances
// one pair and subtracts state 0.  Radix 2 carries the chain through its
// own odd-position metric, radix 4 takes the grouped two-step.
template <bool BETA, int RADIX>
__device__ __forceinline__ void emit_pair(F32& x, const F32& o, const Pair& g, float* outl,
                                          size_t ns, int pos, bool write) {
  F32 odd, ao;
  if (BETA) {
    bstep(x, odd, g.s1, g.p1);  // beta(e+1)
    const float v0 = llr(o, odd, g.s0, g.p0);
    astep(o, ao, g.s0, g.p0);  // alpha(e+1)
    const float v1 = llr(ao, x, g.s1, g.p1);
    if (write) {
      outl[(size_t)pos * ns] = v0;
      outl[(size_t)(pos + 1) * ns] = v1;
    }
    if (RADIX == 4)
      advance<true, 4>(x, g);
    else
      bstep(odd, x, g.s0, g.p0);
  } else {
    F32 b1;
    bstep(o, b1, g.s1, g.p1);  // beta(2j+1)
    const float v0 = llr(x, b1, g.s0, g.p0);
    astep(x, odd, g.s0, g.p0);  // alpha(2j+1)
    const float v1 = llr(odd, o, g.s1, g.p1);
    if (write) {
      outl[(size_t)pos * ns] = v0;
      outl[(size_t)(pos + 1) * ns] = v1;
    }
    if (RADIX == 4)
      advance<false, 4>(x, g);
    else
      astep(odd, x, g.s1, g.p1);
  }
  normalise(x);
}

// Phase 2, one segment: the reader x emits against the other chain's chunk
// idx, n of its pairs (the other chain's pair indices idx*C + m, m < n),
// rebuilding r[m] (the other chain's metric at pair index idx*C + m) from
// checkpoint idx with the other chain's phase-1 step over g[C-m].  Pair
// index i = idx*C + m is the reader's row pair g[C-1-m]; alpha emits it at
// 2(l2-1-i), beta at 2i.
template <int C, bool BETA, int RADIX, bool FULL>
__device__ __forceinline__ void segment(F32& x, const Pairs<C>& g, int n, const float4* ck,
                                        int tile, int idx, float* outl, size_t ns, int l2) {
  F32 r[C];
  get(ck, tile, idx, r[0]);
#pragma unroll
  for (int m = 1; m < C; ++m) {
    r[m] = r[m - 1];
    advance<!BETA, RADIX>(r[m], g.g[C - m]);
    normalise(r[m]);
  }
#pragma unroll
  for (int m = C - 1; m >= 0; --m) {
    const int i = idx * C + m;
    const int pos = BETA ? 2 * i : 2 * (l2 - 1 - i);
    if (FULL) {
      emit_pair<BETA, RADIX>(x, r[m], g.g[C - 1 - m], outl, ns, pos, true);
      continue;
    }
    F32 y = x;
    emit_pair<BETA, RADIX>(y, r[m], g.g[C - 1 - m], outl, ns, pos, m < n);
    select(x, y, m < n);
  }
}

// A block: `tile` lanes, threads [0, tile) alpha, [tile, 2*tile) beta.
template <int C, int RADIX>
__global__ void __launch_bounds__(2 * kMaxTile, FUSED_MIN_BLOCKS)
fused_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
             const float* __restrict__ a0, const float* __restrict__ b0,
             float* __restrict__ out, int n, int t_train, int l_win, int nof_b,
             int nof_w) {
  extern __shared__ uint4 smem[];
  const int tile = (int)blockDim.x / 2;
  const bool beta = (int)threadIdx.x >= tile;
  const int p = (int)threadIdx.x - (beta ? tile : 0);
  const int lane = (int)blockIdx.x * tile + p;
  const bool live = lane < n;
  const int t2 = t_train / 2, l2 = l_win / 2, h = l2 / 2, nck = (h + C - 1) / C;
  const size_t ns = (size_t)n;
  // [alpha checkpoints | beta checkpoints | ring]
  float4* ack = reinterpret_cast<float4*>(smem) + p;
  float4* bck = ack + (size_t)nck * 2 * tile;
  Ring ring{gs + lane, gp + lane,
            reinterpret_cast<float*>(smem + (size_t)2 * nck * 2 * tile) + threadIdx.x,
            2 * tile, ns, beta ? l_win + 2 * t_train - 2 : 0, beta ? -2 : 2, t2 + l2, 0};

  F32 x;
  if (live) {
    const float* x0 = (beta ? b0 : a0) + lane;
#pragma unroll
    for (int s = 0; s < 8; ++s) x.x[s] = x0[s * ns];
    ring.start();
    const bool trains = beta ? lane < (nof_w - 1) * nof_b : lane >= nof_b;
    for (int i = 0; i < t2; i += C) {
      Pairs<C> g;
      const int c = t2 - i < C ? t2 - i : C;
      ring.take<C>(c, g);
      if (beta)
        chunk<C, true, RADIX, false>(x, g, c, trains);
      else
        chunk<C, false, RADIX, false>(x, g, c, trains);
    }
    for (int s = 0; s < nck; ++s) {
      Pairs<C> g;
      const int c = h - s * C < C ? h - s * C : C;
      put(beta ? bck : ack, tile, s, x);
      ring.take<C>(c, g);
      if (beta)
        chunk<C, true, RADIX, true>(x, g, c, true);
      else
        chunk<C, false, RADIX, true>(x, g, c, true);
    }
  }
  __syncthreads();  // every checkpoint of phase 1 is written
  if (live) {
    // segments in stream order: the other chain's chunks from the last
    // (partial if C does not divide L/4) to the first
    for (int idx = nck - 1; idx >= 0; --idx) {
      Pairs<C> g;
      const int c = h - idx * C < C ? h - idx * C : C;
      ring.take<C>(c, g);
      const float4* other = beta ? ack : bck;
      if (beta) {
        if (c == C)
          segment<C, true, RADIX, true>(x, g, c, other, tile, idx, out + lane, ns, l2);
        else
          segment<C, true, RADIX, false>(x, g, c, other, tile, idx, out + lane, ns, l2);
      } else {
        if (c == C)
          segment<C, false, RADIX, true>(x, g, c, other, tile, idx, out + lane, ns, l2);
        else
          segment<C, false, RADIX, false>(x, g, c, other, tile, idx, out + lane, ns, l2);
      }
    }
  }
}

// Bytes of shared memory a block of `tile` lanes needs at window L and
// checkpoint stride c (pairs), or -1 for a shape, tile or stride the kernel
// does not take.
long long smem_need(int l_win, int tile, int every) {
  if (l_win < 4 || l_win % 4 || tile < 1 || tile > kMaxTile ||
      !(every == 1 || every == 2 || every == 4))
    return -1;
  const long long checkpoints = 2LL * ((l_win / 4 + every - 1) / every);
  return (long long)tile * (checkpoints * 8 * sizeof(float) + 2 * kStages * 4 * sizeof(float));
}

template <class K>
int launch(K kernel, const float* gs, const float* gp, const float* a0, const float* b0,
           float* out, int n, int t_train, int l_win, int nof_b, int nof_w, int tile,
           int smem, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + tile - 1) / tile, 2 * tile, smem, (cudaStream_t)stream>>>(
      gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

template <int RADIX>
int launch_radix(int every, const float* gs, const float* gp, const float* a0,
                 const float* b0, float* out, int n, int t_train, int l_win, int nof_b,
                 int nof_w, int tile, int smem, void* stream) {
  const auto args = [&](auto kernel) {
    return launch(kernel, gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, tile, smem,
                  stream);
  };
  switch (every) {
    case 1: return args(fused_kernel<1, RADIX>);
    case 2: return args(fused_kernel<2, RADIX>);
    default: return args(fused_kernel<4, RADIX>);
  }
}

}  // namespace

// radix: 2 (v7) or 4 (v8); tile: lanes a block (1-32); every: the checkpoint
// stride c in row pairs (1, 2 or 4); smem: the block's dynamic shared
// memory, at least turbo_fused_smem's and at most 232,448 B.  The arguments
// are checked also at n = 0, so a caller can ask whether a geometry is
// taken.
extern "C" int turbo_map_fused(const float* gs, const float* gp, const float* a0,
                               const float* b0, float* out, int n, int t_train, int l_win,
                               int nof_b, int nof_w, int radix, int tile, int every,
                               int smem, void* stream) {
  const long long need = smem_need(l_win, tile, every);
  if (need < 0 || (radix != 2 && radix != 4) || n < 0 || t_train < 0 || t_train % 2 ||
      smem < need || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (radix == 4)
    return launch_radix<4>(every, gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, tile,
                           smem, stream);
  return launch_radix<2>(every, gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, tile,
                         smem, stream);
}

// The bytes of shared memory turbo_map_fused needs for a block, or -1.
extern "C" long long turbo_fused_smem(int l_win, int tile, int every) {
  return smem_need(l_win, tile, every);
}

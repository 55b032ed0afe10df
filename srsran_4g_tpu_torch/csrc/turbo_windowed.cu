// One windowed max-log-MAP (BCJR) half-iteration of the LTE 8-state RSC
// turbo constituent code in f32, for NVIDIA Hopper (sm_90a): the two chains
// of a lane meet in the middle, and each stores checkpoints of its metrics in
// shared memory for the other.
//
// Replaces the TPU kernels map_windowed_pallas_r4
// (srsran_4g_tpu/ops/pallas/turbo_map.py:272, body _make_kernel_v4) and the
// f32 body of map_windowed_pallas (:1423, _make_kernel :1323) as
// turbo_map_windowed, and that entry's _make_kernel_v3 (:1189, TURBO_KERNEL=v3)
// as turbo_map_v3.  Both compute the single-chain function of the plain
// version map_windowed_ref (ops/cuda/turbo_map.py; map_v3_ref names it) with
// its operations (trellis::alpha_step, beta_step, llr<false>: metrics minus
// their max every step, the LLR as (a + p*gp) + b), so every alpha_k and
// beta_{k+1} is the same value and the LLRs are equal (max |diff| 0).  Any L
// and T: odd L and T, T = 0, one window (W = 1) and L = K up to 6144 (the
// exact full-length recursion) all come here.
//
// Contract (the Pallas entries' own, prepared by ops/turbo.py):
//   gs, gp   (L+2T, N) f32  gamma rows; row r of lane w*B+b is trellis index
//                           w*L - T + r (clamped) of block b
//   a0, b0   (8, N)    f32  initial alpha / beta metrics
//   out      (L, N)    f32  a-posteriori LLRs
// Alpha trains on rows [0, T), frozen on window-0 lanes (lane < B); beta
// trains on rows L+2T-1 down to L+T, frozen on last-window lanes
// (lane >= (W-1)*B).  The LLR at body position k takes alpha_k (alpha after
// rows [T, T+k)), beta_{k+1} (beta after rows L+T-1 down to T+k+1) and row
// T+k.
//
// What bounds it on the H100: the function must read 2*(L+2T)*N*4 B of
// gamma and 2*8*N*4 B of initial metrics and write L*N*4 B of LLRs (143 MB
// at the 20 MHz bench shape, L = 208, T = 32, N = 46,592: 0.0427 ms at
// 3.35 TB/s), against about 39 f32 operations per trellis step per chain and
// 40 per LLR (chip_smoke.py prints both bounds).  The kernel it replaces
// stored every body alpha in device memory, (L, 8, N) f32 (620 MB of round
// trip at the bench shape), and ran each lane as one serial chain of 2(T+L)
// steps with one row loaded ahead.
//
// Design:
// - Meeting in the middle.  h = ceil(L/2).  Phase 1: alpha trains and runs
//   the body rows [T, T+h) (to alpha_h); beta trains and runs the body rows
//   T+L-1 down to T+h (to beta_h).  Phase 2: alpha emits positions [h, L),
//   beta positions [0, h), each against the other chain's phase-1 metrics,
//   and carries its own chain on.  One barrier between the phases
//   (map_windowed, one thread a chain); none in map_v3, whose thread runs
//   both chains of its lane and reads only its own stores.  A thread's
//   serial path is T+L steps, not 2(T+L).
// - Checkpoints in shared memory.  Phase 1 cuts each chain's body into
//   chunks of c positions (alpha from position 0 up, beta from L down) and
//   stores the metric at the start of each chunk, 8 f32 (32 B):
//   32*(ceil(h/c) + ceil((L-h)/c)) B a lane, never device memory.  In phase
//   2 the reader takes a segment of the other chain (its c positions), reads
//   the segment's gamma rows (its own next c rows, which the rebuild needs
//   too, so no byte is read twice for it), rebuilds the c metrics from the
//   checkpoint with the other chain's step, holds them in registers, and
//   emits the segment.  The rebuild and the reader's own chain are
//   independent, so they overlap; it costs (c-1)/c steps a position.
// - Gamma rows through a ring of kStages (8) rows a chain in shared memory,
//   filled by cp.async, one commit group a row.  A chain takes its rows a
//   chunk at a time (up to c rows: wait, read them all into registers, refill
//   their slots kStages rows ahead), so a segment's rows are on chip when its
//   checkpoint is rebuilt.  A full chunk runs straight-line; a partial one
//   (the last of a phase-1 run, the first segment of phase 2) computes a
//   full chunk and keeps only its valid steps (selects).  map_v3 takes the
//   straight path when both chains' chunks are full, so that they
//   interleave.
// - Shared memory a block: [alpha checkpoints | beta checkpoints | rings],
//   each checkpoint [index][half][lane] of float4, so a warp's access is 512
//   contiguous bytes.  The host (ops/cuda/turbo_map.windowed_geometry)
//   picks the tile (lanes a block), c and the bytes so that a block fits the
//   232,448 B an H100 block may opt into; the entry checks them and opts in.
// - Lanes past N (a ragged last tile) skip loads, arithmetic and stores but
//   reach the barrier.
//
// Build-time variants, for tools/windowed_split.py only (the defaults are the
// kernel): WINDOWED_STAGES ring rows a chain (a power of two, >= 8);
// WINDOWED_LOADS_ONLY (one add a step and a position in place of the trellis
// arithmetic); WINDOWED_COMPUTE_ONLY (the ring never filled).  c and the tile
// are arguments of the entry.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;

#ifndef WINDOWED_STAGES
#define WINDOWED_STAGES 8
#endif
constexpr int kStages = WINDOWED_STAGES;  // gamma rows in flight per chain
static_assert(kStages >= 8 && (kStages & (kStages - 1)) == 0,
              "the ring's slot is k & (kStages-1), and holds a whole chunk");
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in limit
constexpr int kMaxTile = 32;      // lanes a block

// cp.async.wait_group N: every commit group but the newest N is complete.
template <int N>
__device__ __forceinline__ void wait_groups() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Up to C gamma rows of one chain, in its stream order at [C-n, C); the
// slots before hold 0.
template <int C>
struct Rows {
  float s[C], p[C];
};

// One chain's gamma rows: step i of its stream is row row0 + drow*i, and slot
// i & (kStages-1) of the ring holds it, at base[slot * 2 * stride] (gs) and
// base[(slot * 2 + 1) * stride] (gp), stride = the block's chain count.  One
// commit group per row (an empty one past the last step).  Before each take
// the groups of steps up to k + kStages - 1 are committed, so waiting for all
// but the newest kStages - C leaves the rows of steps k .. k+C-1 complete;
// another ring's groups committed meanwhile only add newer groups, so two
// rings may share a thread.
struct Ring {
  const float* gs;  // this lane's column
  const float* gp;
  float* base;
  int stride;
  size_t ns;  // N
  int row0, drow, steps, k;

  __device__ __forceinline__ void fetch(int i) {
#ifndef WINDOWED_COMPUTE_ONLY
    if (i < steps) {
      const size_t r = (size_t)(row0 + drow * i) * ns;
      float* d = base + (size_t)(i & (kStages - 1)) * 2 * stride;
      __pipeline_memcpy_async(d, gs + r, sizeof(float));
      __pipeline_memcpy_async(d + stride, gp + r, sizeof(float));
    }
#endif
    __pipeline_commit();
  }

  __device__ __forceinline__ void start() {
    for (int i = 0; i < kStages; ++i) fetch(i);
    k = 0;
  }

  // The next n (1 <= n <= C) rows into g, then their slots refilled with the
  // rows kStages steps ahead.
  template <int C>
  __device__ __forceinline__ void take(int n, Rows<C>& g) {
    wait_groups<kStages - C>();
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const float* d = base + (size_t)((k + u - (C - n)) & (kStages - 1)) * 2 * stride;
      const bool in = u >= C - n;
      g.s[u] = in ? d[0] : 0.f;
      g.p[u] = in ? d[stride] : 0.f;
    }
    for (int q = 0; q < n; ++q) fetch(k + kStages + q);
    k += n;
  }
};

// ---- the chains' steps ------------------------------------------------------

template <bool BETA>
__device__ __forceinline__ void step(float x[8], float gs, float gp) {
#ifdef WINDOWED_LOADS_ONLY
  x[0] += gs;
  x[1] += gp;
#else
  if (BETA)
    beta_step(x, gs, gp);
  else
    alpha_step(x, gs, gp);
#endif
}

__device__ __forceinline__ float emit(const float a[8], const float b[8], float gs,
                                      float gp) {
#ifdef WINDOWED_LOADS_ONLY
  return a[0] + b[1] + gs + gp;
#else
  return llr<false>(a, b, gs, gp);
#endif
}

// x advanced over the chunk's valid rows (those at [C-n, C)); `on` false
// keeps x (a frozen training, or no chunk).  FULL (n == C and on): the
// plain steps.  Otherwise straight-line: every step is computed and the
// invalid ones are dropped by selects.
template <int C, bool BETA, bool FULL>
__device__ __forceinline__ void steps(float x[8], const Rows<C>& g, int n, bool on) {
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (FULL) {
      step<BETA>(x, g.s[u], g.p[u]);
      continue;
    }
    float y[8];
    copy8(x, y);
    step<BETA>(y, g.s[u], g.p[u]);
    const bool use = on && u >= C - n;
#pragma unroll
    for (int s = 0; s < 8; ++s) x[s] = use ? y[s] : x[s];
  }
}

// Checkpoint idx of a lane: two float4 at ck[idx*2*tile] and ck[idx*2*tile + tile].
__device__ __forceinline__ void put(float4* ck, int tile, int idx, const float x[8]) {
  float4 lo, hi;
  lo.x = x[0], lo.y = x[1], lo.z = x[2], lo.w = x[3];
  hi.x = x[4], hi.y = x[5], hi.z = x[6], hi.w = x[7];
  ck[(size_t)idx * 2 * tile] = lo;
  ck[(size_t)idx * 2 * tile + tile] = hi;
}

__device__ __forceinline__ void get(const float4* ck, int tile, int idx, float x[8]) {
  const float4 lo = ck[(size_t)idx * 2 * tile], hi = ck[(size_t)idx * 2 * tile + tile];
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// The chunk sizes.  Alpha's body positions [0, h) in chunks from 0 up: chunk
// s is [s*C, min(s*C + C, h)).  Beta's [h, L) in chunks from L down: chunk m
// is [max(h, L - (m+1)*C), L - m*C).  Checkpoint s (m) is the metric at the
// chunk's start in its chain's order: alpha_{s*C}, beta_{L - m*C}.
template <int C>
__device__ __forceinline__ int alpha_chunk(int s, int h) {
  return imin(C, h - s * C);
}
template <int C>
__device__ __forceinline__ int beta_chunk(int m, int h, int l_win) {
  return imin(C, l_win - m * C - h);
}

// Phase 2, one segment: the chain x (alpha if !BETA) emits the positions of
// the other chain's chunk idx, n of them (0: nothing), rebuilding the other
// chain's metrics from checkpoint idx over the segment's rows g.  Rebuilt
// r[i] is the other chain's metric at the segment's i-th position from its
// checkpoint end: alpha's segment emits at L-1-idx*C-i against beta r[i] =
// beta_{L-idx*C-i}; beta's at idx*C+i against alpha r[i] = alpha_{idx*C+i}.
// Both take row g[C-1-i] for position i and rebuild r[i] over g[C-i].
template <int C, bool BETA, bool FULL>
__device__ __forceinline__ void segment(float x[8], const Rows<C>& g, int n, const float4* ck,
                                        int tile, int idx, float* outl, size_t ns,
                                        int l_win) {
  float r[C][8];
  get(ck, tile, idx > 0 ? idx : 0, r[0]);
#pragma unroll
  for (int i = 1; i < C; ++i) {
    copy8(r[i - 1], r[i]);
    step<!BETA>(r[i], g.s[C - i], g.p[C - i]);
  }
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    const float gs = g.s[C - 1 - i], gp = g.p[C - 1 - i];
    const float v = BETA ? emit(r[i], x, gs, gp) : emit(x, r[i], gs, gp);
    const int pos = BETA ? idx * C + i : l_win - 1 - idx * C - i;
    if (FULL) {
      outl[(size_t)pos * ns] = v;
      step<BETA>(x, gs, gp);
      continue;
    }
    if (i < n) outl[(size_t)pos * ns] = v;
    float y[8];
    copy8(x, y);
    step<BETA>(y, gs, gp);
#pragma unroll
    for (int s = 0; s < 8; ++s) x[s] = i < n ? y[s] : x[s];
  }
}

// One chain's chunk or segment, through the straight path when it is full.
template <int C, bool BETA>
__device__ __forceinline__ void advance(float x[8], const Rows<C>& g, int n, bool on) {
  if (!on) return;
  if (n == C)
    steps<C, BETA, true>(x, g, n, on);
  else
    steps<C, BETA, false>(x, g, n, on);
}
template <int C, bool BETA>
__device__ __forceinline__ void emit_segment(float x[8], const Rows<C>& g, int n,
                                             const float4* ck, int tile, int idx, float* outl,
                                             size_t ns, int l_win) {
  if (n == C)
    segment<C, BETA, true>(x, g, n, ck, tile, idx, outl, ns, l_win);
  else
    segment<C, BETA, false>(x, g, n, ck, tile, idx, outl, ns, l_win);
}

__device__ __forceinline__ void load8(const float* p, size_t ns, float x[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = p[s * ns];
}

// Shared memory of a block: [alpha checkpoints | beta checkpoints | rings].
struct Layout {
  float4* ack;  // this lane's alpha checkpoints
  float4* bck;
  float* ring;  // the rings' base (chain 0 of the block)
};
__device__ __forceinline__ Layout layout(uint4* smem, int tile, int p, int na, int nb) {
  float4* ck = reinterpret_cast<float4*>(smem);
  return Layout{ck + p, ck + (size_t)na * 2 * tile + p,
                reinterpret_cast<float*>(ck + (size_t)(na + nb) * 2 * tile)};
}

// map_windowed: a block of `tile` lanes, threads [0, tile) alpha,
// [tile, 2*tile) beta.
template <int C>
__global__ void __launch_bounds__(2 * kMaxTile, 8)
windowed_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                const float* __restrict__ a0, const float* __restrict__ b0,
                float* __restrict__ out, int n, int t_train, int l_win, int nof_b,
                int nof_w) {
  extern __shared__ uint4 smem[];
  const int tile = (int)blockDim.x / 2;
  const bool beta = (int)threadIdx.x >= tile;
  const int p = (int)threadIdx.x - (beta ? tile : 0);
  const int lane = (int)blockIdx.x * tile + p;
  const bool live = lane < n;
  const int h = (l_win + 1) / 2, na = (h + C - 1) / C, nb = (l_win - h + C - 1) / C;
  const size_t ns = (size_t)n;
  const Layout sm = layout(smem, tile, p, na, nb);
  Ring ring{gs + lane, gp + lane, sm.ring + threadIdx.x, 2 * tile, ns,
            beta ? l_win + 2 * t_train - 1 : 0, beta ? -1 : 1, t_train + l_win, 0};

  float x[8];
  if (live) {
    load8((beta ? b0 : a0) + lane, ns, x);
    ring.start();
    const bool trains = beta ? lane < (nof_w - 1) * nof_b : lane >= nof_b;
    for (int i = 0; i < t_train; i += C) {
      Rows<C> g;
      const int c = imin(C, t_train - i);
      ring.take<C>(c, g);
      if (beta)
        advance<C, true>(x, g, c, trains);
      else
        advance<C, false>(x, g, c, trains);
    }
    for (int s = 0; s < (beta ? nb : na); ++s) {
      Rows<C> g;
      const int c = beta ? beta_chunk<C>(s, h, l_win) : alpha_chunk<C>(s, h);
      put(beta ? sm.bck : sm.ack, tile, s, x);
      ring.take<C>(c, g);
      if (beta)
        advance<C, true>(x, g, c, true);
      else
        advance<C, false>(x, g, c, true);
    }
  }
  __syncthreads();  // every checkpoint of phase 1 is written
  if (live) {
    // segments in stream order: the other chain's chunks from the meeting
    // point out, the first one partial
    for (int i = 0, m = beta ? na : nb; i < m; ++i) {
      Rows<C> g;
      const int idx = m - 1 - i;
      const int c = beta ? alpha_chunk<C>(idx, h) : beta_chunk<C>(idx, h, l_win);
      ring.take<C>(c, g);
      if (beta)
        emit_segment<C, true>(x, g, c, sm.ack, tile, idx, out + lane, ns, l_win);
      else
        emit_segment<C, false>(x, g, c, sm.bck, tile, idx, out + lane, ns, l_win);
    }
  }
}

// map_v3: a block of `tile` lanes, one thread a lane running both chains,
// interleaved.  Alpha has na >= nb chunks (na - nb <= 1); a chain without a
// chunk in a round takes no rows and keeps its metric.
template <int C>
__global__ void __launch_bounds__(kMaxTile, 16)
v3_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
          const float* __restrict__ a0, const float* __restrict__ b0,
          float* __restrict__ out, int n, int t_train, int l_win, int nof_b, int nof_w) {
  extern __shared__ uint4 smem[];
  const int tile = (int)blockDim.x, p = (int)threadIdx.x;
  const int lane = (int)blockIdx.x * tile + p;
  if (lane >= n) return;  // no barrier: a thread reads only its own stores
  const int h = (l_win + 1) / 2, na = (h + C - 1) / C, nb = (l_win - h + C - 1) / C;
  const size_t ns = (size_t)n;
  const Layout sm = layout(smem, tile, p, na, nb);
  Ring ra{gs + lane, gp + lane, sm.ring + p, 2 * tile, ns, 0, 1, t_train + l_win, 0};
  Ring rb{gs + lane, gp + lane, sm.ring + tile + p, 2 * tile, ns, l_win + 2 * t_train - 1,
          -1, t_train + l_win, 0};
  float a[8], b[8];
  load8(a0 + lane, ns, a);
  load8(b0 + lane, ns, b);
  ra.start();
  rb.start();
  const bool ta = lane >= nof_b, tb = lane < (nof_w - 1) * nof_b;
  for (int i = 0; i < t_train; i += C) {
    Rows<C> ga, gb;
    const int c = imin(C, t_train - i);
    ra.take<C>(c, ga);
    rb.take<C>(c, gb);
    if (c == C && ta && tb) {
      steps<C, false, true>(a, ga, c, true);
      steps<C, true, true>(b, gb, c, true);
    } else {
      steps<C, false, false>(a, ga, c, ta);
      steps<C, true, false>(b, gb, c, tb);
    }
  }
  for (int s = 0; s < na; ++s) {
    Rows<C> ga, gb = {};
    const int ca = alpha_chunk<C>(s, h), cb = s < nb ? beta_chunk<C>(s, h, l_win) : 0;
    put(sm.ack, tile, s, a);
    ra.take<C>(ca, ga);
    if (cb) {
      put(sm.bck, tile, s, b);
      rb.take<C>(cb, gb);
    }
    if (ca == C && cb == C) {
      steps<C, false, true>(a, ga, ca, true);
      steps<C, true, true>(b, gb, cb, true);
    } else {
      steps<C, false, false>(a, ga, ca, true);
      steps<C, true, false>(b, gb, cb, cb > 0);
    }
  }
  for (int i = 0; i < na; ++i) {
    Rows<C> ga = {}, gb;
    const int ia = nb - 1 - i, ib = na - 1 - i;
    const int ca = i < nb ? beta_chunk<C>(ia, h, l_win) : 0, cb = alpha_chunk<C>(ib, h);
    if (ca) ra.take<C>(ca, ga);
    rb.take<C>(cb, gb);
    if (ca == C && cb == C) {
      segment<C, false, true>(a, ga, ca, sm.bck, tile, ia, out + lane, ns, l_win);
      segment<C, true, true>(b, gb, cb, sm.ack, tile, ib, out + lane, ns, l_win);
    } else {
      segment<C, false, false>(a, ga, ca, sm.bck, tile, ia, out + lane, ns, l_win);
      segment<C, true, false>(b, gb, cb, sm.ack, tile, ib, out + lane, ns, l_win);
    }
  }
}

// Bytes of shared memory a block of `tile` lanes needs at window L and
// checkpoint stride c, or -1 for a tile or stride the kernel does not take.
long long smem_need(int l_win, int tile, int every, bool v3) {
  const bool ok_every = every == 1 || every == 2 || every == 4 || (every == 8 && !v3);
  if (l_win < 1 || tile < 1 || tile > kMaxTile || !ok_every) return -1;
  const int h = (l_win + 1) / 2;
  const long long checkpoints = (h + every - 1) / every + (l_win - h + every - 1) / every;
  return (long long)tile * (checkpoints * 2 * sizeof(float4) +
                            2 * kStages * 2 * sizeof(float));
}

template <class K>
int launch(K kernel, int threads, const float* gs, const float* gp, const float* a0,
           const float* b0, float* out, int n, int t_train, int l_win, int nof_b,
           int nof_w, int tile, int smem, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + tile - 1) / tile, threads, smem, (cudaStream_t)stream>>>(
      gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

// Checks the arguments (also at n = 0, so a caller can ask whether a
// geometry is taken), then launches.
int entry(bool v3, const float* gs, const float* gp, const float* a0, const float* b0,
          float* out, int n, int t_train, int l_win, int nof_b, int nof_w, int tile,
          int every, int smem, void* stream) {
  const long long need = smem_need(l_win, tile, every, v3);
  if (need < 0 || t_train < 0 || n < 0 || smem < need || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = v3 ? tile : 2 * tile;
  const auto args = [&](auto kernel) {
    return launch(kernel, threads, gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w,
                  tile, smem, stream);
  };
  if (v3) {
    switch (every) {
      case 1: return args(v3_kernel<1>);
      case 2: return args(v3_kernel<2>);
      default: return args(v3_kernel<4>);
    }
  }
  switch (every) {
    case 1: return args(windowed_kernel<1>);
    case 2: return args(windowed_kernel<2>);
    case 4: return args(windowed_kernel<4>);
    default: return args(windowed_kernel<8>);
  }
}

}  // namespace

// tile: lanes a block (1-32); every: the checkpoint stride c (1, 2, 4, 8);
// smem: the block's dynamic shared memory, at least turbo_windowed_smem's.
extern "C" int turbo_map_windowed(const float* gs, const float* gp, const float* a0,
                                  const float* b0, float* out, int n, int t_train,
                                  int l_win, int nof_b, int nof_w, int tile, int every,
                                  int smem, void* stream) {
  return entry(false, gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, tile, every,
               smem, stream);
}

// The same function with one thread a lane (both chains); every: 1, 2 or 4.
extern "C" int turbo_map_v3(const float* gs, const float* gp, const float* a0,
                            const float* b0, float* out, int n, int t_train, int l_win,
                            int nof_b, int nof_w, int tile, int every, int smem,
                            void* stream) {
  return entry(true, gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, tile, every,
               smem, stream);
}

// The bytes of shared memory the entries need for a block (v3: 0 or 1), or -1.
extern "C" long long turbo_windowed_smem(int l_win, int tile, int every, int v3) {
  return smem_need(l_win, tile, every, v3 != 0);
}

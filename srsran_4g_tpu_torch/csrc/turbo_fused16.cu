// One windowed max-log-MAP half-iteration in the fused two-phase dataflow at
// bf16 (v9), for NVIDIA Hopper (sm_90a), with the half-depth stores in
// shared memory.
//
// Replaces the TPU kernel map_windowed_pallas_v9
// (srsran_4g_tpu/ops/pallas/turbo_map.py:942, pallas_call :1005, body
// _make_kernel_v7 :641 with bf16 and train_norm): gammas, initial metrics,
// every add and subtract, and the stores in bf16; metrics minus state 0
// after every training pair and every body pair; LLRs emitted as bf16
// values written as f32.  Every add and subtract has the operands, and the
// grouping, of the Pallas body and of the plain version map_fused16_ref
// (ops/cuda/turbo_map.py); only maxes, which round nothing, are taken in
// another order, so the three agree exactly.
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
// per emitted LLR (0.0374 ms at the CUDA cores' dispatch rate).  Measured on
// an H100 at 700 W (tools/fused16_split.py; PERF.md): this dataflow's loads
// alone take 0.073 ms, since each chain reads again in phase 2 the body rows
// that the other chain read in phase 1, likely from HBM by then; its
// arithmetic alone takes 0.059-0.062 ms.
//
// Design:
// - The stores live in shared memory, never in device memory, as the TPU
//   kernel keeps them in VMEM (the earlier kernel of this function wrote and
//   read 155 MB of them in device memory at the bench shape, more than the
//   function's own 143 MB).  Each chain stores every other of its L/4
//   phase-1 metrics, 16 B each: 4*L bytes a lane (832 B at L = 208).  A
//   metric that was not stored is the stored one before it advanced one row
//   pair and normalised, over the rows that are the reader's next step:
//   the same bf16 operations on the same values, so the same metric.  This
//   doubles the lanes an SM holds for one extra pair step every other step
//   of phase 2.
// - A block is a tile of 32 lanes and runs one thread per chain: threads
//   [0, 32) carry alpha, threads [32, 64) beta, so each warp runs one kind
//   of chain.  The chains need each other only at the midpoint:
//   phase 1 (pairs j < L/4) stores alpha(2j) and beta(L-2j); phase 2 keeps
//   each chain going and reads only the other chain's stores, so one
//   __syncthreads() separates the phases.  In phase 2 the alpha thread
//   emits positions [L/2, L), the pair (2j, 2j+1) against beta(2j+2), and
//   the beta thread positions [0, L/2), the pair (L-2j-2, L-2j-1) against
//   alpha(L-2j-2), each with one radix-2 step off its chain for the odd
//   position (_make_kernel_v7 :825-867).  Out-of-range lanes of the last
//   tile skip their loads, arithmetic and stores but reach the barrier.
// - The 8 metrics of a chain are 4 bf16 pairs, laid out so that every
//   radix-2 step needs each input only broadcast to both halves (a free
//   operand selector) and no repacking: alpha keeps {x[m], x[m+4]}, the
//   states with the same predecessors; beta {x[2k], x[2k+1]}, the states
//   with the same successors.  Each half gets the scalar step's bf16 add
//   and max.  Scalar bf16 metrics compile to paired instructions anyway,
//   with a byte permute (PRMT) per operand moved between halves: the
//   earlier kernel's bf16 body has 376 PRMT beside 241 adds and maxes.
// - Each thread's gamma row pairs stream through a ring of kStages slots in
//   shared memory filled by cp.async, the next row pair read one step ahead,
//   so the loads overlap the arithmetic.  Step k of a chain reads row 2k
//   (alpha) or L+2T-2-2k (beta), training, phase 1 and phase 2 alike, so
//   one ring serves the whole run.
// - Stores are [pair][lane] of 16 bytes: a warp's store or load is 512
//   contiguous bytes, free of bank conflicts.
// - The host (ops/cuda/turbo_map.fused16_geometry) passes the tile and the
//   dynamic shared-memory bytes, tile * (32*ceil(L/8) + 256): the stores and
//   the ring, 34,816 B at L = 208 and 32 lanes.  The tile is 32 lanes up to
//   L = 1,752, then 16 (to L = 3,568), then 8 (to L = 7,200; the full
//   K = 6,144 takes 198,656 B), so that a block fits the 232,448 B an H100
//   block may opt into; the entry opts into the bytes it is given.
//
// Build-time variants, for tools/fused16_split.py only (the defaults are the
// kernel): FUSED16_TILE, a further tile the entry takes (lanes a block),
// FUSED16_STAGES ring slots, FUSED16_EVERY = 1 to store every phase-1
// metric; FUSED16_LOADS_ONLY (one bf16 add a step
// in place of the trellis arithmetic and the emission), FUSED16_COMPUTE_ONLY
// (the ring never filled) and FUSED16_COOP_FILL (each warp fills its ring
// slot with one 16-byte cp.async a thread; needs N % 4 == 0 and no ragged
// tile).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "trellis.cuh"

namespace {

using namespace trellis;
using M = __nv_bfloat16;
using V = __nv_bfloat162;  // two metrics, or two branch terms

#ifndef FUSED16_STAGES
#define FUSED16_STAGES 8
#endif
#ifndef FUSED16_EVERY
#define FUSED16_EVERY 2
#endif
constexpr int kStages = FUSED16_STAGES;   // gamma row pairs in flight per thread
constexpr int kEvery = FUSED16_EVERY;     // phase-1 metrics per store
static_assert(kEvery == 1 || kEvery == 2, "a store is read at most one pair ahead");
static_assert((kStages & (kStages - 1)) == 0, "the ring's slot is k & (kStages-1)");

// ---- the trellis facts the paired steps rest on -----------------------------
// Alpha: states t and t^4 have the same two predecessors, 2*(t&3) and
// 2*(t&3)+1, and the complementary input and parity bits on each.  Beta:
// states s and s^1 have the same two successors, each other's, with the same
// parity per input; the two successors differ in bit 2.
constexpr bool trellis_pairs() {
  for (int t = 0; t < 4; ++t)
    for (int j = 0; j < 2; ++j)
      if (pred_state(t, j) != 2 * t + j || pred_state(t + 4, j) != 2 * t + j ||
          pred_input(t + 4, j) != 1 - pred_input(t, j) ||
          pred_parity(t + 4, j) != 1 - pred_parity(t, j))
        return false;
  for (int s = 0; s < 8; s += 2)
    for (int u = 0; u < 2; ++u)
      if (next_state(s + 1, u) != next_state(s, 1 - u) ||
          parity(s + 1, u) != parity(s, u) ||
          parity(s, 1) != 1 - parity(s, 0) ||
          (next_state(s, 0) ^ next_state(s, 1)) != 4)
        return false;
  return true;
}
static_assert(trellis_pairs(), "the LTE trellis pairs its states as assumed");

// ---- 8 metrics as 4 pairs ----------------------------------------------------
// Alpha keeps {x[m], x[m+4]} in r[m] (layout Q: the pairs that share
// predecessors), beta {x[2k], x[2k+1]} in r[k] (layout P: the pairs that
// share successors).  State 0 is the low half of r[0] in both.
template <bool Q>
__device__ __forceinline__ M elem(const V r[4], int s) {
  const V v = r[Q ? (s & 3) : (s >> 1)];
  return (Q ? (s >> 2) : (s & 1)) ? __high2bfloat16(v) : __low2bfloat16(v);
}
template <bool Q>
__device__ __forceinline__ V bcast(const V r[4], int s) {  // {x[s], x[s]}
  const V v = r[Q ? (s & 3) : (s >> 1)];
  return (Q ? (s >> 2) : (s & 1)) ? __high2bfloat162(v) : __low2bfloat162(v);
}

// The branch terms of one trellis step (one gamma row) as pairs k[2u + p] =
// {u*gs + p*gp, (1-u)*gs + (1-p)*gp}: {0, gsp}, {gp, gs}, {gs, gp}, {gsp, 0},
// gsp = gs + gp rounded once, as trellis::add_combo adds them.  Adding a
// zero term leaves a metric's value as it is.
struct Terms {
  V k[4];
};
__device__ __forceinline__ Terms terms(float gs, float gp) {
  const V k2 = __floats2bfloat162_rn(gs, gp), k1 = __floats2bfloat162_rn(gp, gs);
  const V sp = __hadd2(k2, k1);
  const M z = __low2bfloat16(__float2bfloat162_rn(0.f));
  return Terms{{__halves2bfloat162(z, __low2bfloat16(sp)), k1, k2,
                __halves2bfloat162(__low2bfloat16(sp), z)}};
}

// Radix-2 alpha step, Q -> Q, unnormalised: trellis::astep2 for the pair
// {t, t^4} at once, each half the same bf16 add and max.
__device__ __forceinline__ void astep2v(const V a[4], V n[4], const Terms& g) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    n[m] = __hmax2(
        __hadd2(bcast<true>(a, pred_state(m, 0)),
                g.k[2 * pred_input(m, 0) + pred_parity(m, 0)]),
        __hadd2(bcast<true>(a, pred_state(m, 1)),
                g.k[2 * pred_input(m, 1) + pred_parity(m, 1)]));
}

// Radix-2 beta step, P -> P, unnormalised: trellis::bstep2 for the pair
// {s, s+1} (s even) at once.  The successor A = next_state(s, 0) adds s's
// input-0 term and s+1's input-1 term, B = next_state(s, 1) the reverse.
__device__ __forceinline__ void bstep2v(const V b[4], V n[4], const Terms& g) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = 2 * k, p0 = parity(s, 0);
    n[k] = __hmax2(__hadd2(bcast<false>(b, next_state(s, 0)), g.k[p0 ? 1 : 0]),
                   __hadd2(bcast<false>(b, next_state(s, 1)), g.k[p0 ? 2 : 3]));
  }
}

// Minus state 0 (trellis::norm0).
__device__ __forceinline__ void norm0v(V x[4]) {
  const V z = __low2bfloat162(x[0]);
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = __hsub2(x[k], z);
}

// trellis::emit2 from alpha (layout Q) and beta_{k+1} (layout P): the 16
// terms a[s] + (b1[next_state(s, u)] + parity(s, u)*gp) as 8 pairs
// {u = 0, u = 1} (four of them swapped), each the same two adds, then both
// 8-way maxes as trees.  A max rounds nothing, so its order does not change
// the result; (m1 + gs) - m0 as emit2.
__device__ __forceinline__ M emit2v(const V a[4], const V b1[4],
                                    const Terms& g) {
  const M z = __low2bfloat16(__float2bfloat162_rn(0.f));
  const M gp = __high2bfloat16(g.k[2]);
  const V g0 = __halves2bfloat162(z, gp), g1 = __halves2bfloat162(gp, z);
  V t[2][4];  // [0]: {u=0, u=1} terms; [1]: swapped
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // the states whose successors are q and q^4, and their parities
    const int s0 = ((q >> 1) << 2) | ((q & 1) << 1), c = parity(s0, 0);
    const V w = __halves2bfloat162(elem<false>(b1, q), elem<false>(b1, q ^ 4));
    const V in[2] = {__hadd2(w, c ? g1 : g0), __hadd2(w, c ? g0 : g1)};
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int s = s0 | d, swapped = next_state(s, 0) != q;
      t[swapped][q] = __hadd2(bcast<true>(a, s), in[swapped]);
    }
  }
  V m[2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
    m[w] = __hmax2(__hmax2(t[w][0], t[w][1]), __hmax2(t[w][2], t[w][3]));
  const V mm = __hmax2(m[0], __lowhigh2highlow(m[1]));  // {m0, m1}
  return __low2bfloat16(__hsub2(
      __hadd2(__high2bfloat162(mm), __low2bfloat162(g.k[2])), __low2bfloat162(mm)));
}

// ---- 8 metrics as one 16-byte vector ---------------------------------------
struct alignas(16) V4 {
  V r[4];
};
__device__ __forceinline__ void put4(uint4* p, const V x[4]) {
  V4 v;
#pragma unroll
  for (int k = 0; k < 4; ++k) v.r[k] = x[k];
  *reinterpret_cast<V4*>(p) = v;
}
__device__ __forceinline__ void get4(const uint4* p, V x[4]) {
  const V4 v = *reinterpret_cast<const V4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = v.r[k];
}
__device__ __forceinline__ void copy4(const V src[4], V dst[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
}

// ---- one chain's gamma rows through a ring of kStages slots ----------------
// Slot s holds (gs[r], gp[r], gs[r+1], gp[r+1]) of the step it was filled
// for, at slot0[(4*s + c) * kThreads].  fetch(k) fills step k's slot and
// commits one cp.async group (an empty one past the last step, so that the
// group count stays in step).  Per step k: `cur` holds step k's pair;
// ahead() waits for step k+1's group and reads its slot into `nxt`, so the
// shared-memory read overlaps step k's arithmetic; next(), after that
// arithmetic, refills step k's slot with step k+kStages and moves on.  A slot
// is refilled only after the step that read it has used its values.
template <int kThreads>  // the block's threads: one per chain
struct GammaRing {
  const float* gs;  // this lane's column
  const float* gp;
  float* slot0;  // ring + threadIdx.x
  size_t ns;     // N
  int row0, drow, steps;
  int k;
  Pair cur, nxt;

  __device__ __forceinline__ void fetch(int i) {
#ifndef FUSED16_COMPUTE_ONLY
    if (i < steps) {
      const size_t r = (size_t)(row0 + drow * i) * ns;
      float* d = slot0 + (i & (kStages - 1)) * 4 * kThreads;
#ifdef FUSED16_COOP_FILL
      // thread l of a warp copies floats 4*(l % 8) .. +3 of the warp's 32
      // lanes of gamma row c = l / 8 (gs r, gp r, gs r+1, gp r+1)
      const int l = threadIdx.x & 31, c = l >> 3, o = 4 * (l & 7) - l;
      __pipeline_memcpy_async(d + o + c * kThreads, (c & 1 ? gp : gs) + o + r + (c >> 1) * ns,
                              4 * sizeof(float));
#else
      __pipeline_memcpy_async(d, gs + r, sizeof(float));
      __pipeline_memcpy_async(d + kThreads, gp + r, sizeof(float));
      __pipeline_memcpy_async(d + 2 * kThreads, gs + r + ns, sizeof(float));
      __pipeline_memcpy_async(d + 3 * kThreads, gp + r + ns, sizeof(float));
#endif
    }
#endif
    __pipeline_commit();
  }

  __device__ __forceinline__ void wait(int pending) {
    __pipeline_wait_prior(pending);
#ifdef FUSED16_COOP_FILL
    __syncwarp();  // the warp's copies of the slot are all in
#endif
  }

  __device__ __forceinline__ Pair read(int i) const {
    const float* d = slot0 + (i & (kStages - 1)) * 4 * kThreads;
    return Pair{d[0], d[kThreads], d[2 * kThreads], d[3 * kThreads]};
  }

  __device__ __forceinline__ void start() {
    for (int i = 0; i < kStages; ++i) fetch(i);
    k = 0;
    wait(kStages - 1);
    cur = read(0);
  }

  // Groups 0 .. k+kStages-1 are committed; step k+1's may leave kStages-2
  // later ones pending.  Past the last step the slot read is stale, unused.
  __device__ __forceinline__ void ahead() {
    wait(kStages - 2);
    nxt = read(k + 1);
  }

  __device__ __forceinline__ void next() {
    fetch(k + kStages);
    ++k;
    cur = nxt;
  }
};

// One chain over one row pair, normalised: alpha(2i) -> alpha(2i+2) in
// layout Q, or beta(2i+2) -> beta(2i) in layout P.
template <bool BETA>
__device__ __forceinline__ void advance(V x[4], const Terms& g0,
                                        const Terms& g1) {
#ifdef FUSED16_LOADS_ONLY
  x[0] = __hadd2(x[0], g0.k[2]);
  x[1] = __hadd2(x[1], g1.k[2]);
#else
  V m[4];
  if (BETA) {
    bstep2v(x, m, g1);
    bstep2v(m, x, g0);
  } else {
    astep2v(x, m, g0);
    astep2v(m, x, g1);
  }
  norm0v(x);
#endif
}

// Training (steps [0, T/2), frozen unless `trains`, normalised every pair)
// and phase 1 (the next L/4 steps j; at even j the metric it starts from is
// stored at own[(j/2) * kTile]).
template <bool BETA, int kTile>
__device__ __forceinline__ void phase1(V x[4], GammaRing<2 * kTile>& ring, uint4* own,
                                       bool trains, int t2, int h) {
  for (int i = 0; i < t2; ++i) {
    const Pair g = ring.cur;
    ring.ahead();
    V nx[4];
    copy4(x, nx);
    advance<BETA>(nx, terms(g.s0, g.p0), terms(g.s1, g.p1));
    if (trains) copy4(nx, x);
    ring.next();
  }
  for (int j = 0; j < h; ++j) {
    const Pair g = ring.cur;
    ring.ahead();
    if (j % kEvery == 0) put4(own + (size_t)(j / kEvery) * kTile, x);
    advance<BETA>(x, terms(g.s0, g.p0), terms(g.s1, g.p1));
    ring.next();
  }
}

// Phase 2 (pairs j in [L/4, L/2)): both positions of one row pair emitted
// against the other chain's metric at its pair index i = L/2-1-j.  Even i:
// the store other[(i/2) * kTile].  Odd i: the store of pair index i-1 (the
// same slot, i/2) advanced one pair and normalised, as the other chain did,
// over the row pair that is this thread's next step (ring.nxt): the same
// bf16 operations on the same values, so the same metric.  Alpha
// (a = alpha(2j)) emits 2j and 2j+1 against beta(2j+2); beta
// (b = beta(e+2), e = L-2j-2) emits e and e+1 against alpha(e).
template <bool BETA, int kTile>
__device__ __forceinline__ void phase2(V x[4], GammaRing<2 * kTile>& ring,
                                       const uint4* other, float* outl,
                                       size_t ns, int l2, int l_win) {
  for (int j = l2 / 2; j < l2; ++j) {
    const Pair g = ring.cur;
    ring.ahead();
    const int i = l2 - 1 - j;
    V st[4], y[4];
    get4(other + (size_t)(i / kEvery) * kTile, st);
    if (i % kEvery)
      advance<!BETA>(st, terms(ring.nxt.s0, ring.nxt.p0),
                     terms(ring.nxt.s1, ring.nxt.p1));
    const Terms g0 = terms(g.s0, g.p0), g1 = terms(g.s1, g.p1);
#ifdef FUSED16_LOADS_ONLY
    x[0] = __hadd2(x[0], __hadd2(st[0], g0.k[1]));
    outl[(size_t)(2 * j) * ns] = to_f32(__low2bfloat16(x[0]));
    outl[(size_t)(2 * j + 1) * ns] = to_f32(__high2bfloat16(x[0]));
#else
    if (BETA) {
      const int e = l_win - 2 * j - 2;
      bstep2v(x, y, g1);  // beta(e+1)
      outl[(size_t)e * ns] = to_f32(emit2v(st, y, g0));
      V ao[4];
      astep2v(st, ao, g0);  // alpha(e+1)
      outl[(size_t)(e + 1) * ns] = to_f32(emit2v(ao, x, g1));
      bstep2v(y, x, g0);
    } else {
      V b1[4];
      bstep2v(st, b1, g1);  // beta(2j+1)
      outl[(size_t)(2 * j) * ns] = to_f32(emit2v(x, b1, g0));
      astep2v(x, y, g0);  // alpha(2j+1)
      outl[(size_t)(2 * j + 1) * ns] = to_f32(emit2v(y, st, g1));
      astep2v(y, x, g1);
    }
#endif
    norm0v(x);
    ring.next();
  }
}

// A block: kTile lanes (32, 16 or 8), 2*kTile threads.
template <int kTile>
__global__ void __launch_bounds__(2 * kTile)
fused16_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
               const float* __restrict__ a0, const float* __restrict__ b0,
               float* __restrict__ out, int n, int t_train, int l_win,
               int nof_b, int nof_w) {
  extern __shared__ uint4 smem[];
  const bool beta = (int)threadIdx.x >= kTile;
  const int p = (int)threadIdx.x - (beta ? kTile : 0);  // lane in the tile
  const int lane = (int)blockIdx.x * kTile + p;
  const bool live = lane < n;
  const int t2 = t_train / 2, l2 = l_win / 2, h = l2 / 2, hs = (h + kEvery - 1) / kEvery;
  const size_t ns = (size_t)n;
  // [alpha stores | beta stores | gamma ring]
  uint4* astore = smem + p;
  uint4* bstore = astore + (size_t)hs * kTile;
  GammaRing<2 * kTile> ring{gs + lane, gp + lane,
                 reinterpret_cast<float*>(smem + (size_t)2 * hs * kTile) + threadIdx.x,
                 ns, beta ? l_win + 2 * t_train - 2 : 0, beta ? -2 : 2, t2 + l2};

  V x[4];
  if (live) {
    const float* x0 = (beta ? b0 : a0) + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lo = beta ? 2 * k : k, hi = beta ? 2 * k + 1 : k + 4;
      x[k] = __floats2bfloat162_rn(x0[lo * ns], x0[hi * ns]);
    }
    ring.start();
    if (beta)
      phase1<true, kTile>(x, ring, bstore, lane < (nof_w - 1) * nof_b, t2, h);
    else
      phase1<false, kTile>(x, ring, astore, lane >= nof_b, t2, h);
  }
  __syncthreads();  // every store of phase 1 is written
  if (live) {
    if (beta)
      phase2<true, kTile>(x, ring, astore, out + lane, ns, l2, l_win);
    else
      phase2<false, kTile>(x, ring, bstore, out + lane, ns, l2, l_win);
  }
}

constexpr int kMaxSmem = 232448;  // an H100 block's opt-in limit

#if defined(FUSED16_TILE) && FUSED16_TILE != 32 && FUSED16_TILE != 16 && FUSED16_TILE != 8
#define FUSED16_EXTRA_TILE FUSED16_TILE
#endif

// Bytes of shared memory a block of `tile` lanes needs at window L (L % 4 ==
// 0), or -1 for a tile the entry does not take.
long long smem_need(int l_win, int tile) {
  const bool ok = tile == 32 || tile == 16 || tile == 8
#ifdef FUSED16_EXTRA_TILE
                  || tile == FUSED16_EXTRA_TILE
#endif
      ;
  if (!ok || l_win <= 0 || l_win % 4) return -1;
  return (long long)tile * (2 * ((l_win / 4 + kEvery - 1) / kEvery) * sizeof(uint4) +
                            2 * kStages * 4 * sizeof(float));
}

template <int kTile>
int launch(const float* gs, const float* gp, const float* a0, const float* b0, float* out,
           int n, int t_train, int l_win, int nof_b, int nof_w, int smem, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused16_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused16_kernel<kTile><<<(n + kTile - 1) / kTile, 2 * kTile, smem, (cudaStream_t)stream>>>(
      gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: lanes per block (32, 16 or 8); smem: the block's dynamic shared
// memory, at least turbo_fused16_smem's and at most 232,448 B.  The
// arguments are checked also at n = 0, so a caller can ask whether a
// geometry is taken.
extern "C" int turbo_map_fused16(const float* gs, const float* gp,
                                 const float* a0, const float* b0, float* out,
                                 int n, int t_train, int l_win, int nof_b,
                                 int nof_w, int tile, int smem, void* stream) {
  const long long need = smem_need(l_win, tile);
  if (need < 0 || n < 0 || t_train < 0 || t_train % 2 || smem < need || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  switch (tile) {
#ifdef FUSED16_EXTRA_TILE
    case FUSED16_EXTRA_TILE:
      return launch<FUSED16_EXTRA_TILE>(gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w,
                                        smem, stream);
#endif
    case 32:
      return launch<32>(gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, smem, stream);
    case 16:
      return launch<16>(gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, smem, stream);
    default:
      return launch<8>(gs, gp, a0, b0, out, n, t_train, l_win, nof_b, nof_w, smem, stream);
  }
}

// The bytes of shared memory turbo_map_fused16 needs for a block, or -1.
extern "C" long long turbo_fused16_smem(int l_win, int tile) {
  return smem_need(l_win, tile);
}

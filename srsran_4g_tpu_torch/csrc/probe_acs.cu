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
// Design: the 8 state metrics of a lane in registers, loads coalesced along
// lanes ([row][lane] layouts).  In bf16x2 a thread's __nv_bfloat162 holds
// two lanes or two lane groups (__hadd2, __hsub2, __hmax2; each half rounds
// to nearest even, as torch and XLA round each bf16 op).  Probe 2 and probe
// 6's skeleton run one thread a lane; probe 2's full and astore bodies and
// probe 6's pair fetch their gammas ahead, probe 6's pair splits its chains
// over two warps, and probe 7 keeps one metric a state pair (each at its
// section).  Where the TPU body kept a store in VMEM scratch (probe 2's
// astore), the store is in shared memory, a ring a lane.  Nothing here is
// forced against the compiler: a body whose work nvcc removes (fixedrow's
// loop-invariant loads, the unread states of addchain, addpar and load1x)
// is reported as folded, as the TPU probe measured what Mosaic kept.
//
// What bounds them on the H100: compute, but for probe 6's pair.  Every
// probe reads a few bytes per trellis step of each lane and does 20-60
// add/max/sub operations per step; at one operation per lane per cycle (132
// SMs x 128 lanes x 1.98 GHz = 33.5 T op/s; two bf16 elements per bf16x2
// instruction) the operations outweigh the bytes at 3.35 TB/s by 5-30x,
// except probe 2's loadsonly, load1, load1x and empty bodies, which the
// bytes bound, and probe 6's pair, whose four gamma rows a step each chain
// reads put its bytes just above its operations.  The empty, addchain and
// addpar bodies take less than a launch: the launch floor bounds them.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

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
// (8, N); out (out_rows, N) gets row 0 only, as the TPU body writes it.
// n_steps radix-4 steps.  The bodies but FULL and ASTORE (probe2_full_kernel,
// probe2_astore_kernel).
template <int V>
__global__ void __launch_bounds__(128)
    probe2_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                  const float* __restrict__ a0, float* __restrict__ out, int n,
                  int n_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* gsl = gs + lane;
  const float* gpl = gp + lane;
  float a[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = a0[s * ns + lane];
  if constexpr (V == FIXEDROW) {
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

// ---- probe 2's full and astore bodies: the sweep, gammas fetched ahead ----
// The TPU bodies run a lane's steps as one serial chain over gamma rows held
// in VMEM; astore also writes alpha, before every step, into a VMEM scratch
// of (WIN/2, 8, TILE) f32 that every grid step reuses and nothing reads.  On
// Hopper, one thread a lane, as the other bodies, with the gammas off the
// critical path, fetched D steps ahead of the step that adds them:
// - full keeps them in a register ring of D + 1 steps (the loop unrolled
//   D + 1 times, so that every slot is a register), in blocks of one warp:
//   the probe's 2,704 blocks put 20 or 21 warps on each SM, all resident at
//   once (1.03x the mean, where 128-lane blocks put 6 blocks, 24 warps, on
//   16 SMs against a mean of 5.12);
// - astore keeps its store on chip, as on the TPU: each lane's ring of
//   store_rows rows of its 8 metrics in dynamic shared memory, row
//   i % store_rows before step i, as two 16-byte stores ([row][half][lane]
//   float4: a warp stores 512 contiguous bytes, free of bank conflicts).
//   That leaves about 110 lanes an SM, one warp a scheduler, too few to
//   wait out a load each: the gammas go through cp.async into shared
//   stages (one commit group a step, D + 1 stages of a float4 a lane), and
//   step i + 1's are read back while step i's arithmetic runs.  A lane
//   takes 32 * store_rows + 16 * (D + 1) bytes, 2,000 at the probe's 56
//   rows, so at most 116 lanes fit an SM at a time.  The lanes
//   run in tiles of blockDim.x, block b taking tiles b, b + gridDim.x, ...
//   (ops/cuda/probes.probe2_geometry: 110 lanes in 787 tiles on 132 blocks,
//   one an SM, 6 tiles each, at the probe's shape); a block's fetches run
//   on across its tiles and the next tile's alpha(0) is loaded while this
//   tile runs, so a block waits on memory once, where a block a tile would
//   wait at every tile.
// The arithmetic is probe2_acs, so the outputs equal probe2_kernel's.
// Full's blocks are one warp, and at most 97 registers a thread let 21
// blocks an SM be resident at once.
constexpr int kP2FullLanes = 32, kP2FullMinBlocks = 21, kP2FullDepth = 5;
constexpr int kP2StoreDepth = 12, kP2MaxLanes = 256;
constexpr long long kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// The dynamic shared bytes that astore's block of `lanes` lanes indexes:
// the gamma stages (D + 1 float4 a lane) and the ring (store_rows rows of
// 32 B a lane).
inline long long p2_smem_need(int store_rows, int lanes) {
  return (16LL * (kP2StoreDepth + 1) + 32LL * store_rows) * lanes;
}

// One step's gamma rows: (gs row 2i, gp row 2i, gs row 2i+1, gp row 2i+1).
struct P2Rows {
  float q[4];
  __device__ __forceinline__ void load(const float* s, const float* p, size_t at,
                                       size_t ns) {
    q[0] = __ldg(s + at);
    q[1] = __ldg(p + at);
    q[2] = __ldg(s + (at + ns));
    q[3] = __ldg(p + (at + ns));
  }
};

// full: one lane a thread, blocks of kP2FullLanes; D: the ring of gamma
// rows, in steps.
template <int D>
__global__ void __launch_bounds__(kP2FullLanes, kP2FullMinBlocks)
    probe2_full_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                       const float* __restrict__ a0, float* __restrict__ out, int n,
                       int n_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t ns = (size_t)n;
  const float* s = gs + lane;
  const float* p = gp + lane;
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = a0[k * ns + lane];
  if (n_steps > 0) {
    // D + 1 slots: step i fetches step i + D into the slot step i - 1 read,
    // so no slot is read after it is refilled and every slot keeps its
    // register around the loop (no move waiting on a load)
    constexpr int R = D + 1;
    const int last = n_steps - 1;
    const size_t rs = 2 * ns;  // one step's rows
    P2Rows ring[R];
    unroll<0, D>([&](auto v_) {
      constexpr int V = decltype(v_)::value;
      if (V <= last) ring[V].load(s, p, V * rs, ns);
    });
    const float* fs = s + D * rs;  // step i + D's rows
    const float* fp = p + D * rs;
    const auto step = [&](auto u_, bool fetch) {
      constexpr int U = decltype(u_)::value % R;
      if (fetch) {
        ring[(U + D) % R].load(fs, fp, 0, ns);
        fs += rs;
        fp += rs;
      }
      probe2_acs(a, ring[U].q[0], ring[U].q[1], ring[U].q[2], ring[U].q[3]);
    };
    // the steps whose step + D exists, in whole turns of the ring (every
    // fetch unconditional: a fetch under a branch joins into a register move
    // that waits for the load), then the rest, once
    const int fetching = n_steps > D ? n_steps - D : 0;
    const int whole = fetching - fetching % R;
    for (int i0 = 0; i0 < whole; i0 += R)
      unroll<0, R>([&](auto u_) { step(u_, true); });
    unroll<0, R + D>([&](auto u_) {
      constexpr int K = decltype(u_)::value;
      if (whole + K < n_steps) step(u_, whole + K < fetching);
    });
  }
  out[lane] = a[0];
}

// astore; D: the steps fetched ahead (at least 2).  Dynamic shared memory:
// D + 1 gamma stages of blockDim.x float4, then the ring of 2 * store_rows
// * blockDim.x float4.  gridDim.x <= the tiles, and 2 * n_steps * n < 2^31
// (the gamma offsets are 32-bit).
template <int D>
__global__ void __launch_bounds__(kP2MaxLanes, 1)
    probe2_astore_kernel(const float* __restrict__ gs, const float* __restrict__ gp,
                         const float* __restrict__ a0, float* __restrict__ out, int n,
                         int n_steps, int store_rows) {
  extern __shared__ float4 p2_smem[];
  const int lanes = blockDim.x, stride = gridDim.x * lanes;  // to the block's next tile
  int lane = blockIdx.x * lanes + threadIdx.x;               // in the tile being computed
  const auto clamp = [&](int l) { return l < n ? l : n - 1; };  // the ragged last tile
  float4* const stage0 = p2_smem + threadIdx.x;  // stage k at stage0[k * lanes]
  float4* const stage_end = stage0 + (D + 1) * lanes;
  float4* const ring = stage_end;  // row r, half h at ring[(2r + h) * lanes]
  float4* const ring_end = ring + 2 * lanes * store_rows;
  // the fetch cursor, D steps ahead: its step, its tile's lane, and its
  // rows' offset in gs and gp.  Past the block's last tile it runs on over
  // lane n - 1's rows, which nothing reads.
  int fi = 0, flane = lane, at = clamp(lane);
  float4* fslot = stage0;
  const auto fetch = [&] {  // one commit group a step
    float* d = reinterpret_cast<float*>(fslot);
    __pipeline_memcpy_async(d, gs + at, sizeof(float));
    __pipeline_memcpy_async(d + 1, gp + at, sizeof(float));
    __pipeline_memcpy_async(d + 2, gs + (at + n), sizeof(float));
    __pipeline_memcpy_async(d + 3, gp + (at + n), sizeof(float));
    __pipeline_commit();
    at += 2 * n;
    if (++fi == n_steps) {
      fi = 0;
      flane += stride;
      at = clamp(flane);
    }
    fslot += lanes;
    if (fslot == stage_end) fslot = stage0;
  };
  // a tile's alpha(0): this one's, and the next one's loaded ahead
  float a[8], nx[8];
  const auto load_a0 = [&](float x[8], int l) {
    const float* src = a0 + clamp(l);
#pragma unroll
    for (int s = 0; s < 8; ++s) x[s] = src[(size_t)s * n];
  };
  load_a0(a, lane);
  load_a0(nx, lane + stride);
  if (n_steps > 0)
    for (int k = 0; k < D; ++k) fetch();
  __pipeline_wait_prior(D - 1);  // step 0's group
  float4 q = stage0[0];
  const float4* rslot = stage0 + lanes;  // step i + 1's stage
  float4* row = ring;                    // ring row i % store_rows
  while (lane < n) {                     // the block's tiles
    for (int i = 0; i < n_steps; ++i) {
      row[0] = float4{a[0], a[1], a[2], a[3]};
      row[lanes] = float4{a[4], a[5], a[6], a[7]};
      row += 2 * lanes;
      if (row == ring_end) row = ring;
      fetch();
      __pipeline_wait_prior(D - 1);  // step i + 1's group, committed D - 1 groups ago
      const float4 qn = *rslot;
      rslot += lanes;
      if (rslot == stage_end) rslot = stage0;
      probe2_acs(a, q.x, q.y, q.z, q.w);
      q = qn;
    }
    out[lane] = a[0];
    lane += stride;
    row = ring;
    copy8(nx, a);
    load_a0(nx, lane + stride);
  }
  __pipeline_wait_prior(0);  // no copy outlives the block
}

// ---- probe 6: turbo_probe6.py's v5 radix-4 pair --------------------------
// Path-labelled tables (j = (u1 << 1) | u2): candidate j of alpha state s is
// (alpha[r4_pred(s, j)] + (p1*gp0 + p2*gp1)) + u-row j, with u-rows
// (none, gs1, gs0, gs0 + gs1); beta the same over r4_next.  Both chains are
// normalised to state 0 after every step; in bf16 both lane groups are
// normalised to group 0's state 0, as make_bf16 broadcasts new[0:1] over all
// 16 sublanes.
//
// The pair on Hopper.  The TPU body runs both chains one after the other in
// one grid step.  One thread a lane doing the same waits on its gamma loads
// every step, and 86,528 threads fill a third of the card's thread slots.
// So:
// - the chains split: a block is two warps over one tile of 32 threads'
//   lanes, warp 0 runs alpha and warp 1 beta;
// - the gammas leave the critical path: a thread holds the rows of its next
//   kP6Depth steps in registers, each fetched kP6Depth steps ahead, before
//   the step's arithmetic, so a step waits only on its own ACS chain;
// - bf16 where H is even and the arrays 4-byte aligned: a thread runs lanes
//   h and h + 1 of both groups, each metric a __nv_bfloat162 of the two
//   lanes, so every row and metric is one 32-bit word a group, used as read
//   (else one lane a thread, the two groups packed, 16-bit reads).
// What still bounds it: every row is read twice, by alpha at step i and by
// beta at step S-1-i, and with every lane in flight the rows alpha reads
// early are gone from the L2 by the time beta reads them, so most rows come
// from device memory twice.  The arithmetic and its order are make_full's
// and make_bf16's, so the outputs equal the plain versions' (bf16 bit for
// bit).
//
// f32: g2s, g2p (steps, 2, N): [i][0] = row 2i, [i][1] = row 2i+1; a0, b0,
// aout, bout (8, N).  bf16: g2s, g2p (steps, 2, 2, H) [i][row][group][h];
// a0, b0, aout, bout (16, H), rows 0-7 group 0's states, 8-15 group 1's.
// kP6Depth steps of gammas in flight a thread; at most 48 registers in f32,
// so that 21 blocks of 64 threads (1,344) fit an SM and the probe's 2,704
// tiles (86,528 lanes) run in one round on 132 SMs
constexpr int kP6Warp = 32, kP6Depth = 3, kP6MinBlocksF32 = 21;

// One radix-4 step of x into n, unnormalised.
template <bool BETA, class M>
__device__ __forceinline__ void probe6_new(const M x[8], M n[8], M g0s, M g0p, M g1s,
                                           M g1p) {
  const M u3 = add(g0s, g1s);
  const M p3 = add(g0p, g1p);
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
}

template <class M>
__device__ __forceinline__ void p6_norm(M x[8], const M n[8], M z) {
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = sub(n[s], z);
}

// One step's gamma rows for one thread, as fetched, and what the thread
// does with them: K metric vectors of 8 states of type M, acs<BETA> one
// step of them; metrics_in/out move them from and to (8, n) or (16, n).
// s, p: the thread's first lane in g2s, g2p; at: the step's offset, rs the
// row stride, gs the group stride, in elements.
template <class E, int P>
struct P6Rows;

template <>
struct P6Rows<float, 1> {
  using Elem = float;
  using M = float;
  static constexpr int K = 1;
  float q[4];  // (s row 2i, p row 2i, s row 2i+1, p row 2i+1)
  __device__ __forceinline__ void load(const float* s, const float* p, long long at,
                                       long long rs, long long) {
    q[0] = __ldg(s + at);
    q[1] = __ldg(p + at);
    q[2] = __ldg(s + (at + rs));
    q[3] = __ldg(p + (at + rs));
  }
  template <bool BETA>
  __device__ __forceinline__ void acs(float (&x)[1][8]) const {
    float n[8];
    probe6_new<BETA>(x[0], n, q[0], q[1], q[2], q[3]);
    p6_norm(x[0], n, n[0]);
  }
  static __device__ __forceinline__ void metrics_in(const float* x0, size_t n, size_t h,
                                                    float (&x)[1][8]) {
#pragma unroll
    for (int s = 0; s < 8; ++s) x[0][s] = x0[s * n + h];
  }
  static __device__ __forceinline__ void metrics_out(float* xo, size_t n, size_t h,
                                                     const float (&x)[1][8]) {
#pragma unroll
    for (int s = 0; s < 8; ++s) xo[s * n + h] = x[0][s];
  }
};

// bf16, lanes h and h + 1 (h even, H even, every array 4-byte aligned): one
// word a quantity and group, x[g] group g's metrics of both lanes
template <>
struct P6Rows<__nv_bfloat16, 2> {
  using Elem = __nv_bfloat16;
  using M = __nv_bfloat162;
  static constexpr int K = 2;
  __nv_bfloat162 w[4][2];  // [quantity][group]
  __device__ __forceinline__ void load(const __nv_bfloat16* s, const __nv_bfloat16* p,
                                       long long at, long long rs, long long gs) {
    using W = __nv_bfloat162;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      w[0][g] = __ldg(reinterpret_cast<const W*>(s + (at + g * gs)));
      w[1][g] = __ldg(reinterpret_cast<const W*>(p + (at + g * gs)));
      w[2][g] = __ldg(reinterpret_cast<const W*>(s + (at + rs + g * gs)));
      w[3][g] = __ldg(reinterpret_cast<const W*>(p + (at + rs + g * gs)));
    }
  }
  template <bool BETA>
  __device__ __forceinline__ void acs(__nv_bfloat162 (&x)[2][8]) const {
    __nv_bfloat162 n0[8], n1[8];
    probe6_new<BETA>(x[0], n0, w[0][0], w[1][0], w[2][0], w[3][0]);
    probe6_new<BETA>(x[1], n1, w[0][1], w[1][1], w[2][1], w[3][1]);
    p6_norm(x[0], n0, n0[0]);  // group 0's state 0, of each lane
    p6_norm(x[1], n1, n0[0]);
  }
  static __device__ __forceinline__ void metrics_in(const __nv_bfloat16* x0, size_t n,
                                                    size_t h, __nv_bfloat162 (&x)[2][8]) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int s = 0; s < 8; ++s)
        x[g][s] = *reinterpret_cast<const __nv_bfloat162*>(x0 + (8 * g + s) * n + h);
  }
  static __device__ __forceinline__ void metrics_out(__nv_bfloat16* xo, size_t n, size_t h,
                                                     const __nv_bfloat162 (&x)[2][8]) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *reinterpret_cast<__nv_bfloat162*>(xo + (8 * g + s) * n + h) = x[g][s];
  }
};

// bf16, one lane (odd H, or an array not 4-byte aligned): a 16-bit value a
// quantity and group, the two groups packed in one __nv_bfloat162
template <>
struct P6Rows<__nv_bfloat16, 1> {
  using Elem = __nv_bfloat16;
  using M = __nv_bfloat162;
  static constexpr int K = 1;
  __nv_bfloat16 e[4][2];
  __device__ __forceinline__ void load(const __nv_bfloat16* s, const __nv_bfloat16* p,
                                       long long at, long long rs, long long gs) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      e[0][g] = __ldg(s + (at + g * gs));
      e[1][g] = __ldg(p + (at + g * gs));
      e[2][g] = __ldg(s + (at + rs + g * gs));
      e[3][g] = __ldg(p + (at + rs + g * gs));
    }
  }
  template <bool BETA>
  __device__ __forceinline__ void acs(__nv_bfloat162 (&x)[1][8]) const {
    __nv_bfloat162 n[8];
    probe6_new<BETA>(x[0], n, __halves2bfloat162(e[0][0], e[0][1]),
                     __halves2bfloat162(e[1][0], e[1][1]),
                     __halves2bfloat162(e[2][0], e[2][1]),
                     __halves2bfloat162(e[3][0], e[3][1]));
    p6_norm(x[0], n, __bfloat162bfloat162(__low2bfloat16(n[0])));
  }
  static __device__ __forceinline__ void metrics_in(const __nv_bfloat16* x0, size_t n,
                                                    size_t h, __nv_bfloat162 (&x)[1][8]) {
#pragma unroll
    for (int s = 0; s < 8; ++s)
      x[0][s] = __halves2bfloat162(x0[s * n + h], x0[(8 + s) * n + h]);
  }
  static __device__ __forceinline__ void metrics_out(__nv_bfloat16* xo, size_t n, size_t h,
                                                     const __nv_bfloat162 (&x)[1][8]) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      xo[s * n + h] = __low2bfloat16(x[0][s]);
      xo[(8 + s) * n + h] = __high2bfloat16(x[0][s]);
    }
  }
};

// One chain (alpha forward over the steps, beta backward) of one thread's
// lanes h ..: G lane groups in memory.
template <bool BETA, class R, int G>
__device__ __forceinline__ void p6_chain(const typename R::Elem* g2s,
                                         const typename R::Elem* g2p,
                                         const typename R::Elem* x0, typename R::Elem* xout,
                                         size_t n, int steps, size_t h) {
  constexpr int D = kP6Depth;
  const typename R::Elem* s = g2s + h;
  const typename R::Elem* p = g2p + h;
  const long long gs = (long long)n, rs = G * gs, ss = 2 * rs;
  // step j's rows into a ring slot
  R ring[D];
  const auto fetch = [&](R& slot, int j) {
    slot.load(s, p, (long long)(BETA ? steps - 1 - j : j) * ss, rs, gs);
  };
  typename R::M x[R::K][8];
  R::metrics_in(x0, n, h, x);
  unroll<0, D>([&](auto v_) {
    constexpr int V = decltype(v_)::value;
    if (V < steps) fetch(ring[V], V);
  });
  for (int i0 = 0; i0 < steps; i0 += D)
    unroll<0, D>([&](auto u_) {
      constexpr int U = decltype(u_)::value;
      const int i = i0 + U;
      if (i < steps) {
        const R cur = ring[U];
        if (i + D < steps) fetch(ring[U], i + D);
        cur.template acs<BETA>(x);
      }
    });
  R::metrics_out(xout, n, h, x);
}

// R: a thread's rows (P6Rows<E, P>, P lanes a thread); G = 1 or 2 lane
// groups.  n lanes (bf16: lanes of each group), a block a tile of 32 P.
template <class R, int G, int P>
__global__ void __launch_bounds__(2 * kP6Warp, G == 1 ? kP6MinBlocksF32 : 1)
    probe6_pair_kernel(const typename R::Elem* __restrict__ g2s,
                       const typename R::Elem* __restrict__ g2p,
                       const typename R::Elem* __restrict__ a0,
                       const typename R::Elem* __restrict__ b0,
                       typename R::Elem* __restrict__ aout, typename R::Elem* __restrict__ bout,
                       int n, int steps) {
  const int h = (blockIdx.x * kP6Warp + threadIdx.x % kP6Warp) * P;
  if (h >= n) return;
  if (threadIdx.x >= kP6Warp)  // one chain a warp
    p6_chain<true, R, G>(g2s, g2p, b0, bout, (size_t)n, steps, (size_t)h);
  else
    p6_chain<false, R, G>(g2s, g2p, a0, aout, (size_t)n, steps, (size_t)h);
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

// Rows s and s ^ 1 take the same two candidates in swapped order, so from
// the first step on they are equal (max is commutative on these finite
// values).  The kernel keeps one metric a pair, r[p] = a[2p] = a[2p+1]:
// the first step reads all eight start metrics, each later one is 4 states
// x 2 candidates, each normalisation one subtract a pair: 16 adds and 8
// maxes an iteration in either type.  nvcc merges the pairs of 8 states by
// itself in f32, but not in bf16x2, whose __hmax2 is inline PTX that it does
// not merge when the operands are swapped (12 adds, 8 subtracts and 16
// HMNMX2 an iteration in cuobjdump -sass: 1.5x the instructions).
template <int C, class M>
__device__ __forceinline__ M p7_cand(M v, M g0, M g1, M g01) {
  if constexpr (C == 0)
    return v;
  else if constexpr (C == 1)
    return add(v, g0);
  else if constexpr (C == 2)
    return add(v, g1);
  else
    return add(v, g01);
}

// One radix-2 step into the pairs' metrics r from the eight state metrics
// (PAIRS false: the first step) or from the pairs' (a[s] = r[s >> 1]),
// each pair taking state 2p's candidates in its order.
template <bool PAIRS, class M>
__device__ __forceinline__ void p7_step(const M* x, M r[4], M g0, M g1, M g01) {
  M n[4];
  unroll<0, 4>([&](auto p_) {
    constexpr int S = 2 * decltype(p_)::value;
    constexpr int A = p7_src(S, 0), B = p7_src(S, 1);
    n[S / 2] = mx(p7_cand<p7_cmb(S, 0)>(x[PAIRS ? A / 2 : A], g0, g1, g01),
                  p7_cand<p7_cmb(S, 1)>(x[PAIRS ? B / 2 : B], g0, g1, g01));
  });
#pragma unroll
  for (int p = 0; p < 4; ++p) r[p] = n[p];
}

template <class M>
__device__ __forceinline__ void p7_norm(M r[4]) {
  const M z = r[0];
#pragma unroll
  for (int p = 0; p < 4; ++p) r[p] = sub(r[p], z);
}

// the iteration loop unrolled 4 times: its counter and branch are 3 of 27
// instructions an iteration, 0.75 of 24.75 unrolled
constexpr int kP7Unroll = 4;

// g (2, n), a0 and out (8, n) of M elements (n lanes of f32, or n pairs of
// bf16 lanes).
template <class M>
__global__ void __launch_bounds__(128)
    probe7_kernel(const M* __restrict__ g, const M* __restrict__ a0,
                  M* __restrict__ out, int n, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t ns = (size_t)n;
  if (iters <= 0) {
#pragma unroll
    for (int s = 0; s < 8; ++s) out[s * ns + t] = a0[s * ns + t];
    return;
  }
  const M g0 = g[t], g1 = g[ns + t];
  const M g01 = add(g0, g1);
  M a[8], r[4];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = a0[s * ns + t];
  p7_step<false>(a, r, g0, g1, g01);
  p7_step<true>(r, r, g0, g1, g01);
  p7_norm(r);
#pragma unroll kP7Unroll
  for (int i = 1; i < iters; ++i) {
    p7_step<true>(r, r, g0, g1, g01);
    p7_step<true>(r, r, g0, g1, g01);
    p7_norm(r);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) out[2 * p * ns + t] = out[(2 * p + 1) * ns + t] = r[p];
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// One block a tile.
template <class E, int G, int P>
int probe6_launch(const E* g2s, const E* g2p, const E* a0, const E* b0, E* aout, E* bout,
                  int n, int steps, void* stream) {
  using R = P6Rows<E, P>;
  const int tiles = (n + kP6Warp * P - 1) / (kP6Warp * P);
  probe6_pair_kernel<R, G, P><<<tiles, 2 * kP6Warp, 0, (cudaStream_t)stream>>>(
      g2s, g2p, a0, b0, aout, bout, n, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: the Probe2 enum (0 full ... 11 load1x, the order of
// ops/cuda/probes.PROBE2_VARIANTS); lanes, smem, blocks: the launch that
// ops/cuda/probes.probe2_geometry gives, one thread a lane, lanes a tile:
// a block a tile, but astore's blocks (1 to the tiles), which take the
// tiles in turn.  Checked here only as far as the kernels need: lanes
// within a body's launch bounds, astore's dynamic shared bytes holding its
// gamma stages and rings and at most 232,448 (0 for the others), and
// astore's 32-bit gamma offsets (2 * n_steps * n < 2^31); also at n = 0,
// so a caller can ask whether a launch is taken.
extern "C" int probe2(const float* gs, const float* gp, const float* a0, float* out,
                      int n, int n_steps, int store_rows, int variant, int lanes,
                      int smem, int blocks, void* stream) {
  if (n < 0 || n_steps < 0 || store_rows < 1 || variant < FULL || variant > LOAD1X)
    return (int)cudaErrorInvalidValue;
  const bool store = variant == ASTORE;
  const long long need = store ? p2_smem_need(store_rows, lanes) : 0;
  const int most = variant == FULL ? kP2FullLanes : store ? kP2MaxLanes : kThreads;
  const int tiles = lanes > 0 ? (n + lanes - 1) / lanes : 0;
  if (lanes < 1 || lanes > most || smem < need ||
      smem > (store ? kMaxSmem : 0) || blocks < 1 ||
      (n > 0 && (store ? blocks > tiles : blocks != tiles)) ||
      (store && 2LL * n_steps * n > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case FULL:
      probe2_full_kernel<kP2FullDepth><<<blocks, lanes, 0, st>>>(gs, gp, a0, out, n,
                                                                 n_steps);
      break;
    case ASTORE: {
      const cudaError_t err =
          cudaFuncSetAttribute(probe2_astore_kernel<kP2StoreDepth>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      probe2_astore_kernel<kP2StoreDepth><<<blocks, lanes, smem, st>>>(
          gs, gp, a0, out, n, n_steps, store_rows);
      break;
    }
#define PROBE2_CASE(V)                                                        \
  case V:                                                                     \
    probe2_kernel<V><<<blocks, lanes, 0, st>>>(gs, gp, a0, out, n, n_steps);    \
    break;
    PROBE2_CASE(FIXEDROW)
    PROBE2_CASE(BLOCK8)
    PROBE2_CASE(LOADSONLY)
    PROBE2_CASE(ACSONLY)
    PROBE2_CASE(UNROLL4)
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
  return probe6_launch<float, 1, 1>(g2s, g2p, a0, b0, aout, bout, n, steps, stream);
}

// h: lanes per group, both groups packed in one __nv_bfloat162 a lane; two
// lanes a thread where h is even and every array starts on a 4-byte
// boundary (so each 32-bit word is aligned), else one
extern "C" int probe6_bf16(const __nv_bfloat16* g2s, const __nv_bfloat16* g2p,
                           const __nv_bfloat16* a0, const __nv_bfloat16* b0,
                           __nv_bfloat16* aout, __nv_bfloat16* bout, int h,
                           int steps, void* stream) {
  if (h <= 0) return 0;
  const uintptr_t odd = (uintptr_t)g2s | (uintptr_t)g2p | (uintptr_t)a0 | (uintptr_t)b0 |
                        (uintptr_t)aout | (uintptr_t)bout;
  if (h % 2 == 0 && odd % 4 == 0)
    return probe6_launch<__nv_bfloat16, 2, 2>(g2s, g2p, a0, b0, aout, bout, h, steps,
                                              stream);
  return probe6_launch<__nv_bfloat16, 2, 1>(g2s, g2p, a0, b0, aout, bout, h, steps, stream);
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

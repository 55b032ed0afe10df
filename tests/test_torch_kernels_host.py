"""The CUDA kernels' own source, compiled for the host, against their plain
torch versions.

Each ``srsran_4g_tpu_torch/csrc/*.cu`` is built with the host C++ compiler
against a stand-in ``cuda_runtime.h`` that defines the CUDA keywords and two
launches, after the ``<<<...>>>`` launches are rewritten as calls to them:
a sequential one (every block and thread in turn) for sources without a
barrier, and a block-cooperative one for sources that call
``__syncthreads()``.  The cooperative launch runs a block's threads as
coroutines (``ucontext``) on one OS thread, each until it reaches a barrier
or ends; the barrier releases when every thread of the block waits at it,
and a thread that ends while others wait fails the launch (an early exit
before a barrier).  The block's dynamic shared memory (``extern
__shared__``) is one buffer, filled with NaN bytes before each block, and
``cuda_pipeline.h``'s asynchronous copies are synchronous ones.  The C entry points that the
wrappers of ``ops/cuda/turbo_map.py`` and ``ops/cuda/probes.py`` call through ctypes then run on CPU
buffers, so the kernels' indexing, schedules and arithmetic are checked
here; only the card (tests/test_torch_cuda.py, chip_smoke.py) shows that
nvcc builds them and that they run right in parallel.

A stand-in ``cuda_bf16.h`` does the same for the 16-bit kernels: its
``__nv_bfloat16`` is the 16-bit pattern, ``__nv_bfloat162`` a pair of them,
and ``__hadd``/``__hsub`` (and their pairwise ``2`` forms) add or subtract
in float and round to bf16 (round to nearest even) after every op,
which is what the card's bf16 instructions and torch's bf16 ops compute.

Tolerance: atol 1e-3 for the sweep and emission kernels and the f32
probes, as on the card (the same arithmetic in the same order; in practice
the results are identical); every other half-iteration kernel, f32 and bf16,
and the bf16 probes must equal their plain versions exactly.  Skips without
a host C++ compiler.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import probes
from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
from srsran_4g_tpu_torch.ops.cuda.build import CSRC
from srsran_4g_tpu_torch.tools import fused16_split, fused_split, windowed_split

torch.set_num_threads(2)

_CUDA_RUNTIME = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#include <ucontext.h>
#include <vector>
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
static dim3 gridDim, blockDim, blockIdx, threadIdx;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 719 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum { cudaSharedmemCarveoutMaxShared = 100 };
static int host_error = cudaSuccess;
static inline int cudaGetLastError() {
  const int err = host_error;
  host_error = cudaSuccess;
  return err;
}
template <class T>
static inline int cudaFuncSetAttribute(T, int, int) { return cudaSuccess; }
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
template <class F>
static void host_launch(dim3 grid, dim3 block, F kernel) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (unsigned tx = 0; tx < block.x; ++tx) {
        blockIdx = dim3(bx, by);
        threadIdx = dim3(tx);
        kernel();
      }
}
// The block-cooperative launch: the threads of a block as coroutines.
static ucontext_t host_scheduler;
static ucontext_t* host_threads = nullptr;  // null outside host_launch_block
static unsigned char* host_waiting = nullptr;
static unsigned host_current = 0;
static void* host_smem = nullptr;
static void (*host_body)(void*) = nullptr;
static void* host_body_arg = nullptr;
static inline void* host_shared() { return host_smem; }
static inline void __syncwarp(unsigned = 0xffffffffu) {}  // compiled, never run
static inline void __syncthreads() {
  if (!host_threads) abort();  // a barrier under the sequential launch
  host_waiting[host_current] = 1;
  swapcontext(&host_threads[host_current], &host_scheduler);
}
static void host_thread_main() { host_body(host_body_arg); }
template <class F>
static void host_launch_block(dim3 grid, dim3 block, size_t smem, F kernel) {
  const size_t stack = 1 << 16;
  const unsigned nt = block.x;
  std::vector<ucontext_t> ctx(nt);
  std::vector<unsigned char> waiting(nt), done(nt), stacks(nt * stack);
  std::vector<uint4> shared(smem / sizeof(uint4) + 1);
  gridDim = grid;
  blockDim = block;
  host_body = [](void* k) { (*static_cast<F*>(k))(); };
  host_body_arg = &kernel;
  host_threads = ctx.data();
  host_waiting = waiting.data();
  host_smem = shared.data();
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      memset(shared.data(), 0xff, shared.size() * sizeof(uint4));
      for (unsigned t = 0; t < nt; ++t) {
        getcontext(&ctx[t]);
        ctx[t].uc_stack.ss_sp = &stacks[t * stack];
        ctx[t].uc_stack.ss_size = stack;
        ctx[t].uc_link = &host_scheduler;
        makecontext(&ctx[t], host_thread_main, 0);
        done[t] = 0;
      }
      for (;;) {  // one pass: every live thread to its next barrier or its end
        unsigned n_wait = 0, n_done = 0;
        for (unsigned t = 0; t < nt; ++t) {
          if (done[t]) continue;
          waiting[t] = 0;
          host_current = t;
          threadIdx = dim3(t);
          swapcontext(&host_scheduler, &ctx[t]);
          if (waiting[t]) ++n_wait; else done[t] = 1;
        }
        for (unsigned t = 0; t < nt; ++t) n_done += done[t];
        if (!n_wait) break;
        if (n_done) {  // ended threads would leave the others at the barrier
          host_error = cudaErrorLaunchFailure;
          host_threads = nullptr;
          return;
        }
      }
    }
  host_threads = nullptr;
}
"""

_CUDA_PIPELINE = r"""
#pragma once
#include <stddef.h>
#include <string.h>
static inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                           size_t zfill = 0) {
  (void)zfill;
  memcpy(dst, src, size);
}
static inline void __pipeline_commit() {}
static inline void __pipeline_wait_prior(size_t) {}
"""

_CUDA_BF16 = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
struct __nv_bfloat16 {
  uint16_t x;
};
static inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even (finite values)
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
static inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
static inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short x) {
  return __nv_bfloat16{x};
}
static inline __nv_bfloat16 __hadd(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}
static inline __nv_bfloat16 __hsub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) - __bfloat162float(b));
}
static inline __nv_bfloat16 __hmax(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(fmaxf(__bfloat162float(a), __bfloat162float(b)));
}
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
static inline __nv_bfloat162 __halves2bfloat162(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __nv_bfloat162{a, b};
}
static inline __nv_bfloat16 __low2bfloat16(__nv_bfloat162 v) { return v.x; }
static inline __nv_bfloat16 __high2bfloat16(__nv_bfloat162 v) { return v.y; }
static inline __nv_bfloat162 __bfloat162bfloat162(__nv_bfloat16 a) {
  return __nv_bfloat162{a, a};
}
static inline __nv_bfloat162 __low2bfloat162(__nv_bfloat162 v) { return {v.x, v.x}; }
static inline __nv_bfloat162 __high2bfloat162(__nv_bfloat162 v) { return {v.y, v.y}; }
static inline __nv_bfloat162 __lowhigh2highlow(__nv_bfloat162 v) { return {v.y, v.x}; }
static inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
static inline __nv_bfloat162 __float2bfloat162_rn(float a) {
  return __floats2bfloat162_rn(a, a);
}
static inline __nv_bfloat162 __hadd2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __nv_bfloat162{__hadd(a.x, b.x), __hadd(a.y, b.y)};
}
static inline __nv_bfloat162 __hsub2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __nv_bfloat162{__hsub(a.x, b.x), __hsub(a.y, b.y)};
}
static inline __nv_bfloat162 __hmax2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __nv_bfloat162{__hmax(a.x, b.x), __hmax(a.y, b.y)};
}
"""

# kernel<<<grid, block, smem, stream>>>(args);  ->
#   host_launch(grid, block, [&] { kernel(args); });  or, with a barrier,
#   host_launch_block(grid, block, smem, [&] { kernel(args); });
_LAUNCH = re.compile(
    r"([\w:]+(?:<[^<>;]*>)?)<<<\s*([^,]+?)\s*,\s*([^,]+?)\s*,\s*([^,]+?)\s*,[^>]*>>>"
    r"\s*\(([^;]*)\);", re.S)
# extern __shared__ T name[];  ->  T* name = static_cast<T*>(host_shared());
_EXTERN_SHARED = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")

# C entry -> (source, pointer args, int args), as ops/cuda/turbo_map.py binds them
_ENTRIES = {"turbo_map_windowed": ("turbo_windowed", 5, 8),
            "turbo_map_windowed16": ("turbo_windowed", 5, 8),
            "turbo_map_fused": ("turbo_fused", 5, 9),
            "turbo_map_fused16": ("turbo_fused16", 5, 7),
            "turbo_sweep": ("turbo_sweep", 6, 6),
            "turbo_emit": ("turbo_emit", 5, 2),
            "turbo_map_v3": ("turbo_windowed", 5, 8),
            "probe2": ("probe_acs", 5, 4),
            "probe6_full": ("probe_acs", 6, 2),
            "probe6_bf16": ("probe_acs", 6, 2),
            "probe6_skel": ("probe_acs", 4, 2),
            "probe7_f32": ("probe_acs", 3, 2),
            "probe7_bf16": ("probe_acs", 3, 2),
            "probe_empty": ("probe_launch", 3, 3)}


def _host_dir(out):
    """The stand-in CUDA headers and the package's shared headers in
    ``out``; returns the host C++ compiler (skips without one)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    (out / "cuda_runtime.h").write_text(_CUDA_RUNTIME)
    (out / "cuda_bf16.h").write_text(_CUDA_BF16)
    (out / "cuda_pipeline.h").write_text(_CUDA_PIPELINE)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    return cxx


def _host_build(cxx, out, name, lib, flags=()):
    """Start the host build of ``csrc/<name>.cu`` (its launches rewritten)
    into ``out / lib``; returns the compiler's process."""
    src = (CSRC / f"{name}.cu").read_text()
    launch = (r"host_launch_block(\2, \3, \4, [&] { \1(\5); });"
              if "__syncthreads" in src else r"host_launch(\2, \3, [&] { \1(\5); });")
    src = _EXTERN_SHARED.sub(r"\1* \2 = static_cast<\1*>(host_shared());", src)
    src, n_launch = _LAUNCH.subn(launch, src)
    assert n_launch, f"{name}.cu: no kernel launch found"
    (out / f"{lib}.cpp").write_text(src)
    cmd = [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", *flags,
           "-I", str(out), "-o", str(out / f"lib{lib}.so"), str(out / f"{lib}.cpp")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name} does not build for the host:\n{log}"


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The C entry of every kernel source, built for the host."""
    out = tmp_path_factory.mktemp("host_kernels")
    cxx = _host_dir(out)
    _wait({name: _host_build(cxx, out, name, name)
           for name in {source for source, _, _ in _ENTRIES.values()}})
    fns = {}
    for symbol, (name, n_ptr, n_int) in _ENTRIES.items():
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[symbol] = fn
    # the shared-memory bytes each entry checks a block's against
    for symbol, name, n_int in (("turbo_windowed_smem", "turbo_windowed", 4),
                                ("turbo_fused_smem", "turbo_fused", 3),
                                ("turbo_fused16_smem", "turbo_fused16", 2)):
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
        fn.argtypes = [ctypes.c_int] * n_int
        fn.restype = ctypes.c_longlong
        fns[symbol] = fn
    return fns


def _run(fn, *args):
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    assert all(t.is_contiguous() and t.dtype in (torch.float32, torch.bfloat16)
               for t in tensors)
    assert fn(*(t.data_ptr() for t in tensors), *ints, None) == 0


def _inputs(b, k, l, t):
    rng = np.random.default_rng(k + t)
    lsa, lp = (torch.as_tensor((rng.standard_normal((b, k)) * 3).astype(np.float32))
               for _ in range(2))
    ts, tp = (torch.as_tensor(rng.standard_normal((b, 3)).astype(np.float32))
              for _ in range(2))
    return turbo._windowed_inputs(lsa, lp, ts, tp, l, t)[:4] + (t, l, b, k // l)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=0)


# L % 4 == 0, L ≡ 2 (mod 4), odd T, and the full recursion (L = K, T = 0)
SHAPES = [(3, 256, 64, 16), (3, 424, 106, 32), (2, 512, 64, 31), (2, 40, 40, 0)]


# turbo_windowed.cu's entries: (chains a thread, metric bytes, plain version)
_WINDOWED = {"turbo_map_windowed": (1, 32, tm.map_windowed_ref),
             "turbo_map_v3": (2, 32, tm.map_v3_ref),
             "turbo_map_windowed16": (1, 16, tm.map_windowed16_ref)}


def _windowed(host_kernels, entry, args, **force):
    """``turbo_windowed.cu``'s entry (map_windowed, map_v3 or
    map_windowed16) at the geometry ``windowed_geometry`` gives (``force``:
    its every/lanes)."""
    gs, gp, a0, b0, t, l, nof_b, nof_w = args
    n = gs.shape[1]
    chains, metric_bytes, _ = _WINDOWED[entry]
    geo = tm.windowed_geometry(n, l, t, chains, metric_bytes=metric_bytes, **force)
    out = gs.new_empty((l, n))
    _run(host_kernels[entry], gs, gp, a0, b0, out, n, t, l, nof_b, nof_w, geo.lanes,
         geo.every, geo.smem_bytes)
    return out


# map_windowed's kernel (turbo_windowed.cu) at its default geometry
@pytest.mark.parametrize("b,k,l,t", SHAPES)
def test_turbo_map_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    _equal(_windowed(host_kernels, "turbo_map_windowed", args), tm.map_windowed_ref(*args))


# two tiles with a ragged last one (N = 40); odd L (h = 32 and L - h = 31,
# so at c = 4 and 8 a partial segment meets the middle); odd T with L ≡ 2
# (mod 4) (h = 53); the full recursion (L = K, T = 0, W = 1, N odd)
WINDOWED_SHAPES = [(5, 512, 64, 16), (3, 189, 63, 16), (2, 424, 106, 31), (3, 40, 40, 0)]
# (entry, checkpoint stride c) for every stride the geometry can pick
WINDOWED_STRIDES = [("turbo_map_windowed", c) for c in (1, 2, 4, 8)] + [
    ("turbo_map_v3", c) for c in (1, 2, 4)] + [
    ("turbo_map_windowed16", c) for c in (1, 2, 4, 8)]


@pytest.mark.parametrize("entry,every", WINDOWED_STRIDES)
@pytest.mark.parametrize("b,k,l,t", WINDOWED_SHAPES)
def test_turbo_windowed_sources_equal_plain(host_kernels, entry, every, b, k, l, t):
    args = _inputs(b, k, l, t)
    _equal(_windowed(host_kernels, entry, args, every=every), _WINDOWED[entry][2](*args))


# the narrow tiles the geometry picks at large L: 8 lanes (five blocks) and
# one lane a block
@pytest.mark.parametrize("lanes", [8, 1])
@pytest.mark.parametrize("entry", ["turbo_map_windowed", "turbo_map_v3", "turbo_map_windowed16"])
def test_turbo_windowed_narrow_tiles_equal_plain(host_kernels, entry, lanes):
    args = _inputs(*WINDOWED_SHAPES[0])
    _equal(_windowed(host_kernels, entry, args, lanes=lanes), _WINDOWED[entry][2](*args))


def test_windowed_geometry_fits_and_covers_every_window(host_kernels):
    """For every L from 1 to 6,144 and T in {0, 31, 32}, the three entries'
    geometry fits an H100 block, agrees with the bytes the entry checks, is
    taken by the entry (asked at N = 0), and its tiles cover every lane
    once."""
    need = host_kernels["turbo_windowed_smem"]
    for kind, (entry, (chains, metric_bytes, _)) in enumerate(_WINDOWED.items()):
        fn = host_kernels[entry]
        for l in range(1, 6145):
            for t in (0, 31, 32):
                for n in (1, 37, 46592):
                    geo = tm.windowed_geometry(n, l, t, chains, metric_bytes=metric_bytes)
                    assert geo.grid * geo.lanes >= n > (geo.grid - 1) * geo.lanes
                assert geo.smem_bytes <= 232448 and geo.threads == 2 * geo.lanes // chains
                assert need(l, geo.lanes, geo.every, kind) == geo.smem_bytes
                assert fn(None, None, None, None, None, 0, t, l, 1, 1, geo.lanes, geo.every,
                          geo.smem_bytes, None) == 0
            # too little shared memory, a tile or stride the kernel does not take
            assert fn(None, None, None, None, None, 0, 32, l, 1, 1, geo.lanes, geo.every,
                      geo.smem_bytes - 16, None) != 0
            assert fn(None, None, None, None, None, 0, 32, l, 1, 1, 64, 4, 232448, None) != 0
            assert fn(None, None, None, None, None, 0, 32, l, 1, 1, 1, 3, 232448, None) != 0
    assert tm.windowed_geometry(1664, 6144, 32)[:3] == (8, 16, 8)  # c = 8, 8 lanes
    assert tm.windowed_geometry(46592, 208, 32)[:3] == (32, 64, 4)
    assert tm.windowed_geometry(46592, 208, 32, metric_bytes=16)[1:4] == (64, 4, 30720)


def _fused(fn, args, radix, **force):
    """``turbo_fused.cu``'s entry at the geometry ``fused_geometry`` gives
    (``force``: its every/lanes)."""
    gs, gp, a0, b0, t, l, nof_b, nof_w = args
    n = gs.shape[1]
    geo = tm.fused_geometry(n, l, radix, **force)
    out = gs.new_empty((l, n))
    _run(fn, gs, gp, a0, b0, out, n, t, l, nof_b, nof_w, radix, geo.lanes, geo.every,
         geo.smem_bytes)
    return out


@pytest.mark.parametrize("radix", [2, 4])
def test_turbo_fused_source_matches_plain(host_kernels, radix):
    args = _inputs(*SHAPES[0])
    _equal(_fused(host_kernels["turbo_map_fused"], args, radix),
           tm.map_fused_ref(*args, radix=radix))


# a ragged last tile (N = 84), one window (W = 1, L = 40: L/4 = 10 pairs, a
# partial chunk at c = 4), L/4 odd (L = 188: partial chunks at c = 2 and 4),
# and T/2 odd (a partial training chunk)
FUSED_SHAPES = [(3, 5824, 208, 32), (3, 40, 40, 32), (2, 6016, 188, 32), (2, 512, 64, 30)]


@pytest.mark.parametrize("every", [1, 2, 4])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b,k,l,t", FUSED_SHAPES)
def test_turbo_fused_strides_equal_plain(host_kernels, b, k, l, t, radix, every):
    args = _inputs(b, k, l, t)
    _equal(_fused(host_kernels["turbo_map_fused"], args, radix, every=every),
           tm.map_fused_ref(*args, radix=radix))


# the narrow tile the geometry picks at a large window (L = 3,584: 8 lanes a
# block), and one lane a block
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("shape,lanes", [((2, 7168, 3584, 32), None), ((5, 512, 64, 16), 1)])
def test_turbo_fused_narrow_tiles_equal_plain(host_kernels, shape, lanes, radix):
    args = _inputs(*shape)
    force = {} if lanes is None else {"lanes": lanes}
    _equal(_fused(host_kernels["turbo_map_fused"], args, radix, **force),
           tm.map_fused_ref(*args, radix=radix))


def test_fused_geometry_fits_every_window(host_kernels):
    """For every L % 4 == 0 from 4 to 6,144 and either radix map_fused's
    geometry fits an H100 block, agrees with the bytes the entry checks, is
    taken by the entry (asked at N = 0, T = 0 and 32), and its tiles cover
    every lane once."""
    need, fn = host_kernels["turbo_fused_smem"], host_kernels["turbo_map_fused"]
    for radix in (2, 4):
        for l in range(4, 6145, 4):
            for n in (1, 37, 46592):
                geo = tm.fused_geometry(n, l, radix)
                assert geo.grid * geo.lanes >= n > (geo.grid - 1) * geo.lanes
            assert geo.smem_bytes <= 232448 and geo.threads == 2 * geo.lanes
            assert need(l, geo.lanes, geo.every) == geo.smem_bytes
            for t in (0, 32):
                assert fn(None, None, None, None, None, 0, t, l, 1, 1, radix, geo.lanes,
                          geo.every, geo.smem_bytes, None) == 0
            assert fn(None, None, None, None, None, 0, 32, l, 1, 1, radix, geo.lanes,
                      geo.every, geo.smem_bytes - 16, None) != 0
    # odd T, L % 4 != 0, a radix, tile or stride the kernel does not take
    for bad in ((31, 208, 2, 32, 4), (32, 206, 2, 32, 4), (32, 208, 3, 32, 4),
                (32, 208, 2, 64, 4), (32, 208, 2, 32, 8)):
        t, l, radix, tile, every = bad
        assert fn(None, None, None, None, None, 0, t, l, 1, 1, radix, tile, every, 232448,
                  None) != 0
    assert [tm.fused_geometry(1, l, 2).lanes for l in (208, 1776, 1780, 3600, 3604, 6144)] == [
        32, 32, 16, 16, 8, 8]
    assert [tm.fused_geometry(1, l, 4)[0:3:2] for l in (888, 892, 6144)] == [
        (32, 2), (32, 4), (8, 4)]
    assert tm.fused_geometry(46592, 208, 2)[1:4] == (64, 4, 30720)
    assert tm.fused_geometry(46592, 208, 4)[1:4] == (64, 2, 57344)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b,k,l,t", SHAPES[:2])
def test_turbo_sweep_and_emit_sources_match_plain(host_kernels, b, k, l, t, radix):
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    stores = [gs.new_empty((l // 2, 8, n)) for _ in range(2)]
    _run(host_kernels["turbo_sweep"], *args[:4], *stores, n, t, l, b, k // l, radix)
    for got, want in zip(stores, tm.sweep_ref(*args, radix=radix)):
        _close(got, want)
    g2 = [x[t:t + l].view(l // 2, 2, n) for x in args[:2]]
    out = gs.new_empty((l // 2, 2, n))
    _run(host_kernels["turbo_emit"], *g2, *stores, out, n, l // 2)
    _close(out, tm.emit_ref(*g2, *stores))


def _equal(got, want):
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


# map_windowed16's kernel (turbo_windowed.cu) at its default geometry
@pytest.mark.parametrize("b,k,l,t", SHAPES)
def test_turbo_map16_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    _equal(_windowed(host_kernels, "turbo_map_windowed16", args), tm.map_windowed16_ref(*args))


# five tiles of 32 lanes (N = 160), a ragged last tile (N = 84), one window
# (W = 1), L/4 odd (K = 6016, L = 188), and windows above 320 that take 16
# (L = 1,792) and 8 (L = 3,584) lanes a block
@pytest.mark.parametrize("b,k,l,t", [SHAPES[0], (2, 512, 128, 32), (5, 6144, 192, 32),
                                     (3, 5824, 208, 32), (3, 40, 40, 32), (2, 6016, 188, 32),
                                     (2, 3584, 1792, 32), (2, 7168, 3584, 32)])
def test_turbo_fused16_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    geo = tm.fused16_geometry(n, l)
    out = gs.new_empty((l, n))
    _run(host_kernels["turbo_map_fused16"], *args[:4], out, n, t, l, b, k // l, geo.lanes,
         geo.smem_bytes)
    _equal(out, tm.map_fused16_ref(*args))


def test_fused16_geometry_fits_every_window(host_kernels):
    """For every L % 4 == 0 from 4 to 6,144 the geometry fits an H100
    block, agrees with the bytes the entry checks, and the entry takes it
    (asked at N = 0)."""
    need, fn = host_kernels["turbo_fused16_smem"], host_kernels["turbo_map_fused16"]
    for l in range(4, 6145, 4):
        geo = tm.fused16_geometry(46592, l)
        assert geo.smem_bytes <= 232448 and geo.threads == 2 * geo.lanes
        assert need(l, geo.lanes) == geo.smem_bytes
        for t in (0, 32):
            assert fn(None, None, None, None, None, 0, t, l, 1, 1, geo.lanes, geo.smem_bytes,
                      None) == 0
        assert fn(None, None, None, None, None, 0, 32, l, 1, 1, geo.lanes, geo.smem_bytes - 16,
                  None) != 0
    assert [tm.fused16_geometry(1, l).lanes for l in (208, 1752, 1756, 3568, 3572, 6144)] == [
        32, 32, 16, 16, 8, 8]


def test_fused16_split_variants_build_for_the_host(tmp_path):
    """Every build-time variant of turbo_fused16.cu that tools/fused16_split
    times still compiles (host build)."""
    cxx = _host_dir(tmp_path)
    _wait({name: _host_build(cxx, tmp_path, "turbo_fused16", name,
                             fused16_split.variant_flags(name))
           for name in fused16_split.VARIANTS})


# the variants that change only where the dataflow keeps its values (ring
# depth, stores, tile width) compute the kernel's function; coop_fill's warp
# copies need the warp's threads in step, which the host launch does not
# give, and the other two compute no LLRs
@pytest.mark.parametrize("variant", ["ring2", "full_stores", "ring4_full_tile64"])
def test_fused16_variants_match_plain_on_the_host(tmp_path, variant):
    cxx = _host_dir(tmp_path)
    _wait({variant: _host_build(cxx, tmp_path, "turbo_fused16", variant,
                                fused16_split.variant_flags(variant))})
    fn = getattr(ctypes.CDLL(str(tmp_path / f"lib{variant}.so")), "turbo_map_fused16")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, k, l, t = 3, 5824, 208, 32  # N = 84: a ragged last tile at 32 and 64 lanes
    args = _inputs(b, k, l, t)
    out = args[0].new_empty((l, args[0].shape[1]))
    _run(fn, *args[:4], out, args[0].shape[1], t, l, b, k // l,
         *fused16_split.variant_geometry(variant, l))
    _equal(out, tm.map_fused16_ref(*args))


def test_windowed_split_variants_build_for_the_host(host_kernels, tmp_path):
    """Every build of turbo_windowed.cu that tools/windowed_split times still
    compiles (host build), and every variant whose outputs are LLRs computes
    the kernel's function, in all three entries, at its own geometry."""
    cxx = _host_dir(tmp_path)
    names = {windowed_split.build_name(name): name for name in windowed_split.VARIANTS
             if windowed_split.build_name(name)}
    _wait({lib: _host_build(cxx, tmp_path, "turbo_windowed", lib,
                            windowed_split.variant_flags(name)) for lib, name in names.items()})
    args = _inputs(*WINDOWED_SHAPES[0])
    gs, gp, a0, b0, t, l, nof_b, nof_w = args
    n = gs.shape[1]
    for name in windowed_split.VARIANTS:
        if name in windowed_split.NOT_LLRS:
            continue
        for wrapper, (symbol, *_) in windowed_split.ENTRIES.items():
            if not windowed_split.applies(name, wrapper):
                continue
            want = _WINDOWED[symbol][2](*args)
            lib = windowed_split.build_name(name)
            if lib is None:
                fn = host_kernels[symbol]
            else:
                fn = getattr(ctypes.CDLL(str(tmp_path / f"lib{lib}.so")), symbol)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            geo = windowed_split.variant_geometry(name, wrapper, n, l, t)
            out = gs.new_empty((l, n))
            _run(fn, gs, gp, a0, b0, out, n, t, l, nof_b, nof_w, geo.lanes, geo.every,
                 geo.smem_bytes)
            _equal(out, want)


def test_fused_split_variants_build_for_the_host(host_kernels, tmp_path):
    """Every build of turbo_fused.cu that tools/fused_split times still
    compiles (host build), and every variant whose outputs are LLRs computes
    the kernel's function, at both radices, at its own geometry (N = 84: a
    ragged last tile at 32 and 16 lanes)."""
    cxx = _host_dir(tmp_path)
    names = {fused_split.build_name(name): name for name in fused_split.VARIANTS
             if fused_split.build_name(name)}
    _wait({lib: _host_build(cxx, tmp_path, "turbo_fused", lib, fused_split.variant_flags(name))
           for lib, name in names.items()})
    args = _inputs(3, 5824, 208, 32)
    gs, gp, a0, b0, t, l, nof_b, nof_w = args
    n = gs.shape[1]
    for radix in (2, 4):
        want = tm.map_fused_ref(*args, radix=radix)
        for name in fused_split.VARIANTS:
            if name in fused_split.NOT_LLRS:
                continue
            lib = fused_split.build_name(name)
            if lib is None:
                fn = host_kernels["turbo_map_fused"]
            else:
                fn = getattr(ctypes.CDLL(str(tmp_path / f"lib{lib}.so")), "turbo_map_fused")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            geo = fused_split.variant_geometry(name, n, l, radix)
            out = gs.new_empty((l, n))
            _run(fn, gs, gp, a0, b0, out, n, t, l, nof_b, nof_w, radix, geo.lanes, geo.every,
                 geo.smem_bytes)
            _equal(out, want)


# map_v3's kernel (turbo_windowed.cu) at its default geometry; odd N in the
# last shape
@pytest.mark.parametrize("b,k,l,t", SHAPES[:3] + [(3, 40, 40, 0)])
def test_turbo_v3_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    _equal(_windowed(host_kernels, "turbo_map_v3", args), tm.map_v3_ref(*args))


# --- the probe kernels (probe_acs.cu, probe_launch.cu) -----------------------


def _probe_inputs(shape, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("variant", probes.PROBE2_VARIANTS)
def test_probe2_source_matches_plain(host_kernels, variant):
    n, steps, out_rows, store_rows = 37, 10, 16, 8
    g, a0 = _probe_inputs((24, n), 2), _probe_inputs((8, n), 3, 1.0)
    out, astore = g.new_empty((out_rows, n)), g.new_empty((store_rows, 8, n))
    _run(host_kernels["probe2"], g, g, a0, out, astore, n, steps, store_rows,
         probes.PROBE2_VARIANTS.index(variant))
    want = probes.probe2_ref(variant, g, g, a0, steps, out_rows, store_rows)
    np.testing.assert_allclose(out[0].numpy(), want[0].numpy(), atol=1e-3, rtol=0)
    if variant == "astore":  # the store holds alpha before steps 8, 9 (slots 0, 1)
        a = a0.clone()
        for i in range(9):
            a = probes._probe2_acs(a, g[2 * i], g[2 * i], g[2 * i + 1], g[2 * i + 1])
        _close(astore[1], a)


@pytest.mark.parametrize("threads,smem", [(16, 0), (32, probes.ONE_BLOCK_PER_SM_SMEM)])
def test_probe_empty_source_matches_plain(host_kernels, threads, smem):
    x = _probe_inputs((16, 50), 4)
    out = x.new_zeros((8, 50))
    _run(host_kernels["probe_empty"], x, x, out, 50, threads, smem)
    _equal(out[0], probes.probe_empty_ref([x], 8)[0])


def test_probe6_sources_match_plain(host_kernels):
    n, steps = 21, 6
    g2s, g2p = _probe_inputs((steps, 2, n), 5), _probe_inputs((steps, 2, n), 6)
    a0, b0 = _probe_inputs((8, n), 7, 1.0), _probe_inputs((8, n), 8, 1.0)
    aout, bout = a0.new_empty((8, n)), b0.new_empty((8, n))
    _run(host_kernels["probe6_full"], g2s, g2p, a0, b0, aout, bout, n, steps)
    for got, want in zip((aout, bout), probes.probe6_full_ref(g2s, g2p, a0, b0)):
        _close(got, want)
    _run(host_kernels["probe6_skel"], a0, b0, aout, bout, n, steps)
    for got, want in zip((aout, bout), probes.probe6_skel_ref(a0, b0, steps)):
        _close(got, want)
    h = 11
    g16 = [_probe_inputs((steps, 2, 2, h), 9 + i).to(torch.bfloat16) for i in range(2)]
    m16 = [_probe_inputs((16, h), 11 + i, 1.0).to(torch.bfloat16) for i in range(2)]
    out16 = [m.new_empty((16, h)) for m in m16]
    _run(host_kernels["probe6_bf16"], *g16, *m16, *out16, h, steps)
    for got, want in zip(out16, probes.probe6_bf16_ref(*g16, *m16)):
        _equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe7_source_matches_plain(host_kernels, dtype):
    n, iters = 18, 12
    g = _probe_inputs((2, n), 13, 0.5).to(dtype)
    a0 = _probe_inputs((8, n), 14, 1.0).to(dtype)
    out = a0.new_empty((8, n))
    if dtype == torch.float32:
        _run(host_kernels["probe7_f32"], g, a0, out, n, iters)
        _close(out, probes.probe7_ref(g, a0, iters))
    else:
        _run(host_kernels["probe7_bf16"], g, a0, out, n // 2, iters)
        _equal(out, probes.probe7_ref(g, a0, iters))

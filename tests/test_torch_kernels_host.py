"""The CUDA kernels' own source, compiled for the host, against their plain
torch versions.

Each ``srsran_4g_tpu_torch/csrc/*.cu`` is built with the host C++ compiler
against a stand-in ``cuda_runtime.h`` that defines the CUDA keywords and a
sequential launch (every block and thread in turn), after the ``<<<...>>>``
launches are rewritten as calls to it.  The C entry points that the
wrappers of ``ops/cuda/turbo_map.py`` and ``ops/cuda/probes.py`` call through ctypes then run on CPU
buffers, so the kernels' indexing, schedules and arithmetic are checked
here; only the card (tests/test_torch_cuda.py, chip_smoke.py) shows that
nvcc builds them and that they run right in parallel.

A stand-in ``cuda_bf16.h`` does the same for the 16-bit kernels: its
``__nv_bfloat16`` is the 16-bit pattern, ``__nv_bfloat162`` a pair of them,
and ``__hadd``/``__hsub`` (and their pairwise ``2`` forms) add or subtract
in float and round to bf16 (round to nearest even) after every op,
which is what the card's bf16 instructions and torch's bf16 ops compute.

Tolerance: atol 1e-3 for the f32 kernels, as on the card (the same
arithmetic in the same order; in practice the results are identical); the
bf16 kernels and the v3 kernel must equal their plain versions exactly.
Skips without a host C++ compiler.
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
#define __launch_bounds__(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
static dim3 gridDim, blockDim, blockIdx, threadIdx;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static inline int cudaGetLastError() { return cudaSuccess; }
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

# kernel<<<grid, block, smem, stream>>>(args);  ->  host_launch(grid, block, [&] { kernel(args); });
_LAUNCH = re.compile(
    r"([\w:]+(?:<[^<>;]*>)?)<<<\s*([^,]+?)\s*,\s*([^,]+?)\s*,[^>]*>>>\s*\(([^;]*)\);", re.S)

# C entry -> (source, pointer args, int args), as ops/cuda/turbo_map.py binds them
_ENTRIES = {"turbo_map_windowed": ("turbo_map", 6, 5),
            "turbo_map_windowed16": ("turbo_map", 6, 5),
            "turbo_map_fused": ("turbo_fused", 7, 6),
            "turbo_map_fused16": ("turbo_fused", 7, 5),
            "turbo_sweep": ("turbo_sweep", 6, 6),
            "turbo_emit": ("turbo_emit", 5, 2),
            "turbo_map_v3": ("turbo_v3", 6, 5),
            "probe2": ("probe_acs", 5, 4),
            "probe6_full": ("probe_acs", 6, 2),
            "probe6_bf16": ("probe_acs", 6, 2),
            "probe6_skel": ("probe_acs", 4, 2),
            "probe7_f32": ("probe_acs", 3, 2),
            "probe7_bf16": ("probe_acs", 3, 2),
            "probe_empty": ("probe_launch", 3, 3)}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The C entry of every kernel source, built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "cuda_runtime.h").write_text(_CUDA_RUNTIME)
    (out / "cuda_bf16.h").write_text(_CUDA_BF16)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    procs = {}
    for name in {source for source, _, _ in _ENTRIES.values()}:
        src = (CSRC / f"{name}.cu").read_text()
        src, n_launch = _LAUNCH.subn(r"host_launch(\2, \3, [&] { \1(\4); });", src)
        assert n_launch, f"{name}.cu: no kernel launch found"
        (out / f"{name}.cpp").write_text(src)
        cmd = [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
               "-I", str(out), "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cpp")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}.cu does not build for the host:\n{log}"
    fns = {}
    for symbol, (name, n_ptr, n_int) in _ENTRIES.items():
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
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


@pytest.mark.parametrize("b,k,l,t", SHAPES)
def test_turbo_map_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    out, astore = gs.new_empty((l, n)), gs.new_empty((l, 8, n))
    _run(host_kernels["turbo_map_windowed"], *args[:4], astore, out, n, t, l, b, k // l)
    _close(out, tm.map_windowed_ref(*args))


@pytest.mark.parametrize("radix", [2, 4])
def test_turbo_fused_source_matches_plain(host_kernels, radix):
    b, k, l, t = SHAPES[0]
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    out = gs.new_empty((l, n))
    stores = [gs.new_empty((l // 4, 8, n)) for _ in range(2)]
    _run(host_kernels["turbo_map_fused"], *args[:4], *stores, out, n, t, l, b, k // l, radix)
    _close(out, tm.map_fused_ref(*args, radix=radix))


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


@pytest.mark.parametrize("b,k,l,t", SHAPES)
def test_turbo_map16_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    out = gs.new_empty((l, n))
    astore = gs.new_empty((l, 8, n), dtype=torch.bfloat16)
    _run(host_kernels["turbo_map_windowed16"], *args[:4], astore, out, n, t, l, b, k // l)
    _equal(out, tm.map_windowed16_ref(*args))


@pytest.mark.parametrize("b,k,l,t", [SHAPES[0], (2, 512, 128, 32)])
def test_turbo_fused16_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    out = gs.new_empty((l, n))
    stores = [gs.new_empty((l // 4, 8, n), dtype=torch.bfloat16) for _ in range(2)]
    _run(host_kernels["turbo_map_fused16"], *args[:4], *stores, out, n, t, l, b, k // l)
    _equal(out, tm.map_fused16_ref(*args))


# odd N (one lane without a partner) in the last shape
@pytest.mark.parametrize("b,k,l,t", SHAPES[:3] + [(3, 40, 40, 0)])
def test_turbo_v3_source_matches_plain(host_kernels, b, k, l, t):
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    out, store = gs.new_empty((l, n)), gs.new_empty((l, 8, n))
    _run(host_kernels["turbo_map_v3"], *args[:4], store, out, n, t, l, b, k // l)
    _equal(out, tm.map_v3_ref(*args))


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

"""The CUDA kernels' own source, compiled for the host, against their plain
torch versions.

Each ``srsran_4g_tpu_torch/csrc/*.cu`` is built with the host C++ compiler
against a stand-in ``cuda_runtime.h`` that defines the CUDA keywords and a
sequential launch (every block and thread in turn), after the ``<<<...>>>``
launches are rewritten as calls to it.  The C entry points that the
wrappers of ``ops/cuda/turbo_map.py`` call through ctypes then run on CPU
buffers, so the kernels' indexing, schedules and arithmetic are checked
here; only the card (tests/test_torch_cuda.py, chip_smoke.py) shows that
nvcc builds them and that they run right in parallel.

Tolerance: atol 1e-3, as on the card (f32, the same arithmetic in the same
order; in practice the results are identical).  Skips without a host C++
compiler.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from srsran_4g_tpu_torch.ops import turbo
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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline int cudaGetLastError() { return cudaSuccess; }
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

# kernel<<<grid, block, smem, stream>>>(args);  ->  host_launch(grid, block, [&] { kernel(args); });
_LAUNCH = re.compile(r"([\w<>]+?)<<<\s*([^,]+?)\s*,\s*([^,]+?)\s*,[^>]*>>>\s*\(([^;]*)\);", re.S)

# source -> (C entry, pointer args, int args), as ops/cuda/turbo_map.py binds them
_ENTRIES = {"turbo_map": ("turbo_map_windowed", 6, 5),
            "turbo_fused": ("turbo_map_fused", 7, 6),
            "turbo_sweep": ("turbo_sweep", 6, 6),
            "turbo_emit": ("turbo_emit", 5, 2)}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The C entry of every kernel source, built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "cuda_runtime.h").write_text(_CUDA_RUNTIME)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    procs = {}
    for name in _ENTRIES:
        src = (CSRC / f"{name}.cu").read_text()
        src, n_launch = _LAUNCH.subn(r"host_launch(\2, \3, [&] { \1(\4); });", src)
        assert n_launch, f"{name}.cu: no kernel launch found"
        (out / f"{name}.cpp").write_text(src)
        cmd = [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
               "-I", str(out), "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cpp")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}.cu does not build for the host:\n{log}"
        symbol, n_ptr, n_int = _ENTRIES[name]
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _run(fn, *args):
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in tensors)
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
    _run(host_kernels["turbo_map"], *args[:4], astore, out, n, t, l, b, k // l)
    _close(out, tm.map_windowed_ref(*args))


@pytest.mark.parametrize("radix", [2, 4])
def test_turbo_fused_source_matches_plain(host_kernels, radix):
    b, k, l, t = SHAPES[0]
    args = _inputs(b, k, l, t)
    gs, n = args[0], args[0].shape[1]
    out = gs.new_empty((l, n))
    stores = [gs.new_empty((l // 4, 8, n)) for _ in range(2)]
    _run(host_kernels["turbo_fused"], *args[:4], *stores, out, n, t, l, b, k // l, radix)
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

// The cost of one launch and of one block on NVIDIA Hopper (sm_90a): the
// H100 counterpart of the TPU probe tools/turbo_probe3.py empty_bench
// (pallas_call :26), an empty kernel that copies row 0 of its first input
// to row 0 of its output, to isolate what a grid step costs.
//
// On the TPU a grid step is one tile of the sequential grid with its DMA of
// every input block and its VMEM scratch.  Here blocks run in parallel and
// nothing is copied that the kernel does not read, so the question becomes
// three: the device time of the kernel over N lanes at 128-1,024 threads a
// block; the same with a dynamic shared-memory allocation large enough to
// leave one block per SM (standing in for the TPU's (56, 8, tile) VMEM
// scratch, which at tile 1,024 is 1.8 MB and fits no SM); and the host
// time of a launch through the package's ctypes path against its device
// time (ops/cuda/probes.py, tools/turbo_probe3.py).
//
// Contract: in0 (rows_in, N) f32, in1 an unused second input (the probe's
// nin = 2), out (rows_out, N) f32; only row 0 is read and written.
//
// What bounds it: the launch.  The bytes (row 0 in and out, 8 B per lane,
// 0.69 MB at N = 86,528) take 0.2 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel(const float* __restrict__ in0,
                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in0[i];
}

}  // namespace

// threads: 1..1024 a block; smem: dynamic shared-memory bytes a block asks
// for (0, or up to the card's opt-in maximum, 227 KB on the H100).
extern "C" int probe_empty(const float* in0, const float* in1, float* out, int n,
                           int threads, int smem, void* stream) {
  (void)in1;
  if (n <= 0) return 0;
  if (threads < 1 || threads > 1024 || smem < 0) return (int)cudaErrorInvalidValue;
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int blocks = (n + threads - 1) / threads;
  empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(in0, out, n);
  return (int)cudaGetLastError();
}

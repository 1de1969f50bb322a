// Shared helpers of the port's CUDA kernels (plain C interface, loaded with
// ctypes by repro_torch/kernels/pipeline.py).
//
// Every C entry point starts with the same launch prefix, filled in by the
// pipeline from a StreamPlan:
//   device        CUDA device ordinal the tensors live on
//   gx, gy, gz    the plan's "parallel" axes, last axis in x
//   loop          the product of the plan's "arbitrary" axes: the number of
//                 hypersteps each block runs in order
//   scratch_bytes the plan's ScratchSpec bytes: the block's persistent state,
//                 placed at the start of dynamic shared memory, or kept in
//                 registers by kernels that say so (they check the size)
//   stream        PyTorch's current cudaStream_t
// and returns cudaGetLastError() (0 on success) after its launches.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BSPS_EXPORT extern "C" __attribute__((visibility("default")))

namespace bsps {

// dtype codes shared with the Python wrappers
enum DType { kFloat32 = 0, kBFloat16 = 1 };

// Must equal the JAX kernels' _NEG_INF: masked scores and the initial
// running max of the online softmax.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum of one float per thread over the block, in a fixed order (warp
// shuffles, then warp 0 over the warp sums): deterministic run to run.
// `warp_sums` holds at least blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float x, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  x = (threadIdx.x < n_warps) ? warp_sums[threadIdx.x] : 0.f;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;  // valid in thread 0
}

// Sets the dynamic shared-memory limit of `kernel` when a launch needs more
// than the default 48 KB, and refuses a request above the device's per-block
// opt-in limit.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, int device, size_t bytes) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return err;
}

// A kernel's compiled attributes at `threads` a block and `smem` bytes of
// dynamic shared memory, as the CUDA runtime reports them: out[0] registers
// a thread, out[1] local (spilled) bytes a thread, out[2] `smem`, out[3]
// resident blocks an SM.
template <typename Kernel>
inline cudaError_t attrs(Kernel kernel, int device, int threads, int smem, int* out) {
  cudaError_t err = prepare_smem(kernel, device, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = fa.numRegs, out[1] = (int)fa.localSizeBytes, out[2] = smem, out[3] = blocks;
  return err;
}

}  // namespace bsps

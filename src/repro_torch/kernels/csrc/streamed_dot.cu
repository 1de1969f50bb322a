// BSPS inner product (paper §3.1, Algorithm 1) on Hopper.
//
// Replaces: src/repro/kernels/streamed_dot.py:32 (_dot_kernel), the Pallas
// kernel that runs the token stream as one sequential "arbitrary" grid axis
// and carries the fp32 partial sum across it in VMEM scratch.
//
// Bound on this card: bytes. Two input words are read per two FLOPs, far
// below the ~295 FLOP/byte the H100 needs before its arithmetic limits, so
// the kernel's only job is to keep device memory busy.
//
// Design: a CUDA grid has no order, so the sequential stream becomes the
// paper's p-core product. Block `core` takes the tokens core, core + p,
// core + 2p, ... (the cyclic distribution of §3.1) and streams them through
// registers with coalesced loads, keeping its fp32 partial sum α_s; the
// block's sum lands in its plan scratch and then in `partials[core]`. A second,
// one-block launch adds the p partials in a fixed order — the closing
// BROADCAST/SYNC of Algorithm 1. Deterministic, no atomics. The ragged tail
// is masked (the TPU kernel zero-pads it).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_partials(const T* __restrict__ v, const T* __restrict__ u, long long n,
             int token, int tokens_per_core, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* alpha = reinterpret_cast<float*>(smem);  // plan scratch "acc" (1, 1)
  __shared__ float warp_sums[kThreads / 32];
  const int core = blockIdx.x, cores = gridDim.x;
  float acc = 0.f;
  for (int t = 0; t < tokens_per_core; ++t) {            // the hypersteps
    const long long base = ((long long)t * cores + core) * token;
    for (int i = threadIdx.x; i < token; i += kThreads) {
      const long long idx = base + i;
      if (idx < n) acc += bsps::to_float(v[idx]) * bsps::to_float(u[idx]);
    }
  }
  acc = bsps::block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    alpha[0] = acc;
    partials[core] = alpha[0];
  }
}

__global__ void __launch_bounds__(kThreads)
dot_reduce(const float* __restrict__ partials, int cores, float* __restrict__ out) {
  __shared__ float warp_sums[kThreads / 32];
  float acc = 0.f;
  for (int i = threadIdx.x; i < cores; i += kThreads) acc += partials[i];
  acc = bsps::block_sum(acc, warp_sums);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename T>
cudaError_t launch(int device, int cores, int loop, int scratch_bytes, cudaStream_t stream,
                   const void* v, const void* u, long long n, int token,
                   float* partials, float* out) {
  cudaError_t err = bsps::prepare_smem(dot_partials<T>, device, scratch_bytes);
  if (err != cudaSuccess) return err;
  dot_partials<T><<<cores, kThreads, scratch_bytes, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(u), n, token, loop, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dot_reduce<<<1, kThreads, 0, stream>>>(partials, cores, out);
  return cudaGetLastError();
}

}  // namespace

// α = v·u. grid (cores, 1, 1), loop = tokens per core; `partials` holds
// `cores` floats, `out` one.
BSPS_EXPORT int bsps_dot(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                         void* stream, const void* v, const void* u, long long n,
                         int token, int dtype, float* partials, float* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gy != 1 || gz != 1 || gx < 1 || loop < 1 || token < 1 || scratch_bytes < 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kFloat32)
    return launch<float>(device, gx, loop, scratch_bytes, s, v, u, n, token, partials, out);
  if (dtype == bsps::kBFloat16)
    return launch<__nv_bfloat16>(device, gx, loop, scratch_bytes, s, v, u, n, token, partials, out);
  return cudaErrorInvalidValue;
}

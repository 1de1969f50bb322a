// Mamba selective scan on Hopper:
//   h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t x_t) ⊗ B_t ,   y_t = C_t·h_t + D ⊙ x_t
//
// Replaces: src/repro/kernels/ssm_scan.py:35 (_scan_kernel), the Pallas
// kernel that walks the grid (batch, chunk) in order on one core and keeps a
// batch row's whole state h (d_inner × d_state, fp32) in VMEM scratch across
// the chunk axis, reset at chunk 0 of each row.
//
// Bound on this card: operations. Per position and channel the scan does
// d_state exponentials and about 10·d_state fp32 operations on 2 streamed
// words (x, Δ) and 1 written word (y), far above the memory balance point;
// the fp32 units outside the tensor cores set the bound.
//
// Design: one row's state is 8192 × 16 × 4 B = 512 KB at jamba's width, more
// than one block's shared memory, but the recurrence is independent per
// channel. So channels are a parallel axis: grid (channel tiles, batch rows),
// one thread per channel, its h[i, 0:d_state] and A[i, :] in registers for
// the whole sequence (the plan's "h" scratch is this register state) and D[i]
// with them. The block walks the chunks in order (the plan's "arbitrary"
// axis, `loop` chunks). Per chunk it stages the chunk's B_t and C_t — shared
// by every channel of the row — in shared memory as fp32, then each thread
// steps through the chunk's positions, reading x and Δ coalesced across the
// channels of the tile and writing y once per position. Thread-per-channel
// rather than lane-per-(channel, state): the output contraction C_t·h_t is
// then a register sum with no warp shuffles, and B_t/C_t are broadcast reads
// of shared memory. The state is fp32 and the exponential is the accurate
// expf. The ragged last chunk and the ragged last channel tile are masked;
// nothing is padded. Deterministic: every sum has one fixed order.

#include "common.cuh"

namespace {

constexpr int kBlockD = 128;   // channels per block; the wrapper's BLOCK_D

template <typename T, int DS>
__global__ void __launch_bounds__(kBlockD)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                T* __restrict__ y, int seq, int d_inner, int chunk, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sb = reinterpret_cast<float*>(smem);   // (chunk, DS): B_t of this chunk
  float* sc = sb + chunk * DS;                  // (chunk, DS): C_t
  const int row = blockIdx.y;
  const int i = blockIdx.x * kBlockD + threadIdx.x;
  const bool active = i < d_inner;

  float h[DS], av[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = 0.f;                                 // the state resets per row
    av[s] = active ? a[(long long)i * DS + s] : 0.f;
  }
  const float d_i = active ? dskip[i] : 0.f;
  const long long row_pos = (long long)row * seq;

  for (int ci = 0; ci < n_chunks; ++ci) {       // the hypersteps
    const int t0 = ci * chunk;
    const int len = min(chunk, seq - t0);
    __syncthreads();                            // the last chunk's reads are done
    const long long bc0 = (row_pos + t0) * DS;
    for (int e = threadIdx.x; e < len * DS; e += kBlockD) {
      sb[e] = bsps::to_float(bm[bc0 + e]);
      sc[e] = bsps::to_float(cm[bc0 + e]);
    }
    __syncthreads();
    if (!active) continue;
    const long long p0 = (row_pos + t0) * d_inner + i;
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const long long p = p0 + (long long)t * d_inner;
      const float x_t = bsps::to_float(x[p]);
      const float dt_t = bsps::to_float(dt[p]);
      const float u = dt_t * x_t;
      const float* b_t = sb + t * DS;
      const float* c_t = sc + t * DS;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = expf(dt_t * av[s]) * h[s] + u * b_t[s];
        acc += h[s] * c_t[s];
      }
      y[p] = bsps::from_float<T>(acc + d_i * x_t);
    }
  }
}

template <typename T, int DS>
cudaError_t launch(int device, int tiles, int rows, int n_chunks, cudaStream_t stream,
                   const void* x, const void* dt, const void* b, const void* c,
                   const float* a, const float* d, void* y, int seq, int d_inner, int chunk) {
  const size_t smem = 2 * (size_t)chunk * DS * sizeof(float);
  cudaError_t err = bsps::prepare_smem(ssm_scan_kernel<T, DS>, device, smem);
  if (err != cudaSuccess) return err;
  ssm_scan_kernel<T, DS><<<dim3(tiles, rows, 1), kBlockD, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), a, d, static_cast<T*>(y), seq, d_inner, chunk, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int device, int tiles, int rows, int n_chunks, cudaStream_t stream,
                     const void* x, const void* dt, const void* b, const void* c,
                     const float* a, const float* d, void* y, int seq, int d_inner,
                     int d_state, int chunk) {
  if (d_state == 8)
    return launch<T, 8>(device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y, seq,
                        d_inner, chunk);
  if (d_state == 16)
    return launch<T, 16>(device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y, seq,
                         d_inner, chunk);
  return cudaErrorInvalidValue;
}

}  // namespace

// y = scan(x, Δ, B, C; A, D). grid (channel tiles, batch rows, 1), loop =
// chunks per row; x, Δ, y (B, seq, d_inner) and B, C (B, seq, d_state)
// contiguous in `dtype`, A (d_inner, d_state) and D (d_inner,) fp32.
// `scratch_bytes` is the plan's per-tile state, block_d × d_state fp32,
// which the kernel keeps in registers; its dynamic shared memory is the
// chunk's B/C stage.
BSPS_EXPORT int bsps_ssm_scan(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                              void* stream, const void* x, const void* dt, const void* b,
                              const void* c, const float* a, const float* d, void* y,
                              int seq, int d_inner, int d_state, int chunk, int block_d,
                              int dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (block_d != kBlockD || gz != 1 || gy < 1 || seq < 1 || d_inner < 1 || chunk < 1 ||
      gx != (d_inner + kBlockD - 1) / kBlockD || loop != (seq + chunk - 1) / chunk ||
      scratch_bytes != kBlockD * d_state * (int)sizeof(float))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kFloat32)
    return dispatch<float>(device, gx, gy, loop, s, x, dt, b, c, a, d, y, seq, d_inner,
                           d_state, chunk);
  if (dtype == bsps::kBFloat16)
    return dispatch<__nv_bfloat16>(device, gx, gy, loop, s, x, dt, b, c, a, d, y, seq,
                                   d_inner, d_state, chunk);
  return cudaErrorInvalidValue;
}

// BSPS block-streamed matmul (paper §3.2, the outer level) on Hopper.
//
// Replaces: src/repro/kernels/streamed_matmul.py:44 (_matmul_kernel), the
// Pallas kernel over grid (i, j, k) = (parallel, parallel, arbitrary) whose
// fp32 accumulator tile is carried across the K stream in VMEM scratch and
// cast to the output dtype on the last K step.
//
// Bound on this card: at decode (m = 4 rows) bytes — the call reads the whole
// weight matrix to do 8 FLOPs per weight, so it is bounded by device memory;
// at prefill (m = 1024) operations, on the bf16 tensor cores.
//
// Design: output tiles are the CUDA grid; the K stream is a loop inside the
// block, as the plan's "arbitrary" axis says. Each hyperstep stages one
// BM×BK tile of A and one BK×BN tile of B in shared memory — double
// buffered: the next tiles are loaded into registers while the tensor cores
// (nvcuda::wmma, bf16 in, fp32 accumulate) work on the current ones. The
// accumulator lives in the warps' fragments; at the end it is stored to the
// plan's scratch tile in shared memory and written out once, cast to the
// output dtype, with ragged edges masked in the kernel (no padding copies).
// Two tile shapes: 64×64×32 with a 2×2 warp grid, and 16×64×64 with a 1×4
// warp grid for decode, where a 64-row tile would waste most of the block.
// When the output tiles alone cannot fill the card (decode), the K stream is
// split over a third grid axis: each split writes an fp32 partial tile and a
// second launch sums the splits in a fixed order and casts — deterministic,
// no atomics. Operands are bf16; other dtypes are refused.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

using raw16 = unsigned short;  // bf16 bits, moved without conversion

// 8 consecutive bf16 values (16 bytes) of row `r`, columns [c, c+8), zero
// outside [0, rows) × [0, cols). One 16-byte load when in range and aligned.
__device__ __forceinline__ uint4 load8(const raw16* __restrict__ base, long long ld,
                                       int rows, int cols, int r, int c) {
  union { uint4 v; raw16 h[8]; } out;
  if (r < rows) {
    const raw16* p = base + (long long)r * ld + c;
    if (c + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      out.v = *reinterpret_cast<const uint4*>(p);
      return out.v;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) out.h[e] = (c + e < cols) ? p[e] : raw16(0);
    return out.v;
  }
  out.v = make_uint4(0, 0, 0, 0);
  return out.v;
}

template <int BM, int BN, int BK, int WM, int WN>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int FM = BM / (16 * WM);     // fragments per warp, rows
  static constexpr int FN = BN / (16 * WN);     // fragments per warp, cols
  static constexpr int A_CHUNKS = BM * BK / 8;  // 16-byte chunks per A tile
  static constexpr int B_CHUNKS = BK * BN / 8;
  static constexpr int A_PER = (A_CHUNKS + kThreads - 1) / kThreads;
  static constexpr int B_PER = (B_CHUNKS + kThreads - 1) / kThreads;
  static constexpr int SCRATCH = BM * BN * 4;   // fp32 accumulator tile
  static constexpr int STAGE = (BM * BK + BK * BN) * 2;
  static constexpr int SMEM = SCRATCH + 2 * STAGE;
  static_assert(FM >= 1 && FN >= 1 && BK % 16 == 0, "bad tile");
};

template <int BM, int BN, int BK, int WM, int WN, typename Out>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN>::kThreads)
matmul_kernel(const raw16* __restrict__ a, const raw16* __restrict__ b,
              Out* __restrict__ c, float* __restrict__ partials,
              int m, int n, int k, long long lda, long long ldb, long long ldc,
              int k_steps) {
  using T = Tile<BM, BN, BK, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_tile = reinterpret_cast<float*>(smem);                    // plan scratch
  raw16* a_buf = reinterpret_cast<raw16*>(smem + T::SCRATCH);          // [2][BM][BK]
  raw16* b_buf = a_buf + 2 * BM * BK;                                  // [2][BK][BN]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp / WN, wc = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int kt0 = split * k_steps;                                     // first K tile

  uint4 a_reg[T::A_PER], b_reg[T::B_PER];
  auto fetch = [&](int kt) {                       // global -> registers
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int ch = tid + i * T::kThreads;
      if (ch < T::A_CHUNKS) {
        const int r = ch / (BK / 8), cc = (ch % (BK / 8)) * 8;
        a_reg[i] = load8(a, lda, m, k, m0 + r, k0 + cc);
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int ch = tid + i * T::kThreads;
      if (ch < T::B_CHUNKS) {
        const int r = ch / (BN / 8), cc = (ch % (BN / 8)) * 8;
        b_reg[i] = load8(b, ldb, k, n, k0 + r, n0 + cc);
      }
    }
  };
  auto stash = [&](int buf) {                      // registers -> shared
    raw16* as = a_buf + buf * BM * BK;
    raw16* bs = b_buf + buf * BK * BN;
#pragma unroll
    for (int i = 0; i < T::A_PER; ++i) {
      const int ch = tid + i * T::kThreads;
      if (ch < T::A_CHUNKS) reinterpret_cast<uint4*>(as)[ch] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < T::B_PER; ++i) {
      const int ch = tid + i * T::kThreads;
      if (ch < T::B_CHUNKS) reinterpret_cast<uint4*>(bs)[ch] = b_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(kt0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < k_steps; ++s) {              // the K stream (hypersteps)
    const int buf = s & 1;
    if (s + 1 < k_steps) fetch(kt0 + s + 1);       // prefetch the next tokens
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(a_buf + buf * BM * BK);
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(b_buf + buf * BK * BN);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], as + ((wr * T::FM + i) * 16) * BK + kk, BK);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * BN + (wc * T::FN + j) * 16, BN);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (s + 1 < k_steps) stash(buf ^ 1);
    __syncthreads();
  }

  // WRITE(σ_C, Σ_C): the finished tile goes up once, through the scratch tile.
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(acc_tile + ((wr * T::FM + i) * 16) * BN + (wc * T::FN + j) * 16,
                              acc[i][j], BN, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += T::kThreads) {
    const int r = m0 + idx / BN, col = n0 + idx % BN;
    if (r >= m || col >= n) continue;
    if (partials != nullptr) {
      partials[((long long)split * m + r) * n + col] = acc_tile[idx];
    } else {
      c[(long long)r * ldc + col] = bsps::from_float<Out>(acc_tile[idx]);
    }
  }
}

template <typename Out>
__global__ void splitk_reduce(const float* __restrict__ partials, int splits, int m, int n,
                              Out* __restrict__ c, long long ldc) {
  const long long total = (long long)m * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partials[s * total + i];
    c[(i / n) * ldc + i % n] = bsps::from_float<Out>(acc);
  }
}

template <int BM, int BN, int BK, int WM, int WN, typename Out>
cudaError_t launch(int device, dim3 grid, int k_steps, int scratch_bytes, cudaStream_t stream,
                   const void* a, const void* b, void* c, float* partials, int m, int n,
                   int k, long long lda, long long ldb, long long ldc) {
  using T = Tile<BM, BN, BK, WM, WN>;
  if (scratch_bytes != T::SCRATCH) return cudaErrorInvalidValue;  // plan and kernel disagree
  auto kernel = matmul_kernel<BM, BN, BK, WM, WN, Out>;
  cudaError_t err = bsps::prepare_smem(kernel, device, T::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T::kThreads, T::SMEM, stream>>>(
      static_cast<const raw16*>(a), static_cast<const raw16*>(b), static_cast<Out*>(c),
      grid.z > 1 ? partials : nullptr, m, n, k, lda, ldb, ldc, k_steps);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid.z == 1) return err;
  const long long total = (long long)m * n;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_reduce<Out><<<blocks, 256, 0, stream>>>(partials, grid.z, m, n, static_cast<Out*>(c), ldc);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t dispatch(int device, dim3 grid, int k_steps, int scratch_bytes, cudaStream_t stream,
                     const void* a, const void* b, void* c, float* partials, int m, int n,
                     int k, long long lda, long long ldb, long long ldc, int block_m) {
  if (block_m == 16)
    return launch<16, 64, 64, 1, 4, Out>(device, grid, k_steps, scratch_bytes, stream, a, b, c,
                                         partials, m, n, k, lda, ldb, ldc);
  if (block_m == 64)
    return launch<64, 64, 32, 2, 2, Out>(device, grid, k_steps, scratch_bytes, stream, a, b, c,
                                         partials, m, n, k, lda, ldb, ldc);
  return cudaErrorInvalidValue;
}

}  // namespace

// C = A·B, A (m, k) and B (k, n) bf16 with row strides lda, ldb; C (m, n) of
// `out_dtype` with row stride ldc. grid (n tiles, m tiles, splits), loop = K
// tiles per split; `block_m` (16 or 64) picks the tile shape. With splits > 1,
// `partials` holds splits·m·n floats.
BSPS_EXPORT int bsps_matmul(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                            void* stream, const void* a, const void* b, void* c,
                            float* partials, int m, int n, int k, long long lda,
                            long long ldb, long long ldc, int block_m, int out_dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gx < 1 || gy < 1 || gz < 1 || loop < 1 || (gz > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == bsps::kBFloat16)
    return dispatch<__nv_bfloat16>(device, grid, loop, scratch_bytes, s, a, b, c, partials, m,
                                   n, k, lda, ldb, ldc, block_m);
  if (out_dtype == bsps::kFloat32)
    return dispatch<float>(device, grid, loop, scratch_bytes, s, a, b, c, partials, m, n, k,
                           lda, ldb, ldc, block_m);
  return cudaErrorInvalidValue;
}

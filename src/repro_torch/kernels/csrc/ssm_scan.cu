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
// words (x, Δ) and 1 written word (y), far above the memory balance point.
// The exponentials have a floor of their own: the special-function unit
// gives 16 a clock per SM, 134 M of them at jamba's forward shape.
//
// Design: one row's state is 8192 × 16 × 4 B = 512 KB at jamba's width, more
// than one block's shared memory, but the recurrence is independent per
// channel. So channels are a parallel axis: grid (channel tiles, batch rows).
// Each channel's d_state states are split over a group of G lanes (G = 2, 4
// or 8, at most d_state / 2), each lane holding d_state / G of h and of A·log2(e)
// in registers for the whole sequence (the plan's "h" scratch is this
// register state): a 128-thread block takes 128 / G channels, so the card
// gets G times the warps of one thread per channel and B 1 fills it. Per
// position a lane updates its states serially (the fp32 state, an FMA chain
// per state) and y_t = C_t·h_t is a balanced tree over state pairs whose
// last log2(G) levels are xor-shuffles within the group: the same order,
// so the same bits, for every G, and so for every batch size. exp(Δ·A) is
// ex2.approx of Δ·(A·log2 e), one special-function instruction.
//
// The block walks the chunks in order (the plan's "arbitrary" axis, `loop`
// chunks). Each chunk's x, Δ (the block's channels) and B_t, C_t (shared by
// the row's channels) are staged in shared memory by 16-byte cp.async, the
// next chunk's while this one is scanned (double buffered: the paper's
// prefetch of the next token); y is staged too and leaves in coalesced
// stores. Pieces that are ragged or not 16-byte aligned are copied element
// by element. bf16 B_t and C_t are widened to fp32 once per block. The
// chunk only sizes the stage (at most kMaxStage positions):
// every (channel, state) walks the positions in order, so the bits do not
// depend on it. Ragged L and d_inner are masked; nothing is padded.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStage = 64;   // positions per stage (the wrapper's STAGE_BYTES / 2)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst (rows × cols, dense) ← src rows `ld` apart; zero past valid_rows and
// valid_cols. 16-byte pieces in range and aligned go by cp.async.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, int rows,
                                           int cols, int valid_rows, int valid_cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v % per_row) * kVec;
    T* d = dst + r * cols + c;
    const T* s = src + (long long)r * ld + c;
    if (r < valid_rows && c + kVec <= valid_cols && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = (r < valid_rows && c + e < valid_cols) ? s[e] : bsps::from_float<T>(0.f);
    }
  }
}

// dst rows `ld` apart ← src (rows × cols, dense), only rows < valid_rows and
// columns < valid_cols; 16-byte stores where a piece is whole and aligned
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, long long ld, int cols,
                                           int valid_rows, int valid_cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int v = threadIdx.x; v < valid_rows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v % per_row) * kVec;
    T* d = dst + (long long)r * ld + c;
    const T* s = src + r * cols + c;
    if (c + kVec <= valid_cols && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < kVec && c + e < valid_cols; ++e) d[e] = s[e];
    }
  }
}

// N consecutive floats of a stage row (vector loads of shared memory)
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = v.x, o[4 * i + 1] = v.y, o[4 * i + 2] = v.z, o[4 * i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "a lane holds pairs of states");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(p)[i];
      o[2 * i] = v.x, o[2 * i + 1] = v.y;
    }
  }
}
template <typename T, int DS>
__host__ __device__ constexpr int buffer_elems(int bd, int stage) {
  // x, Δ (stage × bd) and B, C (stage × DS), each piece 16-byte aligned
  return ((2 * stage * bd + 2 * stage * DS) * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
}

template <typename T, int DS, int G>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                T* __restrict__ y, int seq, int d_inner, int chunk, int n_chunks) {
  constexpr int BD = kThreads / G;            // channels per block
  constexpr int SPL = DS / G;                 // states per lane
  static_assert(SPL >= 2, "a lane holds at least one pair of states");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWide = std::is_same<T, float>::value;
  const int buf_elems = buffer_elems<T, DS>(BD, chunk);
  T* bufs = reinterpret_cast<T*>(smem);              // two stages, buf_elems apart
  T* ys = bufs + 2 * buf_elems;                      // (chunk, BD): this chunk's y
  // bf16 B_t and C_t once per block as fp32 (2, chunk, DS): every lane of a
  // channel group reads them, so they are widened once, not per lane
  float* bcf = reinterpret_cast<float*>(ys + (chunk * BD + 7) / 8 * 8);
  const int row = blockIdx.y, c0 = blockIdx.x * BD;
  const int ch = threadIdx.x / G, lane_s = threadIdx.x % G;
  const int i = c0 + ch;
  const bool active = i < d_inner;
  const int valid_cols = d_inner - c0;

  float h[SPL], a2[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    h[s] = 0.f;                               // the state resets per row
    a2[s] = active ? a[(long long)i * DS + lane_s * SPL + s] * kLog2e : 0.f;
  }
  const float d_i = active ? dskip[i] : 0.f;
  const long long row_pos = (long long)row * seq;

  auto stage = [&](int ci, T* dst) {          // issue chunk ci's copies; no wait
    const int t0 = ci * chunk, len = min(chunk, seq - t0);
    const long long p0 = (row_pos + t0) * d_inner + c0;
    stage_tile(dst, x + p0, d_inner, chunk, BD, len, valid_cols);
    stage_tile(dst + chunk * BD, dt + p0, d_inner, chunk, BD, len, valid_cols);
    const long long q0 = (row_pos + t0) * DS;
    stage_tile(dst + 2 * chunk * BD, bm + q0, DS, chunk, DS, len, DS);
    stage_tile(dst + 2 * chunk * BD + chunk * DS, cm + q0, DS, chunk, DS, len, DS);
    cp_async_commit();
  };

  stage(0, bufs);
  for (int ci = 0; ci < n_chunks; ++ci) {     // the hypersteps
    if (ci + 1 < n_chunks) {
      stage(ci + 1, bufs + ((ci + 1) & 1) * buf_elems);
      cp_async_wait<1>();                     // chunk ci has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xs = bufs + (ci & 1) * buf_elems;
    const T* dts = xs + chunk * BD;
    const T* bc = dts + chunk * BD;          // B (chunk, DS), then C
    const int t0 = ci * chunk, len = min(chunk, seq - t0);
    const float* bs;
    if constexpr (kWide) {
      bs = bc;
    } else {
      for (int e = threadIdx.x; e < 2 * chunk * DS; e += kThreads) bcf[e] = bsps::to_float(bc[e]);
      __syncthreads();
      bs = bcf;
    }
    const float* cs = bs + chunk * DS;
    // unrolled for ILP across positions: only h is carried from one to the next
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const float x_t = bsps::to_float(xs[t * BD + ch]);
      const float dt_t = bsps::to_float(dts[t * BD + ch]);
      const float u = dt_t * x_t;
      float b_t[SPL], c_t[SPL];
      load_floats(bs + t * DS + lane_s * SPL, b_t);
      load_floats(cs + t * DS + lane_s * SPL, c_t);
#pragma unroll
      for (int s = 0; s < SPL; ++s) h[s] = fmaf(ex2(dt_t * a2[s]), h[s], u * b_t[s]);
      // C_t·h_t in one order for every lane grouping: state pairs fused as
      // h0·c0 + (h1·c1), then a balanced tree over the pairs in index order,
      // its last log2(G) levels across the group (ascending xor offsets)
      float pr[SPL / 2];
#pragma unroll
      for (int q = 0; q < SPL / 2; ++q)
        pr[q] = fmaf(h[2 * q], c_t[2 * q], h[2 * q + 1] * c_t[2 * q + 1]);
#pragma unroll
      for (int w = 1; w < SPL / 2; w *= 2)
#pragma unroll
        for (int q = 0; q + w < SPL / 2; q += 2 * w) pr[q] += pr[q + w];
      float acc = pr[0];
#pragma unroll
      for (int off = 1; off < G; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane_s == 0) ys[t * BD + ch] = bsps::from_float<T>(fmaf(d_i, x_t, acc));
    }
    __syncthreads();                          // ys is whole; this stage is free
    store_tile(y + (row_pos + t0) * d_inner + c0, ys, d_inner, BD, len, valid_cols);
  }
}

template <typename T, int DS, int G>
cudaError_t launch(int device, int tiles, int rows, int n_chunks, cudaStream_t stream,
                   const void* x, const void* dt, const void* b, const void* c,
                   const float* a, const float* d, void* y, int seq, int d_inner, int chunk) {
  constexpr int BD = kThreads / G;
  const size_t wide = std::is_same<T, float>::value ? 0 : 2 * (size_t)chunk * DS * sizeof(float);
  const size_t smem = (2 * (size_t)buffer_elems<T, DS>(BD, chunk) + ((size_t)chunk * BD + 7) / 8 * 8) *
                          sizeof(T) + wide;
  cudaError_t err = bsps::prepare_smem(ssm_scan_kernel<T, DS, G>, device, smem);
  if (err != cudaSuccess) return err;
  ssm_scan_kernel<T, DS, G><<<dim3(tiles, rows, 1), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), a, d, static_cast<T*>(y), seq, d_inner, chunk, n_chunks);
  return cudaGetLastError();
}

template <typename T, int DS>
cudaError_t by_group(int lanes, int device, int tiles, int rows, int n_chunks,
                     cudaStream_t stream, const void* x, const void* dt, const void* b,
                     const void* c, const float* a, const float* d, void* y, int seq,
                     int d_inner, int chunk) {
  if (lanes == 2)
    return launch<T, DS, 2>(device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y, seq,
                            d_inner, chunk);
  if (lanes == 4)
    return launch<T, DS, 4>(device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y, seq,
                            d_inner, chunk);
  if constexpr (DS >= 16) {
    if (lanes == 8)
      return launch<T, DS, 8>(device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y, seq,
                              d_inner, chunk);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int lanes, int device, int tiles, int rows, int n_chunks,
                     cudaStream_t stream, const void* x, const void* dt, const void* b,
                     const void* c, const float* a, const float* d, void* y, int seq,
                     int d_inner, int d_state, int chunk) {
  if (d_state == 8)
    return by_group<T, 8>(lanes, device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y,
                          seq, d_inner, chunk);
  if (d_state == 16)
    return by_group<T, 16>(lanes, device, tiles, rows, n_chunks, stream, x, dt, b, c, a, d, y,
                           seq, d_inner, chunk);
  return cudaErrorInvalidValue;
}

}  // namespace

// y = scan(x, Δ, B, C; A, D). grid (channel tiles, batch rows, 1), loop =
// chunks per row; x, Δ, y (B, seq, d_inner) and B, C (B, seq, d_state)
// contiguous in `dtype`, A (d_inner, d_state) and D (d_inner,) fp32.
// `block_d` channels per block (16, 32 or 64: 8, 4 or 2 lanes per channel,
// at most d_state / 2).
// `scratch_bytes` is the plan's per-tile state, block_d × d_state fp32,
// which the kernel keeps in registers; its dynamic shared memory is the
// double-buffered chunk stage (chunk ≤ kMaxStage positions) and y's stage.
BSPS_EXPORT int bsps_ssm_scan(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                              void* stream, const void* x, const void* dt, const void* b,
                              const void* c, const float* a, const float* d, void* y,
                              int seq, int d_inner, int d_state, int chunk, int block_d,
                              int dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((block_d != 16 && block_d != 32 && block_d != 64) || gz != 1 || gy < 1 || seq < 1 ||
      d_inner < 1 || chunk < 1 || chunk > kMaxStage || gx != (d_inner + block_d - 1) / block_d ||
      loop != (seq + chunk - 1) / chunk || scratch_bytes != block_d * d_state * (int)sizeof(float))
    return cudaErrorInvalidValue;
  const int lanes = kThreads / block_d;
  if (2 * lanes > d_state) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kFloat32)
    return dispatch<float>(lanes, device, gx, gy, loop, s, x, dt, b, c, a, d, y, seq, d_inner,
                           d_state, chunk);
  if (dtype == bsps::kBFloat16)
    return dispatch<__nv_bfloat16>(lanes, device, gx, gy, loop, s, x, dt, b, c, a, d, y, seq,
                                   d_inner, d_state, chunk);
  return cudaErrorInvalidValue;
}

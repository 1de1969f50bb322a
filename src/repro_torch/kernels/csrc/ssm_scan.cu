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

// ---------------------------------------------------------------------------
// The backward: (dx, dΔ, dB, dC, dA, dD) of the scan above for the output
// gradient dy.
//
// Replaces: jax.grad through the JAX package's chunked_selective_scan
// (src/repro/models/mamba.py:63), its training path; it has no Pallas
// backward. With g_t = ∂L/∂h_t, carried from the last position to the first,
//   g_t  = C_t dy_t + exp(Δ_{t+1}A) ⊙ g_{t+1}
//   dx_t = D dy_t + Δ_t Σ_s g_t B_t          dΔ_t = Σ_s g_t (A e_t h_{t-1} + B_t x_t)
//   dB_t = Σ_i g_t Δ_t x_t                   dC_t = Σ_i dy_t h_t
//   dA   = Σ_{b,t} g_t Δ_t e_t h_{t-1}       dD   = Σ_{b,t} dy_t x_t
// with e_t = exp(Δ_t A), s over states and i over channels.
//
// Bound on this card: operations. The function needs one exponential and
// about 18 fp32 operations per (position, channel, state); this design does
// about 22 and three exponentials (a forward sweep, a recompute and a
// reverse step per position), and moves a checkpoint tape besides.
//
// Design. The grid and lane groups are the forward's: (channel tiles, batch
// rows), G lanes a channel, SPL = d_state / G states a lane. The recurrence
// is not run backwards: h_{t-1} = (h_t - Δ_t B_t x_t) / e_t divides by decays
// down to exp(-16Δ) and loses the state. Instead the block first walks its
// channels forward (sweep 1) and stores the state before every segment of
// `chunk` positions to an fp32 checkpoint tape (B, n_chunks, d_inner,
// d_state) in device memory; then it walks the segments in reverse (sweep
// 2), recomputes a segment's states from its checkpoint into registers (the
// forward's arithmetic, so the forward's bits) and steps g back through
// them. A segment is 8 positions at 8 states a lane, 16 at fewer, so the
// recomputed states stay in registers. Each segment's x, Δ, dy, B_t, C_t are
// staged in shared memory by cp.async, the next one's while this one runs.
//
// No atomics, and the same bits for every G, every batch and every run:
// - the per-channel sums over states (Σ g B, Σ A e h g) take the forward's
//   C_t·h_t order: state pairs fused, a balanced tree over the pairs, its
//   last log2(G) levels across the group;
// - dA and dD sum over positions in one thread, last position first, and
//   the per-row partials are summed in row order by a second kernel;
// - dB and dC sum over channels that live in other blocks. Each position's
//   per-(channel, state) terms go to shared memory, kBatch positions at a
//   time, and are summed in channel order over groups of kGroup = 16
//   channels (the tile at G = 8); the second kernel sums the groups'
//   partials (B, L, 2, ceil(d_inner / 16), d_state) in group order.
// The chunk sets only where the checkpoints fall, so the bits do not depend
// on it either.

namespace {

constexpr int kBatch = 8;    // positions per dB/dC reduction through shared memory
constexpr int kGroup = 16;   // channels per dB/dC partial

// positions per segment: the segment's recomputed states stay in registers
__host__ __device__ constexpr int seg_len(int spl) { return spl >= 8 ? 8 : 16; }

template <typename T, int DS>
__host__ __device__ constexpr int bwd_buffer_elems(int bd, int chunk) {
  // x, Δ, dy (chunk × bd) and B, C (chunk × DS), each piece 16-byte aligned
  return ((3 * chunk * bd + 2 * chunk * DS) * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
}

template <typename T, int DS>
__host__ __device__ constexpr size_t bwd_red_offset(int bd, int chunk) {
  // bytes before the reduction buffer: two stages, then dx's and dΔ's stage
  return ((2 * (size_t)bwd_buffer_elems<T, DS>(bd, chunk) + 2 * (size_t)chunk * bd) *
              sizeof(T) + 15) / 16 * 16;
}

// Σ_s p_s q_s over a channel's states in the forward's C_t·h_t order, the
// sum in every lane of the group
template <int SPL, int G>
__device__ __forceinline__ float channel_dot(const float (&p)[SPL], const float (&q)[SPL]) {
  float pr[SPL / 2];
#pragma unroll
  for (int k = 0; k < SPL / 2; ++k) pr[k] = fmaf(p[2 * k], q[2 * k], p[2 * k + 1] * q[2 * k + 1]);
#pragma unroll
  for (int w = 1; w < SPL / 2; w *= 2)
#pragma unroll
    for (int k = 0; k + w < SPL / 2; k += 2 * w) pr[k] += pr[k + w];
  float acc = pr[0];
#pragma unroll
  for (int off = 1; off < G; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&o)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) o[s] = bsps::to_float(p[s]);
}

template <typename T, int DS, int G>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dskip,
                    const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ ddt,
                    float* __restrict__ hck, float* __restrict__ pbc, float* __restrict__ pa,
                    float* __restrict__ pd, int seq, int d_inner, int chunk, int n_chunks,
                    int n16) {
  constexpr int BD = kThreads / G;            // channels per block
  constexpr int SPL = DS / G;                 // states per lane
  constexpr int K = seg_len(SPL);             // most positions per segment
  constexpr int NG = BD / kGroup;             // dB/dC channel groups per tile
  static_assert(SPL >= 2 && BD % kGroup == 0, "lane group geometry");
  extern __shared__ __align__(16) unsigned char smem[];
  const int buf_elems = bwd_buffer_elems<T, DS>(BD, chunk);
  T* bufs = reinterpret_cast<T*>(smem);              // two stages, buf_elems apart
  T* dxs = bufs + 2 * buf_elems;                     // (chunk, BD): this segment's dx
  T* ddts = dxs + chunk * BD;                        // and dΔ
  // (kBatch, 2, BD, DS): each position's g_t Δ_t x_t and dy_t h_t terms
  float* red = reinterpret_cast<float*>(smem + bwd_red_offset<T, DS>(BD, chunk));
  const int row = blockIdx.y, c0 = blockIdx.x * BD;
  const int ch = threadIdx.x / G, lane_s = threadIdx.x % G;
  const int i = c0 + ch;
  const bool active = i < d_inner;
  const int valid_cols = d_inner - c0;
  const long long row_pos = (long long)row * seq;

  float a_s[SPL], a2[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    a_s[s] = active ? a[(long long)i * DS + lane_s * SPL + s] : 0.f;
    a2[s] = a_s[s] * kLog2e;                  // the forward's exponent
  }
  const float d_i = active ? dskip[i] : 0.f;
  // this lane's states in the checkpoint of segment ci (the state before it)
  auto ckpt = [&](int ci) {
    return hck + (((long long)row * n_chunks + ci) * d_inner + i) * DS + lane_s * SPL;
  };
  auto stage = [&](int ci, T* dst, bool reverse) {  // issue segment ci's copies; no wait
    const int t0 = ci * chunk, len = min(chunk, seq - t0);
    const long long p0 = (row_pos + t0) * d_inner + c0;
    stage_tile(dst, x + p0, d_inner, chunk, BD, len, valid_cols);
    stage_tile(dst + chunk * BD, dt + p0, d_inner, chunk, BD, len, valid_cols);
    const long long q0 = (row_pos + t0) * DS;
    stage_tile(dst + 3 * chunk * BD, bm + q0, DS, chunk, DS, len, DS);
    if (reverse) {
      stage_tile(dst + 2 * chunk * BD, dy + p0, d_inner, chunk, BD, len, valid_cols);
      stage_tile(dst + 3 * chunk * BD + chunk * DS, cm + q0, DS, chunk, DS, len, DS);
    }
    cp_async_commit();
  };

  // sweep 1: forward, the state before every segment but the first to the
  // tape (the last segment's end state is not needed)
  {
    float h[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) h[s] = 0.f;
    const int n_fwd = n_chunks - 1;
    if (n_fwd > 0) stage(0, bufs, false);
    for (int ci = 0; ci < n_fwd; ++ci) {
      if (ci + 1 < n_fwd) {
        stage(ci + 1, bufs + ((ci + 1) & 1) * buf_elems, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* xs = bufs + (ci & 1) * buf_elems;
      const T* dts = xs + chunk * BD;
      const T* bs = xs + 3 * chunk * BD;
      // only the last segment is ragged, and it is not walked here
#pragma unroll 4
      for (int t = 0; t < chunk; ++t) {
        const float x_t = bsps::to_float(xs[t * BD + ch]);
        const float dt_t = bsps::to_float(dts[t * BD + ch]);
        const float u = dt_t * x_t;
        float b_t[SPL];
        load_row(bs + t * DS + lane_s * SPL, b_t);
#pragma unroll
        for (int s = 0; s < SPL; ++s) h[s] = fmaf(ex2(dt_t * a2[s]), h[s], u * b_t[s]);
      }
      if (active) {
        float* p = ckpt(ci + 1);
#pragma unroll
        for (int s = 0; s < SPL; ++s) p[s] = h[s];
      }
      __syncthreads();                        // this stage is free for segment ci + 2
    }
  }

  // sweep 2: the segments in reverse
  float gn[SPL], da_acc[SPL];                 // e_{t+1} ⊙ g_{t+1}; Σ_t g Δ e h_{t-1}
#pragma unroll
  for (int s = 0; s < SPL; ++s) gn[s] = da_acc[s] = 0.f;
  float dd_acc = 0.f;
  // kBatch positions' terms summed over each group of kGroup channels in
  // channel order, to the partials (B, L, 2, n16, DS)
  auto flush = [&](long long pos0, int nb) {
    for (int o = threadIdx.x; o < nb * 2 * NG * DS; o += kThreads) {
      const int s = o % DS, grp = (o / DS) % NG, kind = (o / (DS * NG)) % 2;
      const int tt = o / (2 * NG * DS);
      const int gg = c0 / kGroup + grp;
      if (gg >= n16) continue;                // a group wholly past d_inner
      const float* src = red + ((tt * 2 + kind) * BD + grp * kGroup) * DS + s;
      float acc = src[0];
#pragma unroll
      for (int j = 1; j < kGroup; ++j) acc += src[j * DS];
      pbc[(((pos0 + tt) * 2 + kind) * n16 + gg) * DS + s] = acc;
    }
  };
  stage(n_chunks - 1, bufs + ((n_chunks - 1) & 1) * buf_elems, true);
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    if (ci > 0) {
      stage(ci - 1, bufs + ((ci - 1) & 1) * buf_elems, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xs = bufs + (ci & 1) * buf_elems;
    const T* dts = xs + chunk * BD;
    const T* dys = xs + 2 * chunk * BD;
    const T* bs = xs + 3 * chunk * BD;
    const T* cs = bs + chunk * DS;
    const int t0 = ci * chunk, len = min(chunk, seq - t0);
    // hs[0] the state before the segment, hs[t + 1] the state after position t
    float hs[K + 1][SPL];
    if (ci > 0 && active) {
      const float* p = ckpt(ci);
#pragma unroll
      for (int s = 0; s < SPL; ++s) hs[0][s] = p[s];
    } else {
#pragma unroll
      for (int s = 0; s < SPL; ++s) hs[0][s] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      if (t < len) {
        const float x_t = bsps::to_float(xs[t * BD + ch]);
        const float dt_t = bsps::to_float(dts[t * BD + ch]);
        const float u = dt_t * x_t;
        float b_t[SPL];
        load_row(bs + t * DS + lane_s * SPL, b_t);
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          hs[t + 1][s] = fmaf(ex2(dt_t * a2[s]), hs[t][s], u * b_t[s]);
      }
    }
#pragma unroll
    for (int t = K - 1; t >= 0; --t) {
      if (t < len) {
        const float x_t = bsps::to_float(xs[t * BD + ch]);
        const float dt_t = bsps::to_float(dts[t * BD + ch]);
        const float dy_t = bsps::to_float(dys[t * BD + ch]);
        const float u = dt_t * x_t;
        float b_t[SPL], c_t[SPL], g[SPL], geh[SPL];
        load_row(bs + t * DS + lane_s * SPL, b_t);
        load_row(cs + t * DS + lane_s * SPL, c_t);
        float* rb = red + ((t % kBatch) * 2 * BD + ch) * DS + lane_s * SPL;   // g Δ x
        float* rc = rb + BD * DS;                                             // dy h
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          g[s] = fmaf(c_t[s], dy_t, gn[s]);
          const float ge = g[s] * ex2(dt_t * a2[s]);
          geh[s] = ge * hs[t][s];
          da_acc[s] = fmaf(dt_t, geh[s], da_acc[s]);
          rb[s] = g[s] * u;
          rc[s] = dy_t * hs[t + 1][s];
          gn[s] = ge;
        }
        const float sgb = channel_dot<SPL, G>(g, b_t);
        const float sgah = channel_dot<SPL, G>(a_s, geh);
        if (lane_s == 0) {
          dxs[t * BD + ch] = bsps::from_float<T>(fmaf(dt_t, sgb, d_i * dy_t));
          ddts[t * BD + ch] = bsps::from_float<T>(fmaf(x_t, sgb, sgah));
          dd_acc = fmaf(dy_t, x_t, dd_acc);
        }
        if (t % kBatch == 0) {                // positions t .. t + kBatch - 1 are in
          __syncthreads();
          flush(row_pos + t0 + t, min(kBatch, len - t));
          __syncthreads();                    // red is free; dxs, ddts whole; the stage read
        }
      }
    }
    store_tile(dx + (row_pos + t0) * d_inner + c0, dxs, d_inner, BD, len, valid_cols);
    store_tile(ddt + (row_pos + t0) * d_inner + c0, ddts, d_inner, BD, len, valid_cols);
    // the next segment's first writes to dxs come after its __syncthreads
  }
  if (active) {
    float* p = pa + ((long long)row * d_inner + i) * DS + lane_s * SPL;
#pragma unroll
    for (int s = 0; s < SPL; ++s) p[s] = da_acc[s];
    if (lane_s == 0) pd[(long long)row * d_inner + i] = dd_acc;
  }
}

// dB, dC: each (row, position, state)'s channel-group partials summed in
// group order; dA, dD: the per-row partials summed in row order
template <typename T>
__global__ void ssm_scan_bwd_sum_kernel(const float* __restrict__ pbc,
                                        const float* __restrict__ pa,
                                        const float* __restrict__ pd, T* __restrict__ db,
                                        T* __restrict__ dc, float* __restrict__ da,
                                        float* __restrict__ dd, int rows, int seq, int d_inner,
                                        int ds, int n16) {
  const long long n_bc = (long long)rows * seq * 2 * ds, n_a = (long long)d_inner * ds;
  long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o < n_bc) {
    const long long rtk = o / ds;             // (row, position, kind)
    const int s = (int)(o % ds);
    const float* src = pbc + rtk * n16 * ds + s;
    float acc = src[0];
    for (int j = 1; j < n16; ++j) acc += src[(long long)j * ds];
    (rtk % 2 ? dc : db)[rtk / 2 * ds + s] = bsps::from_float<T>(acc);
    return;
  }
  o -= n_bc;
  if (o < n_a) {
    float acc = pa[o];
    for (int r = 1; r < rows; ++r) acc += pa[r * n_a + o];
    da[o] = acc;
    return;
  }
  o -= n_a;
  if (o < d_inner) {
    float acc = pd[o];
    for (int r = 1; r < rows; ++r) acc += pd[(long long)r * d_inner + o];
    dd[o] = acc;
  }
}

struct BwdArgs {
  const void *x, *dt, *b, *c;
  const float *a, *d;
  const void* dy;
  void *dx, *ddt, *db, *dc;
  float *da, *dd, *hck, *pbc, *pa, *pd;
  int seq, d_inner, chunk, n_chunks, n16;
};

template <typename T, int DS, int G>
cudaError_t launch_bwd(int device, int tiles, int rows, cudaStream_t stream, const BwdArgs& p) {
  constexpr int BD = kThreads / G;
  if (p.chunk > seg_len(DS / G)) return cudaErrorInvalidValue;
  const size_t smem = bwd_red_offset<T, DS>(BD, p.chunk) +
                      (size_t)kBatch * 2 * BD * DS * sizeof(float);
  cudaError_t err = bsps::prepare_smem(ssm_scan_bwd_kernel<T, DS, G>, device, smem);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<T, DS, G><<<dim3(tiles, rows, 1), kThreads, smem, stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.dt), static_cast<const T*>(p.b),
      static_cast<const T*>(p.c), p.a, p.d, static_cast<const T*>(p.dy), static_cast<T*>(p.dx),
      static_cast<T*>(p.ddt), p.hck, p.pbc, p.pa, p.pd, p.seq, p.d_inner, p.chunk, p.n_chunks,
      p.n16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)rows * p.seq * 2 * DS + (long long)p.d_inner * DS + p.d_inner;
  constexpr int kSumThreads = 256;
  ssm_scan_bwd_sum_kernel<T><<<(unsigned)((total + kSumThreads - 1) / kSumThreads), kSumThreads,
                               0, stream>>>(p.pbc, p.pa, p.pd, static_cast<T*>(p.db),
                                            static_cast<T*>(p.dc), p.da, p.dd, rows, p.seq,
                                            p.d_inner, DS, p.n16);
  return cudaGetLastError();
}

template <typename T, int DS>
cudaError_t bwd_by_group(int lanes, int device, int tiles, int rows, cudaStream_t stream,
                         const BwdArgs& p) {
  if (lanes == 2) return launch_bwd<T, DS, 2>(device, tiles, rows, stream, p);
  if (lanes == 4) return launch_bwd<T, DS, 4>(device, tiles, rows, stream, p);
  if constexpr (DS >= 16) {
    if (lanes == 8) return launch_bwd<T, DS, 8>(device, tiles, rows, stream, p);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_dispatch(int lanes, int device, int tiles, int rows, int d_state,
                         cudaStream_t stream, const BwdArgs& p) {
  if (d_state == 8) return bwd_by_group<T, 8>(lanes, device, tiles, rows, stream, p);
  if (d_state == 16) return bwd_by_group<T, 16>(lanes, device, tiles, rows, stream, p);
  return cudaErrorInvalidValue;
}

}  // namespace

// (dx, dΔ, dB, dC, dA, dD) of bsps_ssm_scan for dy. grid (channel tiles,
// batch rows, 1), loop = segments per row (both sweeps walk them); x, Δ, dy,
// dx, dΔ (B, seq, d_inner) and B, C, dB, dC (B, seq, d_state) contiguous in
// `dtype`; A, dA (d_inner, d_state) and D, dD (d_inner,) fp32. `chunk`
// positions a segment (at most 8 at 8 states a lane, else 16). fp32 work
// buffers, none read before this launch writes it: hck the checkpoint tape
// (B, loop, d_inner, d_state); pbc the dB/dC partials (B, seq, 2, n_groups,
// d_state), `group` channels a partial; pa (B, d_inner, d_state) and pd
// (B, d_inner) the per-row dA and dD. The caller allocates them: `group`
// must be kGroup and n_groups ceil(d_inner / kGroup), or nothing runs.
// `scratch_bytes` is the plan's per-tile h and g, 2 × block_d × d_state
// fp32, which the kernel keeps in registers.
BSPS_EXPORT int bsps_ssm_scan_bwd(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                                  void* stream, const void* x, const void* dt, const void* b,
                                  const void* c, const float* a, const float* d, const void* dy,
                                  void* dx, void* ddt, void* db, void* dc, float* da, float* dd,
                                  float* hck, float* pbc, float* pa, float* pd, int seq,
                                  int d_inner, int d_state, int chunk, int block_d, int n_groups,
                                  int group, int dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((block_d != 16 && block_d != 32 && block_d != 64) || gz != 1 || gy < 1 || seq < 1 ||
      d_inner < 1 || chunk < 1 || gx != (d_inner + block_d - 1) / block_d ||
      loop != (seq + chunk - 1) / chunk || group != kGroup ||
      n_groups != (d_inner + kGroup - 1) / kGroup ||
      scratch_bytes != 2 * block_d * d_state * (int)sizeof(float))
    return cudaErrorInvalidValue;
  const int lanes = kThreads / block_d;
  if (2 * lanes > d_state) return cudaErrorInvalidValue;
  const BwdArgs p{x,  dt, b,  c,   a,   d,   dy,  dx,  ddt,     db,      dc,
                  da, dd, hck, pbc, pa, pd, seq, d_inner, chunk, loop, n_groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kFloat32) return bwd_dispatch<float>(lanes, device, gx, gy, d_state, s, p);
  if (dtype == bsps::kBFloat16)
    return bwd_dispatch<__nv_bfloat16>(lanes, device, gx, gy, d_state, s, p);
  return cudaErrorInvalidValue;
}

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
//
// Under autograd the forward also writes the backward's checkpoint tape:
// the state after every kSeg positions but the last, (B, ceil(L / kSeg) - 1,
// d_inner, d_state) fp32, each lane storing its states where a segment
// ends. That instantiation (kTape) adds only those stores to the walk, so
// y is the same bits with and without the tape; serving passes no tape and
// runs the instantiation without them.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStage = 64;   // positions per stage (the wrapper's STAGE_BYTES / 2)
constexpr int kSeg = 8;         // positions per checkpoint segment (the wrapper's SEGMENT)
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
template <typename T, int NT = kThreads>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, int rows,
                                           int cols, int valid_rows, int valid_cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int v = threadIdx.x; v < rows * per_row; v += NT) {
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
// and the stores: N consecutive floats, shared or device memory
template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}
template <typename T, int DS>
__host__ __device__ constexpr int buffer_elems(int bd, int stage) {
  // x, Δ (stage × bd) and B, C (stage × DS), each piece 16-byte aligned
  return ((2 * stage * bd + 2 * stage * DS) * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
}

template <typename T, int DS, int G, bool kTape>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                T* __restrict__ y, float* __restrict__ tape, int seq, int d_inner, int chunk,
                int n_chunks) {
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
    // the tape: the local position that ends the chunk's first segment
    int seg_end = kSeg - 1 - t0 % kSeg;
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
      if constexpr (kTape) {
        if (t == seg_end) {                   // h is the state before segment k
          const int k = (t0 + t + 1) / kSeg;
          if (active && t0 + t + 1 < seq)
            store_floats(tape + (((long long)row * ((seq - 1) / kSeg) + k - 1) * d_inner + i) * DS +
                             lane_s * SPL, h);
          seg_end += kSeg;
        }
      }
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

struct FwdArgs {
  const void *x, *dt, *b, *c;
  const float *a, *d;
  void* y;
  float* tape;
  int seq, d_inner, chunk, n_chunks;
};

template <typename T, int DS, int G, bool kTape>
cudaError_t launch(int device, int tiles, int rows, cudaStream_t stream, const FwdArgs& p) {
  constexpr int BD = kThreads / G;
  const size_t wide = std::is_same<T, float>::value ? 0 : 2 * (size_t)p.chunk * DS * sizeof(float);
  const size_t smem = (2 * (size_t)buffer_elems<T, DS>(BD, p.chunk) + ((size_t)p.chunk * BD + 7) / 8 * 8) *
                          sizeof(T) + wide;
  cudaError_t err = bsps::prepare_smem(ssm_scan_kernel<T, DS, G, kTape>, device, smem);
  if (err != cudaSuccess) return err;
  ssm_scan_kernel<T, DS, G, kTape><<<dim3(tiles, rows, 1), kThreads, smem, stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.dt), static_cast<const T*>(p.b),
      static_cast<const T*>(p.c), p.a, p.d, static_cast<T*>(p.y), p.tape, p.seq, p.d_inner, p.chunk,
      p.n_chunks);
  return cudaGetLastError();
}

template <typename T, int DS, int G>
cudaError_t with_tape(int device, int tiles, int rows, cudaStream_t stream, const FwdArgs& p) {
  return p.tape ? launch<T, DS, G, true>(device, tiles, rows, stream, p)
                : launch<T, DS, G, false>(device, tiles, rows, stream, p);
}

template <typename T, int DS>
cudaError_t by_group(int lanes, int device, int tiles, int rows, cudaStream_t stream,
                     const FwdArgs& p) {
  if (lanes == 2) return with_tape<T, DS, 2>(device, tiles, rows, stream, p);
  if (lanes == 4) return with_tape<T, DS, 4>(device, tiles, rows, stream, p);
  if constexpr (DS >= 16) {
    if (lanes == 8) return with_tape<T, DS, 8>(device, tiles, rows, stream, p);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int lanes, int device, int tiles, int rows, int d_state, cudaStream_t stream,
                     const FwdArgs& p) {
  if (d_state == 8) return by_group<T, 8>(lanes, device, tiles, rows, stream, p);
  if (d_state == 16) return by_group<T, 16>(lanes, device, tiles, rows, stream, p);
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
// `seg` 0 and a null `tape`: y alone. `seg` kSeg: `tape` (B, ceil(seq /
// kSeg) - 1, d_inner, d_state) fp32 gets the state after every kSeg
// positions but the last (null only where that is no state at all).
BSPS_EXPORT int bsps_ssm_scan(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                              void* stream, const void* x, const void* dt, const void* b,
                              const void* c, const float* a, const float* d, void* y,
                              float* tape, int seq, int d_inner, int d_state, int chunk,
                              int block_d, int seg, int dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((block_d != 16 && block_d != 32 && block_d != 64) || gz != 1 || gy < 1 || seq < 1 ||
      d_inner < 1 || chunk < 1 || chunk > kMaxStage || gx != (d_inner + block_d - 1) / block_d ||
      loop != (seq + chunk - 1) / chunk || scratch_bytes != block_d * d_state * (int)sizeof(float) ||
      (seg != 0 && seg != kSeg) || (seg == 0 && tape) || (seg == kSeg && !tape && seq > kSeg))
    return cudaErrorInvalidValue;
  const int lanes = kThreads / block_d;
  if (2 * lanes > d_state) return cudaErrorInvalidValue;
  const FwdArgs p{x, dt, b, c, a, d, y, seq > kSeg ? tape : nullptr, seq, d_inner, chunk, loop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kFloat32) return dispatch<float>(lanes, device, gx, gy, d_state, s, p);
  if (dtype == bsps::kBFloat16) return dispatch<__nv_bfloat16>(lanes, device, gx, gy, d_state, s, p);
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
// about 18 fp32 operations per (position, channel, state), each input read
// and each output written once (chip_smoke.py's _scan_bwd_bound). This
// design does that exponential and about 30 instructions (the segment's
// recompute, the reverse step, the sums over states and over channels),
// and moves the forward's checkpoint tape and one dB/dC partial per BD
// channels besides. It is bound by instruction throughput: at two blocks
// an SM the registers leave little room to run positions ahead of their
// loads.
//
// Design. The recurrence is not run backwards: h_{t-1} = (h_t - Δ_t B_t
// x_t) / e_t divides by decays down to exp(-16Δ) and loses the state. The
// forward writes the state before every segment of kSeg positions to a
// tape (bsps_ssm_scan with a tape); the backward walks the segments in
// reverse, recomputes a segment's states and decays from its checkpoint
// into registers (the forward's arithmetic, so the forward's bits) and
// steps g back through them.
// - dB and dC are summed over the block's channels on chip, in an order
//   fixed by channel index, with no atomics: a butterfly of shuffles over
//   the warp's channels leaves each lane one (kind, state)'s sum, which goes
//   to a block buffer by (position, warp); at the next stage's first
//   barrier the block sums those over its warps in warp order and writes
//   one partial per (row, position, kind, tile of BD channels, state),
//   (B, L, 2, ceil(d_inner / BD), d_state) fp32: 16.8 MB at jamba's train
//   shape where 16-channel partials took 67 MB. A second kernel sums the
//   tiles' partials in a fixed order (four interleaved runs in tile order,
//   then a tree over the four). Shared-memory transposes summed the warp's
//   channels too, and were the slower on the H100 (PERF.md).
// - One exponential per (position, channel, state): the reverse step takes
//   e_t from the recompute's registers.
// - The sums over states (Σ_s g B for dx, Σ_s A g e h for dΔ) leave the
//   walk too: each lane writes its share to shared memory, and the stage's
//   drain sums each (position, channel)'s shares as a tree over its lanes
//   and writes dx and dΔ, coalesced. Per-position shuffles did the same
//   and were the slower on the H100 (PERF.md).
// - No forward sweep: the tape comes from the forward, and each stage's
//   cp.async brings the checkpoints of its segments beside its streams.
// - A geometry of its own: 256-thread blocks, kSpl = 4 states a lane, so
//   G = d_state / 4 lanes a channel and BD = 64 channels a block at
//   d_state 16 (128 at 8); grid (channel tiles, batch rows). A segment of
//   kSeg = 8 positions keeps its 9 states and 8 decays in 68 registers, and
//   the kernel fits 128 a thread with no spills: two blocks (16 warps) an
//   SM at d_state 16, so jamba's 512 blocks fill 1.94 waves (one block an
//   SM at d_state 8). One grouping: every batch size takes the same tiles
//   and orders.
// - Stages of kStage = 16 positions (two segments), double buffered; bf16
//   B_t and C_t widened to fp32 once per block and stage. Two block
//   barriers a stage: where it lands, and after the widening and the
//   previous stage's drain. A segment past the sequence's end walks the
//   stage's zeros, so every position runs unguarded.
// - dA sums over positions in one thread, last position first, dD in a
//   fixed order over the drain's threads; the per-row partials are summed
//   in row order by the second kernel.
// So the gradients are the same bits for every batch size and run.

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSpl = 4;                      // states a lane
constexpr int kStage = 16;                   // positions a stage (the wrapper's BWD_STAGE)
constexpr int kSegs = kStage / kSeg;         // segments a stage
constexpr int kSumSplit = 4;                 // lanes an output of the dB/dC tile sum
static_assert(kStage % kSeg == 0, "whole segments a stage");

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// the backward's geometry and shared-memory layout at d_state DS, streams T
template <typename T, int DS>
struct Bwd {
  static constexpr int G = DS / kSpl;              // lanes a channel
  static constexpr int BD = kBwdThreads / G;       // channels a block
  static_assert(G >= 2 && 2 * kSpl <= 32 / G, "a lane's 2 × kSpl terms scatter over the warp");
  // blocks an SM the registers are held to: two (128 registers a thread)
  // at d_state 16; at 8 a block's 128 channels take more, and one block an
  // SM keeps them out of local memory
  static constexpr int kBlocksPerSM = DS >= 16 ? 2 : 1;
  // a stage: x, Δ, dy (kStage × BD) and B, C (kStage × DS) in T, then the
  // checkpoints of its segments (kSegs × BD × DS fp32)
  static constexpr int kStreamBytes = align16(kStage * BD * (int)sizeof(T));
  static constexpr int kTapeOff = 3 * kStreamBytes + align16(2 * kStage * DS * (int)sizeof(T));
  static constexpr int kStageBytes = kTapeOff + kSegs * BD * DS * 4;
  // after the two stages: B, C widened (bf16); the lanes' shares of the
  // sums over states, (Σ g B, Σ A g e h) by (position, channel, lane); the
  // block buffer of the warps' dB/dC sums (kStage, warps, 2, DS); dD's
  // shares by thread
  static constexpr int kWideOff = 2 * kStageBytes;
  static constexpr int kSpOff = kWideOff + (std::is_same<T, float>::value ? 0 : 2 * kStage * DS * 4);
  static constexpr int kXwOff = kSpOff + kStage * BD * G * 2 * 4;
  static constexpr int kDdOff = kXwOff + kStage * kBwdWarps * 2 * DS * 4;
  static constexpr int kSmem = kDdOff + kBwdThreads * 4;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// a lane's share of Σ_s p_s q_s over a channel's states, in the forward's
// C_t·h_t order: its state pairs fused, then a balanced tree over the pairs
// (the group's shares are then summed as a balanced tree over its lanes)
template <int SPL>
__device__ __forceinline__ float lane_dot(const float (&p)[SPL], const float (&q)[SPL]) {
  float pr[SPL / 2];
#pragma unroll
  for (int k = 0; k < SPL / 2; ++k) pr[k] = fmaf(p[2 * k], q[2 * k], p[2 * k + 1] * q[2 * k + 1]);
#pragma unroll
  for (int w = 1; w < SPL / 2; w *= 2)
#pragma unroll
    for (int k = 0; k + w < SPL / 2; k += 2 * w) pr[k] += pr[k + w];
  return pr[0];
}

template <typename T, int DS>
__global__ void __launch_bounds__(kBwdThreads, Bwd<T, DS>::kBlocksPerSM)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dskip,
                    const T* __restrict__ dy, const float* __restrict__ tape,
                    T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ pbc,
                    float* __restrict__ pa, float* __restrict__ pd, int seq, int d_inner,
                    int n_stages) {
  using L = Bwd<T, DS>;
  constexpr int G = L::G, BD = L::BD, SPL = kSpl;
  constexpr bool kWide = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* sp = reinterpret_cast<float*>(smem + L::kSpOff);
  float* xw = reinterpret_cast<float*>(smem + L::kXwOff);
  const int row = blockIdx.y, tile = blockIdx.x, n_tiles = gridDim.x, c0 = tile * BD;
  const int ch = tid / G, ls = tid % G;
  const int i = c0 + ch;
  const bool active = i < d_inner;
  const int valid_cols = min(BD, d_inner - c0);
  const long long row_pos = (long long)row * seq;
  const int n_seg = (seq + kSeg - 1) / kSeg;

  float a_s[SPL], a2[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    a_s[s] = active ? a[(long long)i * DS + ls * SPL + s] : 0.f;
    a2[s] = a_s[s] * kLog2e;                  // the forward's exponent
  }
  // the channel whose dx, dΔ and dD this thread finishes (the drain's)
  const int fc = tid % BD;
  const float d_f = fc < valid_cols ? dskip[c0 + fc] : 0.f;
  float dd_f = 0.f;                           // Σ dy x over the thread's positions

  auto stage_at = [&](int st) { return smem + (st & 1) * L::kStageBytes; };
  auto stage_in = [&](int st) {               // start stage st's copies; no wait
    unsigned char* buf = stage_at(st);
    const int t0 = st * kStage, len = min(kStage, seq - t0);
    const long long p0 = (row_pos + t0) * d_inner + c0;
    stage_tile<T, kBwdThreads>(reinterpret_cast<T*>(buf), x + p0, d_inner, kStage, BD, len,
                               valid_cols);
    stage_tile<T, kBwdThreads>(reinterpret_cast<T*>(buf + L::kStreamBytes), dt + p0, d_inner,
                               kStage, BD, len, valid_cols);
    stage_tile<T, kBwdThreads>(reinterpret_cast<T*>(buf + 2 * L::kStreamBytes), dy + p0, d_inner,
                               kStage, BD, len, valid_cols);
    T* bc = reinterpret_cast<T*>(buf + 3 * L::kStreamBytes);
    const long long q0 = (row_pos + t0) * DS;
    stage_tile<T, kBwdThreads>(bc, bm + q0, DS, kStage, DS, len, DS);
    stage_tile<T, kBwdThreads>(bc + kStage * DS, cm + q0, DS, kStage, DS, len, DS);
    float* tp = reinterpret_cast<float*>(buf + L::kTapeOff);
#pragma unroll
    for (int j = 0; j < kSegs; ++j) {         // the state before each segment but the first
      const int seg = st * kSegs + j;
      if (seg >= 1 && seg < n_seg)
        stage_tile<float, kBwdThreads>(
            tp + j * BD * DS, tape + (((long long)row * (n_seg - 1) + seg - 1) * d_inner + c0) * DS,
            DS, BD, DS, valid_cols, DS);
    }
    cp_async_commit();
  };
  // stage st's dB/dC terms summed over the block's warps in warp order to
  // the partials; then each (position, channel)'s sums over states from
  // its lanes' shares, and dx, dΔ
  auto drain = [&](int st) {
    constexpr int QP = DS / 2;                // quads a position: 2 kinds x DS / 4
    const int t0 = st * kStage, len = min(kStage, seq - t0);
    const unsigned char* buf = stage_at(st);
    const T* xs = reinterpret_cast<const T*>(buf);
    const T* dts = reinterpret_cast<const T*>(buf + L::kStreamBytes);
    const T* dys = reinterpret_cast<const T*>(buf + 2 * L::kStreamBytes);
    for (int o = tid; o < len * QP; o += kBwdThreads) {
      const int t = o / QP, kind = (o % QP) / (DS / 4), s4 = o % (DS / 4);
      const float* src = xw + t * kBwdWarps * 2 * DS + kind * DS + 4 * s4;
      float4 acc = ld4(src);
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) acc = add4(acc, ld4(src + w * 2 * DS));
      st4(pbc + (((row_pos + t0 + t) * 2 + kind) * n_tiles + tile) * DS + 4 * s4, acc);
    }
    for (int t = tid / BD; t < len; t += kBwdThreads / BD) {
      const float* sh = sp + (t * BD + fc) * G * 2;
      float sgb[G], sgah[G];
#pragma unroll
      for (int l = 0; l < G; ++l) sgb[l] = sh[2 * l], sgah[l] = sh[2 * l + 1];
#pragma unroll
      for (int w = 1; w < G; w *= 2)          // a balanced tree over the lanes
#pragma unroll
        for (int l = 0; l + w < G; l += 2 * w) sgb[l] += sgb[l + w], sgah[l] += sgah[l + w];
      const float x_t = bsps::to_float(xs[t * BD + fc]);
      const float dt_t = bsps::to_float(dts[t * BD + fc]);
      const float dy_t = bsps::to_float(dys[t * BD + fc]);
      dd_f = fmaf(dy_t, x_t, dd_f);
      if (fc < valid_cols) {
        const long long o = (row_pos + t0 + t) * d_inner + c0 + fc;
        dx[o] = bsps::from_float<T>(fmaf(dt_t, sgb[0], d_f * dy_t));
        ddt[o] = bsps::from_float<T>(fmaf(x_t, sgb[0], sgah[0]));
      }
    }
  };
  // the lane's 2 × SPL dB/dC terms summed over the warp's channels, to the
  // block buffer at stage position p: a butterfly over the lane bits that
  // number the channel, highest first; each round keeps half the values and
  // adds the partner lane's copy of that half, so each lane ends with one
  // (kind, state)'s sum (where the warp has more channels than 2 × SPL, the
  // last rounds add whole sums, and two lanes hold each). A fixed tree in
  // channel index.
  auto scatter = [&](const float (&tb)[SPL], const float (&tc)[SPL], int p) {
    float v[2 * SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = tb[s], v[SPL + s] = tc[s];
    int idx = 0, dup = 0;
#pragma unroll
    for (int r = 0; (16 >> r) >= G; ++r) {
      const int m = 16 >> r, nh = (2 * SPL >> r) / 2;
      const bool hi = lane & m;
      if (nh >= 1) {
#pragma unroll
        for (int j = 0; j < nh; ++j) {
          const float keep = hi ? v[j + nh] : v[j], send = hi ? v[j] : v[j + nh];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
        idx = 2 * idx + (hi ? 1 : 0);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
        dup |= m;
      }
    }
    if ((lane & dup) == 0)
      xw[(p * kBwdWarps + warp) * 2 * DS + (idx / SPL) * DS + ls * SPL + idx % SPL] = v[0];
  };
  float gn[SPL], da_acc[SPL];                 // e_{t+1} ⊙ g_{t+1}; Σ_t g Δ e h_{t-1}
#pragma unroll
  for (int s = 0; s < SPL; ++s) gn[s] = da_acc[s] = 0.f;
  stage_in(n_stages - 1);
  for (int st = n_stages - 1; st >= 0; --st) {
    cp_async_wait<0>();
    __syncthreads();                          // stage st landed; stage st + 1's terms whole
    const unsigned char* buf = stage_at(st);
    const T* xs = reinterpret_cast<const T*>(buf);
    const T* dts = reinterpret_cast<const T*>(buf + L::kStreamBytes);
    const T* dys = reinterpret_cast<const T*>(buf + 2 * L::kStreamBytes);
    const float* bs;                          // B_t (kStage × DS) fp32, then C_t
    if constexpr (kWide) {
      bs = reinterpret_cast<const float*>(buf + 3 * L::kStreamBytes);
    } else {
      const T* raw = reinterpret_cast<const T*>(buf + 3 * L::kStreamBytes);
      float* wide = reinterpret_cast<float*>(smem + L::kWideOff);
      for (int e = tid; e < 2 * kStage * DS; e += kBwdThreads) wide[e] = bsps::to_float(raw[e]);
      bs = wide;
    }
    const float* cs = bs + kStage * DS;
    if (st + 1 < n_stages) drain(st + 1);
    __syncthreads();                          // B_t, C_t wide; stage st + 1 drained
    if (st > 0) stage_in(st - 1);             // into stage st + 1's buffer, read by now
    const float* tp = reinterpret_cast<const float*>(buf + L::kTapeOff);
    const int len_st = min(kStage, seq - st * kStage);
#pragma unroll 1
    for (int j = (len_st - 1) / kSeg; j >= 0; --j) {   // the stage's segments, last first
      // a segment past the sequence's end walks zeros (the stage is zero
      // filled there): the states carry over unchanged and g stays 0, so the
      // real positions get the same bits as with a shorter walk
      const int lt0 = j * kSeg;
      // hs[0] the state before the segment, hs[t + 1] after position t; es[t] = e_t
      float hs[kSeg + 1][SPL], es[kSeg][SPL];
      if (st * kSegs + j > 0) {
        load_floats(tp + (j * BD + ch) * DS + ls * SPL, hs[0]);
      } else {
#pragma unroll
        for (int s = 0; s < SPL; ++s) hs[0][s] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        const int p = lt0 + t;
        const float x_t = bsps::to_float(xs[p * BD + ch]);
        const float dt_t = bsps::to_float(dts[p * BD + ch]);
        const float u = dt_t * x_t;
        float b_t[SPL];
        load_floats(bs + p * DS + ls * SPL, b_t);
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          es[t][s] = ex2(dt_t * a2[s]);
          hs[t + 1][s] = fmaf(es[t][s], hs[t][s], u * b_t[s]);
        }
      }
#pragma unroll
      for (int t = kSeg - 1; t >= 0; --t) {
        const int p = lt0 + t;
        const float x_t = bsps::to_float(xs[p * BD + ch]);
        const float dt_t = bsps::to_float(dts[p * BD + ch]);
        const float dy_t = bsps::to_float(dys[p * BD + ch]);
        const float u = dt_t * x_t;
        float b_t[SPL], c_t[SPL], g[SPL], geh[SPL];
        load_floats(bs + p * DS + ls * SPL, b_t);
        load_floats(cs + p * DS + ls * SPL, c_t);
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          g[s] = fmaf(c_t[s], dy_t, gn[s]);
          gn[s] = g[s] * es[t][s];
          geh[s] = gn[s] * hs[t][s];
          da_acc[s] = fmaf(dt_t, geh[s], da_acc[s]);
        }
        *reinterpret_cast<float2*>(sp + ((p * BD + ch) * G + ls) * 2) =
            make_float2(lane_dot(g, b_t), lane_dot(a_s, geh));
        // the dB and dC terms after the shares, so that b_t and geh are dead
        // by then: the walk stays within 128 registers
        float tb[SPL], tc[SPL];
#pragma unroll
        for (int s = 0; s < SPL; ++s) tb[s] = g[s] * u, tc[s] = dy_t * hs[t + 1][s];
        scatter(tb, tc, p);
      }
    }
  }
  __syncthreads();
  drain(0);
  if (active) store_floats(pa + ((long long)row * d_inner + i) * DS + ls * SPL, da_acc);
  // dD: each channel's shares over its threads, in thread order
  float* dd_sh = reinterpret_cast<float*>(smem + L::kDdOff);
  dd_sh[tid] = dd_f;
  __syncthreads();
  if (tid < valid_cols) {
    float acc = dd_sh[tid];
#pragma unroll
    for (int k = 1; k < kBwdThreads / BD; ++k) acc += dd_sh[k * BD + tid];
    pd[(long long)row * d_inner + c0 + tid] = acc;
  }
}

// dB, dC: each (row, position, kind, state)'s tile partials summed in a
// fixed order, kSumSplit runs over the tiles in tile order (run k: tiles
// k, k + kSumSplit, ...) then a tree over the runs; dA, dD: the per-row
// partials summed in row order
template <typename T>
__global__ void ssm_scan_bwd_sum_kernel(const float* __restrict__ pbc,
                                        const float* __restrict__ pa,
                                        const float* __restrict__ pd, T* __restrict__ db,
                                        T* __restrict__ dc, float* __restrict__ da,
                                        float* __restrict__ dd, int rows, int seq, int d_inner,
                                        int ds, int n_tiles) {
  static_assert(kSumSplit == 4, "a warp: 8 outputs x 4 runs");
  // a multiple of 16 outputs (ds 8 or 16), so whole warps take the first branch
  const long long n_bc = (long long)rows * seq * 2 * ds, n_a = (long long)d_inner * ds;
  long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o < n_bc * kSumSplit) {
    const int lane = threadIdx.x % 32, k = lane / 8;
    const long long out = o / 32 * 8 + lane % 8;
    const long long rtk = out / ds;           // (row, position, kind)
    const int s = (int)(out % ds);
    const float* src = pbc + rtk * n_tiles * ds + s;
    float acc = 0.f;
    for (int j = k; j < n_tiles; j += kSumSplit) acc += src[(long long)j * ds];
    acc += __shfl_xor_sync(0xffffffffu, acc, 8);    // runs 0 + 1 and 2 + 3
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);   // then the two
    if (k == 0) (rtk % 2 ? dc : db)[rtk / 2 * ds + s] = bsps::from_float<T>(acc);
    return;
  }
  o -= n_bc * kSumSplit;
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
  const float* tape;
  void *dx, *ddt, *db, *dc;
  float *da, *dd, *pbc, *pa, *pd;
  int seq, d_inner, n_stages;
};

// the kernel's shared memory, with all of the SM's to the carveout: two
// blocks an SM
template <typename T, int DS>
cudaError_t prepare_bwd(int device) {
  cudaError_t err = bsps::prepare_smem(ssm_scan_bwd_kernel<T, DS>, device, Bwd<T, DS>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssm_scan_bwd_kernel<T, DS>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int DS>
cudaError_t launch_bwd(int device, int tiles, int rows, cudaStream_t stream, const BwdArgs& p) {
  constexpr size_t smem = Bwd<T, DS>::kSmem;
  cudaError_t err = prepare_bwd<T, DS>(device);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<T, DS><<<dim3(tiles, rows, 1), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.dt), static_cast<const T*>(p.b),
      static_cast<const T*>(p.c), p.a, p.d, static_cast<const T*>(p.dy), p.tape,
      static_cast<T*>(p.dx), static_cast<T*>(p.ddt), p.pbc, p.pa, p.pd, p.seq, p.d_inner,
      p.n_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)rows * p.seq * 2 * DS * kSumSplit +
                          (long long)p.d_inner * DS + p.d_inner;
  constexpr int kSumThreads = 256;
  ssm_scan_bwd_sum_kernel<T><<<(unsigned)((total + kSumThreads - 1) / kSumThreads), kSumThreads,
                               0, stream>>>(p.pbc, p.pa, p.pd, static_cast<T*>(p.db),
                                            static_cast<T*>(p.dc), p.da, p.dd, rows, p.seq,
                                            p.d_inner, DS, tiles);
  return cudaGetLastError();
}

// registers a thread, spilled (local) bytes a thread, shared memory a block
// and resident blocks an SM
template <typename T, int DS>
cudaError_t bwd_attrs(int device, int* out) {
  cudaError_t err = prepare_bwd<T, DS>(device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ssm_scan_bwd_kernel<T, DS>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssm_scan_bwd_kernel<T, DS>,
                                                      kBwdThreads, Bwd<T, DS>::kSmem);
  out[0] = fa.numRegs, out[1] = (int)fa.localSizeBytes, out[2] = Bwd<T, DS>::kSmem, out[3] = blocks;
  return err;
}

template <typename T>
cudaError_t bwd_dispatch(int device, int tiles, int rows, int d_state, cudaStream_t stream,
                         const BwdArgs& p) {
  if (d_state == 8) return launch_bwd<T, 8>(device, tiles, rows, stream, p);
  if (d_state == 16) return launch_bwd<T, 16>(device, tiles, rows, stream, p);
  return cudaErrorInvalidValue;
}

}  // namespace

// (dx, dΔ, dB, dC, dA, dD) of bsps_ssm_scan for dy. grid (channel tiles,
// batch rows, 1), loop = stages per row (kStage positions each); x, Δ, dy,
// dx, dΔ (B, seq, d_inner) and B, C, dB, dC (B, seq, d_state) contiguous in
// `dtype`; A, dA (d_inner, d_state) and D, dD (d_inner,) fp32. `tape` the
// forward's checkpoints (B, ceil(seq / seg) - 1, d_inner, d_state) fp32
// (null only where that is empty). `block_d` must be 256 / (d_state / 4),
// `stage` kStage, `seg` kSeg. fp32 work buffers, none read before this
// launch writes it: pbc the dB/dC partials (B, seq, 2, n_tiles, d_state),
// one per tile of block_d channels; pa (B, d_inner, d_state) and pd (B,
// d_inner) the per-row dA and dD. The caller allocates them: `n_tiles`
// must be gx, or nothing runs. `scratch_bytes` is the plan's per-tile h and
// g, 2 × block_d × d_state fp32, which the kernel keeps in registers.
BSPS_EXPORT int bsps_ssm_scan_bwd(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                                  void* stream, const void* x, const void* dt, const void* b,
                                  const void* c, const float* a, const float* d, const void* dy,
                                  const float* tape, void* dx, void* ddt, void* db, void* dc,
                                  float* da, float* dd, float* pbc, float* pa, float* pd, int seq,
                                  int d_inner, int d_state, int stage, int block_d, int seg,
                                  int n_tiles, int dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((d_state != 8 && d_state != 16) || block_d != kBwdThreads / (d_state / kSpl) ||
      stage != kStage || seg != kSeg || gz != 1 || gy < 1 || seq < 1 || d_inner < 1 ||
      gx != (d_inner + block_d - 1) / block_d || n_tiles != gx || loop != (seq + stage - 1) / stage ||
      scratch_bytes != 2 * block_d * d_state * (int)sizeof(float) || (!tape && seq > kSeg))
    return cudaErrorInvalidValue;
  const BwdArgs p{x, dt, b, c, a, d, dy, tape, dx, ddt, db, dc, da, dd, pbc, pa, pd,
                  seq, d_inner, loop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kFloat32) return bwd_dispatch<float>(device, gx, gy, d_state, s, p);
  if (dtype == bsps::kBFloat16) return bwd_dispatch<__nv_bfloat16>(device, gx, gy, d_state, s, p);
  return cudaErrorInvalidValue;
}

// The backward kernel at d_state and dtype on `device`, as the CUDA
// runtime reports it: out[0] registers a thread, out[1] spilled bytes a
// thread, out[2] shared memory a block, out[3] resident blocks an SM.
BSPS_EXPORT int bsps_ssm_scan_bwd_attrs(int device, int d_state, int dtype, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == bsps::kFloat32 && d_state == 8) return bwd_attrs<float, 8>(device, out);
  if (dtype == bsps::kFloat32 && d_state == 16) return bwd_attrs<float, 16>(device, out);
  if (dtype == bsps::kBFloat16 && d_state == 8) return bwd_attrs<__nv_bfloat16, 8>(device, out);
  if (dtype == bsps::kBFloat16 && d_state == 16) return bwd_attrs<__nv_bfloat16, 16>(device, out);
  return cudaErrorInvalidValue;
}

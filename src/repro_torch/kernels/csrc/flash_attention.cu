// Streaming (flash) attention forward as a BSPS program, on Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py:40 (_attn_kernel), the
// Pallas kernel over grid (batch, q_heads, q_blocks, kv_blocks) whose online
// softmax state (m, l, acc) is carried across the sequential KV axis in VMEM
// scratch, skipping KV blocks above the causal diagonal.
//
// Bound on this card: at the prefill shapes of the slice (sequence 256,
// head dim 64) operations — 4·D FLOPs per (query, key) pair against 2·D
// bytes read per key and query once — and, this first version computing in
// fp32 on the CUDA cores rather than the tensor cores, the fp32 FMA rate.
//
// Design: one block per (b, h, q-block) — the plan's three "parallel" axes
// are the CUDA grid — and the KV stream is a loop inside the block, up to
// the diagonal under causal masking (the pseudo-streaming skip). Q for the
// block and one K/V token at a time sit in shared memory, converted to fp32
// on load, rows padded by one word so the score loop reads without bank
// conflicts. Two threads own one query row: each computes half of the row's
// 64 scores, the pair exchange row max and row sum by shuffles, and each
// keeps half of the row's output accumulator in registers. The online
// softmax is the TPU kernel's, in fp32: masked scores and the initial max are
// -1e30, l is clamped at 1e-30 before the final division. q-head h reads
// kv-head h / (Hq / Hkv) (GQA), queries sit at the end of the keys
// (q_offset = Skv - Sq). The normalised output is staged in the plan's
// scratch accumulator tile and written out coalesced. Head dims 64 and 128.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int hq, int hkv, int sq, int skv, int q_offset, int causal,
          float scale, int n_kv,
          long long qsb, long long qsh, long long qss,
          long long ksb, long long ksh, long long kss,
          long long vsb, long long vsh, long long vss,
          long long osb, long long osh, long long oss) {
  constexpr int P = D + 1;       // padded row stride of the fp32 tiles
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  // plan scratch: m (BQ), l (BQ), acc (BQ × D), fp32
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + BQ;
  float* acc_s = l_s + BQ;
  // staged tokens: Q block, one K and one V block
  float* q_s = acc_s + BQ * D;
  float* k_s = q_s + BQ * P;
  float* v_s = k_s + BKV * P;

  const int tid = threadIdx.x, lane = tid & 31;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const T* qh = q + b * qsb + h * qsh;
  const T* kh = k + b * ksb + hk * ksh;
  const T* vh = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = qi * BQ + r;
    q_s[r * P + c] = row < sq ? bsps::to_float(qh[row * qss + c]) : 0.f;
  }

  const int r = tid >> 1, half = tid & 1;
  const int q_pos = qi * BQ + r + q_offset;
  float m_run = bsps::kNegInf, l_run = 0.f;
  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;

  // the last KV block the causal skip keeps (whole blocks above the diagonal
  // are never read)
  int last = n_kv - 1;
  if (causal) {
    const int lim = qi * BQ + q_offset + BQ - 1;
    last = lim < 0 ? -1 : min(last, lim / BKV);
  }
  for (int j = 0; j <= last; ++j) {                 // the KV stream
    __syncthreads();                                // previous tiles consumed
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int rr = idx / D, c = idx % D, key = j * BKV + rr;
      const bool ok = key < skv;
      k_s[rr * P + c] = ok ? bsps::to_float(kh[key * kss + c]) : 0.f;
      v_s[rr * P + c] = ok ? bsps::to_float(vh[key * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[BKV / 2];
    float mx = bsps::kNegInf;
#pragma unroll
    for (int cc = 0; cc < BKV / 2; ++cc) {
      const int kc = 2 * cc + half, k_pos = j * BKV + kc;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += q_s[r * P + d] * k_s[kc * P + d];
      dot *= scale;
      if (k_pos >= skv || (causal && q_pos < k_pos)) dot = bsps::kNegInf;
      s[cc] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float row_sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < BKV / 2; ++cc) {
      s[cc] = expf(s[cc] - m_new);
      row_sum += s[cc];
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    const float alpha = expf(m_run - m_new);        // rescale the old state
    l_run = alpha * l_run + row_sum;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
#pragma unroll
    for (int cc = 0; cc < BKV / 2; ++cc) {  // fully unrolled: s[] stays in registers
      const float p0 = __shfl_sync(0xffffffffu, s[cc], lane & ~1);
      const float p1 = __shfl_sync(0xffffffffu, s[cc], lane | 1);
      const float* v0 = v_s + (2 * cc) * P + half * HALF;
      const float* v1 = v0 + P;
#pragma unroll
      for (int d = 0; d < HALF; ++d) acc[d] += p0 * v0[d] + p1 * v1[d];
    }
  }

  const float inv = 1.f / fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc_s[r * D + half * HALF + d] = acc[d] * inv;
  if (half == 0) {
    m_s[r] = m_run;
    l_s[r] = l_run;
  }
  __syncthreads();
  T* oh = o + b * osb + h * osh;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int rr = idx / D, c = idx % D, row = qi * BQ + rr;
    if (row < sq) oh[row * oss + c] = bsps::from_float<T>(acc_s[idx]);
  }
}

template <typename T, int D>
cudaError_t launch(int device, dim3 grid, int n_kv, int scratch_bytes, cudaStream_t stream,
                   const void* q, const void* k, const void* v, void* o, int hq, int hkv,
                   int sq, int skv, int q_offset, int causal, float scale,
                   const long long* st) {
  constexpr int SCRATCH = (2 * BQ + BQ * D) * 4;
  constexpr int SMEM = SCRATCH + (BQ + 2 * BKV) * (D + 1) * 4;
  if (scratch_bytes != SCRATCH) return cudaErrorInvalidValue;  // plan and kernel disagree
  auto kernel = flash_fwd<T, D>;
  cudaError_t err = bsps::prepare_smem(kernel, device, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, sq, skv, q_offset, causal, scale, n_kv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int device, dim3 grid, int n_kv, int scratch_bytes, cudaStream_t stream,
                     const void* q, const void* k, const void* v, void* o, int hq, int hkv,
                     int sq, int skv, int d, int q_offset, int causal, float scale,
                     const long long* st) {
  if (d == 64)
    return launch<T, 64>(device, grid, n_kv, scratch_bytes, stream, q, k, v, o, hq, hkv, sq, skv,
                         q_offset, causal, scale, st);
  if (d == 128)
    return launch<T, 128>(device, grid, n_kv, scratch_bytes, stream, q, k, v, o, hq, hkv, sq,
                          skv, q_offset, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// O = softmax(Q·Kᵀ·scale) V per (b, h), GQA, queries at the end of the keys.
// grid (q blocks of 64, Hq, B), loop = KV blocks of 64. `strides` holds the
// (batch, head, sequence) element strides of q, k, v and o in that order;
// the head dimension is contiguous.
BSPS_EXPORT int bsps_flash(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                           void* stream, const void* q, const void* k, const void* v, void* o,
                           int hq, int hkv, int sq, int skv, int d, int q_offset, int causal,
                           float scale, int dtype, const long long* strides) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gx < 1 || gy != hq || gz < 1 || loop < 1 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bsps::kBFloat16)
    return dispatch<__nv_bfloat16>(device, grid, loop, scratch_bytes, s, q, k, v, o, hq, hkv, sq,
                                   skv, d, q_offset, causal, scale, strides);
  if (dtype == bsps::kFloat32)
    return dispatch<float>(device, grid, loop, scratch_bytes, s, q, k, v, o, hq, hkv, sq, skv, d,
                           q_offset, causal, scale, strides);
  return cudaErrorInvalidValue;
}

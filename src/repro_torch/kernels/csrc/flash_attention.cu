// Streaming (flash) attention forward as a BSPS program, on Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py:40 (_attn_kernel), the
// Pallas kernel over grid (batch, q_heads, q_blocks, kv_blocks) whose online
// softmax state (m, l, acc) is carried across the sequential KV axis in VMEM
// scratch, skipping KV blocks above the causal diagonal.
//
// Both kernels below share the launch grid: one block per (q block of 64,
// q head, batch) — the plan's three "parallel" axes are the CUDA grid — and
// the KV stream is a loop inside the block over blocks of 64 keys, up to
// the diagonal under causal masking (the pseudo-streaming skip). q-head h
// reads kv-head h / (Hq / Hkv) (GQA), queries sit at the end of the keys
// (q_offset = Skv - Sq), ragged Sq and Skv are masked (never padded), heads
// may be strided as long as the head dim is contiguous, D is 16, 32, 64, 128,
// 192 or 256 (the wrapper zero-pads any other D up to 256 to the next). The
// online softmax is the TPU kernel's, in fp32: masked scores and the initial
// max are -1e30, l is clamped at 1e-30 before the final division. The
// plan's scratch (m, l, acc) is the state each warp keeps in registers; the
// launch checks its size against the kernel's and places nothing for it.
//
// bf16 (the main path): FlashAttention-2 on the tensor cores. Bound on this
// card at the slice's shapes (sequence 256): bytes — 4·D FLOPs per (query,
// key) pair at the bf16 tensor-core rate take less time than reading Q, K, V
// and writing O once. What the design does about it: Q, K and V stay bf16 in
// shared memory (Q 8/16/24 KB, K and V double buffered, 40/80/120 KB a
// block at D 64/128/192, 10/20 KB at D 16/32 and 160 KB at D 256, so two
// blocks share an SM up to D 128 and one holds it above, past the 48 KB
// default: prepare_smem opts in), filled
// by 16-byte cp.async copies with the next KV block in flight while this
// one is computed. Each warp owns 16 query rows: S = Q·Kᵀ by mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) with Q's fragments loaded once
// (D ≤ 128) and K read by ldmatrix; the online softmax runs on the fp32 S
// fragments (each lane holds 2 rows × 2 columns per 8-key tile; row max
// and sum over the 4 lanes of a row by shuffles), with sm_scale·log2(e)
// folded into exp2f; P is rounded to bf16 in registers and is the A
// operand of P·V, V read by ldmatrix.trans; the output accumulator never
// leaves the registers until the end (D/2 fp32 a lane: 96 at D 192 and 128
// at D 256, where Q's fragments are read from shared memory at each k-step
// instead of held: see kQInRegs). Tiles are
// stored with a 16-byte XOR swizzle (chunk ^ row % 8), so every ldmatrix
// and every staged store is free of bank conflicts (at D 16 and 32 a row is
// narrower than the 128 bytes of the banks: see swz). The heaviest causal q
// blocks are launched first (the q index is reversed), so the last wave is
// not the long one. Numerics: rounding P to bf16 is the one rounding the
// fp32 kernel does not make (about 2^-9 relative on a convex combination of
// V rows); l sums the unrounded fp32 P.
//
// Both kernels may also write the rows' log-sum-exp (lse, (B, Hq, Sq) fp32,
// natural log), which the backward pass (models/flash.py) recomputes the
// probabilities from. Their running max m₂ and sum l live in the log2
// domain (scores scaled by sm_scale·log2 e, exp2f), so lse is
// (m₂ + log₂ l)·ln 2, l clamped at 1e-30 as for the output.
//
// fp32 (the fp32 LM of the train_lm example, jamba's fp32 cut, the fp32
// smoke configs): exact fp32 FFMAs with fp32 accumulation on the CUDA
// cores, no TF32 and no tensor-core emulation — TF32 would round Q, K and P
// to 10 bits and break the fp32 tolerance of 2e-4. Bound on this card by
// operations (4·D FLOPs a (query, key) pair at the 67 TFLOP/s of the fp32
// pipes) and, inside the SM, by the shared-memory reads that feed them: a
// warp's LDS.128 delivers 512 bytes, four of the SM's 128-byte cycles,
// however many of its lanes read the same word, so each loaded float must
// feed several FFMAs. What the design does about it (one tile choice a
// head dim, F32Tile): 8 warps a block, both products register-tiled, each
// thread owning 4 queries × 4 keys of S and the same 4 rows × D/16 columns
// of O, so a d-quad's 8 LDS.128 of Q and K feed 64 FFMAs and a key's
// LDS.128 of P and D/64 LDS.128 of V feed D/4. Q and each K block are
// staged k-major in d-quads (X4[d/4][row][4]) by 16-byte cp.async copies
// (4-byte ones where rows are not 16-byte aligned), read by the S loop as
// they are, with no transposition; sm_scale·log2 e scales the scores. The
// online softmax runs in registers in the log2 domain (exp2f), the 16
// threads of a query row in one half-warp (row max by shuffles, l a
// per-lane partial summed at the end); P goes to shared memory key-major
// (Pᵀ, its 16-byte chunks XOR-swizzled by key so that the stores are free
// of bank conflicts), each warp reading back only its own rows behind a
// warp barrier. V stays row-major, filled by 16-byte cp.async where its
// rows are 16-byte aligned and 4-byte ones otherwise. Up to D 128, K and V
// are double-buffered, the next block's copies in flight while this one is
// computed (96 KB of shared memory at D 64: two blocks an SM; 176 KB at
// D 128); above, one K and one V block fit (160 and 208 KB at D 192 and
// 256): the next K block is copied during this block's P·V and each V
// block during its S. The heaviest causal q blocks go first. Each score is
// one ascending-d FMA chain and each output one ascending-key chain, and l
// sums in a fixed order, so the same inputs give the same bits, with or
// without lse.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 128;

using bf16 = __nv_bfloat16;

// -- bf16: mma.sync on the tensor cores --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a·b for one m16n8k16 tile: a 16×16 bf16 (row), b 16×8 bf16 (col), c fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// [rows][D] bf16 tile. The chunk is XORed with bits of the row so that the 8
// consecutive rows one ldmatrix phase (or one staged store) touches sit in 8
// different 16-byte bank groups. A row of CH ≥ 8 chunks spans the banks, and
// row & 7 does it; a row of CH = 2 or 4 chunks (D 16, 32) shares 128 bytes
// with 8 / CH - 1 neighbours, so the XOR takes the row bits above those,
// (row >> log2(8 / CH)) & (CH - 1), and stays inside the row.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CH = D / 8;
  static_assert(CH == 2 || CH == 4 || CH % 8 == 0, "head dim 16, 32 or a multiple of 64");
  constexpr int SHIFT = CH >= 8 ? 0 : (CH == 4 ? 1 : 2);
  constexpr int MASK = CH >= 8 ? 7 : CH - 1;
  return row * D + ((chunk ^ ((row >> SHIFT) & MASK)) << 3);
}

// cp.async of 64 rows [r0, r0 + 64) of a (rows, D) bf16 matrix with row
// stride `rs` into a swizzled tile; rows at or past `limit` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          long long rs, int r0, int limit, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(64 * CH % kThreads == 0, "every thread copies whole chunks");
#pragma unroll
  for (int i = 0; i < 64 * CH / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < limit;
    const bf16* p = ok ? src + (long long)(r0 + r) * rs + c * 8 : src;
    cp_async16(dst + swz<D>(r, c) * 2, p, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int hq, int hkv, int sq,
              int skv, int q_offset, int causal, float scale_log2, int n_kv,
              long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss,
              long long vsb, long long vsh, long long vss,
              long long osb, long long osh, long long oss) {
  constexpr int TILE = BKV * D;         // elements of one K or V block
  constexpr int KT = D / 16;            // k-steps of Q·Kᵀ
  constexpr int DT = D / 8;             // 8-wide output column tiles
  static_assert(D >= 16 && D % 16 == 0, "P·V covers D in pairs of 8-wide tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);           // [BQ][D], later the output
  const uint32_t q_a = smem_u32(q_s);
  const uint32_t k_a = q_a + BQ * D * 2;                // [2][BKV][D]
  const uint32_t v_a = k_a + 2 * TILE * 2;              // [2][BKV][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;           // heaviest causal blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bf16* qh = q + b * qsb + h * qsh;
  const bf16* kh = k + b * ksb + hk * ksh;
  const bf16* vh = v + b * vsb + hk * vsh;

  // the last KV block the causal skip keeps (whole blocks above the diagonal
  // are never read)
  int last = n_kv - 1;
  if (causal) {
    const int lim = qi * BQ + q_offset + BQ - 1;
    last = lim < 0 ? -1 : min(last, lim / BKV);
  }

  load_tile<D>(q_a, qh, qss, qi * BQ, sq, tid);
  if (last >= 0) {
    load_tile<D>(k_a, kh, kss, 0, skv, tid);
    load_tile<D>(v_a, vh, vss, 0, skv, tid);
  }
  cp_async_commit();

  const int qpos = qi * BQ + warp * 16 + g + q_offset;  // this lane's first row; +8 the second
  float m_r[2] = {bsps::kNegInf, bsps::kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  // Q's fragments stay in registers up to D 128; at D 192 the 96
  // accumulator registers a lane leave no room for Q's 48 (ptxas spilled
  // 72 bytes), so each k-step reads its Q fragment from the tile again
  // (16 bytes still spill; scoring the keys 32 at a time spilled 76)
  constexpr bool kQInRegs = D <= 128;
  const int q_row = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  uint32_t qf[kQInRegs ? KT : 1][4];

  for (int j = 0; j <= last; ++j) {                     // the KV stream
    const int buf = j & 1;
    if (j < last) {                                     // the next token, in flight
      load_tile<D>(k_a + (buf ^ 1) * TILE * 2, kh, kss, (j + 1) * BKV, skv, tid);
      load_tile<D>(v_a + (buf ^ 1) * TILE * 2, vh, vss, (j + 1) * BKV, skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          ldsm_x4(q_a + swz<D>(q_row, kk * 2 + (lane >> 4)) * 2, qf[kk]);
      }
    }

    // S = Q·Kᵀ: 16 rows × 64 keys per warp, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    const uint32_t kb = k_a + buf * TILE * 2;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t (&qk)[4] = qf[kQInRegs ? kk : 0];
      if constexpr (!kQInRegs) ldsm_x4(q_a + swz<D>(q_row, kk * 2 + (lane >> 4)) * 2, qk);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int key = p * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t f[4];
        ldsm_x4(kb + swz<D>(key, kk * 2 + ((lane >> 3) & 1)) * 2, f);
        mma_bf16(s[2 * p], qk, f[0], f[1]);
        mma_bf16(s[2 * p + 1], qk, f[2], f[3]);
      }
    }

    // scale into the log2 domain; mask only in blocks that cross the edge
    const int k0 = j * BKV;
    const bool edge = k0 + BKV > skv || (causal && k0 + BKV - 1 > qi * BQ + q_offset);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (edge) {
          const int kp = k0 + t * 8 + 2 * tig + (e & 1);
          if (kp >= skv || (causal && kp > qpos + (e >> 1) * 8)) x = bsps::kNegInf;
        }
        s[t][e] = x;
      }

    // online softmax per row (r = 0: row g, r = 1: row g + 8); l stays a
    // per-lane partial sum until the end
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_r[r];
#pragma unroll
      for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_r[r] - mx);           // rescale the old state
      m_r[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        s[t][2 * r] = exp2f(s[t][2 * r] - mx);
        s[t][2 * r + 1] = exp2f(s[t][2 * r + 1] - mx);
        sum += s[t][2 * r] + s[t][2 * r + 1];
      }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        acc[t][2 * r] *= alpha;
        acc[t][2 * r + 1] *= alpha;
      }
    }

    // O += P·V: P's fragments are S's, rounded to bf16 in registers
    const uint32_t vb = v_a + buf * TILE * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t f[4];
        ldsm_x4_trans(vb + swz<D>(key, p * 2 + (lane >> 4)) * 2, f);
        mma_bf16(acc[2 * p], pa, f[0], f[1]);
        mma_bf16(acc[2 * p + 1], pa, f[2], f[3]);
      }
    }
    __syncthreads();                                    // this buffer may be refilled
  }
  cp_async_wait<0>();                                   // Q's copy, when no block ran
  __syncthreads();

  // normalise, stage the warp's 16 rows in its rows of the Q tile, store
  // them coalesced (16 bytes a lane)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
    const int grow = qi * BQ + warp * 16 + g + 8 * r;
    if (lse != nullptr && tig == 0 && grow < sq)
      lse[((long long)b * hq + h) * sq + grow] =
          (m_r[r] + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
  }
  const int row = warp * 16 + g;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(row, t) + 2 * tig) =
        pack_bf16(acc[t][0] * inv[0], acc[t][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(row + 8, t) + 2 * tig) =
        pack_bf16(acc[t][2] * inv[1], acc[t][3] * inv[1]);
  }
  __syncwarp();
  bf16* oh = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 16 * DT / 32; ++i) {
    const int idx = lane + 32 * i;
    const int rr = warp * 16 + idx / DT, c = idx % DT, grow = qi * BQ + rr;
    if (grow < sq)
      *reinterpret_cast<uint4*>(oh + grow * oss + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz<D>(rr, c));
  }
}

// -- fp32: register-tiled exact FFMAs on the CUDA cores ---------------------------

// 4-byte global -> shared copy (through L1: the transposing copies read each
// 32-byte sector in two halves); zero-fills the destination when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// The fp32 kernel's one tile choice a head dim. A block is the plan's BQ =
// 64 queries and 8 warps, and streams the plan's BKV = 64 keys at a time.
// The threads form 16 query groups of 4 rows by 16 column groups, a query
// group's 16 threads in one half-warp. S = Q·Kᵀ: each thread scores its 4
// queries × TK = 4 keys. P·V: the same thread owns the same rows' outputs
// at D/16 columns, NC pieces of W adjacent columns 16·W apart, so the
// softmax's α stays in its registers and a warp reads back only the rows
// of P it wrote. Shared memory: Q and K in d-quads, V row-major, Pᵀ
// key-major with its 4-query chunks XOR-swizzled by key. K and V are
// double-buffered up to D 128; above, one K and one V block fit the 227 KB
// (SPLIT): the next K block is copied during this block's P·V, and each V
// block during its S. The unrolls are the largest that do not spill.
template <int D>
struct F32Tile {
  static constexpr int kThreads = 256, kWarps = 8, TK = BKV / 16;
  static constexpr bool SPLIT = D > 128;
  static constexpr int BUFS = SPLIT ? 1 : 2;           // K and V buffers
  static constexpr int W = D >= 64 ? 4 : D / 16;       // adjacent output columns a piece
  static constexpr int NC = D / (16 * W);              // pieces a row
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;   // two blocks an SM up to D 64
  static constexpr int S_UNROLL = D > 192 ? 1 : 4, PV_UNROLL = D > 128 ? 4 : 8;  // d-quads, keys
  static constexpr int Q_FLOATS = BQ * D, KV_FLOATS = BKV * D;
  static constexpr int SMEM = (Q_FLOATS + 2 * BUFS * KV_FLOATS + BKV * BQ) * 4;
  static_assert(D % 16 == 0 && BQ == 64 && BKV == 64, "16 groups of 4 rows and of 4 keys");
};

// N adjacent floats (1, 2 or 4) from shared memory as one LDS.32, .64 or .128
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&r)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

// N adjacent floats stored as one store where `vec` (the address is N
// floats aligned), else as N
template <int N>
__device__ __forceinline__ void st(float* p, const float (&r)[N], bool vec) {
  if constexpr (N == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
      return;
    }
  } else if constexpr (N == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = r[i];
}

// Pᵀ[key][q], q a multiple of 4: the 16-byte chunk of queries q..q+3 moves
// to chunk (q / 4) ^ ((key / 4) % 8), so that the 8 lanes of a
// quarter-warp, which store the same queries at 8 keys 4 apart, hit 8 bank
// groups
__device__ __forceinline__ int p_idx(int key, int q) {
  return key * BQ + (((q >> 2) ^ ((key >> 2) & 7)) << 2);
}

// Rows [r0, r0 + ROWS) of a (rows, D) matrix with row stride `rs` into its
// d-quad tile X4[D / 4][ROWS][4]: the quad of d 4c..4c+3 of the row at
// position p sits at X4[c][p], and position p holds row r0 + (p % 16)·R +
// p / 16 (R = ROWS / 16), so that the R rows of one column group (rows
// g·R .. g·R + R - 1) sit 16 positions apart. 16-byte copies where the rows
// are 16-byte aligned (`vec`), else 4-byte ones; no transposition. A warp
// instruction copies 8 positions × 4 quads: 8 rows of 64 contiguous bytes
// in device memory, 8 consecutive 16-byte chunks a quarter-warp in shared
// memory. Rows at or past `limit` are zero-filled. Q (ROWS = BQ) and each
// K block.
template <int D, int ROWS>
__device__ __forceinline__ void load_quads(uint32_t dst, const float* __restrict__ src,
                                           long long rs, int r0, int limit, bool vec, int warp,
                                           int lane) {
  constexpr int WARPS = F32Tile<D>::kWarps, PG = ROWS / 8, R = ROWS / 16;
  static_assert(PG * (D / 16) % WARPS == 0, "every warp copies whole groups");
#pragma unroll
  for (int it = 0; it < PG * (D / 16) / WARPS; ++it) {
    const int i = warp + WARPS * it;
    const int p = (i % PG) * 8 + (lane & 7), c = (i / PG) * 4 + (lane >> 3);
    const int r = r0 + (p % 16) * R + p / 16;
    const bool ok = r < limit;
    const float* from = ok ? src + (long long)r * rs + c * 4 : src;
    const uint32_t to = dst + (c * ROWS + p) * 16;
    if (vec) {
      cp_async16(to, from, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(to + e * 4, ok ? from + e : src, ok);
    }
  }
}

// V block [k0, k0 + BKV) into V[BKV][D]: 16-byte copies where the rows are
// 16-byte aligned (`vec`), else 4-byte ones; keys at or past skv are
// zero-filled
template <int D>
__device__ __forceinline__ void load_v(uint32_t dst, const float* __restrict__ vh, long long vss,
                                       int k0, int skv, bool vec, int tid) {
  using T = F32Tile<D>;
  static_assert(BKV * D / 4 % T::kThreads == 0, "every thread copies whole chunks");
  if (vec) {
#pragma unroll
    for (int it = 0; it < BKV * D / 4 / T::kThreads; ++it) {
      const int idx = tid + it * T::kThreads, key = idx / (D / 4), c = idx % (D / 4);
      const bool ok = k0 + key < skv;
      cp_async16(dst + (key * D + c * 4) * 4, ok ? vh + (long long)(k0 + key) * vss + c * 4 : vh,
                 ok);
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < BKV * D / T::kThreads; ++it) {
      const int idx = tid + it * T::kThreads, key = idx / D, d = idx % D;
      const bool ok = k0 + key < skv;
      cp_async4(dst + (key * D + d) * 4, ok ? vh + (long long)(k0 + key) * vss + d : vh, ok);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, F32Tile<D>::MIN_BLOCKS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int hq, int hkv, int sq,
              int skv, int q_offset, int causal, float scale_log2, int n_kv,
              long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss,
              long long vsb, long long vsh, long long vss,
              long long osb, long long osh, long long oss) {
  using T = F32Tile<D>;
  constexpr int RQ = 4, TK = T::TK, W = T::W, NC = T::NC;   // RQ: query rows a thread
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* q_s = reinterpret_cast<float*>(smem_f32);     // Q4[D/4][BQ][4]
  float* k_s = q_s + T::Q_FLOATS;                      // [BUFS] K4[D/4][BKV][4]
  float* v_s = k_s + T::BUFS * T::KV_FLOATS;           // [BUFS] V[BKV][D]
  float* p_s = v_s + T::BUFS * T::KV_FLOATS;           // Pᵀ[BKV][BQ], swizzled
  const uint32_t q_a = smem_u32(q_s), k_a = smem_u32(k_s), v_a = smem_u32(v_s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = tid >> 4, kg = tid & 15;              // query group, key / column group
  const int qi = gridDim.x - 1 - blockIdx.x;           // heaviest causal blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const float* qh = q + b * qsb + h * qsh;
  const float* kh = k + b * ksb + hk * ksh;
  const float* vh = v + b * vsb + hk * vsh;
  const bool q_vec = reinterpret_cast<uintptr_t>(qh) % 16 == 0 && qss % 4 == 0;
  const bool k_vec = reinterpret_cast<uintptr_t>(kh) % 16 == 0 && kss % 4 == 0;
  const bool v_vec = reinterpret_cast<uintptr_t>(vh) % 16 == 0 && vss % 4 == 0;

  int last = n_kv - 1;                                 // the last KV block the causal skip keeps
  if (causal) {
    const int lim = qi * BQ + q_offset + BQ - 1;
    last = lim < 0 ? -1 : min(last, lim / BKV);
  }
  load_quads<D, BQ>(q_a, qh, qss, qi * BQ, sq, q_vec, warp, lane);
  if (last >= 0) {
    load_quads<D, BKV>(k_a, kh, kss, 0, skv, k_vec, warp, lane);
    if constexpr (!T::SPLIT) load_v<D>(v_a, vh, vss, 0, skv, v_vec, tid);
  }
  cp_async_commit();

  const int qpos = qi * BQ + qg * RQ + q_offset;       // row i's position: qpos + i
  float m_r[RQ], l_r[RQ], acc[RQ][NC * W];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_r[i] = bsps::kNegInf, l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * W; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j <= last; ++j) {                    // the KV stream
    const int buf = T::SPLIT ? 0 : j & 1;
    cp_async_wait<0>();                                // block j's copies have landed
    __syncthreads();                                   // ...for every thread; j - 1 is consumed
    if constexpr (T::SPLIT) {
      load_v<D>(v_a, vh, vss, j * BKV, skv, v_vec, tid);      // in flight during S
    } else if (j < last) {                             // the next token, in flight
      load_quads<D, BKV>(k_a + (buf ^ 1) * T::KV_FLOATS * 4, kh, kss, (j + 1) * BKV, skv,
                          k_vec, warp, lane);
      load_v<D>(v_a + (buf ^ 1) * T::KV_FLOATS * 4, vh, vss, (j + 1) * BKV, skv, v_vec, tid);
    }
    cp_async_commit();

    // S = Q·Kᵀ: one ascending-d FMA chain a score, then scaled into log2
    float s[RQ][TK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int t = 0; t < TK; ++t) s[i][t] = 0.f;
    // (row qg·4 + i at position 16·i + qg, key kg·TK + t at 16·t + kg)
    const float* qp = q_s + qg * 4;
    const float* kp = k_s + buf * T::KV_FLOATS + kg * 4;
#pragma unroll (T::S_UNROLL)
    for (int c = 0; c < D / 4; ++c) {
      float qv[RQ][4], kv[TK][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) lds<4>(qp + (c * BQ + 16 * i) * 4, qv[i]);
#pragma unroll
      for (int t = 0; t < TK; ++t) lds<4>(kp + (c * BKV + 16 * t) * 4, kv[t]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int t = 0; t < TK; ++t) s[i][t] = fmaf(qv[i][e], kv[t][e], s[i][t]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int t = 0; t < TK; ++t) s[i][t] *= scale_log2;

    // mask only in blocks that cross the edge
    const int k0 = j * BKV;
    if (k0 + BKV > skv || (causal && k0 + BKV - 1 > qi * BQ + q_offset)) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          const int kpos = k0 + kg * TK + t;
          if (kpos >= skv || (causal && kpos > qpos + i)) s[i][t] = bsps::kNegInf;
        }
    }

    // online softmax: the row max over the half-warp by shuffles; l stays a
    // per-lane partial sum until the end
    float alpha[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int t = 0; t < TK; ++t) mx = fmaxf(mx, s[i][t]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      alpha[i] = exp2f(m_r[i] - mx);
      m_r[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        s[i][t] = exp2f(s[i][t] - mx);
        sum += s[i][t];
      }
      l_r[i] = l_r[i] * alpha[i] + sum;
    }
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      float col[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) col[i] = s[i][t];
      st<RQ>(p_s + p_idx(kg * TK + t, qg * RQ), col, true);
    }
    __syncwarp();                                      // a warp reads only its own rows of P
    if constexpr (T::SPLIT) {
      __syncthreads();                                 // every warp is done with K
      if (j < last) load_quads<D, BKV>(k_a, kh, kss, (j + 1) * BKV, skv, k_vec, warp, lane);
      cp_async_commit();                               // in flight during P·V
      cp_async_wait<1>();                              // V block j's copies have landed
      __syncthreads();                                 // ...for every thread
    }

    // O = α·O + P·V: one ascending-key FMA chain an output
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < NC * W; ++c) acc[i][c] *= alpha[i];
    const float* vp = v_s + buf * T::KV_FLOATS + kg * W;
#pragma unroll (T::PV_UNROLL)
    for (int key = 0; key < BKV; ++key) {
      float pv[RQ];
      lds<RQ>(p_s + p_idx(key, qg * RQ), pv);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[W];
        lds<W>(vp + key * D + c * 16 * W, vv);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[i][c * W + w] = fmaf(pv[i], vv[w], acc[i][c * W + w]);
      }
    }
  }
  cp_async_wait<0>();

  // l over the half-warp (a butterfly: every lane ends with the same bits),
  // the normalised rows stored W columns a lane, a half-warp's columns
  // adjacent
  float* oh = o + b * osb + h * osh;
  const bool o_vec = reinterpret_cast<uintptr_t>(oh) % (4 * W) == 0 && oss % W == 0;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    l = fmaxf(l, 1e-30f);
    const float inv = 1.f / l;
    const int row = qi * BQ + qg * RQ + i;
    if (row >= sq) continue;
    if (lse != nullptr && kg == 0)
      lse[((long long)b * hq + h) * sq + row] = (m_r[i] + log2f(l)) * 0.6931471805599453f;
    float* dst = oh + (long long)row * oss + kg * W;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float r[W];
#pragma unroll
      for (int w = 0; w < W; ++w) r[w] = acc[i][c * W + w] * inv;
      st<W>(dst + c * 16 * W, r, o_vec);
    }
  }
}

// dynamic shared memory a block: bf16 Q and double-buffered K, V (the
// fp32 kernel's is F32Tile<D>::SMEM)
template <int D>
constexpr int kSmemMma = (BQ + 4 * BKV) * D * 2;

// calls f(std::integral_constant<int, D>{}) for the instantiated head dim D
// equal to d; other d are refused
template <typename F>
cudaError_t with_head_dim(int d, F f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch(int device, dim3 grid, int n_kv, int scratch_bytes, cudaStream_t stream,
                   const void* q, const void* k, const void* v, void* o, float* lse, int hq,
                   int hkv, int sq, int skv, int q_offset, int causal, float scale, int dtype,
                   const long long* st) {
  constexpr int SCRATCH = (2 * BQ + BQ * D) * 4;  // m, l, acc: in registers
  if (scratch_bytes != SCRATCH) return cudaErrorInvalidValue;  // plan and kernel disagree
  if (dtype == bsps::kBFloat16) {
    constexpr int SMEM = kSmemMma<D>;
    auto kernel = flash_fwd_mma<D>;
    cudaError_t err = bsps::prepare_smem(kernel, device, SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, hq, hkv, sq, skv, q_offset, causal,
        scale * 1.4426950408889634f, n_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], st[9], st[10], st[11]);
    return cudaGetLastError();
  }
  if (dtype == bsps::kFloat32) {
    using T = F32Tile<D>;
    auto kernel = flash_fwd_f32<D>;
    cudaError_t err = bsps::prepare_smem(kernel, device, T::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, T::kThreads, T::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, hq, hkv, sq, skv, q_offset, causal,
        scale * 1.4426950408889634f, n_kv, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// -- bf16 backward: FlashAttention-2 in two deterministic passes ------------------
//
// Replaces: no Pallas kernel. The reference's backward is jnp
// (src/repro/models/flash.py:129, _flash_bwd), whose counterpart in the port
// was torch ops (models/flash.py, _flash_bwd, still the CPU's and fp32's
// plain version): the same two passes, in fp32, over 1024 × 1024 blocks, so
// every block's S, P, dP and dS was a (B, Hkv, group, 1024, 1024) fp32
// tensor written to and read back from device memory.
//
// Bound on this card by operations at long sequences: 7 products of 2·D
// FLOPs on each kept (query, key) pair (S and dP in both passes, dQ in pass
// A, dV and dK in pass B; the harness counts 10·D, FlashAttention-2's count
// with a dQ atomic), against reading Q, K, V, O, dO and lse and writing dQ,
// dK, dV once. At minicpm-2b's train step (B 8, H 36, S 2048, D 64, causal)
// that is 541 GFLOP (387 counted) against 0.61 GB: 0.55 ms of tensor cores
// to 0.18 ms of bytes. At jamba's (B 4, H 32/8, S 256, D 128) it is 7.5
// GFLOP against 42 MB, 7.6 µs to 12.6 µs: bytes.
//
// What the design does about it: the products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators) from swizzled
// shared tiles read by ldmatrix, with the streamed tiles double-buffered by
// cp.async; P and dS are rounded to bf16 only as operands of the next
// product (as the forward rounds P for P·V), and no score tile leaves the
// registers. Softmax, lse, delta and every sum stay fp32.
//
// - Pass A (flash_bwd_dq): grid (Q tiles of 64, Hq, B), each warp 16 query
//   rows, heaviest causal tiles first. Its prologue computes
//   delta = rowsum(dO ∘ O) in fp32 for its rows (written for pass B). Then
//   it streams the KV blocks up to the diagonal, NK keys a step: S = Q·Kᵀ,
//   dP = dO·Vᵀ, P = exp2(S·scale·log2 e − lse·log2 e), dS = P ∘ (dP − delta),
//   dQ += dS·K in registers; dQ·scale is written once.
// - Pass B (flash_bwd_dkv): grid (KV blocks of 64 × column splits, Hkv, B),
//   each warp 16 keys. It streams the group's query heads and, in each, the
//   Q tiles from the first that sees the block, BQ queries a step, and
//   computes the transposed tiles directly (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ), so
//   that Pᵀ and dSᵀ are the A operands of dV += Pᵀ·dO and dK += dSᵀ·Q
//   straight from the accumulators. Above D 128 the dK and dV accumulators
//   (D fp32 a lane for 16 keys) do not fit beside the tiles, so each block
//   accumulates half of the columns and two blocks share a KV block, both
//   computing its Sᵀ and dPᵀ.
//
// Determinism: no atomics. dQ is summed by the one block that owns its rows
// and dK, dV by the one block (per column half) that owns their keys, each
// in a fixed order (KV blocks ascending; heads, then Q tiles ascending), and
// delta by a fixed pairing. This costs pass B's second recomputation of S
// and dP (14·D FLOPs a pair against 10·D with a dQ atomic) and gives the
// same bits on every run and at every batch size: a row's work never
// depends on the other rows of the batch.
//
// Ragged Sq and Skv are masked in the kernels (rows past the ends are
// zero-filled and their pairs' P set to 0), queries sit at the end of the
// keys (q_offset = Skv − Sq), heads may be strided with a contiguous head
// dim and 16-byte aligned rows, and D is one of the forward's head dims.

// the backward's tiles at head dim D (flash_attention.bwd_tiles mirrors them)
template <int D>
struct BwdTile {
  // pass A: a block owns BQ = 64 queries and streams NK keys a step
  static constexpr int NK = D > 128 ? 32 : 64;
  // pass B: a block owns BKV = 64 keys and streams QB queries a step, and
  // accumulates DC of the D columns of dK and dV (NSPLIT blocks a KV block)
  static constexpr int QB = D >= 128 ? 32 : 64;
  static constexpr int NSPLIT = D > 128 ? 2 : 1, DC = D / NSPLIT;
  // the A operands that stay in registers for the whole loop (Q and dO in
  // pass A, K and V in pass B); above D 64 they are read from shared memory
  // at each k-step
  static constexpr bool FRAGS = D <= 64;
  static constexpr int SMEM_A = (2 * BQ + 4 * NK) * D * 2 + BQ * 4;
  static constexpr int SMEM_B = (2 * BKV + 4 * QB) * D * 2 + 4 * QB * 4;
  static_assert(DC % 16 == 0 && NK % 16 == 0 && QB % 16 == 0, "whole m16n8k16 steps");
};

// (batch, head, sequence) element strides of the backward's eight tensors
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

constexpr float kLog2e = 1.4426950408889634f;

// cp.async of ROWS rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix with row
// stride `rs` into a swizzled tile; rows at or past `limit` are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* __restrict__ src,
                                          long long rs, int r0, int limit, int tid) {
  constexpr int CH = D / 8;
  constexpr int N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    if (N % kThreads == 0 || idx < N) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = r0 + r < limit;
      const bf16* p = ok ? src + (long long)(r0 + r) * rs + c * 8 : src;
      cp_async16(dst + swz<D>(r, c) * 2, p, ok);
    }
  }
}

// the A fragment (16 rows × 16 columns, k-step kk) of a swizzled [rows][D]
// tile whose rows `row0`.. are this warp's
template <int D>
__device__ __forceinline__ void a_frag(uint32_t tile, int row0, int kk, int lane,
                                       uint32_t (&r)[4]) {
  ldsm_x4(tile + swz<D>(row0 + (lane & 7) + (((lane >> 3) & 1) << 3), kk * 2 + (lane >> 4)) * 2, r);
}

// the B fragments of n-tiles 2p and 2p + 1 (16 rows of the tile as the n
// dimension) at k-step kk: the tile's rows are n, its columns k
template <int D>
__device__ __forceinline__ void b_frag_n(uint32_t tile, int p, int kk, int lane,
                                         uint32_t (&r)[4]) {
  ldsm_x4(tile + swz<D>(p * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)) * 2,
          r);
}

// the B fragments of column tiles 2p and 2p + 1 (column chunk c0 + 2p) at
// k-step kk: the tile's rows are k, its columns n
template <int D>
__device__ __forceinline__ void b_frag_k(uint32_t tile, int c0, int p, int kk, int lane,
                                         uint32_t (&r)[4]) {
  ldsm_x4_trans(
      tile + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), c0 + p * 2 + (lane >> 4)) * 2,
      r);
}

// the A operand of k-step kk from fp32 accumulators c[n-tile][4] (rows g,
// g + 8 of the warp's 16; n-tiles 2kk and 2kk + 1 are the 16 k columns)
template <int NT>
__device__ __forceinline__ void a_from_acc(const float (&c)[NT][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows g and g + 8 of a warp's 16 × (8·CT) fp32 accumulator, times `mul`,
// into bf16 rows row0 + g (+ 8) from column col0, rows at or past `limit`
// skipped
template <int CT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long rs, int row0,
                                           int limit, int col0, const float (&c)[CT][4],
                                           float mul, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    bf16* p = dst + (long long)row * rs + col0 + 2 * tig;
#pragma unroll
    for (int t = 0; t < CT; ++t)
      *reinterpret_cast<uint32_t*>(p + t * 8) = pack_bf16(c[t][2 * r] * mul, c[t][2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
             int hq, int hkv, int sq, int skv, int q_offset, int causal, float scale_log2,
             float scale, int n_kv, BwdStrides st) {
  using T = BwdTile<D>;
  constexpr int NK = T::NK, KT = D / 16, DT = D / 8, NT = NK / 8, TILE = NK * D;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const bf16* do_s = reinterpret_cast<const bf16*>(smem_bwd) + BQ * D;
  const uint32_t q_a = smem_u32(smem_bwd);               // [BQ][D]
  const uint32_t do_a = q_a + BQ * D * 2;                 // [BQ][D]
  const uint32_t k_a = do_a + BQ * D * 2;                 // [2][NK][D]
  const uint32_t v_a = k_a + 2 * TILE * 2;                // [2][NK][D]
  float* delta_s = reinterpret_cast<float*>(smem_bwd + (2 * BQ + 4 * NK) * D * 2);  // [BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;            // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bf16* qh = q + b * st.q[0] + h * st.q[1];
  const bf16* oh = o + b * st.o[0] + h * st.o[1];
  const bf16* doh = dout + b * st.dout[0] + h * st.dout[1];
  const bf16* kh = k + b * st.k[0] + hk * st.k[1];
  const bf16* vh = v + b * st.v[0] + hk * st.v[1];
  const long long rows = ((long long)b * hq + h) * sq;   // this head's lse and delta

  int last = n_kv - 1;                                   // the last KV block the causal skip keeps
  if (causal) {
    const int lim = qi * BQ + q_offset + BQ - 1;
    last = lim < 0 ? -1 : min(last, lim / NK);
  }
  load_rows<D, BQ>(q_a, qh, st.q[2], qi * BQ, sq, tid);
  load_rows<D, BQ>(do_a, doh, st.dout[2], qi * BQ, sq, tid);
  cp_async_commit();
  if (last >= 0) {
    load_rows<D, NK>(k_a, kh, st.k[2], 0, skv, tid);
    load_rows<D, NK>(v_a, vh, st.v[2], 0, skv, tid);
  }
  cp_async_commit();

  // delta = rowsum(dO ∘ O) in fp32: two threads a row, each half of its
  // chunks, added by one shuffle; written for pass B
  cp_async_wait<1>();                                    // Q and dO have landed
  __syncthreads();
  {
    constexpr int CH = D / 8, HALF = CH / 2;
    const int r = tid >> 1, grow = qi * BQ + r;
    float acc = 0.f;
    if (grow < sq) {
      const bf16* orow = oh + (long long)grow * st.o[2];
#pragma unroll
      for (int c = (tid & 1) * HALF; c < (tid & 1) * HALF + HALF; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(do_s + swz<D>(r, c));
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(op[e]), y = __bfloat1622float2(dp[e]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (grow < sq) delta[rows + grow] = acc;
    }
  }
  __syncthreads();

  const int row0 = warp * 16;                            // the warp's rows of the tile
  const int qpos = qi * BQ + row0 + g + q_offset;        // this lane's first row; +8 the second
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int grow = qi * BQ + row0 + g + 8 * r;
    lse2[r] = grow < sq ? lse[rows + grow] * kLog2e : 0.f;
    dl[r] = delta_s[row0 + g + 8 * r];
  }
  uint32_t qf[T::FRAGS ? KT : 1][4], dof[T::FRAGS ? KT : 1][4];
  if constexpr (T::FRAGS) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      a_frag<D>(q_a, row0, kk, lane, qf[kk]);
      a_frag<D>(do_a, row0, kk, lane, dof[kk]);
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int j = 0; j <= last; ++j) {                      // the KV stream
    const int buf = j & 1;
    if (j < last) {                                      // the next block, in flight
      load_rows<D, NK>(k_a + (buf ^ 1) * TILE * 2, kh, st.k[2], (j + 1) * NK, skv, tid);
      load_rows<D, NK>(v_a + (buf ^ 1) * TILE * 2, vh, st.v[2], (j + 1) * NK, skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kb = k_a + buf * TILE * 2, vb = v_a + buf * TILE * 2;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × NK keys a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (T::FRAGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e], da[e] = dof[kk][e];
      } else {
        a_frag<D>(q_a, row0, kk, lane, qa);
        a_frag<D>(do_a, row0, kk, lane, da);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t f[4];
        b_frag_n<D>(kb, p, kk, lane, f);
        mma_bf16(s[2 * p], qa, f[0], f[1]);
        mma_bf16(s[2 * p + 1], qa, f[2], f[3]);
        b_frag_n<D>(vb, p, kk, lane, f);
        mma_bf16(dp[2 * p], da, f[0], f[1]);
        mma_bf16(dp[2 * p + 1], da, f[2], f[3]);
      }
    }

    // P from lse, masked only in blocks that cross an edge; dS = P ∘ (dP − delta) into s
    const int k0 = j * NK;
    const bool edge = k0 + NK > skv || (causal && k0 + NK - 1 > qi * BQ + q_offset);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[t][e], scale_log2, -lse2[r]));
        if (edge) {
          const int kp = k0 + t * 8 + 2 * tig + (e & 1);
          if (kp >= skv || (causal && kp > qpos + 8 * r)) p = 0.f;
        }
        s[t][e] = p * (dp[t][e] - dl[r]);
      }

    // dQ += dS·K: dS's fragments are its accumulators, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t a[4];
      a_from_acc<NT>(s, kk, a);
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t f[4];
        b_frag_k<D>(kb, 0, p, kk, lane, f);
        mma_bf16(acc[2 * p], a, f[0], f[1]);
        mma_bf16(acc[2 * p + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();                                     // this buffer may be refilled
  }
  cp_async_wait<0>();
  store_rows<DT>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], qi * BQ + row0, sq, 0, acc, scale,
                 lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int hq, int hkv, int sq, int skv, int q_offset, int causal, float scale_log2,
              float scale, int n_q, BwdStrides st) {
  using T = BwdTile<D>;
  constexpr int QB = T::QB, DC = T::DC, KT = D / 16, NT = QB / 8, CT = DC / 8, TILE = QB * D;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const uint32_t k_a = smem_u32(smem_bwd);               // [BKV][D]
  const uint32_t v_a = k_a + BKV * D * 2;                 // [BKV][D]
  const uint32_t q_a = v_a + BKV * D * 2;                 // [2][QB][D]
  const uint32_t do_a = q_a + 2 * TILE * 2;               // [2][QB][D]
  const uint32_t lse_a = do_a + 2 * TILE * 2;             // [2][QB] fp32
  const uint32_t dl_a = lse_a + 2 * QB * 4;               // [2][QB] fp32
  const float* lse_s = reinterpret_cast<const float*>(smem_bwd + (2 * BKV + 4 * QB) * D * 2);
  const float* dl_s = lse_s + 2 * QB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kj = blockIdx.x / T::NSPLIT, c0 = (blockIdx.x % T::NSPLIT) * DC;
  const int hk = blockIdx.y, b = blockIdx.z, group = hq / hkv;
  const int k0 = kj * BKV;
  // the Q tiles that see this KV block: from the first whose last query
  // reaches its first key
  const int first = causal ? min(n_q, max(0, k0 - q_offset) / QB) : 0;
  const int per_head = n_q - first, steps = group * per_head;

  auto load_step = [&](int i, int buf) {                 // step i: head i / per_head's tile
    const int h = hk * group + i / per_head, q0 = (first + i % per_head) * QB;
    load_rows<D, QB>(q_a + buf * TILE * 2, q + b * st.q[0] + h * st.q[1], st.q[2], q0, sq, tid);
    load_rows<D, QB>(do_a + buf * TILE * 2, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                     q0, sq, tid);
    const long long rows = ((long long)b * hq + h) * sq + q0;
    if (tid < QB) {
      const bool ok = q0 + tid < sq;
      cp_async4(lse_a + (buf * QB + tid) * 4, ok ? lse + rows + tid : lse, ok);
    } else if (tid < 2 * QB) {
      const int i2 = tid - QB;
      const bool ok = q0 + i2 < sq;
      cp_async4(dl_a + (buf * QB + i2) * 4, ok ? delta + rows + i2 : delta, ok);
    }
  };
  if (steps > 0) {
    load_rows<D, BKV>(k_a, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, skv, tid);
    load_rows<D, BKV>(v_a, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, skv, tid);
    load_step(0, 0);
  }
  cp_async_commit();

  const int row0 = warp * 16;                            // the warp's keys of the block
  const int kpos = k0 + row0 + g;                        // this lane's first key; +8 the second
  uint32_t kf[T::FRAGS ? KT : 1][4], vf[T::FRAGS ? KT : 1][4];
  float dk_acc[CT][4], dv_acc[CT][4];
#pragma unroll
  for (int t = 0; t < CT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  for (int i = 0; i < steps; ++i) {                      // the Q stream
    const int buf = i & 1;
    if (i + 1 < steps) {                                 // the next step, in flight
      load_step(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (T::FRAGS) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          a_frag<D>(k_a, row0, kk, lane, kf[kk]);
          a_frag<D>(v_a, row0, kk, lane, vf[kk]);
        }
      }
    }
    const int q0 = (first + i % per_head) * QB;
    const uint32_t qb = q_a + buf * TILE * 2, dob = do_a + buf * TILE * 2;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys × QB queries a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (T::FRAGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ka[e] = kf[kk][e], va[e] = vf[kk][e];
      } else {
        a_frag<D>(k_a, row0, kk, lane, ka);
        a_frag<D>(v_a, row0, kk, lane, va);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t f[4];
        b_frag_n<D>(qb, p, kk, lane, f);
        mma_bf16(s[2 * p], ka, f[0], f[1]);
        mma_bf16(s[2 * p + 1], ka, f[2], f[3]);
        b_frag_n<D>(dob, p, kk, lane, f);
        mma_bf16(dp[2 * p], va, f[0], f[1]);
        mma_bf16(dp[2 * p + 1], va, f[2], f[3]);
      }
    }

    // Pᵀ from each query's lse into s, dSᵀ = Pᵀ ∘ (dPᵀ − delta) into dp;
    // masked only in steps that cross an edge
    const float* lb = lse_s + buf * QB;
    const float* db = dl_s + buf * QB;
    const bool edge = q0 + QB > sq || k0 + BKV > skv || (causal && k0 + BKV - 1 > q0 + q_offset);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = t * 8 + 2 * tig + c;
        const float l2 = lb[col] * kLog2e, dlt = db[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          float p = exp2f(fmaf(s[t][e], scale_log2, -l2));
          if (edge) {
            const int qp = q0 + col, kp = kpos + 8 * r;
            if (qp >= sq || kp >= skv || (causal && kp > qp + q_offset)) p = 0.f;
          }
          s[t][e] = p;
          dp[t][e] = p * (dp[t][e] - dlt);
        }
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over this block's DC columns
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_from_acc<NT>(s, kk, pa);
      a_from_acc<NT>(dp, kk, da);
#pragma unroll
      for (int p = 0; p < DC / 16; ++p) {
        uint32_t f[4];
        b_frag_k<D>(dob, c0 / 8, p, kk, lane, f);
        mma_bf16(dv_acc[2 * p], pa, f[0], f[1]);
        mma_bf16(dv_acc[2 * p + 1], pa, f[2], f[3]);
        b_frag_k<D>(qb, c0 / 8, p, kk, lane, f);
        mma_bf16(dk_acc[2 * p], da, f[0], f[1]);
        mma_bf16(dk_acc[2 * p + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();                                     // this buffer may be refilled
  }
  cp_async_wait<0>();
  store_rows<CT>(dk + b * st.dk[0] + hk * st.dk[1], st.dk[2], k0 + row0, skv, c0, dk_acc, scale,
                 lane);
  store_rows<CT>(dv + b * st.dv[0] + hk * st.dv[1], st.dv[2], k0 + row0, skv, c0, dv_acc, 1.f,
                 lane);
}

// the kernels' strides from the wrapper's (q, k, v, o, dout, dq, dk, dv) × 3
inline BwdStrides bwd_strides(const long long* s) {
  BwdStrides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = s[3 * t + i];
  return st;
}

}  // namespace

// O = softmax(Q·Kᵀ·scale) V per (b, h), GQA, queries at the end of the keys.
// grid (q blocks of 64, Hq, B), loop = KV blocks of 64. `strides` holds the
// (batch, head, sequence) element strides of q, k, v and o in that order;
// the head dimension is contiguous. bf16 needs 16-byte aligned rows (base
// addresses and strides multiples of 8 elements); the wrapper checks. `lse`,
// when not null, receives each row's log-sum-exp, (B, Hq, Sq) fp32.
BSPS_EXPORT int bsps_flash(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                           void* stream, const void* q, const void* k, const void* v, void* o,
                           int hq, int hkv, int sq, int skv, int d, int q_offset, int causal,
                           float scale, int dtype, const long long* strides, float* lse) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gx < 1 || gy != hq || gz < 1 || loop < 1 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(d, [&](auto dk) {
    return launch<decltype(dk)::value>(device, grid, loop, scratch_bytes, s, q, k, v, o, lse, hq,
                                       hkv, sq, skv, q_offset, causal, scale, dtype, strides);
  });
}

// The flash kernel's compiled attributes at head dim d (an instantiated one)
// and dtype, as the CUDA runtime reports them: out[0] registers a thread,
// out[1] local (spilled) bytes a thread, out[2] dynamic shared memory a
// block, out[3] resident blocks an SM.
BSPS_EXPORT int bsps_flash_attrs(int device, int d, int dtype, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype != bsps::kBFloat16 && dtype != bsps::kFloat32) return cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto dk) {
    constexpr int D = decltype(dk)::value;
    return dtype == bsps::kBFloat16
               ? bsps::attrs(flash_fwd_mma<D>, device, kThreads, kSmemMma<D>, out)
               : bsps::attrs(flash_fwd_f32<D>, device, F32Tile<D>::kThreads, F32Tile<D>::SMEM, out);
  });
}

// The backward's pass A: dQ, and delta = rowsum(dO ∘ O) for pass B. grid (Q
// tiles of 64, Hq, B), loop = KV blocks of BwdTile<D>::NK keys; the plan's
// scratch is the dQ accumulator the warps keep in registers. `strides` holds
// the (batch, head, sequence) element strides of q, k, v, o, dout, dq, dk
// and dv in that order; rows 16-byte aligned (the wrapper checks).
BSPS_EXPORT int bsps_flash_bwd_dq(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                                  void* stream, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const float* lse, float* delta,
                                  void* dq, int hq, int hkv, int sq, int skv, int d, int q_offset,
                                  int causal, float scale, const long long* strides) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gy != hq || gz < 1 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto dk_) {
    constexpr int D = decltype(dk_)::value;
    using T = BwdTile<D>;
    if (scratch_bytes != BQ * D * 4 || gx != (sq + BQ - 1) / BQ || loop != (skv + T::NK - 1) / T::NK)
      return cudaErrorInvalidValue;  // plan and kernel disagree
    auto kernel = flash_bwd_dq<D>;
    cudaError_t e = bsps::prepare_smem(kernel, device, T::SMEM_A);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), kThreads, T::SMEM_A, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
        static_cast<bf16*>(dq), hq, hkv, sq, skv, q_offset, causal, scale * kLog2e, scale, loop,
        bwd_strides(strides));
    return cudaGetLastError();
  });
}

// The backward's pass B: dK and dV from pass A's delta. grid (KV blocks of
// 64, Hkv, B), loop = the group's query heads × Q tiles of BwdTile<D>::QB;
// the plan's scratch is the dK and dV accumulators. Above D 128 the launch
// runs BwdTile<D>::NSPLIT blocks a KV block, each over its share of the
// columns. Strides as for pass A.
BSPS_EXPORT int bsps_flash_bwd_dkv(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                                   void* stream, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int hq, int hkv, int sq, int skv, int d,
                                   int q_offset, int causal, float scale,
                                   const long long* strides) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gy != hkv || gz < 1 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto dk_) {
    constexpr int D = decltype(dk_)::value;
    using T = BwdTile<D>;
    const int n_q = (sq + T::QB - 1) / T::QB;
    if (scratch_bytes != 2 * BKV * D * 4 || gx != (skv + BKV - 1) / BKV || loop != hq / hkv * n_q)
      return cudaErrorInvalidValue;  // plan and kernel disagree
    auto kernel = flash_bwd_dkv<D>;
    cudaError_t e = bsps::prepare_smem(kernel, device, T::SMEM_B);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx * T::NSPLIT, gy, gz), kThreads, T::SMEM_B,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), hq, hkv, sq, skv, q_offset, causal, scale * kLog2e, scale, n_q,
        bwd_strides(strides));
    return cudaGetLastError();
  });
}

// The backward kernels' compiled attributes at head dim d (an instantiated
// one): pass 0 is pass A (flash_bwd_dq), 1 pass B (flash_bwd_dkv); out as
// for bsps_flash_attrs.
BSPS_EXPORT int bsps_flash_bwd_attrs(int device, int d, int pass, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (pass != 0 && pass != 1) return cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto dk_) {
    constexpr int D = decltype(dk_)::value;
    return pass == 0 ? bsps::attrs(flash_bwd_dq<D>, device, kThreads, BwdTile<D>::SMEM_A, out)
                     : bsps::attrs(flash_bwd_dkv<D>, device, kThreads, BwdTile<D>::SMEM_B, out);
  });
}

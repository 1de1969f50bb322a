// BSPS block-streamed matmul (paper §3.2, the outer level) on Hopper.
//
// Replaces: src/repro/kernels/streamed_matmul.py:44 (_matmul_kernel), the
// Pallas kernel over grid (i, j, k) = (parallel, parallel, arbitrary) whose
// fp32 accumulator tile is carried across the K stream in VMEM scratch and
// cast to the output dtype on the last K step.
//
// Bound on this card: at decode (m = 4 rows) bytes — the call reads the whole
// weight matrix to do 8 FLOPs per weight, so it is bounded by device memory;
// at prefill (m = 1024) operations, on the bf16 tensor cores; fp32 operands
// (Cannon's local product, 4096³) operations, on the fp32 FMA pipes.
//
// The K stream is a loop inside the block, as the plan's "arbitrary" axis
// says; ragged edges are masked in the kernel (no padding copies). Operands
// are bf16 for five variants and fp32 for simt_f32; other dtypes are
// refused. Six variants (the wrapper's variant_for picks one from the
// dtype, shapes, strides and alignment; `variant` names it here):
//
// decode — m ≤ 16 when TMA can describe B (base 16-byte aligned, rows a
// multiple of 16 bytes apart) and A's K share fits the block: a GEMV-like
// product bounded by the weight bytes, so the design keeps the memory busy.
// Each block takes a 128-column tile of B and one K share. A producer warp
// streams the share in stages of 64 k-rows × 128 columns (two 64-column TMA
// boxes side by side, 16 KB; rows of 256 contiguous bytes) into a 4-stage
// 128-byte-swizzled ring with full/empty mbarriers: 64 KB in flight per
// block, two or three blocks per SM, no register staging and no block-wide
// barrier per K step. The tensor cores compute Cᵀ = Bᵀ·Aᵀ with mma.sync m16n8k16:
// the weight columns are the 16-row operand (ldmatrix.trans from the
// swizzled stage), the ≤ 16 activation rows the 8-wide side (one or two n8
// tiles), read as 32-bit pairs from the block's K share of A, which four
// consumer warps load once into shared memory while the first boxes fly.
// With kBRowsN, B is given as (n, k) rows: a stage is two 64 × 64 boxes of
// 64 weight columns (n) by 64 k, and ldmatrix reads them without .trans —
// the weight columns already lie along the rows of the 16-row operand. The
// output's row stride may be odd (the tied head's vocabulary): stores are
// element by element.
// K is split over a thread-block cluster (up to 8, along x): each block
// leaves its fp32 partial tile in its own shared memory, and after a cluster
// barrier every block sums its share of the tile's elements over ranks
// 0, 1, .., splits-1 in that order through distributed shared memory and
// stores it: one launch, no partial tensor, no atomics, deterministic.
//
// decode_deep — m ≤ 16 when TMA can describe B but A's K share does not fit
// a decode block (the deep-K products: nemotron-4-340b's down projection at
// K = 73728, and at 9-16 rows any K past 15872). The decode kernel with A
// streamed instead of held: each ring stage also holds A's m × 64 slice of
// its K tile (rows 144 bytes apart, 1 or 2 KB a stage), which the producer
// warp's 32 lanes copy with 16-byte cp.async (plain loads where A's rows are
// not 16-byte aligned) and hand to the stage's full barrier beside the
// TMA's bytes. So k is unbounded and a block's shared memory is the same
// at every k (70 or 75 KB: three blocks an SM); the products, the cluster
// split and its sum in rank order are the decode variant's, one launch.
//
// wgmma — m > 16 when TMA can describe both operands (the forward and the
// prefill). A 128×128 output tile per block, K streamed 64 at a time through
// a 4-stage ring of shared-memory stages (32 KB each: A 128×64 and B 64×128
// as two 64×64 boxes), all with the 128-byte swizzle. One producer thread
// issues TMA loads (cp.async.bulk.tensor.2d) into the stages, which report
// to full/empty mbarriers; two consumer warpgroups of 64 rows each run
// wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate) on the stages that
// have arrived, keeping one group of products in flight before they release
// a stage. setmaxnreg moves registers from the producer warpgroup (40) to
// the consumers (232). The plan's 128×128 fp32 accumulator tile lives in the
// consumers' registers (64 a thread), never in shared memory; the launch
// checks its size. TMA zero-fills boxes past the ragged m, n and k edges;
// the epilogue casts and masks the ragged output edge as it stores from the
// registers. Operand layouts (`layout` bits): A is K-major — (m, k) rows —
// or, with kAColMajor, M-major — given as its (k, m) transpose, read in two
// 64 × 64 boxes per stage and fed with the descriptor's A transpose bit (the
// weight gradient Aᵀ·dC reads the activations this way, with no copy); B is
// MN-major — the (k, n) row-major weight, two 64 × 64 boxes, the B transpose
// bit — or, with kBRowsN, K-major — given as (n, k) rows, one 128 × 64 box,
// no transpose bit (the tied LM head x·Eᵀ and the input gradient dC·Wᵀ read
// their operand this way, with no copy). Blocks walk the tiles in groups
// of 8 m-tiles, so the blocks in flight share B's column panels in the L2.
// No split-K, no persistent scheduler. The tensor maps are encoded per call
// on the host (the activations move) with cuTensorMapEncodeTiled, looked
// up through the runtime's entry-point query: nothing links against
// libcuda.
//
// wgmma_cp — m > 16 in the default layouts when TMA cannot describe A or B
// (a base address or a row stride not 16-byte aligned: an odd vocabulary or
// width, a column slice of a wider tensor, a view one element into its
// buffer). wgmma's kernel with producers that copy instead of TMA: two
// producer warpgroups (256 threads) write each stage's bytes at the
// addresses the TMA boxes would (A 128 rows × 64 k, B two 64 × 64 MN-major
// boxes, the 128-byte swizzle, zeros past the ragged m, n and k edges) by
// TileCopy, and the consumers, their tile walk and their products are
// wgmma's: on operands both can take, the two give the same bits. The stage
// is written through the generic proxy and read by wgmma through the async
// proxy, so a proxy fence stands between (matmul_wgmma says where). The
// words a realigned operand's chunks are shifted out of are staged in shared
// memory past the ring, copied four stages ahead (90 KB beside the 128 KB
// ring); the 512 threads keep 128 registers each (no setmaxnreg). One
// launch, no split, no partial tensor.
//
// decode_cp — m ≤ 16 when TMA cannot describe B. decode_deep's kernel (A
// streamed beside B, the consumers, the cluster split of the wrapper's
// deep_split and its sum in rank order) with four producer warps that copy
// B's 64 k-rows × 128 columns into the stage's two swizzled boxes by
// TileCopy, beside A's slice. The consumers read the stage with ldmatrix,
// through the generic proxy as the copies write it, so no proxy fence. On a
// B both can take it gives decode_deep's bits.
//
// simt_f32 — fp32 operands at any m, in all three layouts: exact fp32 FMAs
// with fp32 accumulation, no TF32 and no tensor-core emulation (the
// reference multiplies fp32 operands with preferred_element_type=f32, and
// the plain version is full fp32), so it is bounded by the 67 TFLOP/s of
// the fp32 FMA pipes, and every instruction that is not an FFMA takes an
// issue slot from them. A 256×128 output tile per block; K streamed 32 at a
// time through a 3-stage ring of shared-memory stages (A and B both stored
// k-major, rows padded by 8 floats), filled by cp.async from a producer
// warpgroup and handed over through full/empty mbarriers
// (cp.async.mbarrier.arrive), so the two consumer warpgroups run no copy
// instruction, no address arithmetic and no block-wide barrier: their loop
// is 128 FFMAs and 6 LDS.128 per k. Each consumer lane owns a 16×8 register
// tile (float4 pieces 32 rows and 16 columns apart in a warp's 128×32
// tile: each LDS.128 of a warp reads 128 or 64 contiguous bytes). An
// operand stored with k contiguous (A as (m, k), B as (n, k)) goes into its
// k-major tile by 4-byte copies that transpose on the way, 8 rows by 4 k a
// warp instruction, conflict-free; an operand stored with m or n contiguous
// by 16-byte copies where its row stride and base allow, else 4-byte ones.
// Ragged edges are zero-filled by the copies and masked at the store. Each
// output sums its K terms in ascending k, one FMA each, from 0: no split-K,
// no atomics, so its bits do not depend on m, the tile or the launch. The
// plan's 256×128 fp32 accumulator lives in registers; the launch checks its
// size. Tiles are walked in groups of 8 m-tiles, as wgmma's.

#include <cuda.h>

#include "common.cuh"

namespace {

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

// -- the wgmma variant ------------------------------------------------------------------

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, GROUP_M = 8;
constexpr int kThreads = 384;                 // consumer warpgroups 0-1, producer 2
constexpr int kCpThreads = 512;               // CP: consumer warpgroups 0-1, copy producers 2-3
constexpr int A_BYTES = BM * BK * 2;          // 16 KB: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;            // 8 KB: 64 k-rows of 64 columns
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;  // + alignment, barriers
// CP: staged rows of the realigned operands, 5 stages of one operand's or 2
// of both (A's 128 rows of 9 words, B's 64 of 17), past the barriers
constexpr int RAW_A = BM * (BK / 8 + 1) * 16, RAW_B = BK * (BN / 8 + 1) * 16;
constexpr int RAW_AT = 128;
constexpr int CP_SMEM = SMEM + RAW_AT + 5 * RAW_A;
static_assert(RAW_A >= RAW_B && 2 * (RAW_A + RAW_B) <= 5 * RAW_A, "the staged slots fit");
constexpr int SCRATCH = BM * BN * 4;          // the plan's accumulator: in registers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the phase of parity `parity` has completed. A phase that
// never completes (a lost copy) traps after about 2^26 polls, seconds of
// waiting, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 inner, c1 outer) of `map` into shared memory at `dst`,
// completing `bytes` of transaction on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// cp.async of 16 bytes from global to shared memory: `bytes` (at most 16)
// are read, the rest is zero-filled; `src` is 16-byte aligned. No memory
// clobber: the consumers' shared reads of other stages may move across it.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
// cp_async16 when `pred`
__device__ __forceinline__ void cp_async16_if(uint32_t dst, const void* src, int bytes, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %3, 0;\n"
      "@q cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
      "}\n" ::"r"(dst), "l"(src), "r"(bytes), "r"((int)pred));
}
__device__ __forceinline__ void st_shared(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
// 16 bytes to shared address `dst` when `pred`
__device__ __forceinline__ void st_shared_if(uint32_t dst, uint4 v, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %5, 0;\n"
      "@q st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
      "}\n" ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)pred)
      : "memory");
}
// the mbarrier at `bar` counts one arrival once this thread's earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// returns once at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint4 ld_shared(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// orders this thread's generic-proxy shared-memory accesses before (or
// after) its async-proxy ones: wgmma reads its operands through the async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// whether every 16-byte chunk of a bf16 matrix at `p` with rows `ld`
// elements apart starts 16-byte aligned
inline bool vec16(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

// The 16 bytes at byte `off` (2 .. 14, even) of the 32 bytes lo:hi, by
// selects and funnel shifts: no register array is indexed at run time.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, uint32_t off) {
  const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t t[6], v[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) t[j] = (off & 8) ? u[j + 2] : u[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) v[j] = (off & 4) ? t[j + 1] : t[j];
  const uint32_t sh = (off & 2) * 8;                      // 0 or 16 bits
  return make_uint4(__funnelshift_r(v[0], v[1], sh), __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh), __funnelshift_r(v[3], v[4], sh));
}
// the mask of a chunk's first `valid` (0 .. 8) bf16 elements
__device__ __forceinline__ uint4 keep_mask(int valid) {
  auto word = [valid](int e) { return e + 2 <= valid ? ~0u : e + 1 == valid ? 0xffffu : 0u; };
  return make_uint4(word(0), word(2), word(4), word(6));
}
__device__ __forceinline__ uint4 shfl_down(uint4 x, int width) {
  return make_uint4(__shfl_down_sync(~0u, x.x, 1, width), __shfl_down_sync(~0u, x.y, 1, width),
                    __shfl_down_sync(~0u, x.z, 1, width), __shfl_down_sync(~0u, x.w, 1, width));
}
__device__ __forceinline__ uint4 shfl(uint4 x, int lane) {
  return make_uint4(__shfl_sync(~0u, x.x, lane), __shfl_sync(~0u, x.y, lane),
                    __shfl_sync(~0u, x.z, lane), __shfl_sync(~0u, x.w, lane));
}
// the 16 bytes at `p` (16-byte aligned) when `pred`, else zeros. Volatile:
// a batch's loads are all issued, in order, before the first is used.
__device__ __forceinline__ uint4 ld16_if(const void* p, bool pred) {
  uint4 v = make_uint4(0, 0, 0, 0);
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %4, 0;\n"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%5];\n"
      "}\n"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "r"((int)pred), "l"(p));
  return v;
}

// One operand's share of the copy producers' stages (wgmma_cp, decode_cp),
// where TMA cannot describe it. For stage t, threads pt = 0 .. T-1 copy the
// tile of R rows × 8·W columns of the row-major bf16 matrix g (rows × cols,
// rows ld elements apart) at (row0 + t·DR, col0 + t·DC) to the bytes the TMA
// boxes would write from shared address `tile`: W / 8 boxes of 64 columns
// side by side, box x at tile + x·R·128, row r of a box at r·128 and its
// 16-byte chunk c at (c ^ r % 8)·16 (the 128-byte swizzle), zeros past the
// matrix's rows and columns. W lanes of a warp take one row, lane c its
// chunk c, so a row's lanes read contiguous bytes; a pass of the T threads
// takes ROWS = T / W rows, so a thread's chunks lie ROWS rows apart at every
// pass and stage, in the same swizzle slot (ROWS is a multiple of 8), and
// each row's offset from 16-byte alignment is the same at every stage (DR
// and DC are multiples of 8): the constructor computes them once.
// A chunk whose address is 16-byte aligned (with `vec` every chunk is) is
// one cp.async, zero-filled past the last column. Any other chunk is shifted
// out of the two aligned 16-byte words under it in registers, its elements
// past the last column zeroed, and stored by one st.shared.v4. The words
// come one of two ways:
// - staged (issue_rows, land_rows; wgmma_cp): every row of the tile, aligned
//   or not, is copied as W + 1 aligned words from the one under its first
//   chunk by cp.async into `raw`, stages ahead, the words spread flat over
//   the T threads so that no cp.async is issued predicated off; once they
//   have landed, lane c shifts its chunk out of its row's words c and c + 1.
//   No register holds a word in flight.
// - in registers (issue, land; decode_cp, whose blocks have no shared memory
//   to spare): lane c loads the word under its chunk's start, takes the
//   next from lane c + 1, which loads it as its own, by a shuffle; the word
//   after a row's last chunk is loaded by one lane of the warp per row of
//   the stage (lane j: pass j / (32 / W), the warp's row j % (32 / W)) and
//   shuffled to the row's last lane. A stage's words fly at once, in w and
//   x; land realigns LB passes' chunks side by side.
// A word is read only when it holds an element of the matrix, so it lies on
// the operand's pages; its other bytes never reach the tile.
template <int T, int R, int W, int DR, int DC, int LB = 4>
struct TileCopy {
  static constexpr int ROWS = T / W, PASSES = R / ROWS, SEGS = 32 / W;
  static_assert(32 % W == 0 && R % ROWS == 0 && ROWS % 8 == 0 && PASSES <= 8 &&
                    PASSES * SEGS <= 32 && DR % 8 == 0 && DC % 8 == 0 && PASSES % LB == 0,
                "bad copy tile");
  const raw16* g;
  const raw16* src;        // the thread's chunk at pass 0 of stage 0
  const raw16* xsrc;       // the last chunk of the row whose end word the lane reads, stage 0
  const raw16* org;        // the tile's first element, stage 0
  long long ld;
  int row0, cols0;         // the tile's first row, and the matrix's columns from its first, stage 0
  int rows, row, xrow;     // the matrix's rows; the rows of src and xsrc
  int left, xleft;         // the matrix's columns from src's and from xsrc's chunk on
  uint32_t dst;            // src's chunk in the tile
  uint32_t raw_at;         // src's word in the staged rows
  uint32_t offs, xoff;     // each pass's row's (4 bits a pass) and xsrc's row's byte offset
  bool vec, xlane;         // every chunk aligned; the lane reads a row-end word

  __device__ __forceinline__ TileCopy(const raw16* g_, long long ld_, int rows_, int cols,
                                      int row0_, int col0, bool vec_, int pt)
      : g(g_), org(g_ + (long long)row0_ * ld_ + col0), ld(ld_), row0(row0_),
        cols0(cols - col0), rows(rows_), vec(vec_) {
    const int lane = pt % 32, c = pt % W;
    row = row0 + pt / W;
    left = cols - (col0 + 8 * c);
    src = g + (long long)row * ld + col0 + 8 * c;
    dst = (c / 8) * (R * 128) + (pt / W) * 128 + (((c % 8) ^ ((pt / W) % 8)) << 4);
    raw_at = ((pt / W) * (W + 1) + c) * 16;
    const uint32_t base = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(g)) + 2 * col0;
    auto skew = [&](int r) { return (base + 2 * static_cast<uint32_t>(r * ld)) & 15; };
    offs = 0;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) offs |= skew(row + p * ROWS) << (4 * p);
    xlane = lane < PASSES * SEGS;
    xrow = row0 + (lane / SEGS) * ROWS + (pt - lane) / W + lane % SEGS;
    xleft = cols - (col0 + 8 * (W - 1));
    xsrc = g + (long long)xrow * ld + col0 + 8 * (W - 1);
    xoff = skew(xrow);
  }
  __device__ __forceinline__ long long stage_step() const { return DR * ld + DC; }

  // stage t's cp.async copies of every chunk (vec)
  __device__ __forceinline__ void issue_vec(uint32_t tile, int t) const {
    const raw16* s = src + t * stage_step();
    const int r = row + t * DR, v = max(0, min(8, left - t * DC));
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const bool in = r + p * ROWS < rows && v > 0;
      cp_async16(tile + dst + p * ROWS * 128, in ? s + p * ROWS * ld : g, in ? 2 * v : 0);
    }
  }
  // stage t's rows as staged words: the R · (W + 1) aligned 16-byte words
  // from the one under each row's first chunk, row by row into `raw`, one
  // cp.async each, spread flat over the T threads (a word past the matrix's
  // rows or columns is zero-filled, not read)
  __device__ __forceinline__ void issue_rows(uint32_t raw, int t) const {
    constexpr int WORDS = R * (W + 1);
    const int pt = threadIdx.x % T, cols_t = cols0 - t * DC;
    const raw16* o = org + t * stage_step();
#pragma unroll
    for (int i = 0; i < (WORDS + T - 1) / T; ++i) {
      const int f = i * T + pt;
      if (WORDS % T != 0 && f >= WORDS) break;
      const int rr = f / (W + 1), wd = f % (W + 1);
      const uintptr_t start = reinterpret_cast<uintptr_t>(o + rr * ld);
      const int lead = static_cast<int>(start & 15) / 2;   // elements of the word before the row
      const bool copy = row0 + t * DR + rr < rows && 8 * wd - lead < cols_t;
      cp_async16(raw + f * 16,
                 copy ? reinterpret_cast<const void*>((start & ~uintptr_t(15)) + 16 * wd) : g,
                 copy ? 16 : 0);
    }
  }
  // stage t's chunks from the words issue_rows staged in `raw`, once they
  // have landed: each shifted out of its row's words c and c + 1, zero past
  // the matrix's rows and columns
  __device__ __forceinline__ void land_rows(uint32_t tile, uint32_t raw, int t) const {
    const int r = row + t * DR;
    const uint4 mask = keep_mask(max(0, min(8, left - t * DC)));
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const uint32_t at = raw + raw_at + p * ROWS * (W + 1) * 16;
      const uint4 o = realign(ld_shared(at), ld_shared(at + 16), (offs >> (4 * p)) & 15);
      const bool in = r + p * ROWS < rows;
      st_shared(tile + dst + p * ROWS * 128,
                in ? make_uint4(o.x & mask.x, o.y & mask.y, o.z & mask.z, o.w & mask.w)
                   : make_uint4(0, 0, 0, 0));
    }
  }
  // stage t's cp.async copies of its aligned chunks and the words of the others
  __device__ __forceinline__ void issue(uint32_t tile, int t, uint4 (&w)[PASSES], uint4& x) const {
    const raw16* s = src + t * stage_step();
    const int r = row + t * DR, lt = left - t * DC, v = max(0, min(8, lt));
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const uint32_t off = (offs >> (4 * p)) & 15;
      const bool in = r + p * ROWS < rows;
      const raw16* chunk = s + p * ROWS * ld;
      cp_async16_if(tile + dst + p * ROWS * 128, in && v > 0 ? chunk : g,
                    in && v > 0 ? 2 * v : 0, off == 0 || !in);
      // the aligned word under the chunk holds the row's elements from off / 2 before it on
      w[p] = ld16_if(chunk - off / 2, off != 0 && in && lt + (int)off / 2 > 0);
    }
    x = ld16_if(xsrc + t * stage_step() - xoff / 2 + 8,
                xlane && xoff != 0 && xrow + t * DR < rows && xleft - t * DC + (int)xoff / 2 > 8);
  }
  // stage t's realigned chunks from the words issue read: LB passes' chunks
  // computed side by side, then stored where the row needs it
  __device__ __forceinline__ void land(uint32_t tile, int t, const uint4 (&w)[PASSES],
                                       uint4 x) const {
    const int lane = threadIdx.x % 32, c = lane % W, r = row + t * DR;
    const uint4 mask = keep_mask(max(0, min(8, left - t * DC)));
#pragma unroll
    for (int p0 = 0; p0 < PASSES; p0 += LB) {
      uint4 out[LB];
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int p = p0 + i;
        const uint4 next = shfl_down(w[p], W), end = shfl(x, p * SEGS + lane / W);
        const uint4 o = realign(w[p], c == W - 1 ? end : next, (offs >> (4 * p)) & 15);
        out[i] = make_uint4(o.x & mask.x, o.y & mask.y, o.z & mask.z, o.w & mask.w);
      }
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int p = p0 + i;
        st_shared_if(tile + dst + p * ROWS * 128, out[i],
                     ((offs >> (4 * p)) & 15) != 0 && r + p * ROWS < rows);
      }
    }
  }
};

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 fp32 a thread) += A (64×16) · B (16×128); TA = 1: A M-major (else
// K-major), TB = 1: B MN-major (else K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// orders the compiler's accesses of the accumulator against the async products
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (second) p[1] = y;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16(x);
    if (second) p[1] = __float2bfloat16(y);
  }
}

template <int D>
struct Depth {
  static constexpr int value = D;
};

// A's stage holds rows group·64 .. +64 of the tile at group · 8 KB in both
// layouts: K-major, 64 rows of 128 bytes; M-major, the group's 64 × 64 box.
// CP (wgmma_cp, default layouts only): two producer warpgroups (256 threads)
// fill each stage by TileCopy from a and b (rows lda and ldb apart, k deep;
// a_vec, b_vec: every chunk 16-byte aligned) instead of TMA from the tensor
// maps, which are then unused. Each thread arrives on the stage's full
// barrier when its cp.async copies have landed; where an operand is
// realigned, each producer warp also arrives once after its lanes' stores
// (__syncwarp, then lane 0). A realigned operand's words are staged four
// stages ahead in shared memory past the ring (one stage ahead when both
// are realigned), so no register holds a word in flight; each chunk's shifts
// and selects are the producers' work, shared by 256 threads; the 512
// threads keep 128 registers each (no setmaxnreg).
template <typename Out, bool AT, bool BKM, bool CP>
__global__ void __launch_bounds__(CP ? kCpThreads : kThreads, 1)
matmul_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             const raw16* __restrict__ a, const raw16* __restrict__ b, long long lda,
             long long ldb, int k, int a_vec, int b_vec, Out* __restrict__ c, int m, int n,
             long long ldc, int k_tiles) {
  static_assert(!CP || (!AT && !BKM), "the copy producer takes the default layouts");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle wants 1 KB
  const uint32_t full = ring + STAGES * STAGE_BYTES;            // full[s]: full + 8 s
  const uint32_t empty = full + STAGES * 8;                     // empty[s]: empty + 8 s
  const int tid = threadIdx.x, group = tid / 128;

  // tile of this block: the grid's blocks walk the tiles in groups of
  // GROUP_M m-tiles, m fastest, so the blocks in flight share B's panels
  const int tiles_n = gridDim.x, tiles_m = gridDim.y;
  const int lin = blockIdx.y * tiles_n + blockIdx.x, per_group = GROUP_M * tiles_n;
  const int first_m = lin / per_group * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + lin % per_group % gm) * BM;
  const int n0 = lin % per_group / gm * BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect_tx, or a copy thread's cp.async (+ a warp's stores)
      mbar_init(full + 8 * s, !CP ? 1 : a_vec && b_vec ? 256 : 256 + 8);
      mbar_init(empty + 8 * s, 2);                   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group >= 2 && CP) {                            // producers: copies, 256 threads
    const int pt = tid - 256;
    using CopyA = TileCopy<256, BM, BK / 8, 0, BK>;
    using CopyB = TileCopy<256, BK, BN / 8, BK, 0>;
    const CopyA ca(a, lda, m, k, m0, 0, a_vec, pt);
    const CopyB cb(b, ldb, k, n, 0, n0, b_vec, pt);
    const uint32_t raw0 = full + RAW_AT;
    auto stage = [&](int t) { return ring + (t % STAGES) * STAGE_BYTES; };
    // stage t, once the consumers have freed it: the aligned operands by
    // cp.async into the ring; each thread arrives on full[t] when its copies
    // land
    auto open = [&](int t) {
      if (t >= STAGES) mbar_wait(empty + 8 * (t % STAGES), (t / STAGES - 1) & 1);
      if (a_vec) ca.issue_vec(stage(t), t);
      if (b_vec) cb.issue_vec(stage(t) + A_BYTES, t);
      cp_async_arrive(full + 8 * (t % STAGES));
    };
    // the realigned operands' rows are staged E stages ahead of the stage
    // being realigned, whatever the ring's state, in E + 1 slots. Turn t of
    // the loop: open stage t; wait for this thread's words of stage t (one
    // cp.async group a stage, committed E turns before, so all but the E - 1
    // newest groups); bar.sync the producers, so every producer's words of
    // stage t are visible and every producer has read slot t - 1; refill
    // that slot with stage t + E's words; realign stage t.
    auto stream = [&](auto depth) {
      constexpr int E = decltype(depth)::value;
      const uint32_t slot_bytes = E == 4 ? RAW_A : RAW_A + RAW_B;
      auto raw_a = [&](int t) { return raw0 + (t % (E + 1)) * slot_bytes; };
      auto raw_b = [&](int t) { return raw_a(t) + (E == 4 ? 0 : RAW_A); };
      auto words = [&](int t) {
        if (t < k_tiles) {
          if (!a_vec) ca.issue_rows(raw_a(t), t);
          if (!b_vec) cb.issue_rows(raw_b(t), t);
        }
        cp_async_commit();
      };
      for (int t = 0; t < E; ++t) words(t);
      for (int t = 0; t < k_tiles; ++t) {
        open(t);
        cp_async_wait<E - 1>();                      // this thread's words of stage t
        asm volatile("bar.sync 1, 256;\n" ::: "memory");   // and every producer's
        words(t + E);
        if (!a_vec) ca.land_rows(stage(t), raw_a(t), t);
        if (!b_vec) cb.land_rows(stage(t) + A_BYTES, raw_b(t), t);
        __syncwarp();                                // the warp's stores
        if (tid % 32 == 0) mbar_arrive(full + 8 * (t % STAGES));
      }
    };
    if (a_vec && b_vec) {
      for (int t = 0; t < k_tiles; ++t) open(t);
    } else if (a_vec || b_vec) {
      stream(Depth<4>());                            // one operand staged: 5 slots
    } else {
      stream(Depth<1>());                            // both: 2 slots
    }
    cp_async_wait_all();
  } else if (group == 2) {                           // producer: the TMA stream
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int t = 0; t < k_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t st = ring + s * STAGE_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE_BYTES);
        if (AT) {
          tma_load(st, &ta, bar, m0, t * BK);
          tma_load(st + A_BYTES / 2, &ta, bar, m0 + 64, t * BK);
        } else {
          tma_load(st, &ta, bar, t * BK, m0);
        }
        if (BKM) {
          tma_load(st + A_BYTES, &tb, bar, t * BK, n0);
        } else {
          tma_load(st + A_BYTES, &tb, bar, n0, t * BK);
          tma_load(st + A_BYTES + B_BOX, &tb, bar, n0 + 64, t * BK);
        }
      }
    }
  } else {                                           // consumers: rows group·64 .. +64
    if (!CP) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_regs(d);
    for (int t = 0; t < k_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      // CP: the stage was written through the generic proxy (cp.async and
      // st.shared) and wgmma reads it through the async proxy. The fence
      // stands after the wait, on the path from every write of the stage to
      // this warpgroup's products: the cp.async writes reach the consumers
      // only through the barrier, so the producer cannot fence them itself.
      if (CP) fence_proxy_async();
      const uint32_t sa = ring + s * STAGE_BYTES + group * (64 * 128);
      const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major (A, or B given as (n, k)): 16 k = 32 bytes along the
        // swizzled 128-byte rows, 8-row groups 1 KB apart (SBO). MN-major
        // (B given as (k, n), or A as (k, m)): 16 k = 16 rows of 128 bytes;
        // 8-row groups 1 KB apart (SBO), 64-column boxes 8 KB apart (LBO).
        const uint64_t da = AT ? desc(sa + kk * 2048, B_BOX, 1024) : desc(sa + kk * 32, 16, 1024);
        const uint64_t db = BKM ? desc(sb + kk * 32, 16, 1024) : desc(sb + kk * 2048, B_BOX, 1024);
        wgmma_m64n128k16<AT ? 1 : 0, BKM ? 0 : 1>(d, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();                               // the previous tile's products are done
      if (t > 0 && tid % 128 == 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(d);

    // epilogue: lane (g, q) of warp w holds rows w·16 + g and + 8, columns
    // 8 j + 2 q and + 1 of every 8-column slice j
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row = m0 + group * 64 + warp * 16 + lane / 4;
    const bool even = (ldc & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= n) continue;
      const bool pair = even && col + 1 < n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < m)
          store2(c + (long long)r * ldc + col, d[4 * j + 2 * h], d[4 * j + 2 * h + 1], pair,
                 col + 1 < n);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 matrix with row stride `ld` elements, read
// in boxes of box_rows × box_cols (box_cols · 2 = 128 bytes), 128-byte swizzle
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int rows, int cols,
            long long ld, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// CP: wgmma_cp, whose producer copies from a and b; no tensor map is encoded
template <typename Out, bool AT, bool BKM, bool CP>
cudaError_t launch(int device, dim3 grid, int k_tiles, int scratch_bytes, cudaStream_t stream,
                   const void* a, const void* b, void* c, int m, int n, int k, long long lda,
                   long long ldb, long long ldc) {
  if (scratch_bytes != SCRATCH || grid.z != 1) return cudaErrorInvalidValue;
  CUtensorMap ta = {}, tb = {};
  if (!CP) {
    EncodeTiled enc = encoder();
    if (enc == nullptr) return cudaErrorSymbolNotFound;
    const bool a_ok = AT ? encode(enc, &ta, a, k, m, lda, BK, 64)
                         : encode(enc, &ta, a, m, k, lda, BM, BK);
    const bool b_ok = BKM ? encode(enc, &tb, b, n, k, ldb, BN, BK)
                          : encode(enc, &tb, b, k, n, ldb, BK, 64);
    if (!a_ok || !b_ok) return cudaErrorInvalidValue;
  }
  auto kernel = matmul_wgmma<Out, AT, BKM, CP>;
  cudaError_t err = bsps::prepare_smem(kernel, device, CP ? CP_SMEM : SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, CP ? kCpThreads : kThreads, CP ? CP_SMEM : SMEM, stream>>>(
      ta, tb, static_cast<const raw16*>(a), static_cast<const raw16*>(b), lda, ldb, k,
      vec16(a, lda), vec16(b, ldb), static_cast<Out*>(c), m, n, ldc, k_tiles);
  return cudaGetLastError();
}

}  // namespace wg

// -- the decode variant (m ≤ 16) ----------------------------------------------------------

namespace gv {

constexpr int NB = 2;                         // 64-column TMA boxes side by side per stage
constexpr int BN = 64 * NB, BK = 128 / NB, STAGES = 4;
constexpr int kConsumers = 4;                 // warps 0-3 run the products, warp 4 the TMA stream
constexpr int kCopyWarps = 4;                 // CP: warps 4-7 copy the weight stream
// the block's threads: 4 consumer warps and 1 producer warp, or (CP) 4 copy warps
template <bool CP>
__host__ __device__ constexpr int threads() { return 32 * (kConsumers + (CP ? kCopyWarps : 1)); }
constexpr int BOX_BYTES = BK * 128;           // BK k-rows of 64 columns (128 B)
constexpr int STAGE_BYTES = NB * BOX_BYTES;   // 16 KB
constexpr int RING = STAGES * STAGE_BYTES;    // 64 KB of weights in flight per block
constexpr int CG = NB;                        // 16-column groups per consumer warp
constexpr int MAX_SPLIT = 8;                  // the portable cluster size
constexpr int A_PAD = 8;                      // bf16 past each A row: rows 4 banks apart
constexpr int A_ROW = BK + A_PAD;             // DEEP: a stage's A slice row (elements)

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster; orders shared-memory accesses across it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the float at shared address `addr` of the cluster's block `rank`
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}
// four 8×8 bf16 matrices: lanes 8i .. 8i+7 give the row addresses of matrix
// i, which lands in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// the same, transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d (16×8 fp32) += a (16×16 bf16, row-major) · b (16×8 bf16, column-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes of A the block holds: its whole K share of m rows (decode), or
// (DEEP) one 8·NT-row slice of BK k per ring stage
template <int NT, bool DEEP>
__host__ __device__ __forceinline__ int a_bytes(int m, int per) {
  return DEEP ? STAGES * 8 * NT * A_ROW * 2 : m * (per * BK + A_PAD) * 2;
}

// DEEP: lane `lane` of the producer warp's share of the copies of A's
// m × BK slice at k0 into the stage's slice at shared address `dst` (rows
// A_ROW apart), zero past k; rows at or past m are not written (their
// consumer lanes use 0). With a_vec (A's base and rows 16-byte aligned)
// 16-byte cp.async copies whose completion the lane hands to the stage's
// full barrier; else plain loads and stores, then the lane's arrival.
__device__ __forceinline__ void stage_a(uint32_t dst, const raw16* __restrict__ a,
                                        long long lda, int m, int k, int k0, bool a_vec,
                                        int lane, uint32_t full) {
  for (int ch = lane; ch < m * (BK / 8); ch += 32) {
    const int r = ch / (BK / 8), col = (ch % (BK / 8)) * 8;
    const uint32_t d = dst + (r * A_ROW + col) * 2;
    if (a_vec) {
      const int bytes = max(0, min(16, 2 * (k - k0 - col)));
      wg::cp_async16(d, a + (long long)r * lda + (bytes > 0 ? k0 + col : 0), bytes);
    } else {
      const uint4 v = load8(a, lda, m, k, r, k0 + col);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d), "r"(v.x),
                   "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
  if (a_vec)
    wg::cp_async_arrive(full);
  else
    wg::mbar_arrive(full);
}

// Cᵀ = Bᵀ·Aᵀ: the weight columns fill the 16 rows of m16n8k16, the ≤ 8·NT
// activation rows its N side. Block (rank, j) of a cluster of `splits`
// along x streams K tiles [rank·per, rank·per + per) of column tile j.
// BKM: B is given as (n, k) rows (a stage's box bx holds weight columns
// n0 + 64·bx .. +64 as 64 rows of 64 k); else as (k, n) rows (box bx holds
// 64 k-rows of those 64 columns).
// DEEP (decode_deep): A is streamed beside B instead of held whole — each
// ring stage also holds A's m × 64 slice of its K tile, copied by the
// producer warp's 32 lanes, so A's K share no longer bounds k. The stage's
// full barrier then counts 33 arrivals: the TMA's expect_tx and one per
// producer lane once its A copies have landed.
// CP (decode_cp, with DEEP, B as (k, n)): instead of lane 0's TMA boxes from
// the tensor map (then unused), the 128 threads of kCopyWarps producer warps
// copy B's stage from b (rows ldb apart; b_vec: every chunk 16-byte aligned)
// by TileCopy and arrive as wgmma_cp's (each thread once its cp.async copies
// have landed, each warp once after its stores where B is realigned),
// beside the first producer warp's 32 arrivals for A. Three blocks an SM, as
// decode_deep's shared memory allows (the wrapper's deep_split counts them).
template <int NT, typename Out, bool BKM, bool DEEP, bool CP>
__global__ void __launch_bounds__(threads<CP>(), CP ? 3 : 1)
matmul_decode(const __grid_constant__ CUtensorMap tb, const raw16* __restrict__ a,
              const raw16* __restrict__ b, Out* __restrict__ c, int m, int n, int k,
              long long lda, long long ldb, long long ldc, int k_tiles, int per, int a_vec,
              int b_vec) {
  static_assert(!CP || (DEEP && !BKM), "the copy producer streams A and takes B as (k, n)");
  constexpr int kThreads = threads<CP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = wg::smem_u32(smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;              // the swizzle wants 1 KB
  unsigned char* ring_p = smem_raw + (ring - base);
  // A share row stride (elements): the whole share's, or a stage slice's
  const int lds = DEEP ? A_ROW : per * BK + A_PAD;
  raw16* as = reinterpret_cast<raw16*>(ring_p + RING);       // (m, lds), DEEP: [STAGES][8·NT][lds]
  const uint32_t full = ring + RING + ((a_bytes<NT, DEEP>(m, per) + 15) & ~15);
  const uint32_t empty = full + STAGES * 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t rank = cluster_rank(), splits = cluster_size();
  const int n0 = blockIdx.y * BN;
  const int kt0 = (int)rank * per;
  const int tiles = min(per, k_tiles - kt0);
  const int k0 = kt0 * BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // expect_tx (+ A's 32 lanes), or (CP) a copy thread (+ a copy warp) + A's 32 lanes
      wg::mbar_init(full + 8 * s,
                    CP ? 32 * kCopyWarps + (b_vec ? 0 : kCopyWarps) + 32 : DEEP ? 33 : 1);
      wg::mbar_init(empty + 8 * s, kConsumers);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float d[CG][NT][4];
#pragma unroll
  for (int j = 0; j < CG; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) d[j][t][0] = d[j][t][1] = d[j][t][2] = d[j][t][3] = 0.f;
  if (warp >= kConsumers) {                                  // producer: the weight stream
    // lane 0 issues the TMA boxes (CP: the copy warps copy them); in DEEP
    // every lane of the first producer warp also copies its part of A's
    // slice into the same stage
    using CopyB = wg::TileCopy<32 * kCopyWarps, BK, BN / 8, BK, 0, 1>;
    const CopyB cb(b, ldb, k, n, k0, n0, CP && b_vec, tid - 32 * kConsumers);
    for (int t = 0; t < tiles && (DEEP || lane == 0); ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) wg::mbar_wait(empty + 8 * s, (t / STAGES - 1) & 1);
      if (CP) {
        // B's aligned chunks and the words of the others fly while the first
        // producer warp copies A's slice; then the realigned chunks land
        const uint32_t st = ring + s * STAGE_BYTES;
        uint4 w[CopyB::PASSES], x;
        if (b_vec)
          cb.issue_vec(st, t);
        else
          cb.issue(st, t, w, x);
        wg::cp_async_arrive(full + 8 * s);
        if (warp == kConsumers)
          stage_a(ring + RING + s * (8 * NT * A_ROW * 2), a, lda, m, k, k0 + t * BK, a_vec,
                  lane, full + 8 * s);
        if (!b_vec) {
          cb.land(st, t, w, x);
          __syncwarp();                                      // the warp's stores are done
          if (lane == 0) wg::mbar_arrive(full + 8 * s);
        }
        continue;
      }
      if (lane == 0) {
        wg::mbar_expect_tx(full + 8 * s, STAGE_BYTES);
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          if (BKM)
            wg::tma_load(ring + s * STAGE_BYTES + bx * BOX_BYTES, &tb, full + 8 * s,
                         k0 + t * BK, n0 + 64 * bx);
          else
            wg::tma_load(ring + s * STAGE_BYTES + bx * BOX_BYTES, &tb, full + 8 * s,
                         n0 + 64 * bx, k0 + t * BK);
        }
      }
      if (DEEP && warp == kConsumers)
        stage_a(ring + RING + s * (8 * NT * A_ROW * 2), a, lda, m, k, k0 + t * BK, a_vec, lane,
                full + 8 * s);
    }
    if (DEEP) wg::cp_async_wait_all();
  } else {
    if (!DEEP) {
      // the block's K share of A, once, while the first stages are in
      // flight; zero past k (rows at or past m are never stored: their
      // lanes use 0)
      const int row_chunks = per * BK / 8;
      for (int ch = tid; ch < m * row_chunks; ch += 32 * kConsumers) {
        const int r = ch / row_chunks, col = (ch % row_chunks) * 8;
        *reinterpret_cast<uint4*>(as + r * lds + col) = load8(a, lda, m, k, r, k0 + col);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
    }

    // warp w takes the 16-column groups w·CG .. w·CG + CG-1 of every stage;
    // group gc lies in box gc / 4 at chunks 2·(gc % 4) and + 1. ldmatrix
    // lane l addresses k-row (l & 7) + 8·(l / 16) of chunk 2·(gc % 4) +
    // (l / 8) % 2: the four transposed 8×8 matrices are a0..a3 of the
    // weight fragment. A box is 128-byte swizzled: chunk c of row r sits at
    // c ^ (r % 8), and r % 8 = l % 8.
    // BKM: the group's 16 weight columns are box rows 16·(gc % 4) .. +16;
    // lane l addresses row 16·(gc % 4) + (l & 7) + 8·((l / 8) % 2) at k
    // chunk 2·kq + l / 16, untransposed: the same four matrices a0..a3.
    const int g = lane / 4, q = lane % 4;
    const int lrow = BKM ? (lane & 7) + (((lane >> 3) & 1) << 3) : (lane & 7) + ((lane >> 4) << 3);
    uint32_t loff[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int gc = warp * CG + j;
      if (BKM) {
        loff[j] = (gc / 4) * BOX_BYTES + (16 * (gc % 4) + lrow) * 128;
      } else {
        const uint32_t chunk = (2 * (gc % 4) + ((lane >> 3) & 1)) ^ (lane & 7);
        loff[j] = (gc / 4) * BOX_BYTES + lrow * 128 + (chunk << 4);
      }
    }
    const raw16* arow[NT];
    bool live[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      live[t] = 8 * t + g < m;
      arow[t] = as + (live[t] ? 8 * t + g : 0) * lds + 2 * q;
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      wg::mbar_wait(full + 8 * s, (t / STAGES) & 1);
      const uint32_t st = ring + s * STAGE_BYTES;
      // A's columns of this K tile: in the share, or in the stage's slice
      const int a0 = DEEP ? s * 8 * NT * lds : t * BK;
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq) {
        const int kk = a0 + 16 * kq;
        uint32_t b[NT][2];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          // A[8u + g][kk + 2q, +1] and [kk + 8 + 2q, +1]
          b[u][0] = live[u] ? *reinterpret_cast<const uint32_t*>(arow[u] + kk) : 0u;
          b[u][1] = live[u] ? *reinterpret_cast<const uint32_t*>(arow[u] + kk + 8) : 0u;
        }
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          uint32_t w[4];
          if (BKM)
            ldsm_x4(w, st + loff[j] + (((2 * kq + (lane >> 4)) ^ (lane & 7)) << 4));
          else
            ldsm_x4_t(w, st + loff[j] + kq * 16 * 128);
#pragma unroll
          for (int u = 0; u < NT; ++u) mma16816(d[j][u], w, b[u][0], b[u][1]);
        }
      }
      __syncwarp();                                          // the stage's products are issued
      if (lane == 0) wg::mbar_arrive(empty + 8 * s);
    }
  }
  __syncthreads();                                           // the ring is free

  // each block's fp32 partial (8·NT rows × BN columns) over the ring's
  // start; lane (g, q) of warp w holds columns 16(w·CG + j) + g (+8), rows
  // 8u + 2q (+1)
  float* red = reinterpret_cast<float*>(ring_p);
  if (warp < kConsumers) {
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int col = 16 * (warp * CG + j) + g;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int r = 8 * u + 2 * q;
        red[r * BN + col] = d[j][u][0];
        red[(r + 1) * BN + col] = d[j][u][1];
        red[r * BN + col + 8] = d[j][u][2];
        red[(r + 1) * BN + col + 8] = d[j][u][3];
      }
    }
  }
  cluster_sync();
  // the cluster's sum, through distributed shared memory: block `rank` sums
  // its share of the tile's elements over ranks 0, 1, .., splits-1 in that
  // order (deterministic, no atomics) and stores it, columns coalesced
  for (int e = rank * kThreads + tid; e < m * BN; e += splits * kThreads) {
    const int col = e % BN;
    float acc = 0.f;
    for (uint32_t j = 0; j < splits; ++j) acc += ld_cluster(ring + 4 * e, j);
    if (n0 + col < n) c[(long long)(e / BN) * ldc + n0 + col] = bsps::from_float<Out>(acc);
  }
  cluster_sync();                                            // no block leaves while read
}

// dynamic shared memory of a block: alignment, ring, A's share or slices, barriers
template <int NT, bool DEEP>
int smem_bytes(int m, int per) {
  return 1024 + RING + ((a_bytes<NT, DEEP>(m, per) + 15) & ~15) + 2 * STAGES * 8;
}

// CP: decode_cp, whose producer copies B from b; no tensor map is encoded
template <int NT, typename Out, bool BKM, bool DEEP, bool CP>
cudaError_t launch(int device, dim3 grid, int per, int scratch_bytes, cudaStream_t stream,
                   const void* a, const void* b, void* c, int m, int n, int k, long long lda,
                   long long ldb, long long ldc) {
  const int k_tiles = (k + BK - 1) / BK;
  const int splits = (int)grid.x;
  if (grid.z != 1 || splits > MAX_SPLIT || (int)grid.y != (n + BN - 1) / BN || m > 8 * NT ||
      (splits - 1) * per >= k_tiles || splits * per < k_tiles)
    return cudaErrorInvalidValue;
  if (scratch_bytes != RING + a_bytes<NT, DEEP>(m, per))
    return cudaErrorInvalidValue;                  // plan and kernel disagree
  const int smem = smem_bytes<NT, DEEP>(m, per);
  CUtensorMap tb = {};
  if (!CP) {
    wg::EncodeTiled enc = wg::encoder();
    if (enc == nullptr) return cudaErrorSymbolNotFound;
    const bool b_ok = BKM ? wg::encode(enc, &tb, b, n, k, ldb, 64, BK)
                          : wg::encode(enc, &tb, b, k, n, ldb, BK, 64);
    if (!b_ok) return cudaErrorInvalidValue;
  }
  auto kernel = matmul_decode<NT, Out, BKM, DEEP, CP>;
  cudaError_t err = bsps::prepare_smem(kernel, device, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads<CP>(), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tb, static_cast<const raw16*>(a),
                           static_cast<const raw16*>(b), static_cast<Out*>(c), m, n, k, lda, ldb,
                           ldc, k_tiles, per, (int)wg::vec16(a, lda), (int)wg::vec16(b, ldb));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gv

// -- the fp32 variant (simt_f32) ------------------------------------------------------------

namespace sf {

constexpr int GROUP_M = 8;

using wg::cp_async16;
using wg::cp_async_arrive;
using wg::cp_async_wait_all;

// cp.async of 4 bytes from global to shared memory: `bytes` (4 or 0) are
// read, the rest is zero-filled. No memory clobber, as cp_async16.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

// One configuration: a BM × BN output tile per block, K streamed BK at a
// time through a ring of STAGES shared-memory stages that a producer
// warpgroup fills. Each stage holds A's and B's tiles k-major, rows of
// BM + 8 and BN + 8 floats. Two consumer warpgroups (8 warps): lanes form
// an LM × (32 / LM) grid inside a warp, each lane owning a TM × TN register
// tile in float4 pieces 4·LM rows and 4·LN columns apart; the warps tile the
// block. The block is launched with 168 registers a thread (384 threads on
// 64 K); setmaxnreg gives each consumer REGS and each producer what its
// release leaves: 4 producers' (168 - P) must cover 8 consumers' (REGS -
// 168), so P = 504 - 2·REGS, or the consumers' request never returns.
// ptxas still compiles the consumer code within 168 (its SASS uses no
// register past R165); the kernel measured faster with the split than
// without it.
template <int BM_, int BN_, int BK_, int STAGES_, int LM_, int TM_, int TN_, int REGS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int kWarps = 8, kProducers = 4;        // consumer and producer warps
  static constexpr int kThreads = 32 * (kWarps + kProducers);
  static constexpr int kConsumerRegs = REGS_, kProducerRegs = 504 - 2 * REGS_;
  static constexpr int LM = LM_, LN = 32 / LM_, TM = TM_, TN = TN_;
  static constexpr int WTM = LM * TM, WTN = LN * TN;      // a warp's tile
  static constexpr int WGN = BN / WTN;                    // warps along n
  static constexpr int LDA = BM + 8, LDB = BN + 8;        // k-major row pitch, floats
  static constexpr int A_FLOATS = BK * LDA, STAGE_FLOATS = BK * (LDA + LDB);
  static constexpr int RING = STAGES * STAGE_FLOATS * 4;
  static constexpr int SMEM = RING + 2 * STAGES * 8;      // + full/empty mbarriers
  static constexpr int SCRATCH = BM * BN * 4;             // the plan's accumulator: in registers
  static_assert((BM / WTM) * WGN == kWarps && BM % WTM == 0 && BN % WTN == 0,
                "the warps tile the block");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BM % 128 == 0 && BN % 128 == 0 &&
                    BK % (4 * kProducers) == 0 && STAGES >= 2 && kProducerRegs >= 24 &&
                    REGS_ % 8 == 0, "bad tile");
};

// Producer warp `pw`'s share (of kProducers) of the copies of one stage of
// an operand into its k-major tile T[BK][BX + 8] at shared address `dst`:
// elements (k0 + k, x0 + x), zero outside [0, ks) × [0, xs); CHECK = false
// when the stage lies inside.
// KC — k contiguous, element (k, x) at g[x·ld + k] (A as (m, k), B as
// (n, k)): 4-byte copies that transpose on the way, each warp instruction
// 8 x by 4 k: 8 rows of 16 bytes in device memory, 32 distinct banks in
// shared memory (the row pitch is 8 banks past a multiple of 32).
// Otherwise x contiguous, element (k, x) at g[k·ld + x] (B as (k, n), A as
// (k, m)): 16-byte copies of 4 x where `vec` (row stride and base 16-byte
// aligned), each warp instruction 128 x of one k, else 4-byte copies.
template <int BX, int BK, int P, bool KC, bool CHECK>
__device__ __forceinline__ void copy_stage(uint32_t dst, const float* __restrict__ g, long long ld,
                                           int x0, int xs, int k0, int ks, bool vec, int pw) {
  constexpr int LDX = BX + 8;
  const int lane = threadIdx.x % 32;
  if (KC) {
#pragma unroll
    for (int i = 0; i < BX / 8 / P; ++i) {
      const int x = (pw + P * i) * 8 + lane % 8;
      const float* row = g + (long long)(x0 + x) * ld + k0 + lane / 8;
#pragma unroll
      for (int kg = 0; kg < BK / 4; ++kg) {
        const int kk = kg * 4 + lane / 8;
        const bool ok = !CHECK || (x0 + x < xs && k0 + kk < ks);
        cp_async4(dst + (kk * LDX + x) * 4, ok ? row + kg * 4 : g, ok ? 4 : 0);
      }
    }
  } else if (vec) {
#pragma unroll
    for (int i = 0; i < BK / P; ++i) {
      const int kk = pw + P * i;
      const float* row = g + (long long)(k0 + kk) * ld + x0 + lane * 4;
#pragma unroll
      for (int xc = 0; xc < BX / 128; ++xc) {
        const int left = xs - (x0 + xc * 128 + lane * 4);
        const bool ok = !CHECK || (k0 + kk < ks && left > 0);
        cp_async16(dst + (kk * LDX + xc * 128 + lane * 4) * 4, ok ? row + xc * 128 : g,
                   !CHECK ? 16 : ok ? 4 * min(left, 4) : 0);
      }
    }
  } else {
#pragma unroll 2
    for (int i = 0; i < BK / P; ++i) {
      const int kk = pw + P * i;
      const float* row = g + (long long)(k0 + kk) * ld + x0 + lane;
#pragma unroll
      for (int xc = 0; xc < BX / 32; ++xc) {
        const bool ok = !CHECK || (k0 + kk < ks && x0 + xc * 32 + lane < xs);
        cp_async4(dst + (kk * LDX + xc * 32 + lane) * 4, ok ? row + xc * 32 : g, ok ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4], int valid, bool vec) {
  if (vec && valid == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int e = 0; e < valid; ++e) p[e] = v[e];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4], int valid, bool vec) {
  if (vec && valid == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
    return;
  }
  for (int e = 0; e < valid; ++e) p[e] = __float2bfloat16(v[e]);
}

// A_KC: A given as (m, k) (else as its (k, m) transpose); B_KC: B given as
// its (n, k) transpose (else as (k, n)). The last warpgroup is the
// producer: it streams K tile t into stage t % STAGES once the consumers
// have released it (empty[s]), and the stage's full[s] completes when all
// its copies have landed. The consumers multiply each stage as it arrives
// and release it: no block-wide barrier in the K stream, no copy work in
// the FMA loop. Every output sums its K terms in ascending k, one fmaf
// each, from 0: the stages arrive in K order and each stage's k-rows run
// in order. No split-K, no atomics.
template <class T, typename Out, bool A_KC, bool B_KC>
__global__ void __launch_bounds__(T::kThreads, 1)
matmul_f32(const float* __restrict__ a, const float* __restrict__ b, Out* __restrict__ c,
           int m, int n, int k, long long lda, long long ldb, long long ldc, int k_tiles,
           bool a_vec, bool b_vec, bool c_vec) {
  extern __shared__ __align__(16) float ring[];
  const uint32_t ring_u32 = wg::smem_u32(ring);
  const uint32_t full = ring_u32 + T::RING, empty = full + T::STAGES * 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // tile of this block: groups of GROUP_M m-tiles, m fastest, as wgmma
  const int tiles_n = gridDim.x, tiles_m = gridDim.y;
  const int lin = blockIdx.y * tiles_n + blockIdx.x, per_group = GROUP_M * tiles_n;
  const int first_m = lin / per_group * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + lin % per_group % gm) * T::BM;
  const int n0 = lin % per_group / gm * T::BN;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 32 * T::kProducers);  // one per producer lane, as its copies land
      wg::mbar_init(empty + 8 * s, T::kWarps);       // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::kWarps) {                           // producers: the K stream
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    const int pw = warp - T::kWarps;
    const bool inside = m0 + T::BM <= m && n0 + T::BN <= n;
    for (int t = 0; t < k_tiles; ++t) {
      const int s = t % T::STAGES, k0 = t * T::BK;
      if (t >= T::STAGES) wg::mbar_wait(empty + 8 * s, (t / T::STAGES - 1) & 1);
      const uint32_t st = ring_u32 + s * T::STAGE_FLOATS * 4;
      if (inside && k0 + T::BK <= k) {
        copy_stage<T::BM, T::BK, T::kProducers, A_KC, false>(st, a, lda, m0, m, k0, k, a_vec, pw);
        copy_stage<T::BN, T::BK, T::kProducers, B_KC, false>(st + T::A_FLOATS * 4, b, ldb, n0, n,
                                                             k0, k, b_vec, pw);
      } else {
        copy_stage<T::BM, T::BK, T::kProducers, A_KC, true>(st, a, lda, m0, m, k0, k, a_vec, pw);
        copy_stage<T::BN, T::BK, T::kProducers, B_KC, true>(st + T::A_FLOATS * 4, b, ldb, n0, n,
                                                            k0, k, b_vec, pw);
      }
      cp_async_arrive(full + 8 * s);
    }
    cp_async_wait_all();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  const int arow = (warp / T::WGN) * T::WTM + (lane / T::LN) * 4;
  const int bcol = (warp % T::WGN) * T::WTN + (lane % T::LN) * 4;
  for (int t = 0; t < k_tiles; ++t) {                // the K stream (hypersteps)
    const int s = t % T::STAGES;
    wg::mbar_wait(full + 8 * s, (t / T::STAGES) & 1);
    const float* as = ring + s * T::STAGE_FLOATS + arow;
    const float* bs = ring + s * T::STAGE_FLOATS + T::A_FLOATS + bcol;
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      float av[T::TM], bv[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * T::LDA + i * 4 * T::LM);
        av[4 * i] = v.x, av[4 * i + 1] = v.y, av[4 * i + 2] = v.z, av[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < T::TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * T::LDB + j * 4 * T::LN);
        bv[4 * j] = v.x, bv[4 * j + 1] = v.y, bv[4 * j + 2] = v.z, bv[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncwarp();                                    // the warp's reads of the stage are done
    if (lane == 0) wg::mbar_arrive(empty + 8 * s);
  }

  // WRITE(σ_C, Σ_C): each thread stores its float4 row pieces
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = m0 + arow + (i / 4) * 4 * T::LM + i % 4;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < T::TN / 4; ++j) {
      const int col = n0 + bcol + j * 4 * T::LN;
      if (col >= n) continue;
      const float v[4] = {acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]};
      store4(c + (long long)r * ldc + col, v, min(4, n - col), c_vec);
    }
  }
}

// the configuration the plan's simt_f32 tile names (VARIANTS["simt_f32"])
using Default = Tile<256, 128, 32, 3, 8, 16, 8, 216>;

template <class T, typename Out, bool A_KC, bool B_KC>
cudaError_t launch(int device, dim3 grid, int k_tiles, int scratch_bytes, cudaStream_t stream,
                   const void* a, const void* b, void* c, int m, int n, int k, long long lda,
                   long long ldb, long long ldc) {
  if (scratch_bytes != T::SCRATCH || grid.z != 1 || (int)grid.x != (n + T::BN - 1) / T::BN ||
      (int)grid.y != (m + T::BM - 1) / T::BM || k_tiles != (k + T::BK - 1) / T::BK)
    return cudaErrorInvalidValue;                  // plan and kernel disagree
  const bool a_vec = lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool c_vec = ldc % 4 == 0 && reinterpret_cast<uintptr_t>(c) % (4 * sizeof(Out)) == 0;
  auto kernel = matmul_f32<T, Out, A_KC, B_KC>;
  cudaError_t err = bsps::prepare_smem(kernel, device, T::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T::kThreads, T::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<Out*>(c), m, n, k,
      lda, ldb, ldc, k_tiles, a_vec, b_vec, c_vec);
  return cudaGetLastError();
}

}  // namespace sf

// the variant codes of the wrapper's VARIANTS, in its order
enum Variant { kDecode = 0, kWgmma = 1, kWgmmaCp = 2, kDecodeCp = 3, kSimtF32 = 4,
               kDecodeDeep = 5 };
// the operand layout bits of the wrapper's b_layout / a_layout
enum Layout { kBRowsN = 1, kAColMajor = 2 };

template <typename Out, bool BKM, bool DEEP, bool CP = false>
cudaError_t decode(int device, dim3 grid, int k_steps, int scratch_bytes, cudaStream_t stream,
                   const void* a, const void* b, void* c, int m, int n, int k, long long lda,
                   long long ldb, long long ldc) {
  if (m <= 8)
    return gv::launch<1, Out, BKM, DEEP, CP>(device, grid, k_steps, scratch_bytes, stream, a, b,
                                             c, m, n, k, lda, ldb, ldc);
  return gv::launch<2, Out, BKM, DEEP, CP>(device, grid, k_steps, scratch_bytes, stream, a, b, c,
                                           m, n, k, lda, ldb, ldc);
}

template <typename Out>
cudaError_t dispatch(int device, dim3 grid, int k_steps, int scratch_bytes, cudaStream_t stream,
                     const void* a, const void* b, void* c, int m, int n, int k, long long lda,
                     long long ldb, long long ldc, int variant, int layout) {
  // the copy variants and the decode variant's A take the default layouts
  // only; wgmma and simt_f32 take either layout of one operand, not both
  if (layout & ~(kBRowsN | kAColMajor) || layout == (kBRowsN | kAColMajor) ||
      ((layout & kAColMajor) && variant != kWgmma && variant != kSimtF32) ||
      (layout && (variant == kWgmmaCp || variant == kDecodeCp)))
    return cudaErrorInvalidValue;
  switch (variant) {
    case kDecode:
      if (layout == kBRowsN)
        return decode<Out, true, false>(device, grid, k_steps, scratch_bytes, stream, a, b, c, m,
                                        n, k, lda, ldb, ldc);
      return decode<Out, false, false>(device, grid, k_steps, scratch_bytes, stream, a, b, c, m,
                                       n, k, lda, ldb, ldc);
    case kDecodeDeep:
      if (layout == kBRowsN)
        return decode<Out, true, true>(device, grid, k_steps, scratch_bytes, stream, a, b, c, m,
                                       n, k, lda, ldb, ldc);
      return decode<Out, false, true>(device, grid, k_steps, scratch_bytes, stream, a, b, c, m,
                                      n, k, lda, ldb, ldc);
    case kDecodeCp:
      return decode<Out, false, true, true>(device, grid, k_steps, scratch_bytes, stream, a, b, c,
                                            m, n, k, lda, ldb, ldc);
    case kWgmma:
      if (layout == kBRowsN)
        return wg::launch<Out, false, true, false>(device, grid, k_steps, scratch_bytes, stream,
                                                   a, b, c, m, n, k, lda, ldb, ldc);
      if (layout == kAColMajor)
        return wg::launch<Out, true, false, false>(device, grid, k_steps, scratch_bytes, stream,
                                                   a, b, c, m, n, k, lda, ldb, ldc);
      return wg::launch<Out, false, false, false>(device, grid, k_steps, scratch_bytes, stream, a,
                                                  b, c, m, n, k, lda, ldb, ldc);
    case kWgmmaCp:
      return wg::launch<Out, false, false, true>(device, grid, k_steps, scratch_bytes, stream, a,
                                                 b, c, m, n, k, lda, ldb, ldc);
    case kSimtF32:
      if (layout == kBRowsN)
        return sf::launch<sf::Default, Out, true, true>(device, grid, k_steps, scratch_bytes,
                                                        stream, a, b, c, m, n, k, lda, ldb, ldc);
      if (layout == kAColMajor)
        return sf::launch<sf::Default, Out, false, false>(device, grid, k_steps, scratch_bytes,
                                                          stream, a, b, c, m, n, k, lda, ldb, ldc);
      return sf::launch<sf::Default, Out, true, false>(device, grid, k_steps, scratch_bytes,
                                                       stream, a, b, c, m, n, k, lda, ldb, ldc);
    default:
      return cudaErrorInvalidValue;
  }
}

// the compiled attributes of a decode instance (default layouts, Out output)
template <typename Out, bool CP>
cudaError_t decode_attrs(int device, int m, int* out) {
  return m <= 8 ? bsps::attrs(gv::matmul_decode<1, Out, false, true, CP>, device,
                              gv::threads<CP>(), gv::smem_bytes<1, true>(m, 1), out)
                : bsps::attrs(gv::matmul_decode<2, Out, false, true, CP>, device,
                              gv::threads<CP>(), gv::smem_bytes<2, true>(m, 1), out);
}

// the compiled attributes of a bf16 instance in the default layouts, Out output
template <typename Out>
cudaError_t matmul_attrs(int device, int variant, int m, int* out) {
  switch (variant) {
    case kWgmma:
      return bsps::attrs(wg::matmul_wgmma<Out, false, false, false>, device, wg::kThreads,
                         wg::SMEM, out);
    case kWgmmaCp:
      return bsps::attrs(wg::matmul_wgmma<Out, false, false, true>, device, wg::kCpThreads,
                         wg::CP_SMEM, out);
    case kDecodeDeep:
      return m >= 1 && m <= 16 ? decode_attrs<Out, false>(device, m, out) : cudaErrorInvalidValue;
    case kDecodeCp:
      return m >= 1 && m <= 16 ? decode_attrs<Out, true>(device, m, out) : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C = A·B, A (m, k) and B (k, n) with row strides lda, ldb — bf16, or fp32
// for simt_f32; C (m, n) of `out_dtype` with row stride ldc. `layout` (enum
// Layout bits): kBRowsN — B is given as its (n, k) transpose, rows ldb apart
// (decode, wgmma and simt_f32); kAColMajor — A is given as its (k, m)
// transpose, rows lda apart (wgmma and simt_f32).
// `variant` (enum Variant) picks the kernel:
// decode, decode_deep and decode_cp — grid (splits, n tiles), one cluster of
// `splits` per column tile, loop = K tiles per split, B TMA-describable but
// for decode_cp; wgmma and wgmma_cp — grid (n tiles, m tiles), loop = K
// tiles, A and B TMA-describable but for wgmma_cp; simt_f32 — grid (n
// tiles, m tiles), loop = K tiles of 32, fp32 operands in either layout of
// one operand. One launch each.
BSPS_EXPORT int bsps_matmul(int device, int gx, int gy, int gz, int loop, int scratch_bytes,
                            void* stream, const void* a, const void* b, void* c, int m, int n,
                            int k, long long lda, long long ldb, long long ldc, int variant,
                            int layout, int out_dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (gx < 1 || gy < 1 || gz != 1 || loop < 1) return cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == bsps::kBFloat16)
    return dispatch<__nv_bfloat16>(device, grid, loop, scratch_bytes, s, a, b, c, m, n, k, lda,
                                   ldb, ldc, variant, layout);
  if (out_dtype == bsps::kFloat32)
    return dispatch<float>(device, grid, loop, scratch_bytes, s, a, b, c, m, n, k, lda, ldb, ldc,
                           variant, layout);
  return cudaErrorInvalidValue;
}

// The compiled attributes of a bf16 matmul instance in the default layouts
// with `out_dtype` output, as the CUDA runtime reports them: `variant` one
// of wgmma, wgmma_cp, decode_deep and decode_cp, `m` the rows (the decode
// variants' instance: 1-8 or 9-16). out[0] registers a thread, out[1]
// local (spilled) bytes a thread, out[2] dynamic shared memory a block,
// out[3] resident blocks an SM.
BSPS_EXPORT int bsps_matmul_attrs(int device, int variant, int m, int out_dtype, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (out_dtype == bsps::kBFloat16) return matmul_attrs<__nv_bfloat16>(device, variant, m, out);
  if (out_dtype == bsps::kFloat32) return matmul_attrs<float>(device, variant, m, out);
  return cudaErrorInvalidValue;
}

// Tile configurations of the fp32 matmul variant (simt_f32), for
// repro_torch/launch/sweep_simt_f32.py. Each entry of Configs instantiates
// sf::matmul_f32 at one sf::Tile, with B given as (k, n) and an fp32
// output. Built on its own, never into the kernel library.

#include <tuple>
#include <utility>

#include "../streamed_matmul.cu"

namespace {

// one instance: a tile, and A given as (m, k) (A_KC, copied transposed by
// 4-byte copies) or as (k, m) (16-byte copies)
template <class T, bool A_KC = true>
struct Cfg {
  using Tile = T;
  static constexpr bool kAKC = A_KC;
};

// BM, BN, BK, stages, lanes along m, TM, TN, consumer registers
using Configs = std::tuple<
    Cfg<sf::Default>,                                  // the variant's tile
    Cfg<sf::Tile<256, 128, 32, 3, 8, 16, 8, 224>>,     // consumer registers
    Cfg<sf::Tile<256, 128, 32, 3, 8, 16, 8, 232>>,     // (producers: 504 - 2·that)
    Cfg<sf::Tile<256, 128, 32, 4, 8, 16, 8, 216>>,     // a fourth stage
    Cfg<sf::Tile<256, 128, 16, 4, 8, 16, 8, 216>>,     // K by 16
    Cfg<sf::Tile<256, 128, 48, 3, 8, 16, 8, 216>>,     // K by 48
    Cfg<sf::Tile<128, 256, 32, 3, 8, 8, 16, 216>>,     // the transposed tile, 8×16 a lane
    Cfg<sf::Tile<256, 128, 32, 3, 4, 16, 8, 216>>,     // a 4 × 8 lane grid
    Cfg<sf::Default, false>>;                          // A as (k, m): no transposing copy

// info: BM, BN, BK, stages, consumer registers, ptxas's registers, local
// (spill) bytes, shared bytes, lanes along m, A as (m, k). Launches when
// `a` is given.
template <class C>
int run(int* info, void* stream, const void* a, const void* b, void* c, int m, int n, int k) {
  using T = typename C::Tile;
  auto kernel = sf::matmul_f32<T, float, C::kAKC, false>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int vals[10] = {T::BM, T::BN, T::BK, T::STAGES, T::kConsumerRegs, fa.numRegs,
                        (int)fa.localSizeBytes, T::SMEM, T::LM, C::kAKC};
  for (int i = 0; i < 10; ++i) info[i] = vals[i];
  if (a == nullptr) return 0;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, 1);
  return sf::launch<T, float, C::kAKC, false>(device, grid, (k + T::BK - 1) / T::BK, T::SCRATCH,
                                              static_cast<cudaStream_t>(stream), a, b, c, m, n,
                                              k, C::kAKC ? k : m, n, n);
}

template <size_t... I>
int dispatch(int cfg, std::index_sequence<I...>, int* info, void* stream, const void* a,
             const void* b, void* c, int m, int n, int k) {
  int err = cudaErrorInvalidValue;
  ((cfg == (int)I ? (err = run<std::tuple_element_t<I, Configs>>(info, stream, a, b, c, m, n, k))
                  : 0), ...);
  return err;
}

}  // namespace

BSPS_EXPORT int bsps_sweep_f32_count() { return (int)std::tuple_size_v<Configs>; }

// C = A·B for contiguous fp32 A (m, k), B (k, n), C (m, n) at configuration
// `cfg`; with a == nullptr only fills `info`.
BSPS_EXPORT int bsps_sweep_f32(int cfg, int* info, void* stream, const void* a, const void* b,
                               void* c, int m, int n, int k) {
  return dispatch(cfg, std::make_index_sequence<std::tuple_size_v<Configs>>{}, info, stream, a,
                  b, c, m, n, k);
}

// Stateless Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC'11), the port's dropout bit source.
//
// The dropout mask of element (row, col) of a layer's [rows, width]
// activation is word (col % 4) of
//     philox4x32_10(counter = (col / 4, row_lo32, row_hi32, 0),
//                   key     = (uint32(seed_layer), 0)).
// The counter depends on (row, col) only, never on the tile, the launch
// shape or the number of blocks, so every kernel that draws the mask
// (csrc/relu_dropout.cu, csrc/fused_train.cu) and the torch form
// (ops/relu_dropout.dropout_keep_bits) give the same bits. An element is
// kept iff its word >= threshold = min(rate * 2^32, 2^32 - 1).

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The four mask words of columns 4*group .. 4*group+3 of `row`.
__device__ __forceinline__ uint4 dropout_bits(long long row, uint32_t group,
                                              uint32_t key) {
  return philox4x32_10(group, static_cast<uint32_t>(row),
                       static_cast<uint32_t>(static_cast<unsigned long long>(row) >> 32),
                       0u, key, 0u);
}

__device__ __forceinline__ uint32_t word(const uint4& b, int j) {
  return j == 0 ? b.x : j == 1 ? b.y : j == 2 ? b.z : b.w;
}

}  // namespace philox

// Transposed bit-plane layout of the wire, shared by pack_bits.cu and
// quant_pipeline.cu.
//
// Values go in groups of 32; a group of b-bit values packs into b uint32
// words, bit j of value i at bit i of word j.  Groups are stacked R = 8 deep
// and LANES = 128 wide, so a tile holds 32 * R * LANES = 32768 values and
// b * R * LANES words.  Within a tile, column c = r * LANES + lane (1024 of
// them) owns one group:
//
//   value i of column c at flat index  (tile * 32   + i) * 1024 + c
//   word  j of column c at flat index  (tile * bits + j) * 1024 + c
//
// This is the JAX package's layout word for word, tile padding included.
// quant_pipeline gives each thread one column (pack_bits and unpack_bits
// take four, pack_bits.cu): neighbouring threads take neighbouring lanes,
// so each of the 32 value loads and each of the b word stores of a warp is
// one coalesced 128-byte access, and the 32 values of a group sit in
// registers while their planes are built.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int GROUP = 32;
constexpr int R = 8;
constexpr int LANES = 128;
constexpr int TILE_COLS = R * LANES;          // 1024 columns per tile

// Word j of a group: bit j of each of its 32 values.  j < 32, and every
// shift is of a uint32_t by less than 32, so 1u << 31 and b = 32 are safe.
__device__ __forceinline__ void store_planes(const uint32_t (&v)[GROUP],
                                             int bits, uint32_t* words,
                                             long long tile, int col) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (j < bits) {
      uint32_t w = 0u;
#pragma unroll
      for (int i = 0; i < GROUP; ++i) w |= ((v[i] >> j) & 1u) << i;
      words[(tile * bits + j) * TILE_COLS + col] = w;
    }
  }
}

inline unsigned blocks_for(int tiles) {
  return static_cast<unsigned>(
      (static_cast<long long>(tiles) * TILE_COLS + THREADS - 1) / THREADS);
}

}  // namespace repro

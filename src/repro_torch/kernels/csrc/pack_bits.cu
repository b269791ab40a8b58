// pack_bits / unpack_bits for sm_90a: the wire's transposed bit-plane
// pack and its inverse (layout in bitplanes.cuh).
//
// Replaces the Pallas kernels src/repro/kernels/pack_bits.py:80 pack_bits
// (body :61) and :107 unpack_bits (body :70).
//
// Bound: bytes.  Pack reads 4 bytes per value and writes 4*b bytes per 32
// values; unpack the reverse.  Shift/mask work is 3 integer operations per
// bit, far below what the card does in the time of those bytes.  The
// design keeps every access coalesced (one thread per column of a tile)
// and builds words in registers.  At the main path's shape (100 to 10,000
// values, b = 4) a launch moves well under 100 KB, some 0.02 us at
// 3.35 TB/s, so it is bound by launch latency, not by either.
#include "bitplanes.cuh"

using repro::GROUP;
using repro::TILE_COLS;

__global__ void pack_bits_kernel(const uint32_t* __restrict__ vals,
                                 uint32_t* __restrict__ words, long long n,
                                 int bits, long long columns) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= columns) return;
  const long long tile = t / TILE_COLS;
  const int col = static_cast<int>(t % TILE_COLS);
  uint32_t v[GROUP];
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const long long idx = (tile * GROUP + i) * TILE_COLS + col;
    v[i] = idx < n ? vals[idx] : 0u;   // tail pads with 0, as the JAX kernel
  }
  repro::store_planes(v, bits, words, tile, col);
}

__global__ void unpack_bits_kernel(const uint32_t* __restrict__ words,
                                   uint32_t* __restrict__ vals, long long n,
                                   int bits, long long columns) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= columns) return;
  const long long tile = t / TILE_COLS;
  const int col = static_cast<int>(t % TILE_COLS);
  uint32_t w[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j)
    w[j] = j < bits ? words[(tile * bits + j) * TILE_COLS + col] : 0u;
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const long long idx = (tile * GROUP + i) * TILE_COLS + col;
    if (idx < n) {
      uint32_t x = 0u;
#pragma unroll
      for (int j = 0; j < GROUP; ++j) x |= ((w[j] >> i) & 1u) << j;
      vals[idx] = x;
    }
  }
}

// vals: n uint32 values; words: tiles * bits * 1024 uint32, all written.
extern "C" int repro_pack_bits(const void* vals, void* words, int n, int bits,
                               int tiles, void* stream) {
  pack_bits_kernel<<<repro::blocks_for(tiles), repro::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), static_cast<uint32_t*>(words), n,
      bits, static_cast<long long>(tiles) * TILE_COLS);
  return static_cast<int>(cudaGetLastError());
}

// words: tiles * bits * 1024 uint32; vals: the first n values, written.
extern "C" int repro_unpack_bits(const void* words, void* vals, int n, int bits,
                                 int tiles, void* stream) {
  unpack_bits_kernel<<<repro::blocks_for(tiles), repro::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(vals), n,
      bits, static_cast<long long>(tiles) * TILE_COLS);
  return static_cast<int>(cudaGetLastError());
}

// pack_bits / unpack_bits for sm_90a: the wire's transposed bit-plane
// pack and its inverse (layout in bitplanes.cuh).
//
// Replaces the Pallas kernels src/repro/kernels/pack_bits.py:80 pack_bits
// (body :61) and :107 unpack_bits (body :70).
//
// Bound: bytes.  Pack reads 4 bytes per value and writes 4*b bytes per 32
// values; unpack the reverse.  Shift/mask work is 2-3 integer operations
// per bit, below what the card does in the time of those bytes.  At the
// main path's shape (100 to 10,000 values, b = 4) a launch moves well
// under 100 KB, some 0.02 us at 3.35 TB/s, so it is bound by launch
// latency, not by either.
//
// pack_bits gives each thread one column of a tile: neighbouring threads
// take neighbouring lanes, so each of its 32 value loads and b word stores
// is one coalesced 128-byte warp access.
//
// unpack_bits writes 8 times the bytes it reads at b = 4, so its stores
// decide.  A block of 256 threads takes one tile, and thread t its columns
// 4t .. 4t + 3: they are neighbours in every word plane and in every value
// row, so each of its b word loads is one 16-byte uint4 (VEC; a word
// buffer whose base is not 16-byte aligned, such as a view into a wire
// payload, takes four 4-byte loads instead) and each of its 32 value
// stores one 16-byte uint4, 512 bytes per warp access, streaming
// (st.global.cs, evict first: the values are written once, and at 2**24
// of them they are 64 MB, more than the 50 MB L2).  A group of four that
// crosses n is stored value by value.  The b planes sit in registers
// (MAXB of them, the smallest of 8, 16, 32 that holds b), so all b loads
// of a thread are in flight at once.  The thread -> (tile, column group,
// value row) map is modelled in numpy by test_torch_kernels.py.
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

template <int MAXB, bool VEC>
__global__ void __launch_bounds__(repro::THREADS)
unpack_bits_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ vals,
                   long long n, int bits) {
  const long long tile = blockIdx.x;
  const int col = 4 * static_cast<int>(threadIdx.x);
  uint4 w[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) {
    w[j] = make_uint4(0u, 0u, 0u, 0u);
    if (j < bits) {
      const uint32_t* p = words + (tile * bits + j) * TILE_COLS + col;
      if (VEC) {
        w[j] = *reinterpret_cast<const uint4*>(p);
      } else {
        w[j] = make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const long long idx = (tile * GROUP + i) * TILE_COLS + col;
    if (idx >= n) continue;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      if (j < bits) {                    // bit i of plane j -> bit j of value i
        const uint32_t m = 1u << j;
        x.x |= (i >= j ? w[j].x >> (i - j) : w[j].x << (j - i)) & m;
        x.y |= (i >= j ? w[j].y >> (i - j) : w[j].y << (j - i)) & m;
        x.z |= (i >= j ? w[j].z >> (i - j) : w[j].z << (j - i)) & m;
        x.w |= (i >= j ? w[j].w >> (i - j) : w[j].w << (j - i)) & m;
      }
    }
    if (idx + 4 <= n) {
      __stcs(reinterpret_cast<uint4*>(vals + idx), x);
    } else {
      vals[idx] = x.x;
      if (idx + 1 < n) vals[idx + 1] = x.y;
      if (idx + 2 < n) vals[idx + 2] = x.z;
    }
  }
}

template <int MAXB>
void launch_unpack(const uint32_t* words, uint32_t* vals, int n, int bits, int tiles,
                   bool vec, cudaStream_t stream) {
  if (vec)
    unpack_bits_kernel<MAXB, true><<<tiles, repro::THREADS, 0, stream>>>(words, vals, n, bits);
  else
    unpack_bits_kernel<MAXB, false><<<tiles, repro::THREADS, 0, stream>>>(words, vals, n, bits);
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

// words: tiles * bits * 1024 uint32; vals: the first n values, written,
// 16-byte aligned.  One block of 256 threads per tile.
extern "C" int repro_unpack_bits(const void* words, void* vals, int n, int bits,
                                 int tiles, void* stream) {
  static_assert(TILE_COLS == 4 * repro::THREADS, "a thread per four columns");
  const auto* w = static_cast<const uint32_t*>(words);
  auto* v = static_cast<uint32_t*>(vals);
  const bool vec = reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits <= 8) launch_unpack<8>(w, v, n, bits, tiles, vec, st);
  else if (bits <= 16) launch_unpack<16>(w, v, n, bits, tiles, vec, st);
  else launch_unpack<32>(w, v, n, bits, tiles, vec, st);
  return static_cast<int>(cudaGetLastError());
}

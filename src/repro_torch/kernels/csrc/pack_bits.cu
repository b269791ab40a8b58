// pack_bits / unpack_bits for sm_90a: the wire's transposed bit-plane
// pack and its inverse (layout in bitplanes.cuh).
//
// Replaces the Pallas kernels src/repro/kernels/pack_bits.py:80 pack_bits
// (body :61) and :107 unpack_bits (body :70).
//
// Bound: bytes.  Pack reads each value once, at its own width (1, 2 or 4
// bytes: the wrapper passes uint8 and uint16 level ints as they lie), and
// writes 4*b bytes per 32 values; unpack reads the words and writes 4 bytes
// per value.  From uint8 at b = 4 pack moves 1.5 bytes a value, 0.0075 ms
// at 2**24 values and 3.35 TB/s; at b = 8, 2 bytes, 0.33 ms on the training
// round's largest leaf (5.54e8 values).  Shift/mask work is about two
// integer operations per value and bit plane (half that from uint8, four
// columns a register), below what the card does in the time of those bytes.
//
// Both kernels run a block of 256 threads per tile, and thread t takes
// columns 4t .. 4t + 3 of it: they are neighbours in every value row and
// every word plane.  The thread -> (tile, column group, row) map is
// modelled in numpy by test_torch_kernels.py (unpack) and
// test_torch_quantize_ef_widths.py (pack).
//
// pack_bits loads, for each of the 32 value rows, the 4 neighbouring values
// of its columns with one load of 4 bytes (uint8), 8 (uint16) or 16 (32-bit)
// when the values' base is aligned to that and the tile lies wholly inside
// n; otherwise value by value, a value past n taken as 0 (the JAX kernel's
// tail padding).  From uint8 and uint16, with all 32 rows in registers (32
// and 64 of them), it builds each bit plane j for its 4 columns and stores
// it as one 16-byte uint4, so a warp's store is 512 contiguous bytes.  From
// uint8 a register holds a row's 4 columns,
// one per byte: (row >> j) & 0x01010101, shifted to bit s, gathers bit j of
// 8 rows into one byte per column, and four such registers (rows 0-7, 8-15,
// 16-23, 24-31) are transposed bytewise into the 4 columns' words with 8
// byte permutes.  From uint16 a register holds 2 columns in its halves, so
// 16 rows fill a half and two permutes a pair of words.  Planes at or
// above the value width (b > 8 from uint8) are zero.  From 32-bit values
// (pack_bits32_kernel) the 32 rows would take 128 registers, so each row's
// uint4 goes into MAXB plane accumulators as it arrives (MAXB the smallest
// power of two that holds b: 4 * MAXB registers), one bit at a time.
//
// unpack_bits writes 8 times the bytes it reads at b = 4, so its stores
// decide.  Each of its b word loads is one 16-byte uint4 (VEC; a word
// buffer whose base is not 16-byte aligned, such as a view into a wire
// payload, takes four 4-byte loads instead) and each of its 32 value
// stores one 16-byte uint4, 512 bytes per warp access, streaming
// (st.global.cs, evict first: the values are written once, and at 2**24
// of them they are 64 MB, more than the 50 MB L2).  A group of four that
// crosses n is stored value by value.  The b planes sit in registers
// (MAXB of them, the smallest of 8, 16, 32 that holds b), so all b loads
// of a thread are in flight at once.
#include "bitplanes.cuh"

using repro::GROUP;
using repro::TILE_COLS;

namespace {

constexpr long long TILE_VALUES = static_cast<long long>(GROUP) * TILE_COLS;

// A value row's 4 neighbouring columns: one register of 4 uint8 values,
// or two of 2 uint16 values.
template <typename V> struct RowOf;
template <> struct RowOf<uint8_t> { using type = uint32_t; };
template <> struct RowOf<uint16_t> { using type = uint2; };

template <typename V>
__device__ __forceinline__ typename RowOf<V>::type compose(uint32_t a, uint32_t b,
                                                           uint32_t c, uint32_t d) {
  if constexpr (sizeof(V) == 1) return a | (b << 8) | (c << 16) | (d << 24);
  else return make_uint2(a | (b << 16), c | (d << 16));
}

// Bit j of 8 rows of uint8 values, one byte per column: byte k of the
// result holds bit j of column k's rows R0 .. R0 + 7 at bits 0 .. 7.
template <int J, int R0>
__device__ __forceinline__ uint32_t gather8(const uint32_t (&v)[GROUP]) {
  uint32_t a = 0u;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    // s and J are compile-time after unrolling: one shift and one lop3
    a |= (s >= J ? v[R0 + s] << (s - J) : v[R0 + s] >> (J - s)) & (0x01010101u << s);
  }
  return a;
}

// Plane j of 4 columns from rows of one width.
template <int J>
__device__ __forceinline__ uint4 plane(const uint32_t (&v)[GROUP]) {
  const uint32_t a0 = gather8<J, 0>(v), a1 = gather8<J, 8>(v);
  const uint32_t a2 = gather8<J, 16>(v), a3 = gather8<J, 24>(v);
  // bytes: t0 = (a0.0, a1.0, a0.1, a1.1), t1 = (a2.0, a3.0, a2.1, a3.1), ...
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a2, a3, 0x5140);
  const uint32_t t2 = __byte_perm(a0, a1, 0x7362), t3 = __byte_perm(a2, a3, 0x7362);
  return make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                    __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
}

template <int J>
__device__ __forceinline__ uint4 plane(const uint2 (&v)[GROUP]) {
  uint32_t a[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      uint32_t acc = 0u;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const uint32_t x = h ? v[16 * g + s].y : v[16 * g + s].x;
        acc |= (s >= J ? x << (s - J) : x >> (J - s)) & (0x00010001u << s);
      }
      a[h][g] = acc;    // half k: bit J of column 2h + k, rows 16g .. 16g + 15
    }
  }
  return make_uint4(__byte_perm(a[0][0], a[0][1], 0x5410), __byte_perm(a[0][0], a[0][1], 0x7632),
                    __byte_perm(a[1][0], a[1][1], 0x5410), __byte_perm(a[1][0], a[1][1], 0x7632));
}

// 32-bit values: each row's 4 columns (one uint4) go into the MAXB
// planes' accumulators as the row arrives, bit j of row i to bit i of
// plane j, so the registers hold the planes and not the 32 rows.
template <int MAXB, bool FULL>
__device__ __forceinline__ void gather32(const uint32_t* __restrict__ vals, long long n,
                                         long long tile, int col, uint4 (&w)[MAXB]) {
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const long long idx = (tile * GROUP + i) * TILE_COLS + col;
    const uint4 v = FULL ? *reinterpret_cast<const uint4*>(vals + idx)
                         : make_uint4(idx < n ? vals[idx] : 0u, idx + 1 < n ? vals[idx + 1] : 0u,
                                      idx + 2 < n ? vals[idx + 2] : 0u,
                                      idx + 3 < n ? vals[idx + 3] : 0u);
    const uint32_t m = 1u << i;
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      w[j].x |= (i >= j ? v.x << (i - j) : v.x >> (j - i)) & m;
      w[j].y |= (i >= j ? v.y << (i - j) : v.y >> (j - i)) & m;
      w[j].z |= (i >= j ? v.z << (i - j) : v.z >> (j - i)) & m;
      w[j].w |= (i >= j ? v.w << (i - j) : v.w >> (j - i)) & m;
    }
  }
}

// Planes J .. WIDTH - 1 that are below bits, each stored as one uint4.
template <int J, int WIDTH, typename Row>
__device__ __forceinline__ void store_planes4(const Row (&v)[GROUP], int bits,
                                              uint32_t* __restrict__ words, long long tile,
                                              int col) {
  if constexpr (J < WIDTH) {
    if (J < bits) {
      *reinterpret_cast<uint4*>(words + (tile * bits + J) * TILE_COLS + col) = plane<J>(v);
      store_planes4<J + 1, WIDTH>(v, bits, words, tile, col);
    }
  }
}

}  // namespace

template <typename V, bool VEC>
__global__ void __launch_bounds__(repro::THREADS)
pack_bits_kernel(const V* __restrict__ vals, uint32_t* __restrict__ words, long long n,
                 int bits) {
  using Row = typename RowOf<V>::type;
  constexpr int WIDTH = 8 * static_cast<int>(sizeof(V));
  const long long tile = blockIdx.x;
  const int col = 4 * static_cast<int>(threadIdx.x);
  Row v[GROUP];
  if (VEC && (tile + 1) * TILE_VALUES <= n) {
#pragma unroll
    for (int i = 0; i < GROUP; ++i)
      v[i] = *reinterpret_cast<const Row*>(vals + (tile * GROUP + i) * TILE_COLS + col);
  } else {
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const long long idx = (tile * GROUP + i) * TILE_COLS + col;
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = idx + k < n ? vals[idx + k] : 0u;
      v[i] = compose<V>(x[0], x[1], x[2], x[3]);
    }
  }
  store_planes4<0, WIDTH>(v, bits, words, tile, col);
  for (int j = WIDTH; j < bits; ++j)       // bits no value of this width has
    *reinterpret_cast<uint4*>(words + (tile * bits + j) * TILE_COLS + col) =
        make_uint4(0u, 0u, 0u, 0u);
}

// 32-bit values; MAXB is the smallest power of two that holds b, so every
// plane accumulated is one the words have, save at a b between two powers.
template <int MAXB, bool VEC>
__global__ void __launch_bounds__(repro::THREADS)
pack_bits32_kernel(const uint32_t* __restrict__ vals, uint32_t* __restrict__ words,
                   long long n, int bits) {
  const long long tile = blockIdx.x;
  const int col = 4 * static_cast<int>(threadIdx.x);
  uint4 w[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) w[j] = make_uint4(0u, 0u, 0u, 0u);
  if (VEC && (tile + 1) * TILE_VALUES <= n)
    gather32<MAXB, true>(vals, n, tile, col, w);
  else
    gather32<MAXB, false>(vals, n, tile, col, w);
#pragma unroll
  for (int j = 0; j < MAXB; ++j)
    if (j < bits) *reinterpret_cast<uint4*>(words + (tile * bits + j) * TILE_COLS + col) = w[j];
}

template <typename V>
void launch_pack(const void* vals, void* words, long long n, int bits, int tiles,
                 cudaStream_t stream) {
  static_assert(TILE_COLS == 4 * repro::THREADS, "a thread per four columns");
  const auto* v = static_cast<const V*>(vals);
  auto* w = static_cast<uint32_t*>(words);
  if (reinterpret_cast<uintptr_t>(vals) % (4 * sizeof(V)) == 0)
    pack_bits_kernel<V, true><<<tiles, repro::THREADS, 0, stream>>>(v, w, n, bits);
  else
    pack_bits_kernel<V, false><<<tiles, repro::THREADS, 0, stream>>>(v, w, n, bits);
}

template <int MAXB>
void launch_pack32(const void* vals, void* words, long long n, int bits, int tiles,
                   cudaStream_t stream) {
  const auto* v = static_cast<const uint32_t*>(vals);
  auto* w = static_cast<uint32_t*>(words);
  if (reinterpret_cast<uintptr_t>(vals) % 16 == 0)
    pack_bits32_kernel<MAXB, true><<<tiles, repro::THREADS, 0, stream>>>(v, w, n, bits);
  else
    pack_bits32_kernel<MAXB, false><<<tiles, repro::THREADS, 0, stream>>>(v, w, n, bits);
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
void launch_unpack(const uint32_t* words, uint32_t* vals, long long n, int bits, int tiles,
                   bool vec, cudaStream_t stream) {
  if (vec)
    unpack_bits_kernel<MAXB, true><<<tiles, repro::THREADS, 0, stream>>>(words, vals, n, bits);
  else
    unpack_bits_kernel<MAXB, false><<<tiles, repro::THREADS, 0, stream>>>(words, vals, n, bits);
}

// vals: n values of width 1, 2 or 4 bytes (uint8, uint16, 32-bit); words:
// tiles * bits * 1024 uint32, all written, 16-byte aligned.  One block of
// 256 threads per tile.
extern "C" int repro_pack_bits(const void* vals, void* words, long long n, int bits,
                               int tiles, int width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 1) launch_pack<uint8_t>(vals, words, n, bits, tiles, st);
  else if (width == 2) launch_pack<uint16_t>(vals, words, n, bits, tiles, st);
  else if (bits <= 1) launch_pack32<1>(vals, words, n, bits, tiles, st);
  else if (bits <= 2) launch_pack32<2>(vals, words, n, bits, tiles, st);
  else if (bits <= 4) launch_pack32<4>(vals, words, n, bits, tiles, st);
  else if (bits <= 8) launch_pack32<8>(vals, words, n, bits, tiles, st);
  else if (bits <= 16) launch_pack32<16>(vals, words, n, bits, tiles, st);
  else launch_pack32<32>(vals, words, n, bits, tiles, st);
  return static_cast<int>(cudaGetLastError());
}

// words: tiles * bits * 1024 uint32; vals: the first n values (n 64-bit),
// written, 16-byte aligned.  One block of 256 threads per tile.
extern "C" int repro_unpack_bits(const void* words, void* vals, long long n, int bits,
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

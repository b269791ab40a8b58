// quantize_ef for sm_90a: error feedback + uniform quantization, no pack.
//
// Replaces the Pallas kernel src/repro/kernels/quantize_ef.py:39
// quantize_ef (body :25).  Per value:
//
//   corrected = msg + cache
//   wire      = clip(floor((clip(corrected, vmin, vmax) - vmin) / delta + 0.5), 0, L)
//   new_cache = corrected - (wire * delta + vmin)
//
// with the wire as uint8_t for L <= 255, else uint16_t.  msg and cache are
// each float32, bf16 or fp16, as the Pallas kernel takes any float msg and
// cache and computes in float32 (:26-27); new_cache is written in msg's
// type, rounded to nearest even once (:33, newc in msg's dtype, :75).  With
// no cache (a null pointer) corrected = msg and only the wire is written:
// the downlink's quantize_encode(y) of the JAX deploy round.  The rounding
// is quant_pipeline's, from one definition (quant_levels.cuh), so the wire
// equals unpack_bits(quant_pipeline(msg, cache)) and the new caches agree
// bit for bit.
//
// Bound: bytes.  Per value it reads msg and cache and writes the wire and
// new_cache: 13 bytes for float32 and a uint8 wire, 7 for a bf16 pair, 3
// with no cache (bf16 msg); a dozen float operations per value are far
// below the card's rate.  On the training round's largest leaf (stablelm-
// 1.6b's MLP with its agent axis, 5.54e8 bf16 values) that is 3.88 GB,
// 1.157 ms at 3.35 TB/s.
//
// Design.  A grid-stride loop over groups of N = 16 / sizeof(msg) values:
// each thread loads its group's msg as one 16-byte vector (8 bf16 or fp16
// values, 4 float32) and its cache as 8, 16 or 32 bytes in 16-byte pieces,
// and stores its N wire ints and its new cache as one vector each, so a
// warp's every access is coalesced and wide.  Blocks: enough groups for 16
// blocks of 256 threads on each of the 132 SMs, then each thread loops.
// When a base is not aligned to its vector (a view into a payload), the
// whole call takes the loop value by value; the n % N values of the tail
// are taken value by value in any case.  n is 64-bit: a leaf of an agent-
// stacked table (gemma3-27b's, 2.82e9 values) is one launch.
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"
#include "quant_levels.cuh"

namespace {

// The element types, each with the raw type it is stored as: float32,
// bf16 and fp16 (codes 0, 1, 2 of the C entry point).
struct F32 {
  using raw = float;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
struct BF16 {
  using raw = unsigned short;
  static __device__ __forceinline__ float load(unsigned short x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  static __device__ __forceinline__ unsigned short store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
struct F16 {
  using raw = unsigned short;
  static __device__ __forceinline__ float load(unsigned short x) {
    return __half2float(__ushort_as_half(x));
  }
  static __device__ __forceinline__ unsigned short store(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

// N values at p as vectors of up to 16 bytes (p aligned to them).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&out)[N]) {
  constexpr int B = N * static_cast<int>(sizeof(T));
  if constexpr (B >= 16) {
#pragma unroll
    for (int k = 0; k < B / 16; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      memcpy(reinterpret_cast<char*>(out) + 16 * k, &u, 16);
    }
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(out, &u, 8);
  } else {
    static_assert(B == 4, "a group is 4, 8, 16 or 32 bytes");
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    memcpy(out, &u, 4);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&in)[N]) {
  constexpr int B = N * static_cast<int>(sizeof(T));
  if constexpr (B >= 16) {
#pragma unroll
    for (int k = 0; k < B / 16; ++k) {
      uint4 u;
      memcpy(&u, reinterpret_cast<const char*>(in) + 16 * k, 16);
      reinterpret_cast<uint4*>(p)[k] = u;
    }
  } else if constexpr (B == 8) {
    uint2 u;
    memcpy(&u, in, 8);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    static_assert(B == 4, "a group is 4, 8, 16 or 32 bytes");
    unsigned u;
    memcpy(&u, in, 4);
    *reinterpret_cast<unsigned*>(p) = u;
  }
}

struct Quant {
  float levels, vmin, vmax, delta, recip;
};

// One value: its wire int and, with a cache, its new cache.
template <typename M, typename C, typename W, bool CACHE>
__device__ __forceinline__ void quantize_one(typename M::raw m, typename C::raw c,
                                             const Quant& q, W& w,
                                             typename M::raw& nc) {
  const float corrected = CACHE ? __fadd_rn(M::load(m), C::load(c)) : M::load(m);
  const float level = repro::level_index(corrected, q.levels, q.vmin, q.vmax, q.recip);
  w = static_cast<W>(level);
  if (CACHE) nc = M::store(__fsub_rn(corrected, repro::decode_level(level, q.delta, q.vmin)));
}

template <typename M, typename C, typename W, bool CACHE, bool VEC>
__global__ void __launch_bounds__(repro::THREADS)
quantize_ef_kernel(const typename M::raw* __restrict__ msg,
                   const typename C::raw* __restrict__ cache, W* __restrict__ wire,
                   typename M::raw* __restrict__ new_cache, long long n, Quant q) {
  constexpr int N = 16 / static_cast<int>(sizeof(typename M::raw));
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;                       // values taken as whole groups
  if (VEC) {
    const long long groups = n / N;
    for (long long g = first; g < groups; g += stride) {
      const long long i = g * N;
      typename M::raw m[N], nc[N];
      typename C::raw c[N];
      W w[N];
      load_vec(msg + i, m);
      if (CACHE) load_vec(cache + i, c);
#pragma unroll
      for (int k = 0; k < N; ++k)
        quantize_one<M, C, W, CACHE>(m[k], CACHE ? c[k] : typename C::raw(), q, w[k], nc[k]);
      store_vec(wire + i, w);
      if (CACHE) store_vec(new_cache + i, nc);
    }
    done = groups * N;
  }
  for (long long i = done + first; i < n; i += stride) {
    typename M::raw nc;
    quantize_one<M, C, W, CACHE>(msg[i], CACHE ? cache[i] : typename C::raw(), q,
                                 wire[i], nc);
    if (CACHE) new_cache[i] = nc;
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename M, typename C, typename W, bool CACHE>
void launch(const void* msg, const void* cache, void* wire, void* new_cache,
            long long n, const Quant& q, cudaStream_t s) {
  constexpr int N = 16 / static_cast<int>(sizeof(typename M::raw));
  constexpr int CB = N * static_cast<int>(sizeof(typename C::raw));
  constexpr int WB = N * static_cast<int>(sizeof(W));
  const bool vec = aligned(msg, 16) && aligned(new_cache, 16) &&
                   aligned(cache, CB < 16 ? CB : 16) && aligned(wire, WB < 16 ? WB : 16);
  const unsigned blocks = repro::stride_blocks((n + N - 1) / N);
  const auto* m = static_cast<const typename M::raw*>(msg);
  const auto* c = static_cast<const typename C::raw*>(cache);
  auto* w = static_cast<W*>(wire);
  auto* nc = static_cast<typename M::raw*>(new_cache);
  if (vec)
    quantize_ef_kernel<M, C, W, CACHE, true><<<blocks, repro::THREADS, 0, s>>>(m, c, w, nc, n, q);
  else
    quantize_ef_kernel<M, C, W, CACHE, false><<<blocks, repro::THREADS, 0, s>>>(m, c, w, nc, n, q);
}

template <typename M, typename W>
void launch_for_cache(int cache_type, const void* msg, const void* cache, void* wire,
                      void* new_cache, long long n, const Quant& q, cudaStream_t s) {
  if (cache == nullptr) launch<M, M, W, false>(msg, nullptr, wire, nullptr, n, q, s);
  else if (cache_type == 1) launch<M, BF16, W, true>(msg, cache, wire, new_cache, n, q, s);
  else if (cache_type == 2) launch<M, F16, W, true>(msg, cache, wire, new_cache, n, q, s);
  else launch<M, F32, W, true>(msg, cache, wire, new_cache, n, q, s);
}

template <typename W>
void launch_for_msg(int msg_type, int cache_type, const void* msg, const void* cache,
                    void* wire, void* new_cache, long long n, const Quant& q,
                    cudaStream_t s) {
  if (msg_type == 1)
    launch_for_cache<BF16, W>(cache_type, msg, cache, wire, new_cache, n, q, s);
  else if (msg_type == 2)
    launch_for_cache<F16, W>(cache_type, msg, cache, wire, new_cache, n, q, s);
  else
    launch_for_cache<F32, W>(cache_type, msg, cache, wire, new_cache, n, q, s);
}

}  // namespace

// msg: n values of type msg_type; cache: n values of type cache_type, or
// null for none (then new_cache is null too); new_cache: n values of
// msg_type; types 0 float32, 1 bf16, 2 fp16.  wire: n uint8 (levels <= 255)
// or n uint16 (levels <= 65535).  delta: the float32 rounding of
// (vmax - vmin) / levels; recip: 1.0f / delta in float32.
extern "C" int repro_quantize_ef(const void* msg, const void* cache, void* wire,
                                 void* new_cache, long long n, int levels, float vmin,
                                 float vmax, float delta, float recip, int msg_type,
                                 int cache_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Quant q{static_cast<float>(levels), vmin, vmax, delta, recip};
  if (levels <= 255)
    launch_for_msg<uint8_t>(msg_type, cache_type, msg, cache, wire, new_cache, n, q, s);
  else
    launch_for_msg<uint16_t>(msg_type, cache_type, msg, cache, wire, new_cache, n, q, s);
  return static_cast<int>(cudaGetLastError());
}

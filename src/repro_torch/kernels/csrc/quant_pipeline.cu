// quant_pipeline for sm_90a: the fused EF -> quantize -> pack uplink.
//
// Replaces the Pallas kernel src/repro/kernels/compress_pipeline.py:112
// quant_pipeline (body :68).  Per value:
//
//   corrected = msg + cache
//   idx       = clip(floor((clip(corrected, vmin, vmax) - vmin) / delta + 0.5), 0, L)
//   new_cache = corrected - (idx * delta + vmin)
//
// and the indices are packed at b = ceil(log2(L + 1)) bits in the wire's
// transposed bit-plane layout (bitplanes.cuh).  The index never leaves
// registers.  Slots past n pack as index 0 and write no cache, which is what
// the JAX kernel's tail padding (msg = vmin, cache = 0) gives.
//
// Rounding: repro::level_index and repro::decode_level (quant_levels.cuh),
// bit-exact with the Pallas kernel as XLA compiles it.  msg and cache are
// float32 or bf16 (one type for both, the template T); the sweep computes in
// float32, as the Pallas kernel does (:70-77), and writes new_cache in T,
// rounded to nearest even once.
//
// Bound: bytes.  It reads 8 bytes and writes 4 bytes per float32 value (4
// and 2 in bf16), plus 4*b bytes per 32 values of words; a dozen float
// operations per value are far below the card's rate.  At the Fed-LT path's
// shape, (100, 100) values at b = 4 in one tile, it moves about 136 KB, some
// 0.04 us at 3.35 TB/s, so a launch is bound by launch latency.  On the
// training path's packed round (DeployFedLT, pack_wire) it takes each leaf
// of a bf16 model with its agent axis, up to 5.5e8 values.
#include <cuda_bf16.h>

#include "bitplanes.cuh"
#include "quant_levels.cuh"

using repro::GROUP;
using repro::TILE_COLS;

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

}  // namespace

template <typename T>
__global__ void quant_pipeline_kernel(const T* __restrict__ msg,
                                      const T* __restrict__ cache,
                                      uint32_t* __restrict__ words,
                                      T* __restrict__ new_cache,
                                      long long n, int bits, long long columns,
                                      float levels, float vmin, float vmax,
                                      float delta, float recip) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= columns) return;
  const long long tile = t / TILE_COLS;
  const int col = static_cast<int>(t % TILE_COLS);
  uint32_t v[GROUP];
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const long long idx = (tile * GROUP + i) * TILE_COLS + col;
    uint32_t q = 0u;
    if (idx < n) {
      const float corrected = __fadd_rn(to_f(msg[idx]), to_f(cache[idx]));
      const float level = repro::level_index(corrected, levels, vmin, vmax, recip);
      const float decoded = repro::decode_level(level, delta, vmin);
      store(new_cache + idx, __fsub_rn(corrected, decoded));
      q = static_cast<uint32_t>(level);
    }
    v[i] = q;
  }
  repro::store_planes(v, bits, words, tile, col);
}

template <typename T>
cudaError_t launch(const void* msg, const void* cache, void* words, void* new_cache, int n,
                   int bits, int tiles, int levels, float vmin, float vmax, float delta,
                   float recip, cudaStream_t stream) {
  quant_pipeline_kernel<T><<<repro::blocks_for(tiles), repro::THREADS, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const T*>(cache),
      static_cast<uint32_t*>(words), static_cast<T*>(new_cache), n, bits,
      static_cast<long long>(tiles) * TILE_COLS, static_cast<float>(levels),
      vmin, vmax, delta, recip);
  return cudaGetLastError();
}

// msg, cache, new_cache: n values of float32 (bf16 = 0) or bf16 (bf16 = 1);
// words: tiles * bits * 1024 uint32, all written.  delta: the float32
// rounding of (vmax - vmin) / levels; recip: 1.0f / delta in float32.
extern "C" int repro_quant_pipeline(const void* msg, const void* cache,
                                    void* words, void* new_cache, int n,
                                    int bits, int tiles, int levels, float vmin,
                                    float vmax, float delta, float recip, int bf16,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(msg, cache, words, new_cache, n, bits, tiles, levels,
                                   vmin, vmax, delta, recip, st)
           : launch<float>(msg, cache, words, new_cache, n, bits, tiles, levels, vmin,
                           vmax, delta, recip, st));
}

// quantize_ef for sm_90a: error feedback + uniform quantization, no pack.
//
// Replaces the Pallas kernel src/repro/kernels/quantize_ef.py:39
// quantize_ef (body :25).  Per value:
//
//   corrected = msg + cache
//   wire      = clip(floor((clip(corrected, vmin, vmax) - vmin) / delta + 0.5), 0, L)
//   new_cache = corrected - (wire * delta + vmin)
//
// with the wire as uint8_t for L <= 255, else uint16_t.  The rounding is
// quant_pipeline's, from one definition (quant_levels.cuh), so the wire
// equals unpack_bits(quant_pipeline(msg, cache)) and the new caches agree
// bit for bit.
//
// Bound: bytes.  It reads 8 bytes and writes 4 + sizeof(wire) bytes per
// value (13 for uint8, 14 for uint16); a dozen float operations per value
// are far below the card's rate.  The design is one value per thread in a
// grid-stride loop: neighbouring threads take neighbouring values, so
// every load and store of a warp is coalesced.  At the path's shape, one
// satellite's 2,048 values, a call moves 26.6 KB, under 0.01 us at
// 3.35 TB/s, so it is bound by launch latency.
#include "common.cuh"
#include "quant_levels.cuh"

template <typename Wire>
__global__ void quantize_ef_kernel(const float* __restrict__ msg,
                                   const float* __restrict__ cache,
                                   Wire* __restrict__ wire,
                                   float* __restrict__ new_cache, long long n,
                                   float levels, float vmin, float vmax,
                                   float delta, float recip) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float corrected = __fadd_rn(msg[i], cache[i]);
    const float level = repro::level_index(corrected, levels, vmin, vmax, recip);
    new_cache[i] = __fsub_rn(corrected, repro::decode_level(level, delta, vmin));
    wire[i] = static_cast<Wire>(level);
  }
}

// msg, cache, new_cache: n float32; wire: n uint8 (levels <= 255) or n
// uint16 (levels <= 65535).  delta: the float32 rounding of
// (vmax - vmin) / levels; recip: 1.0f / delta in float32.
extern "C" int repro_quantize_ef(const void* msg, const void* cache, void* wire,
                                 void* new_cache, int n, int levels, float vmin,
                                 float vmax, float delta, float recip,
                                 void* stream) {
  const unsigned blocks = repro::stride_blocks(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(msg);
  const float* c = static_cast<const float*>(cache);
  float* nc = static_cast<float*>(new_cache);
  const float l = static_cast<float>(levels);
  if (levels <= 255)
    quantize_ef_kernel<uint8_t><<<blocks, repro::THREADS, 0, s>>>(
        m, c, static_cast<uint8_t*>(wire), nc, n, l, vmin, vmax, delta, recip);
  else
    quantize_ef_kernel<uint16_t><<<blocks, repro::THREADS, 0, s>>>(
        m, c, static_cast<uint16_t*>(wire), nc, n, l, vmin, vmax, delta, recip);
  return static_cast<int>(cudaGetLastError());
}

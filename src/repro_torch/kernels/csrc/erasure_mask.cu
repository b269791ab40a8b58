// erasure_mask for sm_90a: counter-hash segment erasure over wire words.
//
// Replaces the Pallas kernel src/repro/kernels/erasure_mask.py:77
// erasure_mask (body :62).  For flat word i (a uint32_t that wraps, as the
// Pallas kernel's uint32 iota does) in segment s = i / segment_words:
//
//   h    = fmix32(fmix32(s * 0x9E3779B9 + seed_lo) ^ seed_hi)
//   keep = h >= threshold            (threshold = round(p * 2**32), capped)
//   out  = word * keep
//
// fmix32 is murmur3's 32-bit finalizer.  All arithmetic is on uint32_t,
// which wraps modulo 2**32 as the JAX kernel's uint32 does, so the keep
// mask equals the Pallas kernel's word for word.  A segment's fate depends
// only on (seed, s): no state, any grid.
//
// Bound: bytes.  It reads 4 bytes and writes 8 (masked word and keep) per
// word; the hash is some 20 integer operations per word, far below the
// card's rate.  The design is one word per thread in a grid-stride loop,
// so every load and store of a warp is coalesced, and the outputs have the
// input's length (the JAX kernel pads to 256 x 128-word tiles and trims).
#include "common.cuh"

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void erasure_mask_kernel(const uint32_t* __restrict__ words,
                                    uint32_t* __restrict__ out,
                                    uint32_t* __restrict__ keep, long long n,
                                    uint32_t segment_words, uint32_t seed_lo,
                                    uint32_t seed_hi, uint32_t threshold) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t seg = static_cast<uint32_t>(i) / segment_words;
    const uint32_t h = fmix32(fmix32(seg * 0x9E3779B9u + seed_lo) ^ seed_hi);
    const uint32_t k = h >= threshold ? 1u : 0u;
    out[i] = words[i] * k;
    keep[i] = k;
  }
}

// words, out, keep: n uint32.  segment_words >= 1; seed_lo / seed_hi: the
// low and high 32 bits of the seed; threshold: drop_threshold(p).
extern "C" int repro_erasure_mask(const void* words, void* out, void* keep,
                                  int n, unsigned segment_words,
                                  unsigned seed_lo, unsigned seed_hi,
                                  unsigned threshold, void* stream) {
  erasure_mask_kernel<<<repro::stride_blocks(n), repro::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(keep), n, segment_words, seed_lo, seed_hi,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

// sign_pipeline for sm_90a: the fused scaled-sign -> EF -> 1-bit pack uplink,
// its scale reduction included, in one cooperative launch.
//
// Replaces the Pallas kernel src/repro/kernels/compress_pipeline.py:152
// sign_pipeline (body :81), and the jnp reduction the JAX package runs
// before it (:162-164).  Per value:
//
//   corrected = msg + cache
//   scale     = mean |corrected|               (over all n values)
//   bit       = corrected >= 0                 (0 and -0.0 give 1)
//   new_cache = corrected - (bit ? scale : -scale)
//
// and the bits are packed at b = 1 in the wire's transposed bit-plane
// layout (bitplanes.cuh).  Slots past n pack as bit 0 and write no cache,
// which is what the JAX kernel's tail padding (msg = -1, cache = 0, :160)
// gives.
//
// Bound: bytes.  The function reads msg and cache once (8 bytes per
// float32 value, 4 per bf16 one), writes new_cache (4, or 2) and one word
// per 32 values: 12.125 bytes per float32 value (6.125 in bf16), 0.0607 ms at 2**24 values and 3.35 TB/s.  This design reads
// msg and cache a second time once the scale is known (every new_cache
// depends on it): 20.125 bytes per value from device memory, or
// 12.125 n + max(0, 8 n - L2) = 17.0 per value at 2**24 where the 50 MB
// L2 serves what it can hold of the second read.  Those two figures are
// the design's, not the function's; a stash of corrected in shared memory
// and registers across the sync would spare part of the second read.
//
// Design.  One persistent launch (cudaLaunchCooperativeKernel) of at most
// as many blocks of 256 threads as fit on the card at once.
// Thread work comes in quads, four neighbouring columns of a tile (16-byte
// loads and stores); a chunk is 32 consecutive quads, one per lane of a
// warp, 4096 values.  Each warp owns a contiguous run of chunks, so each
// block owns a contiguous run of tile columns.  Rows of the last tile that
// lie wholly past n are not visited.
//
//   pass 1  each warp reads its chunks forward, row 0 to 31, BATCH rows in
//           flight, and sums |msg + cache| of each chunk in float64 in a
//           fixed order (lane: rows then columns; warp: an xor butterfly);
//           one partial per chunk goes to a scratch buffer.  Nothing else
//           is written.
//   sync    this_grid().sync().
//   scale   every block sums all partials in one fixed order (thread t:
//           partials t, t + 256, ...; then the butterfly; then warps 0..7),
//           so every block, every grid size and every call get the same
//           scale bit for bit.  scale = float(total / n); block 0 writes it.
//   pass 2  each warp walks its chunks and rows in the reverse of pass 1's
//           order, so that the lines pass 1 read last are read first while
//           the L2 may still hold them; it writes the four words of its
//           quad as one uint4 and new_cache with streaming stores.  On the
//           H100 that reuse does not show: the time is that of 20 bytes per
//           value (PERF.md).
//
// msg, cache and new_cache are float32 or bf16, one type for all three
// (the template T), as the Pallas kernel takes any float msg and cache
// (:81-89): both passes and the scale compute in float32 (the partials in
// float64), and new_cache is written in T, rounded to nearest even once.
// A quad is read with one 16-byte (float32) or 8-byte (bf16) load when msg,
// cache and new_cache are all aligned to a quad's bytes; a view off that
// (msg[1:]) takes loads and stores of one value each (VEC = false), with
// no copy.  A quad that crosses n is read and written value by value.  The work split and the summation order are
// modelled in numpy by test_torch_kernels.py; chip_smoke.py holds the
// card's scale to the same order's sum bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "bitplanes.cuh"

namespace cg = cooperative_groups;
using repro::GROUP;
using repro::THREADS;
using repro::TILE_COLS;

constexpr int WARPS = THREADS / 32;
constexpr int QUAD = 4;                               // columns per thread
constexpr int CHUNKS_PER_TILE = TILE_COLS / (QUAD * 32);   // 8
constexpr int BATCH = 8;                              // rows in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// four values at p + idx as floats, 0 past n: one 16-byte (float32) or
// 8-byte (bf16) load when VEC and the quad lies inside n (STREAM: the last
// read, evict first)
template <typename T, bool VEC, bool STREAM>
__device__ __forceinline__ float4 load_quad(const T* __restrict__ p, long long idx,
                                            long long n) {
  if (VEC && idx + QUAD <= n) {
    if constexpr (sizeof(T) == 4) {
      const float4* q = reinterpret_cast<const float4*>(p + idx);
      return STREAM ? __ldcs(q) : __ldcg(q);
    } else {
      const uint2* q = reinterpret_cast<const uint2*>(p + idx);
      const uint2 u = STREAM ? __ldcs(q) : __ldcg(q);
      const float2 a = unpack2(u.x), b = unpack2(u.y);
      return make_float4(a.x, a.y, b.x, b.y);
    }
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (idx < n) v.x = to_f(p[idx]);
  if (idx + 1 < n) v.y = to_f(p[idx + 1]);
  if (idx + 2 < n) v.z = to_f(p[idx + 2]);
  if (idx + 3 < n) v.w = to_f(p[idx + 3]);
  return v;
}

// a whole quad of new_cache: one streaming store of 16 (float32) or 8
// (bf16) bytes
__device__ __forceinline__ void store_quad(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, float4 v) {
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(pack2(v.x, v.y), pack2(v.z, v.w)));
}

// batches of BATCH rows of chunk c that hold values: GROUP / BATCH but in
// the last tile, where the rows past n are not visited (they add +0 to the
// sum and pack as bit 0)
__device__ __forceinline__ int chunk_batches(long long c, long long n) {
  const long long first = (c / CHUNKS_PER_TILE) * GROUP * TILE_COLS +
                          (c % CHUNKS_PER_TILE) * 32 * QUAD;
  const long long rows = (n - first + TILE_COLS - 1) / TILE_COLS;
  if (rows <= 0) return 0;
  return rows >= GROUP ? GROUP / BATCH : static_cast<int>((rows + BATCH - 1) / BATCH);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
sign_pipeline_kernel(const T* __restrict__ msg, const T* __restrict__ cache,
                     uint32_t* __restrict__ words, T* __restrict__ new_cache,
                     float* __restrict__ scale_out, double* __restrict__ partials,
                     long long n, long long chunks) {
  __shared__ double warp_part[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  const long long gw = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const long long lo = gw * chunks / warps;
  const long long hi = (gw + 1) * chunks / warps;

  // pass 1: one float64 partial of |msg + cache| per chunk
  for (long long c = lo; c < hi; ++c) {
    const long long base = (c / CHUNKS_PER_TILE) * GROUP * TILE_COLS +
                           ((c % CHUNKS_PER_TILE) * 32 + lane) * QUAD;
    double acc = 0.0;
    const int batches = chunk_batches(c, n);
#pragma unroll 1
    for (int i0 = 0; i0 < batches * BATCH; i0 += BATCH) {
      float4 m[BATCH], k[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const long long idx = base + static_cast<long long>(i0 + u) * TILE_COLS;
        m[u] = load_quad<T, VEC, false>(msg, idx, n);
        k[u] = load_quad<T, VEC, false>(cache, idx, n);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        acc += static_cast<double>(fabsf(__fadd_rn(m[u].x, k[u].x)));
        acc += static_cast<double>(fabsf(__fadd_rn(m[u].y, k[u].y)));
        acc += static_cast<double>(fabsf(__fadd_rn(m[u].z, k[u].z)));
        acc += static_cast<double>(fabsf(__fadd_rn(m[u].w, k[u].w)));
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) partials[c] = acc;
  }

  cg::this_grid().sync();

  // the scale: all partials, in one order whatever the block or the grid
  double t = 0.0;
  for (long long c = threadIdx.x; c < chunks; c += THREADS) t += __ldcg(partials + c);
  t = warp_sum(t);
  if (lane == 0) warp_part[warp] = t;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += warp_part[w];
  const float scale = __double2float_rn(total / static_cast<double>(n));
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;

  // pass 2: pass 1's order reversed; words and new_cache
  for (long long c = hi - 1; c >= lo; --c) {
    const long long tile = c / CHUNKS_PER_TILE;
    const int col = static_cast<int>((c % CHUNKS_PER_TILE) * 32 + lane) * QUAD;
    const long long base = tile * GROUP * TILE_COLS + col;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
    for (int i0 = (chunk_batches(c, n) - 1) * BATCH; i0 >= 0; i0 -= BATCH) {
      float4 m[BATCH], k[BATCH];
#pragma unroll
      for (int u = BATCH - 1; u >= 0; --u) {
        const long long idx = base + static_cast<long long>(i0 + u) * TILE_COLS;
        m[u] = load_quad<T, VEC, true>(msg, idx, n);
        k[u] = load_quad<T, VEC, true>(cache, idx, n);
      }
#pragma unroll
      for (int u = BATCH - 1; u >= 0; --u) {
        const int i = i0 + u;
        const long long idx = base + static_cast<long long>(i) * TILE_COLS;
        if (idx >= n) continue;
        const float4 cor = make_float4(__fadd_rn(m[u].x, k[u].x), __fadd_rn(m[u].y, k[u].y),
                                       __fadd_rn(m[u].z, k[u].z), __fadd_rn(m[u].w, k[u].w));
        const bool bx = cor.x >= 0.f, by = cor.y >= 0.f, bz = cor.z >= 0.f,
                   bw = cor.w >= 0.f;
        const float4 out = make_float4(__fsub_rn(cor.x, bx ? scale : -scale),
                                       __fsub_rn(cor.y, by ? scale : -scale),
                                       __fsub_rn(cor.z, bz ? scale : -scale),
                                       __fsub_rn(cor.w, bw ? scale : -scale));
        if (VEC && idx + QUAD <= n) {
          w.x |= static_cast<uint32_t>(bx) << i;
          w.y |= static_cast<uint32_t>(by) << i;
          w.z |= static_cast<uint32_t>(bz) << i;
          w.w |= static_cast<uint32_t>(bw) << i;
          store_quad(new_cache + idx, out);
        } else {                      // value by value; slots past n stay bit 0
          w.x |= static_cast<uint32_t>(bx) << i;
          store(new_cache + idx, out.x);
          if (idx + 1 < n) { w.y |= static_cast<uint32_t>(by) << i; store(new_cache + idx + 1, out.y); }
          if (idx + 2 < n) { w.z |= static_cast<uint32_t>(bz) << i; store(new_cache + idx + 2, out.z); }
          if (idx + 3 < n) { w.w |= static_cast<uint32_t>(bw) << i; store(new_cache + idx + 3, out.w); }
        }
      }
    }
    *reinterpret_cast<uint4*>(words + tile * TILE_COLS + col) = w;
  }
}

template <typename T, bool VEC>
int launch_sign(const T* msg, const T* cache, uint32_t* words, T* new_cache,
                float* scale, double* partials, long long n, long long chunks,
                cudaStream_t stream) {
  // blocks that fit on the card at once, per device (computed once)
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sign_pipeline_kernel<T, VEC>, THREADS, 0)))
      return static_cast<int>(err);
    if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
    resident[dev] = sms * per_sm;
  }
  const long long want = (chunks + WARPS - 1) / WARPS;
  const unsigned grid = static_cast<unsigned>(want < resident[dev] ? want : resident[dev]);
  void* args[] = {&msg, &cache, &words, &new_cache, &scale, &partials, &n, &chunks};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sign_pipeline_kernel<T, VEC>), dim3(grid),
      dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* msg, const void* cache, void* words, void* new_cache, void* scale,
             void* partials, long long n, long long chunks, cudaStream_t st) {
  const auto* m = static_cast<const T*>(msg);
  const auto* k = static_cast<const T*>(cache);
  auto* w = static_cast<uint32_t*>(words);
  auto* nc = static_cast<T*>(new_cache);
  auto* s = static_cast<float*>(scale);
  auto* p = static_cast<double*>(partials);
  const bool vec = (reinterpret_cast<uintptr_t>(msg) | reinterpret_cast<uintptr_t>(cache) |
                    reinterpret_cast<uintptr_t>(new_cache)) % (QUAD * sizeof(T)) == 0;
  return vec ? launch_sign<T, true>(m, k, w, nc, s, p, n, chunks, st)
             : launch_sign<T, false>(m, k, w, nc, s, p, n, chunks, st);
}

// msg, cache, new_cache: n values of float32 (bf16 = 0) or bf16 (bf16 = 1),
// new_cache aligned to 16 bytes, as from torch.empty; words: tiles * 1024
// uint32, all written; scale: one float32, written; partials: tiles * 8
// float64 of scratch.  Returns a CUDA error code, cudaErrorNotSupported
// where the card has no cooperative launch.
extern "C" int repro_sign_pipeline(const void* msg, const void* cache, void* words,
                                   void* new_cache, void* scale, void* partials,
                                   int n, int tiles, int bf16, void* stream) {
  static_assert(TILE_COLS == CHUNKS_PER_TILE * 32 * QUAD, "chunks tile a tile");
  const long long chunks = static_cast<long long>(tiles) * CHUNKS_PER_TILE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(msg, cache, words, new_cache, scale, partials, n,
                                        chunks, st)
              : dispatch<float>(msg, cache, words, new_cache, scale, partials, n, chunks,
                                st);
}

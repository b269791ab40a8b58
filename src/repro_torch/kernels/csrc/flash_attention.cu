// flash_attention for sm_90a: blocked online-softmax attention.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:87
// flash_attention (body :27), with explicit positions as the JAX model's
// attention_chunked takes them:
//
//   s    = (q . k) / sqrt(D)                       float32
//   s    = cap * tanh(s / cap)                     with a softcap
//   s    = -1e30 unless k_pos <= q_pos (causal) and k_pos > q_pos - window
//   out  = softmax(s) . v                          cast to q's type once
//
// q is (B, Sq, H, D), k and v are (B, Sk, Hkv, D) with H % Hkv == 0; head h
// reads KV head h / (H / Hkv) in place, so GQA needs no expanded copy.  The
// three inputs are read through their strides (the last one must be 1), so
// the (B, S, H, D) views of x @ wq need no transpose.  float32 and bf16
// inputs; both are taken to float32 on load, as the Pallas kernel upcasts.
//
// It now serves flash_attention's float32 route only: bf16 goes to
// csrc/flash_attention_sm90.cu (wgmma has no float32 inputs, and TF32
// would not hold the float32 check's 2e-5).  Its bf16 instantiation stays
// for timing beside that kernel: chip_smoke.py calls it through its
// launcher, flash_attention.py _launch_simt.
//
// Design (simple first): one block of 256 threads per (query tile of 64
// rows, b*h).  The block keeps Q^T in shared memory as float32 and walks
// the key tiles of 64 in increasing order, staging K^T and V in shared
// memory.  A 16 x 16 thread grid computes the
// 64 x 64 scores, 4 x 4 per thread, keeps the running max m and sum l of
// its 4 rows in registers (reduced over the 16 threads of a row with warp
// shuffles) and accumulates 4 rows x D/16 columns of the output, all in
// float32.  Masked scores are the finite sentinel -1e30, as in the Pallas
// kernel (:24, :66): a row whose first visited tile holds only masked keys
// accumulates p = 1 against m = -1e30, and its first valid key wipes that,
// since exp(-1e30 - m) is 0.  With -inf that step would be NaN.  The end
// divides by max(l, 1e-30) (:81).
//
// Band skipping: a key tile is skipped only when every one of its pairs
// with the query tile's position range [q_lo, q_hi] is masked (k_pos >
// q_hi when causal, k_pos <= q_lo - window with a window), decided by the
// whole block with __syncthreads_or.  For a sliding-window layer this
// keeps the work at O(S * W).  A row that sees no key at all (its tiles
// all skipped or masked) gets what the sentinel gives it, the mean of V
// over the Sk keys, read from global memory in the epilogue.  Query tiles
// are taken in reverse so the longest causal rows start first.
//
// Bound: operations, on the float32 pipes (67 TFLOP/s): at the depth-2
// float32 prefill's shape (B = 1, S = 5000, H = 32, Hkv = 8, D = 120,
// W = 4096) the band holds 12.1 M visible pairs per (b, h), 4 * D flops
// each: 1.86e11 flops, 2.77 ms.  This kernel runs the products from
// shared memory (one shared load for every two or so fused multiply-adds),
// so it is bound by shared-memory bandwidth, above that bound.
#include "common.cuh"

#include <climits>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int BK = 64;                // keys per tile
constexpr int NT = 256;               // threads: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {                      // element strides of (B, S, H); D is 1
  long long b, s, h;
};

// Shared memory, in floats: Q^T [D][BQ+1]; K^T [D][BK+1], reused for P^T
// [BK][BQ+1] once the scores are in registers; V [BK][16*NJ]; then BK ints
// of key positions.  The +1 rows keep the transposing stores free of bank
// conflicts.
inline size_t smem_bytes(int d, int nj) {
  const size_t kt = static_cast<size_t>(d) * (BK + 1);
  const size_t pt = static_cast<size_t>(BK) * (BQ + 1);
  return sizeof(float) * (static_cast<size_t>(d) * (BQ + 1) + (kt > pt ? kt : pt)
                          + static_cast<size_t>(BK) * 16 * nj)
         + sizeof(int) * BK;
}

// Thread (ty, tx) owns rows ty + 16 i (i < 4) and output columns tx + 16 j
// (j < NJ), so D <= 16 * NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, Strides qs, Strides ks,
                       Strides vs, int H, int n_rep, int Sq, int Sk, int D,
                       int causal, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  constexpr int DP = 16 * NJ;
  float* qT = smem;                               // [D][BQ + 1]
  float* kT = qT + D * (BQ + 1);                  // [D][BK + 1]
  float* pT = kT;                                 // [BK][BQ + 1], after S
  const int kt_floats = D * (BK + 1) > BK * (BQ + 1) ? D * (BK + 1) : BK * (BQ + 1);
  float* vS = kT + kt_floats;                     // [BK][DP]
  int* kp = reinterpret_cast<int*>(vS + BK * DP); // [BK]
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, hk = h / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  if (tid == 0) { q_lo = INT_MAX; q_hi = INT_MIN; }
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    qT[d * (BQ + 1) + r] = q0 + r < Sq ? load_f(qb + (q0 + r) * qs.s + d) : 0.f;
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Sq) {
    const int p = q_pos[q0 + tid];
    atomicMin(&q_lo, p);
    atomicMax(&q_hi, p);
  }
  int qp[4];
  bool q_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    q_ok[i] = r < Sq;
    qp[i] = q_ok[i] ? q_pos[r] : 0;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();
  const long long lo = q_lo, hi = q_hi;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    // -- positions of the tile; skip it when no pair can be visible --------
    int any = 0;
    if (tid < BK) {
      const int kk = k0 + tid;
      const int p = kk < Sk ? k_pos[kk] : 0;
      kp[tid] = p;
      bool ok = kk < Sk;
      if (causal) ok = ok && p <= hi;
      if (window > 0) ok = ok && p > lo - window;
      any = ok;
    }
    if (!__syncthreads_or(any)) continue;

    // -- stage K^T and V (float32) --------------------------------------
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D;
      const int kk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kk < Sk) {
        kx = load_f(kb + kk * ks.s + d);
        vx = load_f(vb + kk * vs.s + d);
      }
      kT[d * (BK + 1) + r] = kx;
      vS[r * DP + d] = vx;
    }
    __syncthreads();

    // -- scores: rows ty + 16 i, keys tx + 16 j ---------------------------
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qT[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kT[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // -- softcap, mask, online softmax ----------------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int p = kp[key];
        bool ok = q_ok[i] && k0 + key < Sk;
        if (causal) ok = ok && p <= qp[i];
        if (window > 0) ok = ok && static_cast<long long>(p) > qp[i] - static_cast<long long>(window);
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                  // every thread is done reading K^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pT[(tx + 16 * j) * (BQ + 1) + ty + 16 * i] = s[i][j];
    __syncthreads();

    // -- acc += P V ---------------------------------------------------------
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], c[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pT[kk * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[j] = vS[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], c[j], acc[i][j]);
    }
    __syncthreads();                  // before the next tile overwrites K^T, V
  }

  // -- a row that sees no key: every score is the sentinel, so its softmax
  //    is uniform over the Sk keys and its output the mean of V ----------
  bool none[4], any_none = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    none[i] = q_ok[i] && m[i] == NEG_INF;
    any_none = any_none || none[i];
  }
  float mean[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) mean[j] = 0.f;
  if (any_none) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d >= D) continue;
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int kk = 0;
      for (; kk + 8 <= Sk; kk += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) part[e] += load_f(vb + (kk + e) * vs.s + d);
      }
      for (; kk < Sk; ++kk) part[0] += load_f(vb + kk * vs.s + d);
      mean[j] = ((part[0] + part[1]) + (part[2] + part[3]) +
                 ((part[4] + part[5]) + (part[6] + part[7]))) / static_cast<float>(Sk);
    }
  }

  // -- out = acc / max(l, 1e-30), (B, Sq, H, D) contiguous -----------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!q_ok[i]) continue;
    const int r = q0 + ty + 16 * i;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store_f(orow + d, none[i] ? mean[j] : acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* q_pos, const void* k_pos, Strides qs, Strides ks,
                   Strides vs, int B, int H, int Hkv, int Sq, int Sk, int D,
                   int causal, int window, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, NJ><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), qs, ks, vs,
      H, H / Hkv, Sq, Sk, D, causal, window, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D), read through the given element
// strides of their first three dimensions (the last is 1); out (B, Sq, H, D)
// contiguous, of q's type; q_pos (Sq,) and k_pos (Sk,) int32.  window <= 0
// means none, softcap <= 0 none.  bf16 != 0: the tensors are bf16, else
// float32.  D <= 128; B * H <= 65535.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, const void* q_pos,
    const void* k_pos, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int B, int H, int Hkv, int Sq, int Sk, int D,
    int causal, int window, float scale, float softcap, int bf16, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 64) {
    err = bf16 ? launch<__nv_bfloat16, 4>(q, k, v, out, q_pos, k_pos, qs, ks, vs, B, H,
                                          Hkv, Sq, Sk, D, causal, window, scale,
                                          softcap, st)
               : launch<float, 4>(q, k, v, out, q_pos, k_pos, qs, ks, vs, B, H, Hkv,
                                  Sq, Sk, D, causal, window, scale, softcap, st);
  } else {
    err = bf16 ? launch<__nv_bfloat16, 8>(q, k, v, out, q_pos, k_pos, qs, ks, vs, B, H,
                                          Hkv, Sq, Sk, D, causal, window, scale,
                                          softcap, st)
               : launch<float, 8>(q, k, v, out, q_pos, k_pos, qs, ks, vs, B, H, Hkv,
                                  Sq, Sk, D, causal, window, scale, softcap, st);
  }
  return static_cast<int>(err);
}

// flash_attention_bwd_sm90 for sm_90a: the gradient of flash_attention's
// bf16 route on Hopper's tensor cores, fed by TMA.
//
// The JAX package has no Pallas backward: it differentiates its chunked
// attention (src/repro/models/attention.py:136) in XLA, and its Pallas
// kernel src/repro/kernels/flash_attention.py:87 has no custom_vjp.  The
// port trains through its forward kernel flash_attention_sm90.cu, so this
// kernel is the port's own; csrc/flash_attention_bwd.cu keeps the float32
// route.  With s = q.k / sqrt(D), s' = cap tanh(s / cap) (softcap), the
// mask setting s' to -1e30, P = softmax(s') and O = P V:
//
//   D_i   = sum_d dO_id O_id
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . V_j - D_i) (1 - tanh^2(s_ij / cap))   visible pairs
//   dQ_i  = sum_j dS_ij K_j / sqrt(D),   dK_j = sum_i dS_ij Q_i / sqrt(D)
//
// GQA: dK and dV of KV head hk sum over the group's n_rep query heads, in
// head order.  A row that sees no key takes the mean of V in the forward:
// its P is 1/Sk over every key, so it adds dO_i / Sk to every dV_j and
// nothing to dQ or dK.
//
// The forward saves what the backward needs (flash_attention_sm90.cu, when
// asked): each row's log-sum-exp in log2 units, LSE_i = m_i + log2(l_i)
// (+inf for a row that sees no key or lies past Sq, so that its P is 0),
// in rows of lse_stride floats, and O in float32.  D comes from the
// float32 O: from the bf16 one it is off by about |dO||O| 2**-8, which the
// check's 1e-3 atol does not take where dq is 0.  One call enqueues three
// grids:
//
//   prep  one block per (b, h, 64 rows): D_i = rowsum(dO o O) by a warp per
//         row, an xor butterfly over the lanes, and the count of the rows
//         that see no key (LSE = +inf); bound by bytes (dO and O once);
//   dkdv  one block per (b, hk, 64 keys), longest first: K and V stay in
//         shared memory; a producer warp runs a ring of Q and dO tiles of
//         BQ rows (64 for D <= 64, else 32) and their LSE and D through TMA
//         and mbarriers, over the group's heads and the visible query tiles;
//         one consumer warpgroup computes, with keys as the 64 rows,
//
//           S^T  = K Q^T,  dP^T = V dO^T    wgmma m64nBQk16, both from shared
//                                           memory, K-major
//           P^T  = exp2(S^T scale log2e - LSE),  dS^T = P^T (dP^T - D) chain
//                                           in registers
//           dV  += (P^T_hi + P^T_lo) dO     wgmma, A from registers, B = dO
//           dK  += (dS^T_hi + dS^T_lo) Q    and Q read MN-major
//
//         then adds the rows that see no key (their dO / Sk) to dV and
//         writes dK (times 1/sqrt(D)) and dV in bf16.  The accumulators'
//         sums round toward zero at every step, so one chain over a group
//         of 48 heads (granite-20b's MQA) drifts from the plain sum by
//         1.5e-4 of its size on average and its worst elements by over one
//         bf16 rounding, against 6e-6 for one head (bench/attention_bwd.py
//         measures both).  So a chain takes as many heads as keep it within
//         CHAIN_TILES query tiles (at least one); then the accumulators are
//         added by FADDs to a float32 sum in global memory (dk32, dv32:
//         rows only this block touches) and start again from zero, and the
//         last chain adds that sum before the store;
//   dq    one block per (b, h, 64 query rows), longest first: Q and dO stay
//         in shared memory, a ring of K and V tiles of 64 keys;
//
//           S = Q K^T,  dP = dO V^T,  P,  dS,  dQ += (dS_hi + dS_lo) K
//
//         and writes dQ (times 1/sqrt(D)) in bf16.
//
// Both kernels use 160 threads (a consumer warpgroup and a producer warp)
// and run two blocks to an SM, so one block's element-wise work overlaps
// the other's wgmma.  No atomics: every sum runs in one fixed order, so two
// calls give equal bits.  Which tiles a block visits follows
// flash_attention.py tile_plan's rule, decided in a prologue from the
// tiles' ranges of positions: 0 skips a tile, 1 visits it with the
// per-element mask, 2 visits it with every pair visible.  D = 120 is
// padded to 128 by TMA's zero fill; the wrapper copies other D to a
// multiple of 8 (tma_layout).
//
// Why P and dS are split.  Products in float32 from bf16 Q, K, V and dO,
// the gradient rounded once, against the check |kernel - plain| <=
// 2**-7 |plain| + 1e-3: with P rounded once to bf16, dV fails it; with dS
// rounded once, dQ and dK fail it; with both as hi + lo (relative error
// about 2**-17) all pass (a CPU emulation, test_torch_attention_grad.py).
// So every product with P or dS as an operand takes two wgmma terms.
//
// Bound: operations.  From the forward's saved log-sum-exp and O, the
// function needs five S^2 D products: Q K^T (for P), dO V^T, P^T dO,
// dS^T Q and dS K (the forward's P V for D is not redone).  This design
// runs ten: the dkdv grid's S^T, dP^T and two terms each of dV and dK, the
// dq grid's S, dP and two terms of dQ.  At the training path's shape
// (stablelm-1.6b, B = 2, S = 2048, H = Hkv = 32, D = 64, causal) the five
// take 0.0869 ms at 989 TFLOP/s; the splits and the recomputed S and dP
// are the design's overhead, not part of the bound.
#include "common.cuh"
#include "sm90.cuh"

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>

namespace {

using namespace sm90;

constexpr int BLK = 64;               // keys per tile; query rows per tile of dq
constexpr int THREADS = 160;          // one consumer warpgroup, one producer warp
constexpr int CONSUMERS = 128;
constexpr int STAGES = 2;             // tiles in flight in each ring
constexpr int BOX_ROW = BOX * 2;      // bytes of one row of a box
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

struct Params {
  const int* q_pos;
  const int* k_pos;
  const float* lse;           // (B, H, lse_stride): +inf past Sq
  const float* o32;           // (B, Sq, H, D) float32
  float* delta;               // (B, H, lse_stride), written by prep
  int* nokey;                 // (B, H, lse_stride / 64), written by prep
  const __nv_bfloat16* dout;  // read directly by prep and for rows that see no key
  long long do_sb, do_ss, do_sh;
  __nv_bfloat16* dq;          // (B, Sq, H, D) contiguous
  __nv_bfloat16* dk;          // (B, Sk, Hkv, D) contiguous
  __nv_bfloat16* dv;
  float* dk32;                // (B, Sk, Hkv, D) float32: the group's sums (n_rep > 1)
  float* dv32;
  int H, Hkv, n_rep, Sq, Sk, D, causal, window, lse_stride;
  float scale, softcap;
};

// Shared memory of a dkdv block, from a 1024-byte aligned base: K and V
// [HALVES][64][64] bf16, then STAGES x Q and STAGES x dO [HALVES][BQ][64],
// STAGES x LSE and STAGES x D [BQ] float, the barriers (kv_full, full and
// empty per stage), the no-key rows' dO sum (float [128]) and the plan (a
// byte per query tile).  CPU copy: flash_attention.py sm90_bwd_smem_bytes.
template <int HALVES, int BQ>
struct DkdvSmem {
  static constexpr int KV_BOX = BLK * BOX_ROW;
  static constexpr int Q_BOX = BQ * BOX_ROW;
  static constexpr int K = 0;
  static constexpr int V = K + HALVES * KV_BOX;
  static constexpr int Q = V + HALVES * KV_BOX;
  static constexpr int DO = Q + STAGES * HALVES * Q_BOX;
  static constexpr int LSE = DO + STAGES * HALVES * Q_BOX;
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int BARS = DELTA + STAGES * BQ * 4;
  static constexpr int MEAN = BARS + 8 * (1 + 2 * STAGES);
  static constexpr int PLAN = MEAN + 4 * 128;
  static int bytes(int n_qt) { return PLAN + (n_qt + 15) / 16 * 16 + 1024; }
};

// Shared memory of a dq block: Q and dO [HALVES][64][64], then STAGES x K
// and STAGES x V [HALVES][64][64], the barriers (q_full, full and empty per
// stage) and the plan (a byte per key tile).
template <int HALVES>
struct DqSmem {
  static constexpr int TILE_BOX = BLK * BOX_ROW;
  static constexpr int Q = 0;
  static constexpr int DO = Q + HALVES * TILE_BOX;
  static constexpr int K = DO + HALVES * TILE_BOX;
  static constexpr int V = K + STAGES * HALVES * TILE_BOX;
  static constexpr int BARS = V + STAGES * HALVES * TILE_BOX;
  static constexpr int PLAN = BARS + 8 * (1 + 2 * STAGES);
  static int bytes(int n_kt) { return PLAN + (n_kt + 15) / 16 * 16 + 1024; }
};

// (min, max) of pos[t0 .. t0 + rows - 1] (those < n), rows <= 64, by one
// warp; every lane gets the answer.
__device__ __forceinline__ void tile_range(const int* pos, int n, int t0, int rows, int& lo,
                                           int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = t0 + 32 * i + lane;
    if (32 * i + lane < rows && r < n) {
      const int x = pos[r];
      lo = min(lo, x);
      hi = max(hi, x);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

__device__ __forceinline__ bool visible(long long qp, long long kp, const Params& p) {
  bool ok = true;
  if (p.causal) ok = kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// 2**x by one MUFU.EX2 (about 2 ulp, results below 2**-126 flushed to 0):
// here x is a score minus its row's log-sum-exp, so x <= 0 up to rounding.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and dS of one warpgroup's (64, N) tile in place.  On entry s holds the
// raw products q.k and dp the products dO.v; accumulator i's row
// log-sum-exp and D are lse(i) and delta(i).  On exit s = P = 2**(x -
// LSE), x the score in log2 units (x = cap tanh(q.k scale / cap) log2(e)
// with CAP), and dp = dS = P (dP - D) (1 - tanh^2) on the pairs with
// visible(i) (MASK; every pair without), 0 elsewhere.  CAP and MASK are
// template arguments, so the unrolled loop holds no branch: with the
// softcap's division and tanhf behind a run-time test in the loop, ptxas
// makes a branch region of every element, and the tile takes several
// times as long.
template <bool CAP, bool MASK, int N, typename Lse, typename Delta, typename Vis>
__device__ __forceinline__ void p_and_ds(float (&s)[N / 2], float (&dp)[N / 2],
                                         const Params& p, Lse lse, Delta delta,
                                         Vis visible) {
  const float scale2 = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float x, chain = 1.f;
    if constexpr (CAP) {
      const float t = tanhf(s[i] * p.scale / p.softcap);
      chain = 1.f - t * t;
      x = p.softcap * t * LOG2E;
    } else {
      x = s[i] * scale2;
    }
    float pr = exp2_ftz(x - lse(i));
    if constexpr (MASK) pr = visible(i) ? pr : 0.f;
    s[i] = pr;
    dp[i] = CAP ? pr * (dp[i] - delta(i)) * chain : pr * (dp[i] - delta(i));
  }
}

// p_and_ds with its template arguments from the tile's kind (mask: the
// plan's 1) and the softcap.
template <int N, typename Lse, typename Delta, typename Vis>
__device__ __forceinline__ void p_and_ds_tile(float (&s)[N / 2], float (&dp)[N / 2],
                                              const Params& p, bool mask, Lse lse,
                                              Delta delta, Vis visible) {
  const bool cap = p.softcap > 0.f;
  if (mask) {
    if (cap) p_and_ds<true, true, N>(s, dp, p, lse, delta, visible);
    else p_and_ds<false, true, N>(s, dp, p, lse, delta, visible);
  } else {
    if (cap) p_and_ds<true, false, N>(s, dp, p, lse, delta, visible);
    else p_and_ds<false, false, N>(s, dp, p, lse, delta, visible);
  }
}

// Store a (64, NV) accumulator of one warpgroup, times ``mul`` plus
// add[col] (or not), as bf16 rows row0 + 16 w + g (+ 8) of a (rows, D)
// matrix at ``out`` with ``stride`` elements a row, rows < ``valid``.
template <int NV>
__device__ __forceinline__ void store_rows(const float (&acc)[NV / 2], __nv_bfloat16* out,
                                           long long stride, int row0, int valid, int D,
                                           float mul, const float* add) {
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31, g = lane >> 2,
            c = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 16 * w + g + 8 * rr;
    if (r >= valid) continue;
    __nv_bfloat16* row = out + static_cast<long long>(r) * stride;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      const int col = 8 * j + 2 * c;
      float x0 = acc[4 * j + 2 * rr] * mul, x1 = acc[4 * j + 2 * rr + 1] * mul;
      if (add != nullptr) {
        x0 += add[min(col, 127)];
        x1 += add[min(col + 1, 127)];
      }
      if ((D & 1) == 0 && col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) row[col] = __float2bfloat16_rn(x0);
        if (col + 1 < D) row[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// Query tiles one dK/dV accumulator chain takes at most (whole heads, at
// least one) before it goes to the float32 sums: a chain of this length
// (four heads at S = 2048, D = 128) drifts by 2e-5 of |dK| on average and
// keeps every element within half the check's one rounding.
constexpr int CHAIN_TILES = 256;

// out[rows] (float32, the accumulator's layout as store_rows writes it)
// = acc, or += acc unless ``first``; then acc = 0.  Each element is read
// and written by the one thread that holds it, so no block sync is needed.
template <int NV>
__device__ __forceinline__ void add_rows(float (&acc)[NV / 2], float* out, long long stride,
                                         int row0, int valid, int D, bool first) {
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31, g = lane >> 2,
            c = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 16 * w + g + 8 * rr;
    float* row = out + static_cast<long long>(r) * stride;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      const int col = 8 * j + 2 * c;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a = acc[4 * j + 2 * rr + e];
        if (r < valid && col + e < D) row[col + e] = first ? a : row[col + e] + a;
        a = 0.f;
      }
    }
  }
}

// acc += in[rows] (float32, add_rows' layout) inside the valid rows and D.
template <int NV>
__device__ __forceinline__ void load_add_rows(float (&acc)[NV / 2], const float* in,
                                              long long stride, int row0, int valid,
                                              int D) {
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31, g = lane >> 2,
            c = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 16 * w + g + 8 * rr;
    const float* row = in + static_cast<long long>(r) * stride;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      const int col = 8 * j + 2 * c;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (r < valid && col + e < D) acc[4 * j + 2 * rr + e] += row[col + e];
    }
  }
}

// ---------------------------------------------------------------------------
// prep: D and the no-key counts.  Warp w takes rows r0 + 8 w .. + 7 of the
// block's 64, lane l columns l, l + 32, ...
__global__ void __launch_bounds__(256)
flash_attention_bwd_sm90_prep_kernel(const Params p) {
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * BLK + 8 * warp;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    acc[i] = 0.f;
    if (r < p.Sq) {
      const __nv_bfloat16* dr = p.dout + b * p.do_sb + r * p.do_ss + h * p.do_sh;
      const float* orow = p.o32 + ((static_cast<long long>(b) * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = lane + 32 * cc;
        if (col < p.D) acc[i] = fmaf(__bfloat162float(dr[col]), orow[col], acc[i]);
      }
    }
  }
  int none = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    const long long at = static_cast<long long>(bh) * p.lse_stride + r0 + i;
    if (lane == i) {
      p.delta[at] = acc[i];
      none = r0 + i < p.Sq && p.lse[at] == pos_inf();
    }
  }
  const int count = __syncthreads_count(none);
  if (threadIdx.x == 0)
    p.nokey[static_cast<long long>(bh) * (p.lse_stride / BLK) + blockIdx.y] = count;
}

// ---------------------------------------------------------------------------
// dkdv
// GROUP: more than one query head per KV head (the float32 sums of the
// accumulator chains); without it the kernel has no code for them.
template <int HALVES, int BQ, int NV, bool GROUP>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_bwd_sm90_dkdv_kernel(__grid_constant__ const CUtensorMap q_map,
                __grid_constant__ const CUtensorMap do_map,
                __grid_constant__ const CUtensorMap k_map,
                __grid_constant__ const CUtensorMap v_map, const Params p) {
  using L = DkdvSmem<HALVES, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t off = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + off;
  const uint32_t k_s = base + L::K, v_s = base + L::V, q_s = base + L::Q,
                 do_s = base + L::DO;
  const uint32_t kv_full = base + L::BARS;
  const uint32_t full = kv_full + 8;                  // + 8 stage
  const uint32_t empty = full + 8 * STAGES;
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + off + L::LSE);
  const float* delta_s = reinterpret_cast<const float*>(smem_raw + off + L::DELTA);
  float* mean = reinterpret_cast<float*>(smem_raw + off + L::MEAN);
  signed char* plan = reinterpret_cast<signed char*>(smem_raw + off + L::PLAN);

  const int bhk = blockIdx.x, b = bhk / p.Hkv, hk = bhk - b * p.Hkv;
  const int k0 = blockIdx.y * BLK;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // the plan: warp w takes query tiles w, w + 5, ...
    int klo, khi;
    tile_range(p.k_pos, p.Sk, k0, BLK, klo, khi);
    const bool inside = k0 + BLK <= p.Sk;
    for (int qt = warp; qt < n_qt; qt += THREADS / 32) {
      int qlo, qhi;
      tile_range(p.q_pos, p.Sq, qt * BQ, BQ, qlo, qhi);
      if (lane == 0) plan[qt] = tile_kind(qlo, qhi, klo, khi, inside, p);
    }
  }
  __syncthreads();

  if (warp == 4) {
    // -- producer: one thread issues every copy ----------------------------
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * HALVES * L::KV_BOX);
      for (int i = 0; i < HALVES; ++i) {
        tma_load(k_s + i * L::KV_BOX, &k_map, kv_full, i * BOX, hk, k0, b);
        tma_load(v_s + i * L::KV_BOX, &v_map, kv_full, i * BOX, hk, k0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0; r < p.n_rep; ++r) {
        const int h = hk * p.n_rep + r;
        const long long row = (static_cast<long long>(b) * p.H + h) * p.lse_stride;
        for (int qt = 0; qt < n_qt; ++qt) {
          if (plan[qt] == 0) continue;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t f = full + 8 * stage;
          mbar_expect_tx(f, 2 * HALVES * L::Q_BOX + 2 * BQ * 4);
          for (int i = 0; i < HALVES; ++i) {
            const uint32_t box = (stage * HALVES + i) * L::Q_BOX;
            tma_load(q_s + box, &q_map, f, i * BOX, h, qt * BQ, b);
            tma_load(do_s + box, &do_map, f, i * BOX, h, qt * BQ, b);
          }
          bulk_load(base + L::LSE + stage * BQ * 4, p.lse + row + qt * BQ, BQ * 4, f);
          bulk_load(base + L::DELTA + stage * BQ * 4, p.delta + row + qt * BQ, BQ * 4, f);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // -- consumers: keys k0 + 16 w + g and + 8 of this thread ----------------
  const int g = lane >> 2, c = lane & 3;
  const int kr0 = k0 + 16 * warp + g, kr1 = kr0 + 8;
  const bool kin0 = kr0 < p.Sk, kin1 = kr1 < p.Sk;
  const long long kp0 = kin0 ? p.k_pos[kr0] : 0, kp1 = kin1 ? p.k_pos[kr1] : 0;

  float dv[NV / 2], dk[NV / 2], s[BQ / 2], dp[BQ / 2];
  uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) dv[i] = dk[i] = 0.f;
  // the rows of dK and dV (and of their float32 sums) this block writes
  const auto rows_at = [&](long long stride) {
    return static_cast<long long>(b) * p.Sk * stride + static_cast<long long>(hk) * p.D;
  };
  // heads per accumulator chain (period < n_rep: the float32 sums are used)
  int period = 1;
  if constexpr (GROUP) {
    int n_vis = 0;
    for (int qt = 0; qt < n_qt; ++qt) n_vis += plan[qt] != 0;
    period = max(1, CHAIN_TILES / max(n_vis, 1));
  }

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int r = 0; r < p.n_rep; ++r) {
    for (int qt = 0; qt < n_qt; ++qt) {
      const int kind = plan[qt];
      if (kind == 0) continue;
      mbar_wait(full + 8 * stage, phase);
      const uint32_t qs = q_s + stage * HALVES * L::Q_BOX;
      const uint32_t dos = do_s + stage * HALVES * L::Q_BOX;
      // S^T = K Q^T and dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4 * HALVES; ++kd) {
        const uint32_t col = (kd & 3) * 32, half = kd >> 2;
        wgmma_ss<BQ>(s, sw128_desc(k_s + half * L::KV_BOX + col, 16, 1024),
                     sw128_desc(qs + half * L::Q_BOX + col, 16, 1024), kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < 4 * HALVES; ++kd) {
        const uint32_t col = (kd & 3) * 32, half = kd >> 2;
        wgmma_ss<BQ>(dp, sw128_desc(v_s + half * L::KV_BOX + col, 16, 1024),
                     sw128_desc(dos + half * L::Q_BOX + col, 16, 1024), kd > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);
      // P^T and dS^T in place: accumulator i holds key row 16 w + g + 8
      // ((i >> 1) & 1) and query column 8 (i >> 2) + 2 c + (i & 1)
      const float* lse_t = lse_s + stage * BQ;
      const float* delta_t = delta_s + stage * BQ;
      const auto col = [&](int i) { return 8 * (i >> 2) + 2 * c + (i & 1); };
      p_and_ds_tile<BQ>(
          s, dp, p, kind == 1, [&](int i) { return lse_t[col(i)]; },
          [&](int i) { return delta_t[col(i)]; },
          [&](int i) {
            const int qrow = qt * BQ + col(i);
            const bool up = (i >> 1) & 1;
            return (up ? kin1 : kin0) &&
                   (qrow >= p.Sq || visible(p.q_pos[qrow], up ? kp1 : kp0, p));
          });
      // dV += (P^T_hi + P^T_lo) dO and dK += (dS^T_hi + dS^T_lo) Q, A from
      // registers, dO and Q read MN-major
      split_frags<BQ / 2>(s, p_hi, p_lo);
      split_frags<BQ / 2>(dp, ds_hi, ds_lo);
      reg_fence(dv);
      reg_fence(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t d_do = sw128_desc(dos + kk * 2048, L::Q_BOX, 1024);
        const uint64_t d_q = sw128_desc(qs + kk * 2048, L::Q_BOX, 1024);
        wgmma_rs<NV>(dv, p_hi[kk], d_do);
        wgmma_rs<NV>(dv, p_lo[kk], d_do);
        wgmma_rs<NV>(dk, ds_hi[kk], d_q);
        wgmma_rs<NV>(dk, ds_lo[kk], d_q);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dv);
      reg_fence(dk);
      mbar_arrive(empty + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    if constexpr (GROUP) {
      if ((r + 1) % period == 0 && r + 1 < p.n_rep) {  // the chain into the sums
        const long long stride = static_cast<long long>(p.Hkv) * p.D, at = rows_at(stride);
        add_rows<NV>(dk, p.dk32 + at, stride, k0, p.Sk, p.D, r + 1 == period);
        add_rows<NV>(dv, p.dv32 + at, stride, k0, p.Sk, p.D, r + 1 == period);
      }
    }
  }

  // -- rows that see no key: P = 1/Sk over every key, so every dV_j gains
  //    the sum of their dO over the group's heads, over Sk (column tw; in
  //    head, tile and row order) ------------------------------------------
  const int tw = threadIdx.x;
  const int n_nk = p.lse_stride / BLK;
  bool any = false;
  for (int r = 0; r < p.n_rep && !any; ++r) {
    const long long bh = static_cast<long long>(b) * p.H + hk * p.n_rep + r;
    for (int t = 0; t < n_nk; ++t) any = any || p.nokey[bh * n_nk + t] != 0;
  }
  if (any) {
    float sum = 0.f;
    if (tw < p.D) {
      for (int r = 0; r < p.n_rep; ++r) {
        const int h = hk * p.n_rep + r;
        const long long bh = static_cast<long long>(b) * p.H + h;
        for (int t = 0; t < n_nk; ++t) {
          if (p.nokey[bh * n_nk + t] == 0) continue;
          const int end = min(p.Sq, (t + 1) * BLK);
          for (int row = t * BLK; row < end; ++row)
            if (p.lse[bh * p.lse_stride + row] == pos_inf())
              sum += __bfloat162float(
                  p.dout[b * p.do_sb + row * p.do_ss + h * p.do_sh + tw]);
        }
      }
    }
    mean[tw] = sum / static_cast<float>(p.Sk);
    named_sync<CONSUMERS>(1);
  }

  const long long stride = static_cast<long long>(p.Hkv) * p.D, at = rows_at(stride);
  if (GROUP && period < p.n_rep) {
    load_add_rows<NV>(dk, p.dk32 + at, stride, k0, p.Sk, p.D);
    load_add_rows<NV>(dv, p.dv32 + at, stride, k0, p.Sk, p.D);
  }
  store_rows<NV>(dk, p.dk + at, stride, k0, p.Sk, p.D, p.scale, nullptr);
  store_rows<NV>(dv, p.dv + at, stride, k0, p.Sk, p.D, 1.f, any ? mean : nullptr);
}

// ---------------------------------------------------------------------------
// dq
template <int HALVES, int NV>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_bwd_sm90_dq_kernel(__grid_constant__ const CUtensorMap q_map,
              __grid_constant__ const CUtensorMap do_map,
              __grid_constant__ const CUtensorMap k_map,
              __grid_constant__ const CUtensorMap v_map, const Params p) {
  using L = DqSmem<HALVES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t off = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + off;
  const uint32_t q_s = base + L::Q, do_s = base + L::DO, k_s = base + L::K,
                 v_s = base + L::V;
  const uint32_t q_full = base + L::BARS;
  const uint32_t full = q_full + 8;
  const uint32_t empty = full + 8 * STAGES;
  signed char* plan = reinterpret_cast<signed char*>(smem_raw + off + L::PLAN);

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H, hk = h / p.n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLK;     // longest rows first
  const int n_kt = (p.Sk + BLK - 1) / BLK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // the plan: warp w takes key tiles w, w + 5, ...
    int qlo, qhi;
    tile_range(p.q_pos, p.Sq, q0, BLK, qlo, qhi);
    for (int kt = warp; kt < n_kt; kt += THREADS / 32) {
      int klo, khi;
      tile_range(p.k_pos, p.Sk, kt * BLK, BLK, klo, khi);
      if (lane == 0) plan[kt] = tile_kind(qlo, qhi, klo, khi, (kt + 1) * BLK <= p.Sk, p);
    }
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * HALVES * L::TILE_BOX);
      for (int i = 0; i < HALVES; ++i) {
        tma_load(q_s + i * L::TILE_BOX, &q_map, q_full, i * BOX, h, q0, b);
        tma_load(do_s + i * L::TILE_BOX, &do_map, q_full, i * BOX, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        if (plan[kt] == 0) continue;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t f = full + 8 * stage;
        mbar_expect_tx(f, 2 * HALVES * L::TILE_BOX);
        for (int i = 0; i < HALVES; ++i) {
          const uint32_t box = (stage * HALVES + i) * L::TILE_BOX;
          tma_load(k_s + box, &k_map, f, i * BOX, hk, kt * BLK, b);
          tma_load(v_s + box, &v_map, f, i * BOX, hk, kt * BLK, b);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // -- consumers: rows q0 + 16 w + g and + 8 of this thread ----------------
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const long long at0 = static_cast<long long>(bh) * p.lse_stride + r0;
  const float lse[2] = {p.lse[at0], p.lse[at0 + 8]};
  const float dl[2] = {p.delta[at0], p.delta[at0 + 8]};
  const long long qp[2] = {r0 < p.Sq ? p.q_pos[r0] : 0, r1 < p.Sq ? p.q_pos[r1] : 0};

  float dq[NV / 2], s[BLK / 2], dp[BLK / 2];
  uint32_t ds_hi[BLK / 16][4], ds_lo[BLK / 16][4];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kind = plan[kt];
    if (kind == 0) continue;
    mbar_wait(full + 8 * stage, phase);
    const uint32_t ks = k_s + stage * HALVES * L::TILE_BOX;
    const uint32_t vs = v_s + stage * HALVES * L::TILE_BOX;
    // S = Q K^T and dP = dO V^T
#pragma unroll
    for (int i = 0; i < BLK / 2; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < 4 * HALVES; ++kd) {
      const uint32_t col = (kd & 3) * 32, half = kd >> 2;
      wgmma_ss<BLK>(s, sw128_desc(q_s + half * L::TILE_BOX + col, 16, 1024),
                    sw128_desc(ks + half * L::TILE_BOX + col, 16, 1024), kd > 0);
    }
#pragma unroll
    for (int kd = 0; kd < 4 * HALVES; ++kd) {
      const uint32_t col = (kd & 3) * 32, half = kd >> 2;
      wgmma_ss<BLK>(dp, sw128_desc(do_s + half * L::TILE_BOX + col, 16, 1024),
                    sw128_desc(vs + half * L::TILE_BOX + col, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);
    // dS in place of dP: accumulator i holds row 16 w + g + 8 ((i >> 1) & 1)
    // and key 8 (i >> 2) + 2 c + (i & 1) of the tile
    p_and_ds_tile<BLK>(
        s, dp, p, kind == 1, [&](int i) { return lse[(i >> 1) & 1]; },
        [&](int i) { return dl[(i >> 1) & 1]; },
        [&](int i) {
          const int key = kt * BLK + 8 * (i >> 2) + 2 * c + (i & 1);
          return key < p.Sk && visible(qp[(i >> 1) & 1], p.k_pos[key], p);
        });
    // dQ += (dS_hi + dS_lo) K, A from registers, K read MN-major
    split_frags<BLK / 2>(dp, ds_hi, ds_lo);
    reg_fence(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLK / 16; ++kk) {
      const uint64_t d_k = sw128_desc(ks + kk * 2048, L::TILE_BOX, 1024);
      wgmma_rs<NV>(dq, ds_hi[kk], d_k);
      wgmma_rs<NV>(dq, ds_lo[kk], d_k);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dq);
    mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  const long long stride = static_cast<long long>(p.H) * p.D;
  store_rows<NV>(dq, p.dq + static_cast<long long>(b) * p.Sq * stride +
                         static_cast<long long>(h) * p.D,
                 stride, q0, p.Sq, p.D, p.scale, nullptr);
}

// -- host -------------------------------------------------------------------

struct Maps {
  CUtensorMap q_kv, do_kv;    // Q and dO in boxes of the dkdv grid's BQ rows
  CUtensorMap q, dout, k, v;  // boxes of 64 rows
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HALVES, int BQ, int NV>
cudaError_t launch_all(const Maps& m, const Params& p, int B, cudaStream_t st) {
  const auto dkdv = p.n_rep > 1 ? flash_attention_bwd_sm90_dkdv_kernel<HALVES, BQ, NV, true>
                                : flash_attention_bwd_sm90_dkdv_kernel<HALVES, BQ, NV, false>;
  const auto dq = flash_attention_bwd_sm90_dq_kernel<HALVES, NV>;
  const int n_kt = (p.Sk + BLK - 1) / BLK;
  const int kv_smem = DkdvSmem<HALVES, BQ>::bytes((p.Sq + BQ - 1) / BQ);
  const int q_smem = DqSmem<HALVES>::bytes(n_kt);
  cudaError_t err = set_smem(dkdv, kv_smem);
  if (err == cudaSuccess) err = set_smem(dq, q_smem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_sm90_prep_kernel<<<dim3(B * p.H, p.lse_stride / BLK), 256, 0, st>>>(
      p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<dim3(B * p.Hkv, n_kt), THREADS, kv_smem, st>>>(m.q_kv, m.do_kv, m.k, m.v, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3(B * p.H, (p.Sq + BLK - 1) / BLK), THREADS, q_smem, st>>>(m.q, m.dout, m.k, m.v,
                                                                      p);
  return cudaGetLastError();
}

}  // namespace

// Gradients of flash_attention's bf16 route.  q and dout (B, Sq, H, Dp), k
// and v (B, Sk, Hkv, Dp) bf16, read by TMA through the given element
// strides of (B, S, heads): bases 16-byte aligned, strides multiples of 8
// elements, Dp a multiple of 8 and columns D..Dp-1 zero (the wrapper copies
// an input that breaks this).  lse (B, H, lse_stride) and o32 (B, Sq, H, D)
// float32 from the forward (flash_attention_sm90.cu), lse_stride >= Sq a
// multiple of 128 with +inf past Sq; scratch delta (B, H, lse_stride)
// float32 and nokey (B, H, lse_stride / 64) int32, both written; dq (B, Sq,
// H, D), dk and dv (B, Sk, Hkv, D) bf16 contiguous; where H > Hkv, scratch
// dk32 and dv32 (B, Sk, Hkv, D) float32 contiguous (else null), written
// before they are read.  q_pos (Sq,) and k_pos (Sk,) int32.  window <= 0
// means none, softcap <= 0 none.  D <= 128; lse_stride / 64, ceil(Sk / 64) <= 65535 and each plan (a byte per tile)
// fits in shared memory (the wrapper checks both).  Enqueues three grids.
extern "C" int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, const void* lse, const void* o32, void* delta, void* nokey, const void* q_pos,
    const void* k_pos, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, int B, int H, int Hkv, int Sq,
    int Sk, int D, int Dp, int lse_stride, int causal, int window, float scale,
    float softcap, void* dk32, void* dv32, void* stream) {
  if (D < 1 || D > 128 || Dp < D || Dp % 8 != 0 || H % Hkv != 0 || Sk < 1 || Sq < 1 ||
      lse_stride < Sq || lse_stride % 128 != 0 || lse_stride / BLK > 65535 ||
      (Sk + BLK - 1) / BLK > 65535 || (H > Hkv && (dk32 == nullptr || dv32 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bq = D <= 64 ? 64 : 32;
  Maps m;
  cudaError_t err = make_map(&m.q_kv, q, B, Sq, H, Dp, q_sb, q_ss, q_sh, bq);
  if (err == cudaSuccess)
    err = make_map(&m.do_kv, dout, B, Sq, H, Dp, do_sb, do_ss, do_sh, bq);
  if (err == cudaSuccess) err = make_map(&m.q, q, B, Sq, H, Dp, q_sb, q_ss, q_sh, BLK);
  if (err == cudaSuccess)
    err = make_map(&m.dout, dout, B, Sq, H, Dp, do_sb, do_ss, do_sh, BLK);
  if (err == cudaSuccess) err = make_map(&m.k, k, B, Sk, Hkv, Dp, k_sb, k_ss, k_sh, BLK);
  if (err == cudaSuccess) err = make_map(&m.v, v, B, Sk, Hkv, Dp, v_sb, v_ss, v_sh, BLK);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.lse = static_cast<const float*>(lse);
  p.o32 = static_cast<const float*>(o32);
  p.delta = static_cast<float*>(delta);
  p.nokey = static_cast<int*>(nokey);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk32 = static_cast<float*>(dk32);
  p.dv32 = static_cast<float*>(dv32);
  p.H = H;
  p.Hkv = Hkv;
  p.n_rep = H / Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.lse_stride = lse_stride;
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) err = launch_all<1, 64, 64>(m, p, B, st);
  else if (D <= 120) err = launch_all<2, 32, 120>(m, p, B, st);
  else err = launch_all<2, 32, 128>(m, p, B, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of the dK/dV grid (which = 0) or the
// dQ grid (which = 1) at head dim D: what the launch asks for.  CPU copy:
// flash_attention.py sm90_bwd_smem_bytes, held to this by chip_smoke.py.
extern "C" int repro_flash_attention_bwd_sm90_smem_bytes(int D, int Sq, int Sk, int which) {
  const int n_qt64 = (Sq + 63) / 64, n_qt32 = (Sq + 31) / 32, n_kt = (Sk + BLK - 1) / BLK;
  if (which == 0) {
    return D <= 64 ? DkdvSmem<1, 64>::bytes(n_qt64) : DkdvSmem<2, 32>::bytes(n_qt32);
  }
  return D <= 64 ? DqSmem<1>::bytes(n_kt) : DqSmem<2>::bytes(n_kt);
}

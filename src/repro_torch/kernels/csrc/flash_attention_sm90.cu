// flash_attention_sm90 for sm_90a: the bf16 route of flash_attention on
// Hopper's tensor cores, fed by TMA, with a warp-specialised pipeline.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:87
// flash_attention (body :27) for bf16 inputs; csrc/flash_attention.cu keeps
// the float32 route.  The function is the one that file states, with
// explicit positions as the JAX model's attention_chunked takes them:
//
//   s    = (q . k) / sqrt(D)                       float32
//   s    = cap * tanh(s / cap)                     with a softcap
//   s    = -1e30 unless k_pos <= q_pos (causal) and k_pos > q_pos - window
//   out  = softmax(s) . v                          cast to bf16 once
//
// key tiles in increasing order, the finite sentinel -1e30, and the end
// divides by max(l, 1e-30) (:24, :66, :81).  Head h reads KV head
// h / (H / Hkv) in place.
//
// Design.  A block of 384 threads takes 128 query rows of one (b, h):
// warpgroups 0 and 1 are consumers of 64 rows each, and one warp of
// warpgroup 2 is the producer.  The producer loads Q once and then keeps a
// ring of two stages of K and V tiles (128 keys each) in flight with TMA
// (cp.async.bulk.tensor, 128-byte swizzle, D cut into boxes of 64 columns;
// TMA fills the columns past D and the rows past S with zeros, so D = 120
// is padded to 128 with no host copy).  Each stage has "full" barriers for
// K and for V, which TMA completes by bytes, and an "empty" barrier that
// the 256 consumer threads arrive on when they are done with it.  The
// consumers run
//
//   S   = Q K^T          wgmma m64n128k16, both operands K-major in shared
//                        memory, float32 accumulators in registers
//   P   = online softmax of S, row by row in registers (softcap, mask)
//   O  += P_hi V + P_lo V  two wgmma m64nNk16 per 16 keys, A in registers,
//                        B = V read MN-major through the transpose bit;
//                        N = D rounded up to 64, 120 or 128
//
// and take turns on the tensor cores (ping-pong, two named barriers):
// while one warpgroup issues P.V of its tile and Q K^T of its next, the
// other runs its softmax.  Both read the same stage, so without the turns
// they run in step and the tensor cores idle through both softmaxes.
// S, O and the P fragments take about 190 registers a thread, over the
// 168 that ptxas allocates for 384 threads; the rest spill (48 bytes,
// -Xptxas -v).  setmaxnreg hands the producer's registers to the consumers
// at run time, but ptxas reports the same 168 and the same spills with
// 24/240 and 40/232.
// Which key tiles a query tile visits is decided by the block itself, in a
// prologue that all 384 threads run, from the tiles' ranges of positions:
// 0 skips a tile with no visible pair, 1 visits it with the per-element
// mask, 2 visits it with every pair visible and no mask (tile_kind; its
// CPU copy is flash_attention.py tile_plan, which the tests hold against
// the dense mask).  The plan of the query tile lands in shared memory, one
// byte per key tile, and the producer and the consumers walk it alike.
// Positions, not indices, decide, so a ring cache (rotated positions,
// empty slots at 2**30) stays right.  A row that sees no key at all gets
// what the sentinel gives it: every score is -1e30, so its softmax is
// uniform over the Sk keys and its output is the mean of V over them,
// which the consumers then compute from V in global memory.
// For the backward (flash_attention_bwd_sm90.cu) the kernel can also write
// each row's log-sum-exp, m + log2(l) in log2 units (+inf for a row that
// sees no key), and O in float32 before its bf16 rounding: a second
// instantiation (STATS) that the launch picks when it is given the
// buffers, so serving's launches run exactly the code they ran before.
// Query tiles are taken longest first.  Not done yet: a persistent grid,
// and overlap of one tile's softmax with the next tile's Q K^T inside a
// warpgroup (it needs a second set of S registers).
//
// Why P is split.  The Pallas kernel and the plain version multiply P by V
// in float32 (flash_attention.py:73-75), and the check holds the bf16
// output to one rounding: |kernel - plain| <= 2**-7 |plain| + 1e-4.  With P
// rounded once to bf16 (what FA3 and cuDNN do) every one of the 144 bf16
// grid cases at S in {128, 257} fails that check; with fp16, 98 do; with
// P = P_hi + P_lo, both bf16 (P_lo = bf16(P - P_hi), relative error about
// 2**-17), none does (a CPU emulation with every product exact; the
// CPU tests pin it, test_torch_kernels.py).  The split costs one more
// wgmma per 16 keys: 1.5 times plain FA3's tensor-core work.
//
// Bound: operations.  At the serving path's shape (danube3 prefill, B = 4,
// S = 8192, H = 32, Hkv = 8, D = 120, W = 4096) the band holds 25.2 M
// visible pairs per (b, h), 4 D flops each: 1.546e12 flops, 1.5635 ms at
// 989 TFLOP/s bf16, against 0.19 ms for the bytes of q, k, v and out at
// 3.35 TB/s.  The split's extra P.V and the padding of D (120 -> 128 in
// Q K^T) are this kernel's overhead, not part of the bound.
#include "common.cuh"
#include "sm90.cuh"

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>

namespace {

using namespace sm90;

constexpr int BQ = 128;               // query rows per block: two warpgroups of 64
constexpr int BK = 128;               // keys per tile
constexpr int STAGES = 2;             // K/V tiles in flight
constexpr int THREADS = 384;          // two consumer warpgroups, one producer
constexpr int CONSUMERS = 256;        // the named barriers' threads
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): Q [HALVES][BQ][64], then STAGES x K
// [HALVES][BK][64] and STAGES x V [HALVES][BK][64] (bf16), then the
// barriers, the mean of V for rows that see no key (float [128]) and the
// query tile's plan (one byte per key tile).  HALVES = 1 for D <= 64,
// else 2.
template <int HALVES>
struct Smem {
  static constexpr int Q_HALF = BQ * BOX * 2;       // bytes of one Q box
  static constexpr int KV_HALF = BK * BOX * 2;      // bytes of one K or V box
  static constexpr int Q = 0;
  static constexpr int K = Q + HALVES * Q_HALF;
  static constexpr int V = K + STAGES * HALVES * KV_HALF;
  static constexpr int BARS = V + STAGES * HALVES * KV_HALF;
  // q_full, then k_full, v_full and empty per stage
  static constexpr int MEAN = BARS + 8 * (1 + 3 * STAGES);
  static constexpr int PLAN = MEAN + 4 * 128;
  static int bytes(int n_kt) { return PLAN + (n_kt + 15) / 16 * 16 + 1024; }
};

// Issue S = Q K^T for one warpgroup (64 rows of Q from ``q`` against the
// BK keys of the K tile at ``k``), D in steps of 16: 32 bytes of a 128-byte
// swizzled row, then the next 64-column box.  Committed, not waited for.
template <int HALVES>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q, uint32_t k) {
  constexpr int Q_HALF = Smem<HALVES>::Q_HALF, KV_HALF = Smem<HALVES>::KV_HALF;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < 4 * HALVES; ++kd) {
    const uint32_t col = (kd & 3) * 32, half = kd >> 2;
    wgmma_ss<128>(s, sw128_desc(q + half * Q_HALF + col, 16, 1024),
                  sw128_desc(k + half * KV_HALF + col, 16, 1024), kd > 0);
  }
  wgmma_commit();
}

struct Params {
  const int* q_pos;
  const int* k_pos;
  const __nv_bfloat16* v;     // read directly only for rows that see no key
  long long v_sb, v_ss, v_sh;
  __nv_bfloat16* out;         // (B, Sq, H, D) contiguous
  int H, n_rep, Sq, Sk, D, n_kt, causal, window;
  float scale, softcap;
  // Last, so that the pairs of ints above stay 8-byte aligned: the
  // kernel then reads each pair with one constant load (LDC.64).
  float* lse;                 // the backward's statistics, or null (see the end)
  float* o32;
  int lse_stride;
};

// The plan of query tile rows q0 .. q0 + BQ - 1 into ``plan`` (n_kt bytes),
// by all THREADS threads: warp w takes key tiles w, w + 12, ..., its lanes
// the tile's positions, and reduces their min and max over the warp.
__device__ __forceinline__ void plan_tiles(signed char* plan, int q0, const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int qlo = INT_MAX, qhi = INT_MIN;
#pragma unroll
  for (int i = 0; i < BQ / 32; ++i) {
    const int r = q0 + 32 * i + lane;
    if (r < p.Sq) {
      const int x = p.q_pos[r];
      qlo = min(qlo, x);
      qhi = max(qhi, x);
    }
  }
  qlo = __reduce_min_sync(0xffffffffu, qlo);
  qhi = __reduce_max_sync(0xffffffffu, qhi);
#pragma unroll 2
  for (int kt = warp; kt < p.n_kt; kt += THREADS / 32) {
    int klo = INT_MAX, khi = INT_MIN;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int key = kt * BK + 32 * i + lane;
      if (key < p.Sk) {
        const int x = p.k_pos[key];
        klo = min(klo, x);
        khi = max(khi, x);
      }
    }
    klo = __reduce_min_sync(0xffffffffu, klo);
    khi = __reduce_max_sync(0xffffffffu, khi);
    if (lane == 0) plan[kt] = tile_kind(qlo, qhi, klo, khi, (kt + 1) * BK <= p.Sk, p);
  }
}

// One key tile's online softmax for this thread's two rows: s = Q K^T of
// the tile on entry; scale, softcap, the mask when kind == 1, the new row
// maxima m (over the quad of a row, in log2 units), l and O rescaled, and
// P = exp(s - m)
// left in p_hi + p_lo as bf16 wgmma A fragments (register t of the 16 keys
// kk packs accumulators 8 kk + 2 t and 8 kk + 2 t + 1).
template <int NV>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&o)[NV / 2],
                                             uint32_t (&p_hi)[BK / 16][4],
                                             uint32_t (&p_lo)[BK / 16][4], float (&m)[2],
                                             float (&l)[2], const Params& p, int kt,
                                             int kind, int c, const long long (&qp)[2],
                                             bool cap) {
  // scores in log2 units, x * log2(e), so that exp(x - m) is one exp2
  const float scale_log2 = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (cap) {
      s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap) * LOG2E;
    } else {
      s[i] *= scale_log2;
    }
  }
  if (kind == 1) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * BK + 8 * j + 2 * c + e;
        bool ok0 = key < p.Sk, ok1 = ok0;
        if (ok0) {
          const long long kp = p.k_pos[key];
          if (p.causal) { ok0 = kp <= qp[0]; ok1 = kp <= qp[1]; }
          if (p.window > 0) {
            ok0 = ok0 && kp > qp[0] - p.window;
            ok1 = ok1 && kp > qp[1] - p.window;
          }
        }
        if (!ok0) s[4 * j + e] = NEG_INF;
        if (!ok1) s[4 * j + 2 + e] = NEG_INF;
      }
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float e = exp2f(s[i] - m[r]);
    s[i] = e;
    rs[r] += e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float a = s[8 * kk + 2 * t], a2 = s[8 * kk + 2 * t + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, a2);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][t] = bf16x2_bits(hi);
      p_lo[kk][t] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, a2 - hf.y));
    }
  }
}

// Issue O += P_hi V + P_lo V against the V tile at ``v`` (16 keys = two
// 8-row groups, 2048 bytes, per step; V read MN-major).  Committed, not
// waited for.
template <int HALVES, int NV>
__device__ __forceinline__ void pv_issue(float (&o)[NV / 2],
                                         const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4], uint32_t v) {
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc(v + kk * 2048, Smem<HALVES>::KV_HALF, 1024);
    wgmma_rs<NV>(o, p_hi[kk], dv);
    wgmma_rs<NV>(o, p_lo[kk], dv);
  }
  wgmma_commit();
}

template <int HALVES, int NV, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap q_map,
                            __grid_constant__ const CUtensorMap k_map,
                            __grid_constant__ const CUtensorMap v_map,
                            const Params p) {
  using L = Smem<HALVES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_s = base + L::Q, k_s = base + L::K, v_s = base + L::V;
  const uint32_t q_full = base + L::BARS;
  const uint32_t k_full = q_full + 8;                  // + 8 stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;           // longest rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H, hk = h / p.n_rep;
  const int q0 = qt * BQ;
  signed char* plan = reinterpret_cast<signed char*>(smem_raw + (base - raw) + L::PLAN);
  float* v_mean = reinterpret_cast<float*>(smem_raw + (base - raw) + L::MEAN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  plan_tiles(plan, q0, p);
  __syncthreads();

  if (wg == 2) {
    // -- producer: one thread issues every TMA load.  Q is loaded whatever
    //    the plan, and the consumers wait for it before they exit --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, HALVES * L::Q_HALF);
      for (int i = 0; i < HALVES; ++i)
        tma_load(q_s + i * L::Q_HALF, &q_map, q_full, i * BOX, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < p.n_kt; ++kt) {
        if (plan[kt] == 0) continue;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
        mbar_expect_tx(kf, HALVES * L::KV_HALF);
        for (int i = 0; i < HALVES; ++i)
          tma_load(k_s + (stage * HALVES + i) * L::KV_HALF, &k_map, kf, i * BOX, hk,
                   kt * BK, b);
        mbar_expect_tx(vf, HALVES * L::KV_HALF);
        for (int i = 0; i < HALVES; ++i)
          tma_load(v_s + (stage * HALVES + i) * L::KV_HALF, &v_map, vf, i * BOX, hk,
                   kt * BK, b);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ---------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
    const int g = lane >> 2, c = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;   // this thread's rows
    const long long qp0 = r0 < p.Sq ? p.q_pos[r0] : 0;
    const long long qp1 = r1 < p.Sq ? p.q_pos[r1] : 0;
    const bool cap = p.softcap > 0.f;
    const uint32_t q_wg = q_s + wg * 64 * 128;       // this warpgroup's 64 rows of Q

    float o[NV / 2], s[BK / 2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const long long qp[2] = {qp0, qp1};

    // The two warpgroups take turns on the tensor cores (named barriers 1
    // and 2): while one issues P.V of its tile and Q K^T of its next, the
    // other runs its softmax.  Warpgroup 0 goes first; each wgmma is waited
    // for in the same straight-line stretch that issued it.
    int n_vis = 0;
    for (int kt = 0; kt < p.n_kt; ++kt) n_vis += plan[kt] != 0;
    if (n_vis > 0) {
      int kt = 0;
      while (plan[kt] == 0) ++kt;
      int stage = 0;
      uint32_t phase = 0;
      if (wg == 1) named_arrive<CONSUMERS>(1);
      mbar_wait(q_full, 0);
      named_sync<CONSUMERS>(1 + wg);
      mbar_wait(k_full, 0);
      qk_issue<HALVES>(s, q_wg, k_s);
      named_arrive<CONSUMERS>(2 - wg);
      wgmma_wait_all();
      reg_fence(s);
      for (int i = 0; i < n_vis; ++i) {
        int next = kt + 1;
        while (next < p.n_kt && plan[next] == 0) ++next;
        softmax_tile<NV>(s, o, p_hi, p_lo, m, l, p, kt, plan[kt], c, qp, cap);
        // -- this warpgroup's turn: O += P_hi V + P_lo V, then S = Q K^T of
        //    the next tile ----------------------------------------------------
        named_sync<CONSUMERS>(1 + wg);
        mbar_wait(v_full + 8 * stage, phase);
        pv_issue<HALVES, NV>(o, p_hi, p_lo, v_s + stage * HALVES * L::KV_HALF);
        wgmma_wait_all();
        reg_fence(o);
        mbar_arrive(empty + 8 * stage);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
        if (i + 1 == n_vis) break;
        mbar_wait(k_full + 8 * stage, phase);
        qk_issue<HALVES>(s, q_wg, k_s + stage * HALVES * L::KV_HALF);
        named_arrive<CONSUMERS>(2 - wg);
        wgmma_wait_all();
        reg_fence(s);
        kt = next;
      }
      if (wg == 0) named_arrive<CONSUMERS>(2);      // warpgroup 1 takes the last turn
    } else {
      mbar_wait(q_full, 0);              // no bulk copy in flight at exit
    }
    float l0 = l[0], l1 = l[1];

    // -- a row that sees no key: the mean of V over the Sk keys, one column
    //    per consumer thread, in 8 running sums --------------------------
    const bool none0 = r0 < p.Sq && m[0] == NEG_INF;
    const bool none1 = r1 < p.Sq && m[1] == NEG_INF;
    if (named_sync_or<CONSUMERS>(3, none0 || none1)) {
      const int col = threadIdx.x;
      if (col < p.D) {
        const __nv_bfloat16* vc = p.v + b * p.v_sb + hk * p.v_sh + col;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        int k = 0;
        for (; k + 8 <= p.Sk; k += 8) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[j] += __bfloat162float(vc[static_cast<long long>(k + j) * p.v_ss]);
        }
        for (; k < p.Sk; ++k) acc[0] += __bfloat162float(vc[static_cast<long long>(k) * p.v_ss]);
        v_mean[col] = ((acc[0] + acc[1]) + (acc[2] + acc[3]) +
                       ((acc[4] + acc[5]) + (acc[6] + acc[7]))) / static_cast<float>(p.Sk);
      }
      named_sync<CONSUMERS>(3);
    }

    // -- out = O / max(l, 1e-30), cast to bf16 once -------------------------
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rr ? r1 : r0;
      if (r >= p.Sq) continue;
      const float den = rr ? den1 : den0;
      const bool none = rr ? none1 : none0;
      __nv_bfloat16* row = p.out + ((static_cast<long long>(b) * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        const int col = 8 * j + 2 * c;
        const float x0 = none ? v_mean[min(col, 127)] : o[4 * j + 2 * rr] / den;
        const float x1 = none ? v_mean[min(col + 1, 127)] : o[4 * j + 2 * rr + 1] / den;
        if ((p.D & 1) == 0 && col + 1 < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < p.D) row[col] = __float2bfloat16_rn(x0);
          if (col + 1 < p.D) row[col + 1] = __float2bfloat16_rn(x1);
        }
      }
    }

    // -- the backward's statistics, in the STATS instantiation only (so the
    //    other one compiles as without them): each row's log-sum-exp in log2
    //    units, m + log2(l), +inf for a row that sees no key or lies past Sq,
    //    into row bh of lse (lse_stride floats a row, every row of the tile
    //    written); and O in float32, before its bf16 rounding, into o32
    //    (B, Sq, H, D) contiguous ------------------------------------------
    if constexpr (STATS) {
      const float inf = __int_as_float(0x7f800000);
      if (c == 0) {
        float* lrow = p.lse + static_cast<long long>(bh) * p.lse_stride;
        lrow[r0] = r0 < p.Sq && !none0 ? m[0] + log2f(l0) : inf;
        lrow[r1] = r1 < p.Sq && !none1 ? m[1] + log2f(l1) : inf;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = rr ? r1 : r0;
        if (r >= p.Sq) continue;
        const float den = rr ? den1 : den0;
        const bool none = rr ? none1 : none0;
        float* row = p.o32 + ((static_cast<long long>(b) * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
        for (int j = 0; j < NV / 8; ++j) {
          const int col = 8 * j + 2 * c;
          const float x0 = none ? v_mean[min(col, 127)] : o[4 * j + 2 * rr] / den;
          const float x1 = none ? v_mean[min(col + 1, 127)] : o[4 * j + 2 * rr + 1] / den;
          if ((p.D & 1) == 0 && col + 1 < p.D) {
            *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
          } else {
            if (col < p.D) row[col] = x0;
            if (col + 1 < p.D) row[col + 1] = x1;
          }
        }
      }
    }
  }
}

// -- host -------------------------------------------------------------------

template <int HALVES, int NV, bool STATS>
cudaError_t launch_as(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                      const Params& p, int n_qt, int bh, cudaStream_t stream) {
  const int smem = Smem<HALVES>::bytes(p.n_kt);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel<HALVES, NV, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_attention_sm90_kernel<HALVES, NV, STATS><<<dim3(n_qt, bh), THREADS, smem, stream>>>(
      qm, km, vm, p);
  return cudaGetLastError();
}

template <int HALVES, int NV>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const Params& p, int n_qt, int bh, cudaStream_t stream) {
  return p.lse != nullptr ? launch_as<HALVES, NV, true>(qm, km, vm, p, n_qt, bh, stream)
                          : launch_as<HALVES, NV, false>(qm, km, vm, p, n_qt, bh, stream);
}

}  // namespace

// q (B, Sq, H, Dp), k and v (B, Sk, Hkv, Dp) bf16, read by TMA through the
// given element strides of (B, S, heads): the base addresses 16-byte
// aligned, the strides multiples of 8 elements, Dp a multiple of 8 and
// columns D..Dp-1 zero (the wrapper copies an input that breaks this).
// out (B, Sq, H, D) bf16 contiguous; q_pos (Sq,) and k_pos (Sk,) int32.
// window <= 0 means none, softcap <= 0 none.  D <= 128; B * H <= 65535;
// Sk <= 2**23 (the plan, one byte per key tile, lives in shared memory).
// lse and o32 are null, or the backward's statistics: lse (B, H,
// lse_stride) float32 with lse_stride >= Sq a multiple of 128 (every entry
// written), o32 (B, Sq, H, D) float32 contiguous.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, const void* q_pos,
    const void* k_pos, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int H, int Hkv, int Sq, int Sk, int D, int Dp, int causal,
    int window, float scale, float softcap, void* lse, void* o32, int lse_stride,
    void* stream) {
  if (D < 1 || D > 128 || Dp < D || Dp % 8 != 0 || H % Hkv != 0 || Sk < 1 ||
      Sk > (1 << 23) || (lse != nullptr && (o32 == nullptr || lse_stride < Sq ||
                                            lse_stride % BQ != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map(&qm, q, B, Sq, H, Dp, q_sb, q_ss, q_sh, BQ);
  if (err == cudaSuccess) err = make_map(&km, k, B, Sk, Hkv, Dp, k_sb, k_ss, k_sh, BK);
  if (err == cudaSuccess) err = make_map(&vm, v, B, Sk, Hkv, Dp, v_sb, v_ss, v_sh, BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o32 = static_cast<float*>(o32);
  p.lse_stride = lse_stride;
  p.H = H;
  p.n_rep = H / Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.n_kt = (Sk + BK - 1) / BK;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) err = launch<1, 64>(qm, km, vm, p, n_qt, B * H, st);
  else if (D <= 120) err = launch<2, 120>(qm, km, vm, p, n_qt, B * H, st);
  else err = launch<2, 128>(qm, km, vm, p, n_qt, B * H, st);
  return static_cast<int>(err);
}

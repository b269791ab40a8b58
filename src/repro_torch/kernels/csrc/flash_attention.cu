// flash_attention for sm_90a: the float32 route of flash_attention, on the
// float32 FMA pipes, fed by a cp.async ring.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:87
// flash_attention (body :27) for float32 inputs, with explicit positions
// as the JAX model's attention_chunked takes them:
//
//   s    = (q . k) / sqrt(D)                       float32
//   s    = cap * tanh(s / cap)                     with a softcap
//   s    = -1e30 unless k_pos <= q_pos (causal) and k_pos > q_pos - window
//   out  = softmax(s) . v                          float32
//
// q is (B, Sq, H, D), k and v are (B, Sk, Hkv, D) with H % Hkv == 0; head h
// reads KV head h / (H / Hkv) in place, so GQA needs no expanded copy.  The
// three inputs are read through their strides (the last one must be 1), so
// the (B, S, H, D) views of x @ wq need no transpose.  bf16 goes to
// csrc/flash_attention_sm90.cu.  Every product is a float32 FMA: TF32 on
// the tensor cores keeps 10 bits of mantissa and does not hold the float32
// route's 2e-5.
//
// Bound: operations, on the float32 pipes (67 TFLOP/s).  At the depth-2
// float32 prefill's shape (B = 1, S = 5000, H = 32, Hkv = 8, D = 120,
// W = 4096) the band holds 12.1 M visible pairs per (b, h), 4 * D flops
// each: 1.86e11 flops, 2.77 ms, against 0.02 ms for the bytes.  An FMA
// pipe issues one warp instruction a clock and so does everything else on
// its scheduler, so the design keeps every other instruction rare next to
// the FMAs:
//
// * Register micro-tiles, 4 FMAs or more per float a thread reads from
//   shared memory.  An ld.shared.v4 of a warp holds the SM's one shared
//   memory pipe for four cycles (a quarter warp each, broadcast or not),
//   while each of the SM's four schedulers issues one FMA instruction a
//   cycle; with fewer FMAs per float the shared pipe, not the FMA pipes,
//   sets the pace.  A block of 256 threads takes 128
//   query rows of one (b, h); half warp rg (16 of them) owns rows rg + 16 i
//   (i < 8).  For S = Q K^T of a 64-key tile, lane pair (kg, dh) of a half
//   warp takes keys kg + 8 j (j < 8) and splits D: lane dh reads columns
//   4 c .. 4 c + 3 of chunks c = dh, dh + 2, ..., 8 rows x 8 keys of
//   partial sums from 16 ld.shared.v4 per 256 FMAs, then one shuffle adds
//   the pair's halves, each lane keeping 4 of the 8 rows.  For O += P V
//   lane cg holds 8 rows x 8 columns (4 cg + e and 64 + 4 cg + e; 8 x 4
//   when D <= 64) and reads per key two float4 of P and two of V, 4 per
//   64 FMAs.  Q and P reads are broadcasts within a half warp; K rows are
//   padded to 8 mod 32 floats, so the 8 lanes of a phase (4 keys x 2
//   chunks) and the P^T stores hit distinct bank groups.  P^T keeps a
//   thread's 8 rows side by side (column 8 rg + i holds row rg + 16 i).
// * An asynchronous K/V ring.  Two stages of K and V (64 keys each),
//   copied with cp.async (16 bytes a lane, a warp a row) while the block
//   works on the other stage; a stage's K buffer holds P^T once Q K^T of
//   its tile is done.  Inputs whose base, strides or D are not whole
//   16 bytes take the same ring with 4-byte copies (the template VEC).
//   Zero fill: Q and K columns D .. D rounded to 8, rows past Sq and Sk.
// * Softmax in registers, in log2 units (exp(x - m) is one exp2): the row
//   maximum is reduced over the 8 lanes of the row each tile, and each
//   row's rescale factor reaches the 16 lanes that hold its O by a
//   shuffle; the row sum stays per lane and is reduced once, at the end.
//   exp2 is one ex2.approx.ftz: a p below 2**-126 is a zero next to the
//   2e-5 check.
//
// It keeps the function's edges as the Pallas kernel and the plain version
// have them: key tiles in increasing order, masked scores are the finite
// sentinel -1e30 (:24, :66), so a row whose first visited tile holds only
// masked keys accumulates p = 1 against m = -1e30 and its first valid key
// wipes that (exp(-1e30 - m) is 0; with -inf that step would be NaN); the
// end divides by max(l, 1e-30) (:81).  A row that sees no key at all gets
// what the sentinel gives it, the mean of V over the Sk keys, read from
// global memory in the epilogue.
//
// Which key tiles a query tile visits is decided by the block from the
// tiles' ranges of positions, as csrc/flash_attention_sm90.cu does (its
// plan_tiles and tile_kind, CPU copy flash_attention.py tile_plan, with
// this file's 64-key tiles): 0 skips a tile with no visible pair, 1 visits
// it with the per-element mask, 2 with every pair visible and no mask.
// The plan lands in shared memory a window of PLAN_TILES key tiles at a
// time.  Query tiles are taken longest first, over every head.
//
// For the backward (csrc/flash_attention_bwd.cu) a second instantiation
// (STATS), which the launch picks when it is given an ``lse`` buffer,
// also writes each row's log-sum-exp in log2 units, m + log2(l), +inf for
// a row that sees no key and for the rows past Sq, into rows of
// lse_stride floats; O needs no copy, the output is O in float32.  Its
// arguments come after the others, so the instantiation without them
// compiles as it did before they existed.
#include "common.cuh"

#include <climits>

namespace {

constexpr int BQ = 128;               // query rows per block
constexpr int BK = 64;                // keys per tile
constexpr int NT = 256;               // threads: 16 half warps, a row group each
constexpr int STAGES = 2;             // K/V tiles in the ring
constexpr int KS = 136;               // floats per row of a K stage, and of P^T
constexpr int PLAN_TILES = 2048;      // key tiles planned at a time (a byte each)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {                      // element strides of (B, S, H); D is 1
  long long b, s, h;
};

// Shared memory, in floats: Q [BQ][QS] (QS: D rounded up to 8), STAGES x
// K [BK][KS] (P^T [BK][KS] once the tile's scores are taken), STAGES x V
// [BK][64 NV], then the plan, one byte per key tile.
__host__ __device__ inline int q_stride(int d) { return (d + 7) / 8 * 8; }
__host__ __device__ inline int q_floats(int d) { return BQ * q_stride(d); }
__host__ __device__ inline int v_stride(int nv) { return 64 * nv; }
inline size_t smem_bytes(int d, int nv) {
  return sizeof(float) * (static_cast<size_t>(q_floats(d)) + STAGES * BK * KS +
                          STAGES * BK * v_stride(nv)) + PLAN_TILES;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows w, w + 8, ... (< rows) of a (rows, D) slab at ``src`` (row stride
// ``ss``) into ``dst`` (row stride ``ds``), columns 0 .. cols - 1: warp w
// takes every eighth row, lane c its columns 4c .. 4c + 3.  Rows at or
// past ``valid`` and columns past D are zero.
template <bool VEC>
__device__ __forceinline__ void copy_rows(float* dst, int ds, const float* src,
                                          long long ss, int rows, int valid, int D,
                                          int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = 4 * lane;
  if (c >= cols) return;
  for (int r = warp; r < rows; r += NT / 32) {
    float* d = dst + r * ds + c;
    const bool in = r < valid;
    const float* s = in ? src + r * ss + c : src;
    if (VEC) {
      cp16(d, in && c < D ? s : src, in && c < D ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && c + e < D;
        cp4(d + e, ok ? s + e : src, ok ? 4 : 0);
      }
    }
  }
}

struct Params {
  const int* q_pos;
  const int* k_pos;
  int Sq, Sk, n_kt, causal, window;
};

// What a query tile with positions in [qlo, qhi] does with a key tile with
// positions in [klo, khi]: 0 no pair can be visible, 2 every pair is
// visible and the tile lies inside Sk (``inside``), else 1.  As
// flash_attention_sm90.cu tile_kind; the CPU copy is flash_attention.py
// tile_plan.
__device__ __forceinline__ int tile_kind(int qlo, int qhi, int klo, int khi, bool inside,
                                         const Params& p) {
  bool some = true, every = inside;
  if (p.causal) {
    some = some && klo <= qhi;
    every = every && khi <= qlo;
  }
  if (p.window > 0) {
    some = some && static_cast<long long>(khi) > static_cast<long long>(qlo) - p.window;
    every = every && static_cast<long long>(klo) > static_cast<long long>(qhi) - p.window;
  }
  return some ? (every ? 2 : 1) : 0;
}

// The plan of key tiles base .. base + PLAN_TILES - 1 (those < n_kt) into
// ``plan``, by all NT threads: warp w takes tiles base + w, base + w + 8,
// ..., its lanes two positions each, reduced over the warp.  As
// flash_attention_sm90.cu plan_tiles, with the query range reduced before.
__device__ __forceinline__ void plan_tiles(unsigned char* plan, int base, int qlo, int qhi,
                                           const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int end = min(p.n_kt, base + PLAN_TILES);
  for (int kt = base + warp; kt < end; kt += NT / 32) {
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
    if (lane == 0)
      plan[kt - base] = static_cast<unsigned char>(
          tile_kind(qlo, qhi, klo, khi, (kt + 1) * BK <= p.Sk, p));
  }
}

// Half warp rg = 2 warp + lane / 16 owns rows rg + 16 i (i < 8).  In the
// scores, lane pair kg = (lane % 16) / 2 takes keys kg + 8 j, lane dh =
// lane % 2 of it chunks dh, dh + 2, ... of D and then rows 4 dh + r (r < 4);
// in the output, lane cg = lane % 16 takes columns 64 g + 4 cg + e.
template <int NV, bool VEC, bool STATS>
__global__ void __launch_bounds__(NT, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, Params p,
                       Strides qs, Strides ks, Strides vs, int H, int n_rep, int D,
                       float scale, float softcap, float* __restrict__ lse,
                       int lse_stride) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int QS = q_stride(D), VS = v_stride(NV);
  float* qS = smem;                               // [BQ][QS]
  float* kS = qS + q_floats(D);                   // STAGES x [BK][KS]
  float* vS = kS + STAGES * BK * KS;              // STAGES x [BK][VS]
  unsigned char* plan = reinterpret_cast<unsigned char*>(vS + STAGES * BK * VS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = 2 * warp + (lane >> 4), cg = lane & 15;
  const int dh = lane & 1, kg = cg >> 1, half = lane & 16;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int BH = static_cast<int>(gridDim.x / n_qt);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * BQ;
  const int b = bh / H, h = bh - b * H, hk = h / n_rep;

  const float* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  copy_rows<VEC>(qS, QS, qb, qs.s, BQ, p.Sq - q0, D, QS);
  cp_commit();

  // the query tile's range of positions, reduced by every warp alike
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

  int qp[4];                          // positions of this lane's score rows 4 dh + r
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + rg + 16 * (4 * dh + r);
    qp[r] = row < p.Sq ? p.q_pos[row] : 0;
  }

  int plan_base = 0;
  plan_tiles(plan, 0, qlo, qhi, p);
  __syncthreads();
  // the first visited key tile at or after kt (n_kt if none), and its kind;
  // plans the next window when the walk leaves this one
  auto next_tile = [&](int kt, int& kind) {
    for (;;) {
      const int end = min(p.n_kt, plan_base + PLAN_TILES);
      while (kt < end && plan[kt - plan_base] == 0) ++kt;
      if (kt < end) {
        kind = plan[kt - plan_base];
        return kt;
      }
      if (end == p.n_kt) return p.n_kt;
      __syncthreads();                // every thread is done reading the plan
      plan_base = end;
      plan_tiles(plan, plan_base, qlo, qhi, p);
      __syncthreads();
    }
  };
  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    copy_rows<VEC>(kS + stage * BK * KS, KS, kb + k0 * ks.s, ks.s, BK, p.Sk - k0, D, QS);
    copy_rows<VEC>(vS + stage * BK * VS, VS, vb + k0 * vs.s, vs.s, BK, p.Sk - k0, D, D);
    cp_commit();
  };

  // m and l of the score rows 4 dh + r (l per lane, over its keys); O of
  // rows rg + 16 i
  float m[4], l[4], acc[8][4 * NV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.f;
  const float scale_log2 = scale * LOG2E;
  const bool cap = softcap > 0.f;
  // score rows: this lane's own 4 (rows 4 dh + r) first, then its pair's
  const float* q_own = qS + (rg + 64 * dh) * QS + 4 * dh;
  const float* q_pair = qS + (rg + 64 * (1 - dh)) * QS + 4 * dh;

  int kind = 0;
  int kt = next_tile(0, kind);
  if (kt < p.n_kt) load_tile(kt, 0);
  int stage = 0;
  while (kt < p.n_kt) {
    cp_wait_all();
    __syncthreads();                  // the tile has landed for every thread, and
                                      // every thread is done with the other stage
    const int kind_t = kind;
    const int next = next_tile(kt + 1, kind);
    if (next < p.n_kt) load_tile(next, stage ^ 1);

    // key positions of this lane's keys, for the per-element mask
    int kp[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    bool kin[8] = {true, true, true, true, true, true, true, true};
    if (kind_t == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kt * BK + kg + 8 * j;
        kin[j] = key < p.Sk;
        kp[j] = kin[j] ? p.k_pos[key] : 0;
      }
    }

    // -- S = Q K^T over this lane's half of D: rows (own 4, pair's 4) x
    //    keys kg + 8 j; chunk 2 cc + dh, columns 8 cc + 4 dh .. + 3 ------
    float* kst = kS + stage * BK * KS;
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    const float* krow = kst + kg * KS + 4 * dh;
    for (int c8 = 0; c8 < QS; c8 += 8) {
      float4 a[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = *reinterpret_cast<const float4*>(q_own + 16 * r * QS + c8);
        a[4 + r] = *reinterpret_cast<const float4*>(q_pair + 16 * r * QS + c8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 c = *reinterpret_cast<const float4*>(krow + 8 * j * KS + c8);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][j] = fmaf(a[i].x, c.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c.w, s[i][j]);
        }
      }
    }
    // the pair's halves: this lane's own rows are its pair's other rows
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] += __shfl_xor_sync(0xffffffffu, s[4 + r][j], 1);
    __syncthreads();                  // every thread is done reading K: P^T goes there

    // -- softcap, mask, online softmax in log2 units, rows 4 dh + r --------
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[r][j];
        if (cap) x = softcap * tanhf(x * scale / softcap) * LOG2E;
        else x *= scale_log2;
        if (kind_t == 1) {
          bool ok = kin[j];
          if (p.causal) ok = ok && kp[j] <= qp[r];
          if (p.window > 0)
            ok = ok && static_cast<long long>(kp[j]) >
                           static_cast<long long>(qp[r]) - p.window;
          x = ok ? x : NEG_INF;
        }
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 2; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = ex2(s[r][j] - m_new);
        s[r][j] = e;
        rs += e;
      }
      l[r] = l[r] * corr[r] + rs;
    }
    float* pT = kst;                  // P^T [BK][KS]: column 8 rg + i is row rg + 16 i
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(pT + (kg + 8 * j) * KS + 8 * rg + 4 * dh) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    // each O row's factor, from lane dh = i / 4 of its half warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __shfl_sync(0xffffffffu, corr[i & 3], half | (i >> 2));
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[i][c] *= f;
    }
    __syncwarp();                     // a half warp reads back only its own rows

    // -- O += P V: rows rg + 16 i, columns 64 g + 4 cg + e -------------------
    const float* vst = vS + stage * BK * VS + 4 * cg;
    const float* prow = pT + 8 * rg;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(prow + kk * KS);
      const float4 p1 = *reinterpret_cast<const float4*>(prow + kk * KS + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vv[4 * NV];
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(vst + kk * VS + 64 * g);
        vv[4 * g] = x.x;
        vv[4 * g + 1] = x.y;
        vv[4 * g + 2] = x.z;
        vv[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NV; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
    stage ^= 1;
    kt = next;
  }
  cp_wait_all();                      // Q's copy, when no key tile was visited

  // -- each row's sum over its 8 score lanes, and its sum and max in the
  //    lanes that hold its O; rows that see no key: every score is the
  //    sentinel, so the softmax is uniform over the Sk keys and the
  //    output the mean of V --------------------------------------------
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 2; off < 16; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  float l_row[8];
  bool none[8], any_none = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l_row[i] = __shfl_sync(0xffffffffu, l[i & 3], half | (i >> 2));
    const float m_row = __shfl_sync(0xffffffffu, m[i & 3], half | (i >> 2));
    none[i] = q0 + rg + 16 * i < p.Sq && m_row == NEG_INF;
    any_none = any_none || none[i];
  }
  float mean[4 * NV];
#pragma unroll
  for (int c = 0; c < 4 * NV; ++c) mean[c] = 0.f;
  if (any_none) {
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) {
      const int d = 64 * (c / 4) + 4 * cg + c % 4;
      if (d >= D) continue;
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int kk = 0;
      for (; kk + 8 <= p.Sk; kk += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) part[e] += vb[(kk + e) * vs.s + d];
      }
      for (; kk < p.Sk; ++kk) part[0] += vb[kk * vs.s + d];
      mean[c] = ((part[0] + part[1]) + (part[2] + part[3]) +
                 ((part[4] + part[5]) + (part[6] + part[7]))) / static_cast<float>(p.Sk);
    }
  }

  // -- out = acc / max(l, 1e-30), (B, Sq, H, D) contiguous -----------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + rg + 16 * i;
    if (r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l_row[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * p.Sq + r) * H + h) * D;
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const int d = 64 * g + 4 * cg;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = none[i] ? mean[4 * g + e] : acc[i][4 * g + e] * inv;
      if (D % 4 == 0) {
        if (d < D) *reinterpret_cast<float4*>(orow + d) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) orow[d + e] = y[e];
      }
    }
  }

  // -- the backward's statistics, in the STATS instantiation only: lane 0
  //    of each half warp writes its rows' log-sum-exp, every row of the
  //    tile (row bh of lse, lse_stride floats a row) ------------------------
  if constexpr (STATS) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m_row = __shfl_sync(0xffffffffu, m[i & 3], half | (i >> 2));
      const int r = q0 + rg + 16 * i;
      if (cg == 0)
        lse[static_cast<long long>(bh) * lse_stride + r] =
            r < p.Sq && !none[i] ? m_row + log2f(l_row[i]) : __int_as_float(0x7f800000);
    }
  }
}

template <int NV, bool VEC, bool STATS>
cudaError_t launch_as(const float* q, const float* k, const float* v, float* o,
                      const Params& p, Strides qs, Strides ks, Strides vs, int B, int H,
                      int Hkv, int D, float scale, float softcap, float* lse,
                      int lse_stride, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, NV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NV, VEC, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((p.Sq + BQ - 1) / BQ) * B * H;
  flash_attention_kernel<NV, VEC, STATS><<<blocks, NT, smem, stream>>>(
      q, k, v, o, p, qs, ks, vs, H, H / Hkv, D, scale, softcap, lse, lse_stride);
  return cudaGetLastError();
}

template <int NV, bool VEC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   const Params& p, Strides qs, Strides ks, Strides vs, int B, int H,
                   int Hkv, int D, float scale, float softcap, float* lse, int lse_stride,
                   cudaStream_t stream) {
  return lse != nullptr
             ? launch_as<NV, VEC, true>(q, k, v, o, p, qs, ks, vs, B, H, Hkv, D, scale,
                                        softcap, lse, lse_stride, stream)
             : launch_as<NV, VEC, false>(q, k, v, o, p, qs, ks, vs, B, H, Hkv, D, scale,
                                         softcap, lse, lse_stride, stream);
}

}  // namespace

// Dynamic shared memory of one block at head dim D (the CPU copy is
// flash_attention.py f32_smem_bytes).
extern "C" int repro_flash_attention_smem_bytes(int D) {
  return static_cast<int>(smem_bytes(D, D <= 64 ? 1 : 2));
}

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D) float32, read through the given
// element strides of their first three dimensions (the last is 1); out
// (B, Sq, H, D) contiguous float32; q_pos (Sq,) and k_pos (Sk,) int32.
// window <= 0 means none, softcap <= 0 none.  vec != 0: every base is
// 16-byte aligned and D and every stride a multiple of 4 (16-byte copies),
// else 4-byte copies.  D <= 128; 0 < Sk; B * H <= 65535.  lse is null, or
// the backward's statistics: (B, H, lse_stride) float32 with lse_stride >=
// Sq a multiple of 128, every entry written.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, const void* q_pos,
    const void* k_pos, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int B, int H, int Hkv, int Sq, int Sk, int D,
    int causal, int window, float scale, float softcap, int vec, void* lse,
    int lse_stride, void* stream) {
  if (lse != nullptr && (lse_stride < Sq || lse_stride % BQ != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* lf = static_cast<float*>(lse);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const Params p{static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), Sq, Sk,
                 (Sk + BK - 1) / BK, causal, window};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return static_cast<int>(
        vec ? launch<1, true>(qf, kf, vf, of, p, qs, ks, vs, B, H, Hkv, D, scale, softcap,
                              lf, lse_stride, st)
            : launch<1, false>(qf, kf, vf, of, p, qs, ks, vs, B, H, Hkv, D, scale, softcap,
                               lf, lse_stride, st));
  return static_cast<int>(
      vec ? launch<2, true>(qf, kf, vf, of, p, qs, ks, vs, B, H, Hkv, D, scale, softcap, lf,
                            lse_stride, st)
          : launch<2, false>(qf, kf, vf, of, p, qs, ks, vs, B, H, Hkv, D, scale, softcap, lf,
                             lse_stride, st));
}

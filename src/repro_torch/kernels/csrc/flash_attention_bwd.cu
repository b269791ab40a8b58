// flash_attention_bwd for sm_90a: the gradient of flash_attention's float32
// route on Hopper's tensor cores, every float32 product as three TF32
// products (the bf16 route's is flash_attention_bwd_sm90.cu).
//
// The JAX package has no Pallas backward: it differentiates its chunked
// attention (src/repro/models/attention.py:136) in XLA, and its Pallas
// kernel src/repro/kernels/flash_attention.py:87 has no custom_vjp.  The
// port runs training attention through its forward kernels
// (flash_attention.cu, flash_attention_sm90.cu), so the gradient is this
// kernel.  With s = q.k / sqrt(D), s' = cap tanh(s / cap) (softcap), the
// mask setting s' to -1e30, P = softmax(s') and O = P V:
//
//   D_i  = sum_d dO_id O_id
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . V_j - D_i) (1 - tanh^2(s_ij / cap))   visible pairs
//   dQ_i = sum_j dS_ij K_j / sqrt(D),   dK_j = sum_i dS_ij Q_i / sqrt(D)
//
// GQA: dK and dV of KV head hk sum over the group's n_rep query heads, in
// head order.  A row that sees no key takes the mean of V in the forward
// (its scores are all the sentinel): its P is 1/Sk over every key, so it
// adds dO_i / Sk to every dV_j and nothing to dQ or dK.
//
// The forward saves what the backward needs (flash_attention.cu's STATS
// instantiation): each row's log-sum-exp in log2 units, LSE_i = m_i +
// log2(l_i), +inf for a row that sees no key and for the rows past Sq, in
// rows of lse_stride floats.  O is the float32 route's own output.  So
// P = 2**(s' log2(e) - LSE) with no second pass over the keys.  One call
// enqueues three grids:
//
//   prep  one block per (b, h, 64 rows): D_i = rowsum(dO o O) by a warp per
//         row, an xor butterfly over the lanes, 0 past Sq, and the count of
//         the rows that see no key; bound by bytes (dO and O once);
//   dkdv  one block per (b, hk, 64 keys), longest first: K and V stay in
//         shared memory, a cp.async ring of Q and dO tiles of 32 rows and
//         their LSE and D, over the group's heads and the visible query
//         tiles; warp w owns keys 16 w .. 16 w + 15:
//
//           S^T = K Q^T,  dP^T = V dO^T       B read K-major
//           P^T = 2**(S^T scale log2e - LSE),  dS^T = P^T (dP^T - D) chain
//           dV += P^T dO,  then dK += dS^T Q  A from the accumulators,
//                                             B read MN-major
//
//         then adds the rows that see no key (their dO / Sk) to dV and
//         writes dK (times 1/sqrt(D)) and dV;
//   dq    one block per (b, h, 64 query rows), longest first: Q and dO stay
//         in shared memory, a ring of K and V tiles of 64 keys; warp w owns
//         rows 16 w .. 16 w + 15:
//
//           S = Q K^T,  dP = dO V^T,  P,  dS,  dQ += dS K
//
//         and writes dQ (times 1/sqrt(D)).
//
// No atomics: every sum runs in one fixed order, so two calls give equal
// bits.  Which tiles a block visits follows flash_attention.py tile_plan's
// rule, decided by each warp from the tiles' ranges of positions: 0 skips
// a tile, 1 visits it with the per-element mask, 2 with every pair visible.
//
// Three TF32 products per float32 product.  A TF32 product keeps 10 bits
// of mantissa, too few for the route's 1e-4 (flash_attention.cu rejected
// it for the forward).  Each operand is split as x = hi + lo, hi =
// cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (by two integer operations
// each, see tf32_rna), and a b is taken as a_lo b_hi + a_hi b_lo + a_hi
// b_hi, the small terms first, summed in float32 by mma.sync.m16n8k8.tf32:
// only a_lo b_lo (about 2**-22 of a b) is dropped, as in CUTLASS's
// OpMultiplyAddFastF32 (a CPU model of this arithmetic is held to the
// check in test_torch_attention_grad.py).  The tensor cores round their
// float32 sums toward zero, so the long sums (dV, dK over the queries, dQ
// over the keys) take each depth step's three products from zero and add
// them with an FADD (mma3_add).  Operands are split as their fragments are
// loaded, in registers: splitting Q and dO once in shared memory for the
// four warps moved nothing (the kernel waits on latency, not on issue).
//
// Fragments are loaded by hand from shared memory whose rows are DP + 4
// floats (DP: D rounded up to 64 or 128), 4 mod 32, so that no load has a
// bank conflict: a K-major operand (the product's depth along a row) by
// ldmatrix.x4, which moves 32-bit words as pairs of b16 (thread t gets row
// t / 4, word t % 4 of each 8 x 4 matrix: the tf32 fragment layout); an
// operand read MN-major by single loads.  wgmma is not used: it takes tf32
// operands K-major only (its transpose exists for 16-bit types), and three
// of the five products read B MN-major.  An accumulator (rows g, g + 8,
// columns 2c, 2c + 1 of an 8-column tile) serves as the next product's A
// without a shuffle by permuting the product's depth: A's column slot c
// holds depth 2c and slot c + 4 depth 2c + 1, and B is read in that order.
//
// Bound: operations.  From the forward's saved LSE and O the function
// needs five S^2 D products (Q K^T, dO V^T, P^T dO, dS^T Q, dS K); this
// design runs seven (the dq grid recomputes S and dP rather than sum dQ
// with atomics), each as three TF32 products.  At the training path's
// shape (stablelm-1.6b, B = 2, S = 2048, H = Hkv = 32, D = 64, causal) the
// five take 0.521 ms as three TF32 products each at 495 TFLOP/s, 1.283 ms
// as float32 FMAs at 67 TFLOP/s.
#include "common.cuh"

#include <climits>

namespace {

constexpr int BK = 64;                // keys per dkdv block, and per tile of dq's ring
constexpr int BQ_KV = 32;             // query rows per tile of dkdv's ring
constexpr int BQ_DQ = 64;             // query rows per dq block
constexpr int NT = 128;               // threads: four warps of 16 rows each
constexpr int STAGES = 2;             // tiles in flight in each ring
constexpr int NOKEY_ROWS = 64;        // rows per no-key count (a prep block)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;             // (B, Sq, H, D) contiguous
  const float* k;             // (B, Sk, Hkv, D)
  const float* v;
  const float* dout;          // (B, Sq, H, D)
  const float* o;             // the forward's output (B, Sq, H, D)
  const float* lse;           // (B, H, lse_stride): +inf past Sq
  float* delta;               // (B, H, lse_stride), written by prep (0 past Sq)
  int* nokey;                 // (B, H, lse_stride / 64), written by prep
  float* dq;                  // (B, Sq, H, D)
  float* dk;                  // (B, Sk, Hkv, D)
  float* dv;
  const int* q_pos;
  const int* k_pos;
  int H, Hkv, n_rep, Sq, Sk, D, causal, window, lse_stride, vec;
  float scale, softcap;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

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

// 2**x by one MUFU.EX2 (about 2 ulp, results below 2**-126 flushed to 0):
// x is a score minus its row's log-sum-exp, so x <= 0 up to rounding.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cvt.rna.tf32.f32 of a finite x: round to 10 bits of mantissa, to
// nearest, ties away from zero (add half of the last kept bit to the
// magnitude, clear the 13 bits below it).  Two integer operations, bit for
// bit the conversion's result: the conversion itself compiles to a longer
// sequence (FSETP, SEL, IMAD: it tests for NaN and infinity), which the
// split would run for every element of every fragment.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi): TF32 values (float32
// with the low 13 bits zero); x - hi is exact.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

struct FragA {                        // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};
struct FragB {                        // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

// d += a b, m16n8k8, tf32 in, float32 accumulators.  A: a[0] row g column
// c, a[1] row g + 8 column c, a[2] row g column c + 4, a[3] row g + 8
// column c + 4; B: b0 depth c column g, b1 depth c + 4 column g; d: d[0]
// row g column 2c, d[1] column 2c + 1, d[2], d[3] the same of row g + 8
// (g = lane / 4, c = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 products, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// The same for a sum over many depth steps (dV, dK over the queries, dQ
// over the keys): the step's three products from zero, then one float32
// add into d.  The tensor cores round their float32 sums toward zero, so
// with d summed in the mma itself the error of every add has one sign and
// grows with the number of steps (on the card dV at S = 2048 left the
// check's 1e-4 that way); an FADD rounds to nearest.
__device__ __forceinline__ void mma3_add(float (&d)[4], const FragA& a, const FragB& b) {
  float t[4];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a.lo[0]), "r"(a.lo[1]), "r"(a.lo[2]), "r"(a.lo[3]), "r"(b.hi[0]), "r"(b.hi[1]),
        "f"(0.f));
  mma_tf32(t, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A operand of rows 0 .. 15, columns 0 .. 7 at ``at`` (rows of LD
// floats), K-major, split.
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const float* at) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, at + ((m & 1) * 8 + (lane & 7)) * LD + (m >> 1) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), f.hi[i], f.lo[i]);
}

// The B operands of two 8-column tiles at ``at``, stored as rows of the
// column index (rows 0 .. 7 the first tile, 8 .. 15 the second), depth 0 ..
// 7 along the row: K-major, split.
template <int LD>
__device__ __forceinline__ void load_b2(FragB& f0, FragB& f1, const float* at) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, at + ((m >> 1) * 8 + (lane & 7)) * LD + (m & 1) * 4);
  split(__uint_as_float(r[0]), f0.hi[0], f0.lo[0]);
  split(__uint_as_float(r[1]), f0.hi[1], f0.lo[1]);
  split(__uint_as_float(r[2]), f1.hi[0], f1.lo[0]);
  split(__uint_as_float(r[3]), f1.hi[1], f1.lo[1]);
}

// An accumulator tile as the next product's A operand, split: its columns
// are the depth, slot c holding column 2c and slot c + 4 column 2c + 1.
__device__ __forceinline__ void acc_as_a(FragA& f, const float (&acc)[4]) {
  split(acc[0], f.hi[0], f.lo[0]);
  split(acc[2], f.hi[1], f.lo[1]);
  split(acc[1], f.hi[2], f.lo[2]);
  split(acc[3], f.hi[3], f.lo[3]);
}

// The B operand, in acc_as_a's depth order, of a tile stored as rows of
// the depth: b0 = row 2c, b1 = row 2c + 1, column g; ``at`` points at row
// 2c, column g of the tile (MN-major, single loads).
template <int LD>
__device__ __forceinline__ void load_b_mn(FragB& f, const float* at) {
  split(at[0], f.hi[0], f.lo[0]);
  split(at[LD], f.hi[1], f.lo[1]);
}

// Rows 0 .. rows - 1 of a (rows, D) slab at ``src`` (row stride ``ss``
// floats) into ``dst`` [rows][DP + 4], columns 0 .. DP - 1: zero at and
// past D and in rows at and past ``valid``.  16-byte copies when ``vec``
// (base 16-byte aligned, D a multiple of 4), else 4-byte ones.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss, int rows,
                                          int valid, int D, bool vec) {
  constexpr int LD = DP + 4, C4 = DP / 4;
  for (int idx = threadIdx.x; idx < rows * C4; idx += NT) {
    const int r = idx / C4, c = 4 * (idx - r * C4);
    float* d = dst + r * LD + c;
    const bool in = r < valid;
    const float* s = in ? src + r * ss + c : src;
    if (vec) {
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

// (min, max) of pos[t0 .. t0 + rows - 1] (those < n), by one warp; every
// warp that calls it gets the same answer.
__device__ __forceinline__ void tile_range(const int* pos, int n, int t0, int rows, int& lo,
                                           int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = lane; i < rows; i += 32) {
    if (t0 + i < n) {
      const int x = pos[t0 + i];
      lo = min(lo, x);
      hi = max(hi, x);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// What a query tile with positions in [qlo, qhi] does with a key tile with
// positions in [klo, khi]: 0 no pair can be visible, 2 every pair is
// visible and the key tile lies inside Sk (``inside``), else 1.  As
// flash_attention.cu tile_kind; the CPU copy is flash_attention.py
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

__device__ __forceinline__ bool visible(long long qp, long long kp, const Params& p) {
  bool ok = true;
  if (p.causal) ok = kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// P and dS of one warp's (16, 8 N) tile in place.  On entry s holds the
// raw products q.k and dp the products dO.v; accumulator (j, e)'s row
// log-sum-exp and D are lse(j, e) and delta(j, e).  On exit s = P = 2**(x
// - LSE), x the score in log2 units (x = cap tanh(q.k scale / cap) log2(e)
// with CAP, as the forward computes it), and dp = dS = P (dP - D) (1 -
// tanh^2) on the pairs with visible(j, e) (MASK; every pair without), 0
// elsewhere.  CAP and MASK are template arguments, so the unrolled loop
// holds no branch (a run-time softcap test there makes a branch region of
// every element).
template <bool CAP, bool MASK, int N, typename Lse, typename Delta, typename Vis>
__device__ __forceinline__ void p_and_ds(float (&s)[N][4], float (&dp)[N][4], const Params& p,
                                         Lse lse, Delta delta, Vis vis) {
  const float scale2 = p.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x, chain = 1.f;
      if constexpr (CAP) {
        const float t = tanhf(s[j][e] * p.scale / p.softcap);
        chain = 1.f - t * t;
        x = p.softcap * t * LOG2E;
      } else {
        x = s[j][e] * scale2;
      }
      float pr = exp2_ftz(x - lse(j, e));
      if constexpr (MASK) pr = vis(j, e) ? pr : 0.f;
      s[j][e] = pr;
      dp[j][e] = CAP ? pr * (dp[j][e] - delta(j, e)) * chain : pr * (dp[j][e] - delta(j, e));
    }
}

// p_and_ds with its template arguments from the tile's kind (mask: 1) and
// the softcap.
template <int N, typename Lse, typename Delta, typename Vis>
__device__ __forceinline__ void p_and_ds_tile(float (&s)[N][4], float (&dp)[N][4],
                                              const Params& p, bool mask, Lse lse, Delta delta,
                                              Vis vis) {
  const bool cap = p.softcap > 0.f;
  if (mask) {
    if (cap) p_and_ds<true, true, N>(s, dp, p, lse, delta, vis);
    else p_and_ds<false, true, N>(s, dp, p, lse, delta, vis);
  } else {
    if (cap) p_and_ds<true, false, N>(s, dp, p, lse, delta, vis);
    else p_and_ds<false, false, N>(s, dp, p, lse, delta, vis);
  }
}

// Store a warp's (16, DP) accumulator, times ``mul`` plus add[col] (or
// not), as rows row0 + g (+ 8) of a (rows, D) matrix at ``out`` with
// ``stride`` floats a row, rows < ``valid``.
template <int ND>
__device__ __forceinline__ void store_rows(const float (&acc)[ND][4], float* out,
                                           long long stride, int row0, int valid, int D,
                                           float mul, const float* add) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    if (r >= valid) continue;
    float* row = out + static_cast<long long>(r) * stride;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * c;
      float x0 = acc[n][2 * rr] * mul, x1 = acc[n][2 * rr + 1] * mul;
      if (add != nullptr) {
        x0 += add[col];
        x1 += add[col + 1];
      }
      if ((D & 1) == 0 && col + 1 < D) {
        *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
      } else {
        if (col < D) row[col] = x0;
        if (col + 1 < D) row[col + 1] = x1;
      }
    }
  }
}

// Shared memory, in floats, of a dkdv block: K and V [BK][LD], STAGES x Q
// and STAGES x dO [BQ_KV][LD], STAGES x LSE and STAGES x D [BQ_KV], the
// no-key rows' dO sum [DP]; of a dq block: Q and dO [BQ_DQ][LD], STAGES x K
// and STAGES x V [BK][LD].  CPU copy: flash_attention.py f32_bwd_smem_bytes.
template <int DP>
constexpr int dkdv_floats() {
  return 2 * BK * (DP + 4) + 2 * STAGES * BQ_KV * (DP + 4) + 2 * STAGES * BQ_KV + DP;
}
template <int DP>
constexpr int dq_floats() {
  return 2 * BQ_DQ * (DP + 4) + 2 * STAGES * BK * (DP + 4);
}

// ---------------------------------------------------------------------------
// prep: D and the no-key counts.  Block (bh, t) takes rows 64 t .. 64 t + 63
// of row bh of lse; warp w rows 8 w .. 8 w + 7 of them, lane l columns l,
// l + 32, ...
__global__ void __launch_bounds__(256)
flash_attention_bwd_prep_kernel(const Params p) {
  const int tiles = p.lse_stride / NOKEY_ROWS;
  const int bh = blockIdx.x / tiles, t = blockIdx.x - bh * tiles;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = t * NOKEY_ROWS + 8 * warp;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    acc[i] = 0.f;
    if (r < p.Sq) {
      const long long at = ((static_cast<long long>(b) * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = lane + 32 * cc;
        if (col < p.D) acc[i] = fmaf(p.dout[at + col], p.o[at + col], acc[i]);
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
  if (threadIdx.x == 0) p.nokey[static_cast<long long>(bh) * tiles + t] = count;
}

// ---------------------------------------------------------------------------
// dkdv: block (key tile, bhk), key tiles in increasing order (the longest
// first under causal masks).
template <int DP>
__global__ void __launch_bounds__(NT, DP == 64 ? 2 : 1)
flash_attention_bwd_dkdv_kernel(const Params p) {
  constexpr int LD = DP + 4, KD = DP / 8, NQ = BQ_KV / 8, ND = DP / 8;
  extern __shared__ float4 smem4[];
  float* kS = reinterpret_cast<float*>(smem4);     // [BK][LD]
  float* vS = kS + BK * LD;                         // [BK][LD]
  float* qS = vS + BK * LD;                         // STAGES x [BQ_KV][LD]
  float* oS = qS + STAGES * BQ_KV * LD;             // STAGES x dO [BQ_KV][LD]
  float* lseS = oS + STAGES * BQ_KV * LD;           // STAGES x [BQ_KV]
  float* dlS = lseS + STAGES * BQ_KV;               // STAGES x [BQ_KV]
  float* mean = dlS + STAGES * BQ_KV;               // [DP]

  const int n_bhk = static_cast<int>(gridDim.x) / ((p.Sk + BK - 1) / BK);
  const int kt = static_cast<int>(blockIdx.x) / n_bhk;
  const int bhk = static_cast<int>(blockIdx.x) - kt * n_bhk;
  const int b = bhk / p.Hkv, hk = bhk - b * p.Hkv;
  const int k0 = kt * BK;
  const int n_qt = (p.Sq + BQ_KV - 1) / BQ_KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const long long qrow = static_cast<long long>(p.H) * p.D;
  const long long krow = static_cast<long long>(p.Hkv) * p.D;
  const long long koff = (static_cast<long long>(b) * p.Sk + k0) * krow +
                         static_cast<long long>(hk) * p.D;
  const bool vec = p.vec != 0;
  load_tile<DP>(kS, p.k + koff, krow, BK, p.Sk - k0, p.D, vec);
  load_tile<DP>(vS, p.v + koff, krow, BK, p.Sk - k0, p.D, vec);

  int klo, khi;
  tile_range(p.k_pos, p.Sk, k0, BK, klo, khi);
  const bool inside = k0 + BK <= p.Sk;
  // the first visited query tile at or after qt (n_qt if none), and its kind
  const auto next_q = [&](int qt, int& kind) {
    for (; qt < n_qt; ++qt) {
      int qlo, qhi;
      tile_range(p.q_pos, p.Sq, qt * BQ_KV, BQ_KV, qlo, qhi);
      kind = tile_kind(qlo, qhi, klo, khi, inside, p);
      if (kind != 0) break;
    }
    return qt;
  };
  const auto load_item = [&](int r, int qt, int stage) {
    const int h = hk * p.n_rep + r;
    const long long qoff = (static_cast<long long>(b) * p.Sq + qt * BQ_KV) * qrow +
                           static_cast<long long>(h) * p.D;
    const int valid = p.Sq - qt * BQ_KV;
    load_tile<DP>(qS + stage * BQ_KV * LD, p.q + qoff, qrow, BQ_KV, valid, p.D, vec);
    load_tile<DP>(oS + stage * BQ_KV * LD, p.dout + qoff, qrow, BQ_KV, valid, p.D, vec);
    const long long row =
        (static_cast<long long>(b) * p.H + h) * p.lse_stride + qt * BQ_KV;
    for (int i = threadIdx.x; i < BQ_KV; i += NT) {
      cp4(lseS + stage * BQ_KV + i, p.lse + row + i, 4);
      cp4(dlS + stage * BQ_KV + i, p.delta + row + i, 4);
    }
    cp_commit();
  };

  // keys of this thread: k0 + 16 w + g and + 8
  const int kr0 = k0 + 16 * warp + g, kr1 = kr0 + 8;
  const bool kin0 = kr0 < p.Sk, kin1 = kr1 < p.Sk;
  const long long kp0 = kin0 ? p.k_pos[kr0] : 0, kp1 = kin1 ? p.k_pos[kr1] : 0;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int first_kind = 0;
  const int q_first = next_q(0, first_kind);
  int r = 0, qt = q_first, kind = first_kind, stage = 0;
  if (qt < n_qt) load_item(r, qt, stage);
  while (qt < n_qt) {
    cp_wait_all();
    __syncthreads();                  // the tile has landed for every thread, and
                                      // every thread is done with the other stage
    // the next item: the next visited tile of this head, else the next head's first
    int next_kind = 0, nr = r;
    int nq = next_q(qt + 1, next_kind);
    if (nq == n_qt && ++nr < p.n_rep) {
      nq = q_first;
      next_kind = first_kind;
    }
    if (nq < n_qt) load_item(nr, nq, stage ^ 1);

    const float* qs = qS + stage * BQ_KV * LD;
    const float* os = oS + stage * BQ_KV * LD;
    // -- S^T = K Q^T and dP^T = V dO^T, keys 16 w .. + 15 by 32 queries ----
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      FragA ka, va;
      load_a<LD>(ka, kS + 16 * warp * LD + 8 * kd);
      load_a<LD>(va, vS + 16 * warp * LD + 8 * kd);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        FragB qb0, qb1, ob0, ob1;
        load_b2<LD>(qb0, qb1, qs + 8 * j * LD + 8 * kd);
        load_b2<LD>(ob0, ob1, os + 8 * j * LD + 8 * kd);
        mma3(s[j], ka, qb0);
        mma3(s[j + 1], ka, qb1);
        mma3(dp[j], va, ob0);
        mma3(dp[j + 1], va, ob1);
      }
    }
    // -- P^T and dS^T in place: accumulator (j, e) holds key row 16 w + g +
    //    8 (e >> 1) and query column 8 j + 2 c + (e & 1) of the tile ------
    const float* lse_t = lseS + stage * BQ_KV;
    const float* dl_t = dlS + stage * BQ_KV;
    const int q0 = qt * BQ_KV;
    const auto col = [&](int j, int e) { return 8 * j + 2 * c + (e & 1); };
    p_and_ds_tile<NQ>(
        s, dp, p, kind == 1, [&](int j, int e) { return lse_t[col(j, e)]; },
        [&](int j, int e) { return dl_t[col(j, e)]; },
        [&](int j, int e) {
          const int qr = q0 + col(j, e);
          const bool up = e >> 1;
          return (up ? kin1 : kin0) && (qr >= p.Sq || visible(p.q_pos[qr], up ? kp1 : kp0, p));
        });
    // -- dV += P^T dO, then dK += dS^T Q (in two passes, so that fewer
    //    fragments are live at once): depth the tile's queries, B read
    //    MN-major in acc_as_a's order --------------------------------------
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      FragA pa;
      acc_as_a(pa, s[j]);
      const float* orow = os + (8 * j + 2 * c) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB ob;
        load_b_mn<LD>(ob, orow + 8 * n);
        mma3_add(dv[n], pa, ob);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      FragA da;
      acc_as_a(da, dp[j]);
      const float* qrow_s = qs + (8 * j + 2 * c) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB qb;
        load_b_mn<LD>(qb, qrow_s + 8 * n);
        mma3_add(dk[n], da, qb);
      }
    }
    stage ^= 1;
    r = nr;
    qt = nq;
    kind = next_kind;
  }
  cp_wait_all();                      // K and V's copies, when no tile was visited

  // -- rows that see no key: P = 1/Sk over every key, so every dV_j gains
  //    the sum of their dO over the group's heads, over Sk (column tid; in
  //    head, tile and row order) ------------------------------------------
  const int tid = threadIdx.x;
  const int n_nk = p.lse_stride / NOKEY_ROWS;
  bool any = false;
  for (int rr = 0; rr < p.n_rep && !any; ++rr) {
    const long long bh = static_cast<long long>(b) * p.H + hk * p.n_rep + rr;
    for (int t = 0; t < n_nk; ++t) any = any || p.nokey[bh * n_nk + t] != 0;
  }
  if (any) {
    if (tid < DP) {
      float sum = 0.f;
      if (tid < p.D) {
        for (int rr = 0; rr < p.n_rep; ++rr) {
          const int h = hk * p.n_rep + rr;
          const long long bh = static_cast<long long>(b) * p.H + h;
          for (int t = 0; t < n_nk; ++t) {
            if (p.nokey[bh * n_nk + t] == 0) continue;
            const int end = min(p.Sq, (t + 1) * NOKEY_ROWS);
            for (int row = t * NOKEY_ROWS; row < end; ++row)
              if (p.lse[bh * p.lse_stride + row] == pos_inf())
                sum += p.dout[(static_cast<long long>(b) * p.Sq + row) * qrow +
                              static_cast<long long>(h) * p.D + tid];
          }
        }
      }
      mean[tid] = sum / static_cast<float>(p.Sk);
    }
    __syncthreads();
  }

  const long long kvb =
      static_cast<long long>(b) * p.Sk * krow + static_cast<long long>(hk) * p.D;
  store_rows<ND>(dk, p.dk + kvb, krow, k0 + 16 * warp, p.Sk, p.D, p.scale, nullptr);
  store_rows<ND>(dv, p.dv + kvb, krow, k0 + 16 * warp, p.Sk, p.D, 1.f, any ? mean : nullptr);
}

// ---------------------------------------------------------------------------
// dq: block (query tile, bh), query tiles in decreasing order (the longest
// first under causal masks).
template <int DP>
__global__ void __launch_bounds__(NT, DP == 64 ? 2 : 1)
flash_attention_bwd_dq_kernel(const Params p) {
  constexpr int LD = DP + 4, KD = DP / 8, NK = BK / 8, ND = DP / 8;
  extern __shared__ float4 smem4[];
  float* qS = reinterpret_cast<float*>(smem4);     // [BQ_DQ][LD]
  float* oS = qS + BQ_DQ * LD;                     // dO [BQ_DQ][LD]
  float* kS = oS + BQ_DQ * LD;                     // STAGES x [BK][LD]
  float* vS = kS + STAGES * BK * LD;               // STAGES x [BK][LD]

  const int n_qt = (p.Sq + BQ_DQ - 1) / BQ_DQ;
  const int n_bh = static_cast<int>(gridDim.x) / n_qt;
  const int qi = static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) - qi * n_bh;
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.n_rep;
  const int q0 = (n_qt - 1 - qi) * BQ_DQ;
  const int n_kt = (p.Sk + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const long long qrow = static_cast<long long>(p.H) * p.D;
  const long long krow = static_cast<long long>(p.Hkv) * p.D;
  const long long qoff = (static_cast<long long>(b) * p.Sq + q0) * qrow +
                         static_cast<long long>(h) * p.D;
  const long long kvb =
      static_cast<long long>(b) * p.Sk * krow + static_cast<long long>(hk) * p.D;
  const float* kb = p.k + kvb;
  const float* vb = p.v + kvb;
  const bool vec = p.vec != 0;
  load_tile<DP>(qS, p.q + qoff, qrow, BQ_DQ, p.Sq - q0, p.D, vec);
  load_tile<DP>(oS, p.dout + qoff, qrow, BQ_DQ, p.Sq - q0, p.D, vec);

  int qlo, qhi;
  tile_range(p.q_pos, p.Sq, q0, BQ_DQ, qlo, qhi);
  const auto next_k = [&](int kt, int& kind) {
    for (; kt < n_kt; ++kt) {
      int klo, khi;
      tile_range(p.k_pos, p.Sk, kt * BK, BK, klo, khi);
      kind = tile_kind(qlo, qhi, klo, khi, (kt + 1) * BK <= p.Sk, p);
      if (kind != 0) break;
    }
    return kt;
  };
  const auto load_item = [&](int kt, int stage) {
    const long long at = static_cast<long long>(kt) * BK * krow;
    load_tile<DP>(kS + stage * BK * LD, kb + at, krow, BK, p.Sk - kt * BK, p.D, vec);
    load_tile<DP>(vS + stage * BK * LD, vb + at, krow, BK, p.Sk - kt * BK, p.D, vec);
    cp_commit();
  };

  // rows of this thread: q0 + 16 w + g and + 8 (inside lse_stride; +inf
  // and 0 past Sq)
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const long long at0 = static_cast<long long>(bh) * p.lse_stride + r0;
  const float lse[2] = {p.lse[at0], p.lse[at0 + 8]};
  const float dl[2] = {p.delta[at0], p.delta[at0 + 8]};
  const long long qp[2] = {r0 < p.Sq ? p.q_pos[r0] : 0, r1 < p.Sq ? p.q_pos[r1] : 0};

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int kind = 0, stage = 0;
  int kt = next_k(0, kind);
  if (kt < n_kt) load_item(kt, stage);
  while (kt < n_kt) {
    cp_wait_all();
    __syncthreads();
    int next_kind = 0;
    const int nk = next_k(kt + 1, next_kind);
    if (nk < n_kt) load_item(nk, stage ^ 1);

    const float* ks = kS + stage * BK * LD;
    const float* vs = vS + stage * BK * LD;
    // -- S = Q K^T and dP = dO V^T, rows 16 w .. + 15 by BK keys ----------
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      FragA qa, oa;
      load_a<LD>(qa, qS + 16 * warp * LD + 8 * kd);
      load_a<LD>(oa, oS + 16 * warp * LD + 8 * kd);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        FragB kb0, kb1, vb0, vb1;
        load_b2<LD>(kb0, kb1, ks + 8 * j * LD + 8 * kd);
        load_b2<LD>(vb0, vb1, vs + 8 * j * LD + 8 * kd);
        mma3(s[j], qa, kb0);
        mma3(s[j + 1], qa, kb1);
        mma3(dp[j], oa, vb0);
        mma3(dp[j + 1], oa, vb1);
      }
    }
    // -- dS in place of dP: accumulator (j, e) holds row 16 w + g + 8 (e >>
    //    1) and key 8 j + 2 c + (e & 1) of the tile ------------------------
    p_and_ds_tile<NK>(
        s, dp, p, kind == 1, [&](int, int e) { return lse[e >> 1]; },
        [&](int, int e) { return dl[e >> 1]; },
        [&](int j, int e) {
          const int key = kt * BK + 8 * j + 2 * c + (e & 1);
          return key < p.Sk && visible(qp[e >> 1], p.k_pos[key], p);
        });
    // -- dQ += dS K: depth the tile's keys, K read MN-major ----------------
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      FragA da;
      acc_as_a(da, dp[j]);
      const float* krow_s = ks + (8 * j + 2 * c) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB kf;
        load_b_mn<LD>(kf, krow_s + 8 * n);
        mma3_add(dq[n], da, kf);
      }
    }
    stage ^= 1;
    kt = nk;
    kind = next_kind;
  }
  cp_wait_all();                      // Q and dO's copies, when no tile was visited

  store_rows<ND>(dq, p.dq + static_cast<long long>(b) * p.Sq * qrow +
                         static_cast<long long>(h) * p.D,
                 qrow, q0 + 16 * warp, p.Sq, p.D, p.scale, nullptr);
}

// -- host -------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
cudaError_t launch_all(const Params& p, int B, cudaStream_t st) {
  const auto dkdv = flash_attention_bwd_dkdv_kernel<DP>;
  const auto dq = flash_attention_bwd_dq_kernel<DP>;
  const int kv_smem = 4 * dkdv_floats<DP>(), q_smem = 4 * dq_floats<DP>();
  cudaError_t err = set_smem(dkdv, kv_smem);
  if (err == cudaSuccess) err = set_smem(dq, q_smem);
  if (err != cudaSuccess) return err;
  const unsigned bh = static_cast<unsigned>(B) * p.H, bhk = static_cast<unsigned>(B) * p.Hkv;
  flash_attention_bwd_prep_kernel<<<bh * (p.lse_stride / NOKEY_ROWS), 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<bhk * ((p.Sk + BK - 1) / BK), NT, kv_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<bh * ((p.Sq + BQ_DQ - 1) / BQ_DQ), NT, q_smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Gradients of flash_attention's float32 route.  q, dout (B, Sq, H, D) and
// k, v (B, Sk, Hkv, D) float32 contiguous; lse (B, H, lse_stride) float32
// and o (B, Sq, H, D) from the forward (flash_attention.cu's statistics:
// lse_stride >= Sq a multiple of 128, +inf past Sq; o its output); scratch
// delta (B, H, lse_stride) float32 and nokey (B, H, lse_stride / 64)
// int32, both written; dq (B, Sq, H, D), dk and dv (B, Sk, Hkv, D) float32
// contiguous, written.  q_pos (Sq,) and k_pos (Sk,) int32.  window <= 0
// means none, softcap <= 0 none.  D <= 128; 0 < Sk, 0 < Sq; the grids are
// one-dimensional.  Enqueues three grids.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, const void* lse, const void* o, void* delta, void* nokey, const void* q_pos,
    const void* k_pos, int B, int H, int Hkv, int Sq, int Sk, int D, int lse_stride,
    int causal, int window, float scale, float softcap, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv != 0 || Sk < 1 || Sq < 1 || lse_stride < Sq ||
      lse_stride % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.o = static_cast<const float*>(o);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.nokey = static_cast<int*>(nokey);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.H = H;
  p.Hkv = Hkv;
  p.n_rep = H / Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.lse_stride = lse_stride;
  p.vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(dout);
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch_all<64>(p, B, st)
                                  : launch_all<128>(p, B, st));
}

// Dynamic shared memory of one block of the dK/dV grid (which = 0) or the
// dQ grid (which = 1) at head dim D: what the launch asks for.  CPU copy:
// flash_attention.py f32_bwd_smem_bytes, held to this by chip_smoke.py.
extern "C" int repro_flash_attention_bwd_smem_bytes(int D, int which) {
  if (which == 0) return 4 * (D <= 64 ? dkdv_floats<64>() : dkdv_floats<128>());
  return 4 * (D <= 64 ? dq_floats<64>() : dq_floats<128>());
}

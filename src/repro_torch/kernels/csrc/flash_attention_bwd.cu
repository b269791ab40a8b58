// flash_attention_bwd for sm_90a: the gradient of flash_attention's float32
// route, computed in float32 on the FMA pipes (the bf16 route's is
// flash_attention_bwd_sm90.cu).
//
// The JAX package has no Pallas backward: it differentiates its chunked
// attention (src/repro/models/attention.py:136) in XLA, and its Pallas
// kernel src/repro/kernels/flash_attention.py:87 has no custom_vjp.  The
// port runs training attention through its forward kernels
// (flash_attention.cu, flash_attention_sm90.cu), so the gradient is this
// kernel.  With s = q.k / sqrt(D), s' = cap tanh(s / cap) (softcap), the
// mask setting s' to -1e30, P = softmax(s') and O = P V:
//
//   D_i  = sum_d dO_id O_id                    (O in float32, recomputed)
//   dV_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . V_j - D_i) (1 - tanh^2(s_ij / cap))   visible pairs
//   dQ_i = sum_j dS_ij K_j / sqrt(D),   dK_j = sum_i dS_ij Q_i / sqrt(D)
//
// GQA: dK and dV of KV head hk sum over the group's n_rep query heads.  A
// row that sees no key takes the mean of V in the forward (its scores are
// all the sentinel): its P is 1/Sk over every key, so it adds dO_i / Sk to
// every dV_j and nothing to dQ or dK (the mask cuts the scores' gradient).
//
// One call of repro_flash_attention_bwd enqueues three grids:
//
//   prep  one block per (b, h, 64-row query tile): recomputes the row's
//         log-sum-exp (log2 units) and O in float32 by the forward's online
//         softmax, and writes LSE and D; a row that sees no key gets LSE =
//         +inf, D = 0, and its tile's count of such rows is written;
//   dkdv  one block per (b, hk, 64-key tile): loops over the group's heads
//         and the visible query tiles, keeps dK and dV in registers, then
//         adds the no-key rows' dO / Sk to dV;
//   dq    one block per (b, h, 64-row query tile): loops over the visible
//         key tiles and keeps dQ in registers.
//
// No atomics: every sum runs in one fixed order, so two calls give equal
// bits.  Which tiles a block visits follows flash_attention.py tile_plan's
// rule (64 by 64 tiles here): a pair of tiles is skipped when no (query,
// key) pair of them can be visible, decided from the tiles' ranges of
// positions; visited tiles apply the per-element mask.
//
// Bound: operations.  The function needs five S^2 D products (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K) plus the log-sum-exp's Q K^T; this design does nine
// (the prep recomputes O, and dkdv and dq each recompute Q K^T and dO V^T),
// each as float32 FMAs from 4 x 4 register micro-tiles read from shared
// memory (two shared loads per four FMAs).  Simple first: wgmma and TMA
// are for a later redesign (ROADMAP Queue 2).
#include "common.cuh"

#include <climits>

namespace {

constexpr int BQ = 64;                // query rows per tile
constexpr int BK = 64;                // keys per tile
constexpr int NT = 256;               // threads: 16 x 16, (ty, tx)
constexpr int PS = BK + 1;            // floats per row of a P or dS tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const int* q_pos;
  const int* k_pos;
  int H, Hkv, n_rep, Sq, Sk, D, n_qt, n_kt, causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Rows 0 .. BQ - 1 of a (rows, D) slab at ``src`` (row stride ``ss``
// elements) into ``dst`` as float32 [BQ][DP + 1]; rows at or past
// ``valid`` and columns at or past D are zero.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss,
                                          int valid, int D) {
  for (int idx = threadIdx.x; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, c = idx % DP;
    dst[r * (DP + 1) + c] = r < valid && c < D ? src[r * ss + c] : 0.f;
  }
}

// (min, max) of pos[t0 .. t0 + 63] (those < n), by one warp; every warp
// that calls it gets the same answer.
__device__ __forceinline__ void tile_range(const int* pos, int n, int t0, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = t0 + 32 * i + lane;
    if (r < n) {
      const int x = pos[r];
      lo = min(lo, x);
      hi = max(hi, x);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// Whether a query tile with positions in [qlo, qhi] can see any key of a
// tile with positions in [klo, khi]: tile_kind's "some" in
// flash_attention.cu (CPU copy: flash_attention.py tile_plan).
__device__ __forceinline__ bool tiles_meet(int qlo, int qhi, int klo, int khi,
                                           const Params& p) {
  bool some = qlo <= qhi && klo <= khi;
  if (p.causal) some = some && klo <= qhi;
  if (p.window > 0)
    some = some && static_cast<long long>(khi) > static_cast<long long>(qlo) - p.window;
  return some;
}

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  bool ok = true;
  if (p.causal) ok = kp <= qp;
  if (p.window > 0)
    ok = ok && static_cast<long long>(kp) > static_cast<long long>(qp) - p.window;
  return ok;
}

// The score of q.k = ``dot`` in log2 units, and the softcap's chain factor
// 1 - tanh^2(s / cap) (1 without a softcap).
__device__ __forceinline__ float score2(float dot, const Params& p, float& chain) {
  float s = dot * p.scale;
  chain = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(s / p.softcap);
    s = p.softcap * t;
    chain = 1.f - t * t;
  }
  return s * LOG2E;
}

__device__ __forceinline__ float half_sum(float x) {      // over the 16 tx lanes
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// ---------------------------------------------------------------------------
// prep: LSE (log2 units) and D per row; thread (ty, tx) holds rows ty + 16 a
// and, of O, columns tx + 16 c.
template <int DP>
__global__ void __launch_bounds__(NT)
flash_attention_bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                float* __restrict__ lse, float* __restrict__ delta,
                                int* __restrict__ nokey, Params p) {
  constexpr int LD = DP + 1, CW = DP / 16;
  extern __shared__ float smem[];
  float* qS = smem;                   // [BQ][LD]
  float* kS = qS + BQ * LD;           // [BK][LD]
  float* vS = kS + BK * LD;           // [BK][LD]
  float* pS = vS + BK * LD;           // [BQ][PS]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = static_cast<int>(blockIdx.x % p.n_qt);
  const int bh = static_cast<int>(blockIdx.x / p.n_qt);
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.n_rep;
  const int q0 = qt * BQ;
  const long long qrow = static_cast<long long>(p.H) * p.D;
  const long long krow = static_cast<long long>(p.Hkv) * p.D;
  const float* kb = k + static_cast<long long>(b) * p.Sk * krow + static_cast<long long>(hk) * p.D;
  const float* vb = v + static_cast<long long>(b) * p.Sk * krow + static_cast<long long>(hk) * p.D;
  const long long qoff = (static_cast<long long>(b) * p.Sq + q0) * qrow +
                         static_cast<long long>(h) * p.D;
  load_tile<DP>(qS, q + qoff, qrow, p.Sq - q0, p.D);

  int qlo, qhi;
  tile_range(p.q_pos, p.Sq, q0, qlo, qhi);
  int qp[4];
  bool qin[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    qin[a] = row < p.Sq;
    qp[a] = qin[a] ? p.q_pos[row] : 0;
  }
  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[a][c] = 0.f;
  }

  for (int kt = 0; kt < p.n_kt; ++kt) {
    int klo, khi;
    tile_range(p.k_pos, p.Sk, kt * BK, klo, khi);
    if (!tiles_meet(qlo, qhi, klo, khi, p)) continue;
    __syncthreads();                  // Q has landed; the last tile is read
    load_tile<DP>(kS, kb + kt * BK * krow, krow, p.Sk - kt * BK, p.D);
    load_tile<DP>(vS, vb + kt * BK * krow, krow, p.Sk - kt * BK, p.D);
    int kp[4];
    bool kin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kt * BK + tx + 16 * j;
      kin[j] = key < p.Sk;
      kp[j] = kin[j] ? p.k_pos[key] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = qS[(ty + 16 * a) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = kS[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(x[a], y[j], s[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = NEG_INF;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float chain;
        ok[j] = qin[a] && kin[j] && visible(qp[a], kp[j], p);
        s[a][j] = ok[j] ? score2(s[a][j], p, chain) : NEG_INF;
        mx = fmaxf(mx, s[a][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[a], mx);
      const float corr = exp2f(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ok[j] ? exp2f(s[a][j] - m_new) : 0.f;
        pS[(ty + 16 * a) * PS + tx + 16 * j] = e;
        rs += e;
      }
      l[a] = l[a] * corr + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[a][c] *= corr;
    }
    __syncwarp();                     // a half warp reads back only its own rows
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pr[a] = pS[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = vS[j * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pr[a], vv, acc[a][c]);
      }
    }
  }

  bool none[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float lsum = half_sum(l[a]);
    const int row = q0 + ty + 16 * a;
    none[a] = qin[a] && !(lsum > 0.f);
    float dsum = 0.f;
    if (qin[a] && !none[a]) {
      const float inv = 1.f / lsum;
      const float* drow = dout + (static_cast<long long>(b) * p.Sq + row) * qrow +
                      static_cast<long long>(h) * p.D;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int col = tx + 16 * c;
        if (col < p.D) dsum = fmaf(drow[col], acc[a][c] * inv, dsum);
      }
    }
    dsum = half_sum(dsum);
    if (qin[a] && tx == 0) {
      const long long at = static_cast<long long>(bh) * p.Sq + row;
      lse[at] = none[a] ? pos_inf() : m[a] + log2f(lsum);
      delta[at] = none[a] ? 0.f : dsum;
    }
  }
  int count = 0;                      // rows of this tile that see no key
#pragma unroll
  for (int a = 0; a < 4; ++a) count += __syncthreads_count(none[a] && tx == 0);
  if (tid == 0) nokey[static_cast<long long>(bh) * p.n_qt + qt] = count;
}

// ---------------------------------------------------------------------------
// dq: thread (ty, tx) holds query rows ty + 16 a; in the score tiles keys
// tx + 16 j, in dQ columns tx + 16 c.
template <int DP>
__global__ void __launch_bounds__(NT)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dq,
                              Params p) {
  constexpr int LD = DP + 1, CW = DP / 16;
  extern __shared__ float smem[];
  float* qS = smem;                   // [BQ][LD]
  float* oS = qS + BQ * LD;           // dO [BQ][LD]
  float* kS = oS + BQ * LD;           // [BK][LD]
  float* vS = kS + BK * LD;           // [BK][LD]
  float* dsS = vS + BK * LD;          // [BQ][PS]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = static_cast<int>(blockIdx.x % p.n_qt);
  const int bh = static_cast<int>(blockIdx.x / p.n_qt);
  const int b = bh / p.H, h = bh - b * p.H, hk = h / p.n_rep;
  const int q0 = qt * BQ;
  const long long qrow = static_cast<long long>(p.H) * p.D;
  const long long krow = static_cast<long long>(p.Hkv) * p.D;
  const float* kb = k + static_cast<long long>(b) * p.Sk * krow + static_cast<long long>(hk) * p.D;
  const float* vb = v + static_cast<long long>(b) * p.Sk * krow + static_cast<long long>(hk) * p.D;
  const long long qoff = (static_cast<long long>(b) * p.Sq + q0) * qrow +
                         static_cast<long long>(h) * p.D;
  load_tile<DP>(qS, q + qoff, qrow, p.Sq - q0, p.D);
  load_tile<DP>(oS, dout + qoff, qrow, p.Sq - q0, p.D);

  int qlo, qhi;
  tile_range(p.q_pos, p.Sq, q0, qlo, qhi);
  int qp[4];
  bool qin[4];
  float lr[4], dr[4], acc[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    qin[a] = row < p.Sq;
    qp[a] = qin[a] ? p.q_pos[row] : 0;
    const long long at = static_cast<long long>(bh) * p.Sq + row;
    lr[a] = qin[a] ? lse[at] : pos_inf();      // +inf: P = 0 (no key, or past Sq)
    dr[a] = qin[a] ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[a][c] = 0.f;
  }

  for (int kt = 0; kt < p.n_kt; ++kt) {
    int klo, khi;
    tile_range(p.k_pos, p.Sk, kt * BK, klo, khi);
    if (!tiles_meet(qlo, qhi, klo, khi, p)) continue;
    __syncthreads();
    load_tile<DP>(kS, kb + kt * BK * krow, krow, p.Sk - kt * BK, p.D);
    load_tile<DP>(vS, vb + kt * BK * krow, krow, p.Sk - kt * BK, p.D);
    int kp[4];
    bool kin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kt * BK + tx + 16 * j;
      kin[j] = key < p.Sk;
      kp[j] = kin[j] ? p.k_pos[key] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float x[4], o[4], y[4], w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        x[a] = qS[(ty + 16 * a) * LD + c];
        o[a] = oS[(ty + 16 * a) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = kS[(tx + 16 * j) * LD + c];
        w[j] = vS[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = fmaf(x[a], y[j], s[a][j]);
          dp[a][j] = fmaf(o[a], w[j], dp[a][j]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float chain;
        const float x = score2(s[a][j], p, chain);
        const bool ok = qin[a] && kin[j] && visible(qp[a], kp[j], p);
        const float pr = ok ? exp2f(x - lr[a]) : 0.f;
        dsS[(ty + 16 * a) * PS + tx + 16 * j] = pr * (dp[a][j] - dr[a]) * chain;
      }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = dsS[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float kk = kS[j * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(ds[a], kk, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!qin[a]) continue;
    float* out = dq + qoff + static_cast<long long>(ty + 16 * a) * qrow;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) out[col] = acc[a][c] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dkdv: thread (ty, tx) holds keys ty + 16 a; in the score tiles query rows
// tx + 16 i, in dK and dV columns tx + 16 c.
template <int DP>
__global__ void __launch_bounds__(NT)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const int* __restrict__ nokey, float* __restrict__ dk,
                                float* __restrict__ dv, Params p) {
  constexpr int LD = DP + 1, CW = DP / 16;
  extern __shared__ float smem[];
  float* kS = smem;                   // [BK][LD]
  float* vS = kS + BK * LD;           // [BK][LD]
  float* qS = vS + BK * LD;           // [BQ][LD]
  float* oS = qS + BQ * LD;           // dO [BQ][LD]
  float* pT = oS + BQ * LD;           // P^T [BK][PS]
  float* dsT = pT + BK * PS;          // dS^T [BK][PS]
  float* lseS = dsT + BK * PS;        // [BQ]
  float* dS = lseS + BQ;              // [BQ]
  float* mean = dS + BQ;              // [DP]: the no-key rows' dO / Sk
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kt = static_cast<int>(blockIdx.x % p.n_kt);
  const int bhk = static_cast<int>(blockIdx.x / p.n_kt);
  const int b = bhk / p.Hkv, hk = bhk - b * p.Hkv;
  const int k0 = kt * BK;
  const long long qrow = static_cast<long long>(p.H) * p.D;
  const long long krow = static_cast<long long>(p.Hkv) * p.D;
  const long long koff = (static_cast<long long>(b) * p.Sk + k0) * krow +
                         static_cast<long long>(hk) * p.D;
  load_tile<DP>(kS, k + koff, krow, p.Sk - k0, p.D);
  load_tile<DP>(vS, v + koff, krow, p.Sk - k0, p.D);

  int klo, khi;
  tile_range(p.k_pos, p.Sk, k0, klo, khi);
  int kp[4];
  bool kin[4];
  float gk[4][CW], gv[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    kin[a] = key < p.Sk;
    kp[a] = kin[a] ? p.k_pos[key] : 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) gk[a][c] = gv[a][c] = 0.f;
  }

  for (int r = 0; r < p.n_rep; ++r) {
    const int h = hk * p.n_rep + r;
    const long long bh = static_cast<long long>(b) * p.H + h;
    for (int qt = 0; qt < p.n_qt; ++qt) {
      const int q0 = qt * BQ;
      int qlo, qhi;
      tile_range(p.q_pos, p.Sq, q0, qlo, qhi);
      if (!tiles_meet(qlo, qhi, klo, khi, p)) continue;
      __syncthreads();                // K, V have landed; the last tile is read
      const long long qoff = (static_cast<long long>(b) * p.Sq + q0) * qrow +
                             static_cast<long long>(h) * p.D;
      load_tile<DP>(qS, q + qoff, qrow, p.Sq - q0, p.D);
      load_tile<DP>(oS, dout + qoff, qrow, p.Sq - q0, p.D);
      if (tid < BQ) {
        const bool in = q0 + tid < p.Sq;
        lseS[tid] = in ? lse[bh * p.Sq + q0 + tid] : pos_inf();
        dS[tid] = in ? delta[bh * p.Sq + q0 + tid] : 0.f;
      }
      int qp[4];
      bool qin[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + tx + 16 * i;
        qin[i] = row < p.Sq;
        qp[i] = qin[i] ? p.q_pos[row] : 0;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[a][i] = dp[a][i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float x[4], w[4], y[4], o[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          x[a] = kS[(ty + 16 * a) * LD + c];
          w[a] = vS[(ty + 16 * a) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          y[i] = qS[(tx + 16 * i) * LD + c];
          o[i] = oS[(tx + 16 * i) * LD + c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[a][i] = fmaf(x[a], y[i], s[a][i]);
            dp[a][i] = fmaf(w[a], o[i], dp[a][i]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = tx + 16 * i;
          float chain;
          const float x = score2(s[a][i], p, chain);
          const bool ok = kin[a] && qin[i] && visible(qp[i], kp[a], p);
          const float pr = ok ? exp2f(x - lseS[col]) : 0.f;
          pT[(ty + 16 * a) * PS + col] = pr;
          dsT[(ty + 16 * a) * PS + col] = pr * (dp[a][i] - dS[col]) * chain;
        }
      __syncwarp();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pr[4], ds[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pr[a] = pT[(ty + 16 * a) * PS + i];
          ds[a] = dsT[(ty + 16 * a) * PS + i];
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float o = oS[i * LD + tx + 16 * c];
          const float y = qS[i * LD + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            gv[a][c] = fmaf(pr[a], o, gv[a][c]);
            gk[a][c] = fmaf(ds[a], y, gk[a][c]);
          }
        }
      }
    }
  }

  // rows that see no key: P = 1 / Sk over every key, so dV_j gains the sum
  // of their dO over the group's heads, over Sk; one thread per column
  if (tid < DP) {
    float sum = 0.f;
    if (tid < p.D) {
      for (int r = 0; r < p.n_rep; ++r) {
        const int h = hk * p.n_rep + r;
        const long long bh = static_cast<long long>(b) * p.H + h;
        for (int qt = 0; qt < p.n_qt; ++qt) {
          if (nokey[bh * p.n_qt + qt] == 0) continue;
          const int end = min(p.Sq, (qt + 1) * BQ);
          for (int row = qt * BQ; row < end; ++row)
            if (lse[bh * p.Sq + row] == pos_inf())
              sum += dout[(static_cast<long long>(b) * p.Sq + row) * qrow +
                          static_cast<long long>(h) * p.D + tid];
        }
      }
    }
    mean[tid] = sum / static_cast<float>(p.Sk);
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!kin[a]) continue;
    const long long at = koff + static_cast<long long>(ty + 16 * a) * krow;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) {
        dk[at + col] = gk[a][c] * p.scale;
        dv[at + col] = gv[a][c] + mean[col];
      }
    }
  }
}

template <int DP>
constexpr size_t prep_smem() { return sizeof(float) * (3 * BQ * (DP + 1) + BQ * PS); }
template <int DP>
constexpr size_t dq_smem() { return sizeof(float) * (4 * BQ * (DP + 1) + BQ * PS); }
template <int DP>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * BQ * (DP + 1) + 2 * BK * PS + 2 * BQ + DP);
}

template <int DP>
cudaError_t launch_all(const float* q, const float* k, const float* v, const float* dout,
                       float* dq, float* dk, float* dv, float* lse, float* delta,
                       int* nokey, const Params& p, int B, cudaStream_t st) {
  cudaError_t err;
  err = cudaFuncSetAttribute(flash_attention_bwd_prep_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(prep_smem<DP>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem<DP>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem<DP>()));
  if (err != cudaSuccess) return err;
  const unsigned q_blocks = static_cast<unsigned>(p.n_qt) * B * p.H;
  const unsigned k_blocks = static_cast<unsigned>(p.n_kt) * B * p.Hkv;
  flash_attention_bwd_prep_kernel<DP><<<q_blocks, NT, prep_smem<DP>(), st>>>(
      q, k, v, dout, lse, delta, nokey, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<DP><<<k_blocks, NT, dkdv_smem<DP>(), st>>>(
      q, k, v, dout, lse, delta, nokey, dk, dv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<DP><<<q_blocks, NT, dq_smem<DP>(), st>>>(
      q, k, v, dout, lse, delta, dq, p);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* q, const float* k, const float* v, const float* dout,
                     float* dq, float* dk, float* dv, float* lse, float* delta, int* nokey,
                     const Params& p, int B, cudaStream_t st) {
  if (p.D <= 64)
    return launch_all<64>(q, k, v, dout, dq, dk, dv, lse, delta, nokey, p, B, st);
  return launch_all<128>(q, k, v, dout, dq, dk, dv, lse, delta, nokey, p, B, st);
}

}  // namespace

// Gradients of flash_attention's float32 route.  q, dout, dq (B, Sq, H, D)
// and k, v, dk, dv (B, Sk, Hkv, D), all contiguous float32; q_pos (Sq,) and
// k_pos (Sk,) int32; scratch lse and delta (B, H, Sq) float32 and nokey
// (B, H, ceil(Sq / 64)) int32, all written.  window <= 0 means none,
// softcap <= 0 none.  D <= 128; 0 < Sk.  Enqueues three grids.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, void* lse, void* delta, void* nokey, const void* q_pos, const void* k_pos,
    int B, int H, int Hkv, int Sq, int Sk, int D, int causal, int window, float scale,
    float softcap, void* stream) {
  const Params p{static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), H, Hkv,
                 H / Hkv, Sq, Sk, D, (Sq + BQ - 1) / BQ, (Sk + BK - 1) / BK, causal, window,
                 scale, softcap};
  return static_cast<int>(dispatch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(lse), static_cast<float*>(delta), static_cast<int*>(nokey), p, B,
      static_cast<cudaStream_t>(stream)));
}

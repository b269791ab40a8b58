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

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 128;               // query rows per block: two warpgroups of 64
constexpr int BK = 128;               // keys per tile
constexpr int STAGES = 2;             // K/V tiles in flight
constexpr int THREADS = 384;          // two consumer warpgroups, one producer
constexpr int BOX = 64;               // columns of D per TMA box: 128 bytes
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

// -- PTX --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of the given parity has completed.  A wait of more
// than 20 s can only be a fault of the pipeline: it traps, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 20000000000ull) __trap();
  }
}

// One TMA box of a (D, H, S, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
         "r"(s0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register accesses across a wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The wgmma products.  Accumulator register i of a thread holds row
// 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 c + (i & 1), for
// warp w of the warpgroup, g = lane / 4 and c = lane % 4.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n120(float (&d)[60], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int NV>
__device__ __forceinline__ void wgmma_pv(float (&o)[NV / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (NV == 64) {
    wgmma_rs_n64(o, a, desc_v);
  } else if constexpr (NV == 120) {
    wgmma_rs_n120(o, a, desc_v);
  } else {
    wgmma_rs_n128(o, a, desc_v);
  }
}

// Named barrier ``id`` of the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
// The same, returning whether ``x`` held in any of the 256 threads.
__device__ __forceinline__ bool named_sync_or(int id, bool x) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 256, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(any) : "r"(static_cast<uint32_t>(x)), "r"(id) : "memory");
  return any != 0;
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

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
    wgmma_ss_n128(s, sw128_desc(q + half * Q_HALF + col, 16, 1024),
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
};

// What a query tile with positions in [qlo, qhi] does with a key tile with
// positions in [klo, khi]: 0 no pair can be visible, 2 every pair is
// visible and the tile lies inside Sk (``inside``), else 1.  The CPU copy
// is flash_attention.py tile_plan.
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
    wgmma_pv<NV>(o, p_hi[kk], dv);
    wgmma_pv<NV>(o, p_lo[kk], dv);
  }
  wgmma_commit();
}

template <int HALVES, int NV>
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
      if (wg == 1) named_arrive(1);
      mbar_wait(q_full, 0);
      named_sync(1 + wg);
      mbar_wait(k_full, 0);
      qk_issue<HALVES>(s, q_wg, k_s);
      named_arrive(2 - wg);
      wgmma_wait_all();
      reg_fence(s);
      for (int i = 0; i < n_vis; ++i) {
        int next = kt + 1;
        while (next < p.n_kt && plan[next] == 0) ++next;
        softmax_tile<NV>(s, o, p_hi, p_lo, m, l, p, kt, plan[kt], c, qp, cap);
        // -- this warpgroup's turn: O += P_hi V + P_lo V, then S = Q K^T of
        //    the next tile ----------------------------------------------------
        named_sync(1 + wg);
        mbar_wait(v_full + 8 * stage, phase);
        pv_issue<HALVES, NV>(o, p_hi, p_lo, v_s + stage * HALVES * L::KV_HALF);
        wgmma_wait_all();
        reg_fence(o);
        mbar_arrive(empty + 8 * stage);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
        if (i + 1 == n_vis) break;
        mbar_wait(k_full + 8 * stage, phase);
        qk_issue<HALVES>(s, q_wg, k_s + stage * HALVES * L::KV_HALF);
        named_arrive(2 - wg);
        wgmma_wait_all();
        reg_fence(s);
        kt = next;
      }
      if (wg == 0) named_arrive(2);      // warpgroup 1 takes the last turn
    } else {
      mbar_wait(q_full, 0);              // no bulk copy in flight at exit
    }
    float l0 = l[0], l1 = l[1];

    // -- a row that sees no key: the mean of V over the Sk keys, one column
    //    per consumer thread, in 8 running sums --------------------------
    const bool none0 = r0 < p.Sq && m[0] == NEG_INF;
    const bool none1 = r1 < p.Sq && m[1] == NEG_INF;
    if (named_sync_or(3, none0 || none1)) {
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
      named_sync(3);
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
  }
}

// -- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Tensor map of a (B, S, heads, Dp) bf16 tensor with the given element
// strides of (B, S, heads), as dimensions (Dp, heads, S, B); boxes of 64
// columns x 1 head x ``rows`` rows, 128-byte swizzle, zeros out of bounds.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int Dp,
                     long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * ss),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {BOX, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              const_cast<void*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HALVES, int NV>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const Params& p, int n_qt, int bh, cudaStream_t stream) {
  const int smem = Smem<HALVES>::bytes(p.n_kt);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel<HALVES, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_attention_sm90_kernel<HALVES, NV><<<dim3(n_qt, bh), THREADS, smem, stream>>>(
      qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, Dp), k and v (B, Sk, Hkv, Dp) bf16, read by TMA through the
// given element strides of (B, S, heads): the base addresses 16-byte
// aligned, the strides multiples of 8 elements, Dp a multiple of 8 and
// columns D..Dp-1 zero (the wrapper copies an input that breaks this).
// out (B, Sq, H, D) bf16 contiguous; q_pos (Sq,) and k_pos (Sk,) int32.
// window <= 0 means none, softcap <= 0 none.  D <= 128; B * H <= 65535;
// Sk <= 2**23 (the plan, one byte per key tile, lives in shared memory).
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, const void* q_pos,
    const void* k_pos, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int H, int Hkv, int Sq, int Sk, int D, int Dp, int causal,
    int window, float scale, float softcap, void* stream) {
  if (D < 1 || D > 128 || Dp < D || Dp % 8 != 0 || H % Hkv != 0 || Sk < 1 ||
      Sk > (1 << 23))
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

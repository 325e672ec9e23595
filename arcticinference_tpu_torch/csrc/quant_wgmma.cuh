// Weight-only quantized matmul for Hopper (sm_90a) on wgmma: the tile
// pipeline of fp8_matmul.cu (e4m3 / int8 weights, kernel 5) and
// int4_matmul.cu (split-half packed int4 weights, kernel 6).
//
//   out[M, N] = (x[M, K] bf16 @ bf16(w)[K, N]) * scale     fp32 sums
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at 16-256
// rows the weight bytes against 3.35 TB/s, and at decode the conversion
// of every weight byte to bf16 on the way (the SMs that stream a small
// weight must also convert it); at a 2048-row prefill the products
// against the bf16 tensor cores' 989 TFLOP/s.
//
// Products ("swap AB").  The kernel computes out^T = w^T x^T: the weight
// columns are wgmma's M and the x rows its N (BM = 16, 32, 64 or 128
// rows per CTA, so a 16-row decode multiplies no padding).  A consumer
// warpgroup owns 128 weight columns as two m64 products.  The weight is
// the register operand A: a thread reads four 32-bit words of its four
// columns 4g..4g+3 (rows 2c, 2c+1, 2c+8, 2c+9 of a 16-row step) and
// converts byte pairs to bf16x2, each weight element once per CTA (int4
// folds its group scale in, bf16(q * s)); product t takes columns
// 4g + 2t (A row g) and 4g + 2t + 1 (A row g + 8).  x is operand B, read
// by wgmma from shared memory through a 128-byte-swizzle descriptor.  A
// warpgroup converts its next batch of fragments while the products of
// the current one run (two register sets, wgmma.wait_group 1).
//
// Pipeline.  One producer thread keeps kStages stages in flight with TMA
// (the weight tile [64 rows, 128 columns] per warpgroup and the x tile
// [BM, 64], both 128-byte swizzled; int4 also the x tile of the high
// half and two rows of group scales by bulk copy), each completing on a
// "full" mbarrier; consumer warps release a stage on an "empty"
// mbarrier once their products have read it.  No block-wide barrier
// paces the main loop.  The CTA shapes (launch_plan picks one):
//   - one consumer warpgroup, two CTAs per SM (BM <= 64): the wide
//     decode weights (w_gateup, the LM head);
//   - two warpgroups side by side on 256 columns sharing the x tile
//     (BM = 128): prefill and wide verify steps;
//   - two warpgroups along K, taking alternate stages of the CTA's range,
//     their sums added (stages 0, 2, ..) + (stages 1, 3, ..): the narrow
//     weights (wqkv, wo, w_down), whose few column tiles would leave one
//     converting warpgroup per SM.
//
// Split K, on chip.  A narrow grid also splits K over the `splits` CTAs
// of one thread-block cluster (cluster dims (1, 1, splits), at most 3:
// 4-CTA clusters of one-CTA-per-SM blocks fit only ~120 of an H100's
// 132 SMs at once, and the rest ran in a second wave).  After a cluster barrier (every ring drained), each
// rank stores its partial rows into the shared memory of the rank that
// owns them (ceil(BM / splits) rows each) through distributed shared
// memory; after a second barrier each rank sums its rows' partials in
// rank order 0, 1, .., scales and stores them.  No workspace, no second
// launch, no atomics: a row's sums depend only on the plan, never on the
// data or on the row's index.  Without a split the CTA stores straight
// from registers; the scales are loaded before the main loop.
//
// The wrappers (ops/cuda/{fp8,int4}_matmul.py) check shapes, types,
// contiguity and 16-byte alignment and choose the plan; the C entry
// points re-check what a launch needs and return a CUDA error code.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {
namespace {

// How the fp32 sums are scaled: not (int4 folds its scale into the
// weight), by one scalar, or by one scale per output column.
enum ScaleMode { kScaleNone = 0, kScaleScalar = 1, kScaleColumn = 2 };

// Two floats -> bf16x2 (round to nearest even); lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- weight formats: a weight byte (pair) to bf16 ------------------------
//
// Exact (int4's bf16(q * s) rounds once, in the caller, as the reference
// dequantization does) and mostly on the ALUs: the card's conversion unit
// issues a quarter as many instructions per clock, and at decode, with
// two or three of its instructions per weight pair (cvt, i2f, f2f), it
// bounded the weight stream (int8 w_gateup [4096, 28672] at 64 rows:
// 67.7 -> 57.7 us on an NVIDIA H100 80GB HBM3 at 700 W, outputs bit for
// bit the same).

// bf16x2 from the upper halves of two floats whose low 16 bits are zero
// (every e4m3 and int8 value, and q for int4, is exact in bf16).
__device__ __forceinline__ uint32_t upper_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// e4m3: one conversion-unit instruction per pair (e4m3x2 -> f16x2), the
// widening to float on the half-precision ALU, bf16 by truncation.  An
// e4m3 NaN stays NaN (the card's cvt gives f16's canonical NaN).
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t lo, uint32_t hi,
                                              int j) {
  const uint16_t two =
      static_cast<uint16_t>(__byte_perm(lo, hi, j | ((j + 4) << 4)));
  const float2 f =
      __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
  return upper_halves(f.x, f.y);
}

// Signed byte / nibble v as a float without the conversion unit:
// 1.5 * 2^23 + v has v in its low mantissa bits.
__device__ __forceinline__ float small_int_to_float(int32_t v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// Byte j of w, sign-extended (prmt's sign-replicate selector).
__device__ __forceinline__ int32_t signed_byte(uint32_t w, int j) {
  int32_t r;
  const uint32_t sel = j | ((j | 8) << 4) | ((j | 8) << 8) | ((j | 8) << 12);
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(w), "r"(0), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi,
                                              int j) {
  return upper_halves(small_int_to_float(signed_byte(lo, j)),
                      small_int_to_float(signed_byte(hi, j)));
}

// Sign-extended low / high nibble of byte j of a split-half packed int4
// word (the low nibble holds K row u, the high one K row u + K/2), as
// floats.
__device__ __forceinline__ float lo_nibble(uint32_t w, int j) {
  return small_int_to_float(static_cast<int32_t>(w << (28 - 8 * j)) >> 28);
}
__device__ __forceinline__ float hi_nibble(uint32_t w, int j) {
  return small_int_to_float(static_cast<int32_t>(w << (24 - 8 * j)) >> 28);
}

// ---- tiles and plans --------------------------------------------------------

constexpr int kWK = 64;          // weight rows per stage (packed for int4)
constexpr int kWGCols = 128;     // weight columns per consumer warpgroup
constexpr int kWTileBytes = kWK * kWGCols;  // one warpgroup's weight tile
constexpr int kMaxSplits = 3;    // CTAs of a split-K cluster (launch_plan)
constexpr int kGroup = 128;      // int4 scale group along K

struct E4M3 {
  static constexpr bool kPacked = false;
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    return e4m3_pair(lo, hi, j);
  }
};

struct Int8 {
  static constexpr bool kPacked = false;
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    return int8_pair(lo, hi, j);
  }
};

// Split-half packed int4: packed row u holds K row u (low nibble) and
// K row u + K/2 (high nibble).  A stage of kWK packed rows multiplies
// x columns [t*kWK, +kWK) with the low nibbles and [K/2 + t*kWK, +kWK)
// with the high ones; each range lies inside one scale group.
struct Int4 {
  static constexpr bool kPacked = true;
};

struct WArgs {
  const float* scale;  // scalar, [N] or [K/128, N]
  void* out;           // [M, N] bf16 or float32
  int m, n, k;
  int k_tiles;         // kWK-row weight stages along K
  int tiles_per_split;
  int scale_mode;
  int out_f32;
};

// A CTA: WGS consumer warpgroups side by side along N (128 weight
// columns each) or KW of them along K (warpgroup w takes the CTA's
// stages w, w + KW, ...), and one producer warpgroup.
template <class P, int BM, int WGS, int KW>
struct Shape {
  static_assert(WGS * KW <= 2, "two consumer warpgroups at most");
  static constexpr int kBN = WGS * kWGCols;
  static constexpr int kConsumers = WGS * KW * 128;
  static constexpr int kThreads = kConsumers + 128;
  // Two one-warpgroup CTAs share an SM up to 64 rows.
  static constexpr int kCtasPerSm = BM <= 64 && WGS * KW == 1 ? 2 : 1;
  static constexpr int kWBytes = WGS * kWTileBytes;
  static constexpr int kXBytes = (P::kPacked ? 2 : 1) * BM * 128;
  static constexpr int kSBytes = P::kPacked ? 2 * kBN * 4 : 0;
  static constexpr int kTxBytes = kWBytes + kXBytes + kSBytes;
  static constexpr int kStageBytes = (kTxBytes + 1023) / 1024 * 1024;
  static constexpr int kBudget = (kCtasPerSm == 2 ? 100 : 200) * 1024;
  static constexpr int kStages =
      kBudget / kStageBytes < 8 ? kBudget / kStageBytes : 8;
  // Split K: each rank receives every rank's partial of its rows, one
  // [ceil(BM / splits), kBN] slice per rank (row stride padded by 16
  // bytes), in the ring once the main loops are done.
  // K warpgroup 1 hands its sums to warpgroup 0 the same way.
  static constexpr int kRedStride = kBN + 4;
  static constexpr int kRedBytes = (BM + kMaxSplits) * kRedStride * 4;
  static constexpr int kRingBytes = kStages * kStageBytes > kRedBytes
                                        ? kStages * kStageBytes
                                        : kRedBytes;
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  // Registers per consumer thread after setmaxnreg (the producer keeps
  // 40); 0: the launch bound leaves enough.  setmaxnreg.inc waits for the
  // registers the producer released, so the counts must fit the
  // registers the CTA launched with, or the kernel hangs.
  static constexpr int kConsumerRegs =
      WGS * KW == 2 ? 232 : (kCtasPerSm == 2 ? 216 : 0);
  static constexpr int kLaunchRegs =
      65536 / (kThreads * kCtasPerSm) / 8 * 8 < 255
          ? 65536 / (kThreads * kCtasPerSm) / 8 * 8
          : 255;
  static_assert(kConsumerRegs == 0 ||
                    128 * 40 + kConsumers * kConsumerRegs <=
                        kThreads * kLaunchRegs,
                "setmaxnreg asks for more registers than the CTA has");
  static_assert(kStages >= 2, "shared memory for two stages");
  static_assert(kSmemBytes <= 232448, "shared memory per block");
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA tile (c0 along the contiguous dimension) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Contiguous bytes into shared memory (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// 16 bytes to shared address `addr` of cluster rank `rank`.
__device__ __forceinline__ void st_cluster(uint32_t addr, int rank,
                                           float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma descriptor of a K-major bf16 tile of 128-byte rows (64 k values)
// in 128-byte swizzle: 8-row atoms of 1024 bytes.  Adding 2 moves it 16
// k values (32 bytes) along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Word of bytes [bcol, bcol + 4) of row `row` of a [64, 128] byte tile
// in 128-byte swizzle (16-byte chunk j of row r sits at chunk j ^ r % 8).
__device__ __forceinline__ uint32_t lds_word(const uint8_t* tile, int row,
                                             int bcol) {
  return *reinterpret_cast<const uint32_t*>(
      tile + row * 128 + ((((bcol >> 4) ^ (row & 7)) << 4) | (bcol & 15)));
}

// wgmma.m64nNk16 with A (4 bf16x2 registers per thread) from registers,
// B from shared memory, fp32 accumulators d (N / 2 per thread).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 }, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 }, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 }, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 }, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// ---- the kernel -------------------------------------------------------------

// A stage's products come in batches of kSteps 16-row steps (two for
// e4m3 / int8, one for int4: 16 fragment registers either way); the
// consumer converts batch j + 1 while batch j's products run.
template <class P>
struct Batch {
  static constexpr int kSteps = P::kPacked ? 1 : 2;
  static constexpr int kPerStage = kWK / 16 / kSteps;  // even
  static constexpr int kFrags = P::kPacked ? 4 : 2;    // products per step
  using Regs = uint32_t[kSteps][kFrags][4];
};

// Weight fragments of batch b of a stage for one thread: wt is its
// warpgroup's weight tile, sl / sh its four columns' group scales of the
// low and high halves (int4).  Product t takes the thread's columns
// bcol + 2t (A row g) and bcol + 2t + 1 (A row g + 8); int4's products
// 2 + t take the high nibbles.
template <class P>
__device__ __forceinline__ void convert_batch(const uint8_t* wt, int b,
                                              const float (&sl)[4],
                                              const float (&sh)[4],
                                              typename Batch<P>::Regs& f,
                                              int bcol, int c) {
#pragma unroll
  for (int q = 0; q < Batch<P>::kSteps; ++q) {
    const int r = (b * Batch<P>::kSteps + q) * 16 + 2 * c;
    const uint32_t w0 = lds_word(wt, r, bcol);
    const uint32_t w1 = lds_word(wt, r + 1, bcol);
    const uint32_t w2 = lds_word(wt, r + 8, bcol);
    const uint32_t w3 = lds_word(wt, r + 9, bcol);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * t + h;  // A row g + 8h: column bcol + j
        if constexpr (P::kPacked) {
          // bf16(q * s), as the reference dequantizes before its product.
          f[q][t][h] = pack_bf16x2(lo_nibble(w0, j) * sl[j],
                                   lo_nibble(w1, j) * sl[j]);
          f[q][t][2 + h] = pack_bf16x2(lo_nibble(w2, j) * sl[j],
                                       lo_nibble(w3, j) * sl[j]);
          f[q][2 + t][h] = pack_bf16x2(hi_nibble(w0, j) * sh[j],
                                       hi_nibble(w1, j) * sh[j]);
          f[q][2 + t][2 + h] = pack_bf16x2(hi_nibble(w2, j) * sh[j],
                                           hi_nibble(w3, j) * sh[j]);
        } else {
          f[q][t][h] = P::pair(w0, w1, j);
          f[q][t][2 + h] = P::pair(w2, w3, j);
        }
      }
    }
  }
}

// Issue and commit batch b's products against the stage's x tile(s)
// (descriptors dlo, dhi: the low and high halves for int4).
template <class P, int BM>
__device__ __forceinline__ void issue_batch(float (&acc)[2][BM / 2],
                                            typename Batch<P>::Regs& f,
                                            int b, uint64_t dlo,
                                            uint64_t dhi) {
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < Batch<P>::kSteps; ++q) {
    const int step = b * Batch<P>::kSteps + q;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      Wgmma<BM>::mma(acc[t], f[q][t], dlo + 2 * step);
      if constexpr (P::kPacked)
        Wgmma<BM>::mma(acc[t], f[q][2 + t], dhi + 2 * step);
    }
  }
  wgmma_commit();
}

// The four group scales of the thread's columns in both halves (int4).
template <class P>
__device__ __forceinline__ void stage_scales(const float* ss, int bcol,
                                             float (&sl)[4], float (&sh)[4],
                                             int bn) {
  if constexpr (P::kPacked) {
    const float4 lo = *reinterpret_cast<const float4*>(ss + bcol);
    const float4 hi = *reinterpret_cast<const float4*>(ss + bn + bcol);
    sl[0] = lo.x; sl[1] = lo.y; sl[2] = lo.z; sl[3] = lo.w;
    sh[0] = hi.x; sh[1] = hi.y; sh[2] = hi.z; sh[3] = hi.w;
  }
}

template <class P, int BM, int WGS, int KW>
__device__ __forceinline__ void produce(const CUtensorMap* tm_x,
                                        const CUtensorMap* tm_w,
                                        const WArgs& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int t0, int nt, int m0, int n0) {
  using S = Shape<P, BM, WGS, KW>;
  int s = 0, phase = 0;
  for (int it = 0; it < nt; ++it) {
    mbar_wait(&empty[s], phase ^ 1);
    uint8_t* st = ring + s * S::kStageBytes;
    mbar_expect_tx(&full[s], S::kTxBytes);
    const int t = t0 + it;
#pragma unroll
    for (int w = 0; w < WGS; ++w)
      tma_load(st + w * kWTileBytes, tm_w, n0 + w * kWGCols, t * kWK,
               &full[s]);
    tma_load(st + S::kWBytes, tm_x, t * kWK, m0, &full[s]);
    if constexpr (P::kPacked) {
      tma_load(st + S::kWBytes + BM * 128, tm_x, a.k / 2 + t * kWK, m0,
               &full[s]);
      float* ss = reinterpret_cast<float*>(st + S::kWBytes + S::kXBytes);
      const int glo = t * kWK / kGroup, ghi = (a.k / 2 + t * kWK) / kGroup;
      bulk_load(ss, a.scale + static_cast<size_t>(glo) * a.n + n0,
                S::kBN * 4, &full[s]);
      bulk_load(ss + S::kBN, a.scale + static_cast<size_t>(ghi) * a.n + n0,
                S::kBN * 4, &full[s]);
    }
    if (++s == S::kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// Scale and store 8 consecutive columns of one output row.
__device__ __forceinline__ void store8(const WArgs& a, int row, int col,
                                       float4 v0, float4 v1, float4 f0,
                                       float4 f1) {
  v0.x *= f0.x; v0.y *= f0.y; v0.z *= f0.z; v0.w *= f0.w;
  v1.x *= f1.x; v1.y *= f1.y; v1.z *= f1.z; v1.w *= f1.w;
  const size_t off = static_cast<size_t>(row) * a.n + col;
  if (a.out_f32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out) + off);
    o[0] = v0;
    o[1] = v1;
  } else {
    *reinterpret_cast<uint4*>(static_cast<uint16_t*>(a.out) + off) =
        make_uint4(pack_bf16x2(v0.x, v0.y), pack_bf16x2(v0.z, v0.w),
                   pack_bf16x2(v1.x, v1.y), pack_bf16x2(v1.z, v1.w));
  }
}

// The scales of 4 columns from `col` (all 1 without a scale): loaded
// before the main loop, so the epilogue does not wait for them.
__device__ __forceinline__ float4 scales4(const WArgs& a, int col) {
  if (a.scale_mode == kScaleScalar) {
    const float f = a.scale[0];
    return make_float4(f, f, f, f);
  }
  if (a.scale_mode == kScaleColumn)
    return *reinterpret_cast<const float4*>(a.scale + col);
  return make_float4(1.f, 1.f, 1.f, 1.f);
}

// The output tile without a split: the thread's sums (x rows 8i + 2c + e,
// columns col .. col + 3, scales f) scaled and stored, float32 as 16
// bytes; bf16 rows pair up across lanes g and g ^ 1 (lane ^ 4) into 8
// columns: even g stores row e = 0, odd g row e = 1.
template <int BM>
__device__ __forceinline__ void store_direct(const WArgs& a,
                                             const float (&acc)[2][BM / 2],
                                             float4 f, int m0, int col,
                                             int c, int g) {
  const bool odd = g & 1;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    float4 v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[e] = make_float4(acc[0][4 * i + e] * f.x, acc[0][4 * i + 2 + e] * f.y,
                         acc[1][4 * i + e] * f.z,
                         acc[1][4 * i + 2 + e] * f.w);
    const int row = m0 + 8 * i + 2 * c;
    if (a.out_f32) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (row + e < a.m)
          *reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                     static_cast<size_t>(row + e) * a.n +
                                     col) = v[e];
    } else {
      const uint2 p0 = make_uint2(pack_bf16x2(v[0].x, v[0].y),
                                  pack_bf16x2(v[0].z, v[0].w));
      const uint2 p1 = make_uint2(pack_bf16x2(v[1].x, v[1].y),
                                  pack_bf16x2(v[1].z, v[1].w));
      const uint2 send = odd ? p0 : p1;
      const uint2 got = make_uint2(__shfl_xor_sync(0xffffffffu, send.x, 4),
                                   __shfl_xor_sync(0xffffffffu, send.y, 4));
      const int r = row + (odd ? 1 : 0);
      const uint4 o = odd ? make_uint4(got.x, got.y, p1.x, p1.y)
                          : make_uint4(p0.x, p0.y, got.x, got.y);
      if (r < a.m)
        *reinterpret_cast<uint4*>(static_cast<uint16_t*>(a.out) +
                                  static_cast<size_t>(r) * a.n + col -
                                  (odd ? 4 : 0)) = o;
    }
  }
}

// Split K, step 1: the thread's partial sums (x rows 8i + 2c + e, tile
// columns col .. col + 3) go to the rank that owns each row (ceil(BM /
// splits) rows per rank), into that rank's slice `rank` of red.
template <int BM, int kRedStride>
__device__ __forceinline__ void push_partial(const float (&acc)[2][BM / 2],
                                             const float* red, int rank,
                                             int splits, int col, int c) {
  const int per = (BM + splits - 1) / splits;
  const uint32_t base = smem_addr(red);
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * i + 2 * c + e, owner = row / per;
      const int slot = rank * per + row - owner * per;
      st_cluster(base + (slot * kRedStride + col) * 4, owner,
                 make_float4(acc[0][4 * i + e], acc[0][4 * i + 2 + e],
                             acc[1][4 * i + e], acc[1][4 * i + 2 + e]));
    }
}

// Split K, step 2: rank `rank` sums its rows' slices in rank order 0, 1,
// ..., scales and stores them, 8 columns per item; a consumer thread's
// items share one group of 8 columns (tile column cg8, scales f0, f1).
template <int BM, int WGS, int kConsumers, int kRedStride>
__device__ __forceinline__ void reduce_store(const WArgs& a,
                                             const float* red, int rank,
                                             int splits, int m0, int n0,
                                             int ct, float4 f0, float4 f1) {
  constexpr int kGroups = WGS * kWGCols / 8;
  static_assert(kConsumers % kGroups == 0, "one column group per thread");
  const int per = (BM + splits - 1) / splits;
  const int rows = min(per, min(BM, a.m - m0) - rank * per);
  const int cg8 = (ct % kGroups) * 8;
  for (int r = ct / kGroups; r < rows; r += kConsumers / kGroups) {
    const float* src = red + r * kRedStride + cg8;
    float4 v0 = *reinterpret_cast<const float4*>(src);
    float4 v1 = *reinterpret_cast<const float4*>(src + 4);
    for (int q = 1; q < splits; ++q) {
      const float* p = src + q * per * kRedStride;
      const float4 p0 = *reinterpret_cast<const float4*>(p);
      const float4 p1 = *reinterpret_cast<const float4*>(p + 4);
      v0.x += p0.x; v0.y += p0.y; v0.z += p0.z; v0.w += p0.w;
      v1.x += p1.x; v1.y += p1.y; v1.z += p1.z; v1.w += p1.w;
    }
    store8(a, m0 + rank * per + r, n0 + cg8, v0, v1, f0, f1);
  }
}

template <class P, int BM, int WGS, int KW>
__global__ void __launch_bounds__(Shape<P, BM, WGS, KW>::kThreads,
                                  Shape<P, BM, WGS, KW>::kCtasPerSm)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const WArgs a) {
  using S = Shape<P, BM, WGS, KW>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kRingBytes);
  uint64_t* empty = full + S::kStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * S::kBN, m0 = blockIdx.y * BM;
  // The cluster is (1, 1, splits): cluster rank = split = blockIdx.z.
  const int rank = blockIdx.z, splits = gridDim.z;
  const int t0 = rank * a.tiles_per_split;
  const int nt = min(a.tiles_per_split, a.k_tiles - t0);
  constexpr int kProducer = S::kConsumers;  // the producer thread
  if (tid == kProducer) {  // it fetches the TMA maps first
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_x) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_w) : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // each consumer warp of the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kProducer) {  // producer warpgroup: one thread copies
    if constexpr (S::kConsumerRegs > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kProducer)
      produce<P, BM, WGS, KW>(&tm_x, &tm_w, a, ring, full, empty, t0, nt,
                              m0, n0);
    __syncwarp();
    if (splits > 1) {
      cluster_sync();  // every rank is done with its ring
      cluster_sync();  // every partial has arrived
    }
    return;
  }
  if constexpr (S::kConsumerRegs > 0)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        S::kConsumerRegs));
  using B = Batch<P>;
  const int cw = wg % WGS, kw = wg / WGS;  // column group, K group
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bcol = warp * 32 + 4 * g;  // the thread's 4 weight columns
  const int col = cw * kWGCols + bcol;  // ... within the CTA's columns
  // The scales the epilogue applies, loaded now: the direct store's
  // columns col .., reduce_store's cg8 ...
  const int cg8 = (tid % (S::kBN / 8)) * 8;
  const float4 f_direct = scales4(a, n0 + (splits == 1 ? col : cg8));
  const float4 f_hi = splits == 1 ? f_direct : scales4(a, n0 + cg8 + 4);
  float acc[2][BM / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[t][i] = 0.f;
  // Two fragment register sets: batch j converts into set j % 2 while
  // batch j - 1's products run from the other.
  typename B::Regs f[2];
  float sl[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
  const auto wtile = [&](int stage) {
    return ring + stage * S::kStageBytes + cw * kWTileBytes;
  };
  const auto scales = [&](int stage) {
    return reinterpret_cast<const float*>(ring + stage * S::kStageBytes +
                                          S::kWBytes + S::kXBytes) +
           cw * kWGCols;
  };
  // This warpgroup's stages: it = kw, kw + KW, ... in ring slot s.
  int s = kw, phase = 0, prev = kw;
  if (kw < nt) {
    mbar_wait(&full[s], 0);
    stage_scales<P>(scales(s), bcol, sl, sh, S::kBN);
    convert_batch<P>(wtile(s), 0, sl, sh, f[0], bcol, c);
  }
  for (int it = kw; it < nt; it += KW) {
    const uint8_t* xs = ring + s * S::kStageBytes + S::kWBytes;
    const uint64_t dlo = sw128_desc(xs), dhi = sw128_desc(xs + BM * 128);
    int ns = s + KW, nphase = phase;
    if (ns >= S::kStages) {
      ns -= S::kStages;
      nphase ^= 1;
    }
#pragma unroll
    for (int b = 0; b < B::kPerStage; ++b) {
      issue_batch<P, BM>(acc, f[b & 1], b, dlo, dhi);
      wgmma_wait<1>();  // batch j - 1 is done: its registers are free
      if (b == 0 && it > kw) {  // ... and with it the previous stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      if (b + 1 < B::kPerStage) {
        convert_batch<P>(wtile(s), b + 1, sl, sh, f[(b + 1) & 1], bcol, c);
      } else if (it + KW < nt) {
        mbar_wait(&full[ns], nphase);
        stage_scales<P>(scales(ns), bcol, sl, sh, S::kBN);
        convert_batch<P>(wtile(ns), 0, sl, sh, f[0], bcol, c);
      }
    }
    prev = s;
    s = ns;
    phase = nphase;
  }
  wgmma_wait<0>();
  if (kw < nt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }

  if constexpr (KW == 2) {
    // K warpgroup 1 hands its sums to K warpgroup 0 through the (drained)
    // ring: the CTA's sums are (stages 0, 2, ..) + (stages 1, 3, ..).
    float* xch = reinterpret_cast<float*>(ring);
    asm volatile("bar.sync 1, %0;\n" ::"n"(S::kConsumers) : "memory");
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float4* p = reinterpret_cast<float4*>(
            xch + (8 * i + 2 * c + e) * S::kRedStride + col);
        if (kw == 1)
          *p = make_float4(acc[0][4 * i + e], acc[0][4 * i + 2 + e],
                           acc[1][4 * i + e], acc[1][4 * i + 2 + e]);
      }
    asm volatile("bar.sync 1, %0;\n" ::"n"(S::kConsumers) : "memory");
    if (kw == 0) {
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 o = *reinterpret_cast<const float4*>(
              xch + (8 * i + 2 * c + e) * S::kRedStride + col);
          acc[0][4 * i + e] += o.x;
          acc[0][4 * i + 2 + e] += o.y;
          acc[1][4 * i + e] += o.z;
          acc[1][4 * i + 2 + e] += o.w;
        }
    }
  }
  if (splits == 1) {
    if (kw == 0) store_direct<BM>(a, acc, f_direct, m0, n0 + col, c, g);
    return;
  }
  cluster_sync();  // every rank is done with its ring
  float* red = reinterpret_cast<float*>(ring);
  if (kw == 0) push_partial<BM, S::kRedStride>(acc, red, rank, splits, col, c);
  cluster_sync();  // every partial has arrived
  reduce_store<BM, WGS, S::kConsumers, S::kRedStride>(
      a, red, rank, splits, m0, n0, tid, f_direct, f_hi);
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the
// runtime (no link against libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// TMA map of a row-major [rows, cols] array in boxes of [box_rows,
// box_cols] (box_cols * elem_bytes == 128), 128-byte swizzle; rows past
// the end read as zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* base, int rows, int cols, int box_rows,
                int box_cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P, int BM, int WGS, int KW>
cudaError_t launch_shape(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                         const WArgs& a, int splits, cudaStream_t stream) {
  using S = Shape<P, BM, WGS, KW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_wgmma_kernel<P, BM, WGS, KW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n / S::kBN, (a.m + BM - 1) / BM, splits);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one CTA needs no cluster
  return cudaLaunchKernelEx(&cfg, qmm_wgmma_kernel<P, BM, WGS, KW>, tm_x,
                            tm_w, a);
}

// Checks what a launch needs (the wrappers have checked it already),
// encodes the two TMA maps and launches the plan's instance: (bm, wgs,
// kwgs) is one of (16 | 32 | 64 | 128, 1, 1 | 2) and (128, 2, 1).
template <class P>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   void* out, int m, int n, int k, int scale_mode,
                   int out_f32, int bm, int wgs, int kwgs, int splits,
                   cudaStream_t stream) {
  const int k_rows = P::kPacked ? k / 2 : k;
  if (m <= 0 || n <= 0 || k_rows <= 0 || k_rows % kWK ||
      (P::kPacked && k % kGroup) || (wgs != 1 && wgs != 2) ||
      n % (wgs * kWGCols) || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  WArgs a;
  a.scale = scale;
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  a.k_tiles = k_rows / kWK;
  a.tiles_per_split = (a.k_tiles + splits - 1) / splits;
  a.scale_mode = scale_mode;
  a.out_f32 = out_f32;
  if ((splits - 1) * a.tiles_per_split >= a.k_tiles)  // an empty split
    return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, bm,
                  kWK) ||
      !tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, k_rows, n, kWK,
                  kWGCols))
    return cudaErrorInvalidValue;
#define QMM_CASE(BM, WGS, KW)                                              \
  if (bm == BM && wgs == WGS && kwgs == KW)                                \
    return launch_shape<P, BM, WGS, KW>(tm_x, tm_w, a, splits, stream);
  QMM_CASE(16, 1, 1) QMM_CASE(32, 1, 1) QMM_CASE(64, 1, 1)
  QMM_CASE(128, 1, 1) QMM_CASE(16, 1, 2) QMM_CASE(32, 1, 2)
  QMM_CASE(64, 1, 2) QMM_CASE(128, 1, 2) QMM_CASE(128, 2, 1)
#undef QMM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace qmm

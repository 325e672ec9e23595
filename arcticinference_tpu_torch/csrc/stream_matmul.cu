// Decode weight-stream matmul variants for Hopper (sm_90a): kernel 8.
//
// Replaces benchmarks/stream_microbench.py make_pallas_body (the
// pallas_call at stream_microbench.py:167) with its three kernel bodies:
//
//   out[M, N] = bf16(x[M, K] bf16 @ dequant(w[K, N]))       fp32 sums, no scale
//
// The variants differ only in how a weight byte becomes a bf16 value:
//
//   0 f16 trick (_mm_kernel_f16trick, :96): e4m3 bytes; f16 bits
//     (sign << 15) | (mag << 7), times 2^8 in f32.  Exact for every
//     finite e4m3 value; the NaN codes 0x7f / 0xff become +-480.
//   1 bit trick (_mm_kernel_bittrick_i32, :131): e4m3 bytes; f32 bits
//     sign << 31 | ((mag << 20) + (120 << 23)), subnormals (mag < 8) by
//     a select as mag * 2^-9.  The NaN codes also become +-480.
//   2 astype e4m3 (_mm_kernel_astype, :115, float8_e4m3fn weights): the
//     card's cvt of e4m3 pairs to f16 pairs; NaN stays NaN.
//   3 astype int8 (the same body on int8 weights): exact in bf16.
//
// What bounds it on an H100: at M = 64 the weight bytes, one per value
// (w_gateup fused [4096, 28672]: 117 MB, 35 us at 3.35 TB/s), and the
// conversion of each byte to bf16 on the SMs that stream it.
//
// Design: the wgmma pipeline of the quantized matmuls (quant_wgmma.cuh,
// kernels 5 and 6) with no scale (kScaleNone): TMA stages fed by one
// producer thread, each weight byte converted to bf16 once per CTA in
// the registers of the warpgroup whose wgmma reads it as operand A, x
// rows as wgmma's N, and split K summed on chip within a cluster; the
// plan is kernel 5's (fp8_matmul.launch_plan).  The astype variants are
// the header's own e4m3 and int8 weight formats; the two tricks are two
// more formats here, each with its own conversion arithmetic (comparing
// conversion routes is what the microbench is for).  Every value is
// exact in bf16, so its low 16 float bits are zero and the pair packs by
// truncation.

#include "quant_wgmma.cuh"

namespace {

// e4m3 byte j of lo and of hi through the f16 shift-and-scale, both at
// once: the two bytes in the low bytes of a word's halves, f16x2 bits
// (sign << 15) | (mag << 7) by two shifts and masks, widened to float and
// times 2^8.
struct F16TrickE4M3 {
  static constexpr bool kPacked = false;
  static constexpr int kElem = 1;
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    const uint32_t x = __byte_perm(lo, hi, j | ((j + 4) << 8));
    const uint32_t h = ((x << 8) & 0x80008000u) | ((x << 7) & 0x3f803f80u);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    return qmm::upper_halves(f.x * 256.f, f.y * 256.f);
  }
};

// e4m3 byte j of w through the i32 bit surgery.
struct BitTrickE4M3 {
  static constexpr bool kPacked = false;
  static constexpr int kElem = 1;
  static __device__ __forceinline__ float value(uint32_t w, int j) {
    const uint32_t u = (w >> (8 * j)) & 0xffu;
    const uint32_t mag = u & 0x7fu;
    const float normal =
        __uint_as_float(((u & 0x80u) << 24) | ((mag << 20) + (120u << 23)));
    const float sub = (u >= 0x80u ? -1.f : 1.f) *
                      (static_cast<float>(mag) * 0.001953125f);  // 2^-9
    return mag < 8u ? sub : normal;
  }
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    return qmm::upper_halves(value(lo, j), value(hi, j));
  }
};

enum Variant { kF16Trick = 0, kBitTrick = 1, kAstypeE4M3 = 2, kAstypeInt8 = 3 };

}  // namespace

// x [m, k] bf16, w [k, n] bytes, out [m, n] bf16; (bm, wgs, kwgs, splits)
// is kernel 5's plan for (m, n, k / 64).  Returns a CUDA error code.
extern "C" int stream_matmul_launch(const void* x, const void* w, void* out,
                                    int m, int n, int k, int variant, int bm,
                                    int wgs, int kwgs, int splits,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kF16Trick:
      return static_cast<int>(qmm::launch<F16TrickE4M3>(
          x, w, nullptr, out, m, n, k, qmm::kScaleNone, 0, bm, wgs, kwgs,
          splits, st));
    case kBitTrick:
      return static_cast<int>(qmm::launch<BitTrickE4M3>(
          x, w, nullptr, out, m, n, k, qmm::kScaleNone, 0, bm, wgs, kwgs,
          splits, st));
    case kAstypeE4M3:
      return static_cast<int>(qmm::launch<qmm::E4M3>(
          x, w, nullptr, out, m, n, k, qmm::kScaleNone, 0, bm, wgs, kwgs,
          splits, st));
    case kAstypeInt8:
      return static_cast<int>(qmm::launch<qmm::Int8>(
          x, w, nullptr, out, m, n, k, qmm::kScaleNone, 0, bm, wgs, kwgs,
          splits, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

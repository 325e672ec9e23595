// Decode weight-stream matmul variants for Hopper (sm_90a).
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
// (w_gateup fused [4096, 28672]: 117 MB, 35 us at 3.35 TB/s).
//
// Design: the tile pipeline of quant_matmul.cuh (the fp8 / int4 matmuls'
// header, unchanged): 4 warps own 128 output columns, 4 cp.async stages
// of 64 x 128 weight bytes, mma.sync m16n8k16 bf16 with fp32 sums, each
// byte converted once per CTA in the registers of the warp that
// multiplies it, deterministic split K when the grid is small.  The
// variants are the header's weight-format policy: two new ones here for
// the tricks, the header's own e4m3 (cvt) and int8 formats for astype.
// No scale: scale_mode none.

#include "quant_matmul.cuh"

namespace {

using qmm::pack_bf16x2;

// e4m3 byte j of w through the f16 shift-and-scale.
struct F16TrickE4M3 {
  static constexpr int kXCols = qmm::kBKW;
  static constexpr bool kPacked = false;
  static __device__ __forceinline__ float value(uint32_t w, int j) {
    const uint32_t u = (w >> (8 * j)) & 0xffu;
    const unsigned short h =
        static_cast<unsigned short>(((u & 0x80u) << 8) | ((u & 0x7fu) << 7));
    return __half2float(__ushort_as_half(h)) * 256.f;
  }
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    return pack_bf16x2(value(lo, j), value(hi, j));
  }
};

// e4m3 byte j of w through the i32 bit surgery.
struct BitTrickE4M3 {
  static constexpr int kXCols = qmm::kBKW;
  static constexpr bool kPacked = false;
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
    return pack_bf16x2(value(lo, j), value(hi, j));
  }
};

enum Variant { kF16Trick = 0, kBitTrick = 1, kAstypeE4M3 = 2, kAstypeInt8 = 3 };

}  // namespace

extern "C" int stream_matmul_launch(const void* x, const void* w, void* out,
                                    void* ws, int m, int n, int k,
                                    int variant, int mt, int splits,
                                    void* stream) {
  qmm::Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.scale = nullptr;
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.m = m;
  a.n = n;
  a.k = k;
  a.k_tiles = k / qmm::kBKW;
  a.tiles_per_split = (a.k_tiles + splits - 1) / (splits > 0 ? splits : 1);
  a.scale_mode = qmm::kScaleNone;
  a.out_f32 = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kF16Trick:
      return static_cast<int>(qmm::launch<F16TrickE4M3>(a, mt, splits, st));
    case kBitTrick:
      return static_cast<int>(qmm::launch<BitTrickE4M3>(a, mt, splits, st));
    case kAstypeE4M3:
      return static_cast<int>(
          qmm::launch<qmm::E4M3Weights>(a, mt, splits, st));
    case kAstypeInt8:
      return static_cast<int>(
          qmm::launch<qmm::Int8Weights>(a, mt, splits, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Weight-only fp8 (e4m3) and int8 matmul for Hopper (sm_90a).
//
// Replaces arcticinference_tpu/ops/pallas/fp8_matmul.py
// fp8_matmul_kernel (_mm_kernel): y = (x_bf16 @ bf16(w)) * scale with
// fp32 sums.  Besides the TPU kernel's scalar scale it takes a
// per-output-column scale (fused qkv and gate|up carry one per column,
// and int8 weights always do) and int8 weights, as the JAX package's
// matmul computes them.
//
// What bounds it on an H100: at decode (16-64 rows) the weight bytes,
// one byte per value, against 3.35 TB/s (w_gateup: 117 MB, 35 us); at a
// 2048-row prefill the products, against the bf16 tensor cores' 989
// TFLOP/s (w_gateup: 0.49 ms).
//
// What the design does about it (quant_matmul.cuh): four cp.async
// stages of 64 x 128 weight bytes per CTA, and split K when the grid is
// small, keep the weight stream in flight at decode; the products run on
// bf16 tensor cores (mma.sync m16n8k16), each weight byte converted to
// bf16 once per CTA in registers, and the scale multiplies the fp32 sums
// once in the epilogue.  e4m3 -> bf16 and int8 -> bf16 are exact, so the
// function is the JAX one up to the order of the fp32 sums.

#include "quant_matmul.cuh"

extern "C" int fp8_matmul_launch(const void* x, const void* w,
                                 const void* scale, void* out, void* ws,
                                 int m, int n, int k, int w_int8,
                                 int scale_mode, int out_f32, int mt,
                                 int splits, void* stream) {
  if (scale_mode != qmm::kScaleScalar && scale_mode != qmm::kScaleColumn)
    return cudaErrorInvalidValue;
  qmm::Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.m = m;
  a.n = n;
  a.k = k;
  a.k_tiles = k / qmm::kBKW;
  a.tiles_per_split = (a.k_tiles + splits - 1) / (splits > 0 ? splits : 1);
  a.scale_mode = scale_mode;
  a.out_f32 = out_f32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_int8 ? qmm::launch<qmm::Int8Weights>(a, mt, splits, st)
             : qmm::launch<qmm::E4M3Weights>(a, mt, splits, st));
}

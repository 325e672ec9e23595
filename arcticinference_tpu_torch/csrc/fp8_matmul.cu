// Weight-only fp8 (e4m3) and int8 matmul for Hopper (sm_90a): kernel 5.
//
// Replaces arcticinference_tpu/ops/pallas/fp8_matmul.py
// fp8_matmul_kernel (_mm_kernel): y = (x_bf16 @ bf16(w)) * scale with
// fp32 sums.  Besides the TPU kernel's scalar scale it takes a
// per-output-column scale (fused qkv and gate|up carry one per column,
// and int8 weights always do) and int8 weights, as the JAX package's
// matmul computes them.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at 16-256
// rows the weight bytes, one byte per value, against 3.35 TB/s
// (w_gateup [4096, 28672]: 117 MB, 35 us), and their conversion to bf16
// on the SMs that stream them; at a 2048-row prefill the products
// against the bf16 tensor cores' 989 TFLOP/s (w_gateup: 0.49 ms).
//
// What the design does about it (quant_wgmma.cuh): the weight bytes come
// in by TMA, several stages deep, from one producer thread; the
// products run on wgmma with the weight as the register operand, each
// byte converted to bf16 once per CTA mostly on the ALUs (one
// conversion-unit instruction per e4m3 pair, none for int8), while the
// previous batch's products run; x rows are wgmma's N, so 16-64 decode
// rows multiply no padding; a narrow weight (wqkv, wo, w_down) puts two
// warpgroups on K in each CTA and splits K over a cluster of up to 3
// CTAs, summed on chip in rank order; the scale multiplies the fp32 sums
// once in the epilogue.  e4m3 -> bf16 and int8 -> bf16 are exact, so the
// function is the JAX one up to the order of the fp32 sums.

#include "quant_wgmma.cuh"

extern "C" int fp8_matmul_launch(const void* x, const void* w,
                                 const void* scale, void* out, int m, int n,
                                 int k, int w_int8, int scale_mode,
                                 int out_f32, int bm, int wgs, int kwgs,
                                 int splits, void* stream) {
  if (scale_mode != qmm::kScaleScalar && scale_mode != qmm::kScaleColumn)
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_int8 ? qmm::launch<qmm::Int8>(x, w, s, out, m, n, k, scale_mode,
                                      out_f32, bm, wgs, kwgs, splits, st)
             : qmm::launch<qmm::E4M3>(x, w, s, out, m, n, k, scale_mode,
                                      out_f32, bm, wgs, kwgs, splits, st));
}

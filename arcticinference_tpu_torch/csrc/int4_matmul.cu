// Weight-only int4 matmul for Hopper (sm_90a).
//
// Replaces arcticinference_tpu/ops/pallas/int4_matmul.py
// int4_matmul_kernel (_mm_kernel): y = x_bf16 @ dequant(w) with w split-
// half packed (byte row u holds K row u in its low nibble and K row
// u + K/2 in its high nibble) and group-128 scales [K/128, N].
//
// What bounds it on an H100: at decode the packed weight bytes, half a
// byte per value plus 4 bytes of scale per 128 values, against 3.35 TB/s
// (w_gateup: 62.4 MB, 19 us); at a 2048-row prefill the products against
// the bf16 tensor cores' 989 TFLOP/s.
//
// What the design does about it (quant_matmul.cuh): each packed byte is
// read once and both nibbles are sign-extended in registers; the low
// nibble multiplies x columns [u], the high one x columns [u + K/2], so a
// stage of 64 packed rows feeds 128 rows of products.  Row u takes scale
// row u / 128 and row u + K/2 takes (u + K/2) / 128.  The scale is folded
// into the bf16 weight value, bf16(q * s), which is what the JAX
// package's CPU path and int4_matmul_reference compute (the TPU kernel
// scaled its fp32 partial sums instead), and the products run on bf16
// tensor cores with fp32 sums.  Split K and the cp.async stages keep the
// weight stream in flight at decode, as for fp8.

#include "quant_matmul.cuh"

extern "C" int int4_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, void* ws,
                                  int m, int n, int k, int out_f32, int mt,
                                  int splits, void* stream) {
  qmm::Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.m = m;
  a.n = n;
  a.k = k;
  a.k_tiles = k / 2 / qmm::kBKW;
  a.tiles_per_split = (a.k_tiles + splits - 1) / (splits > 0 ? splits : 1);
  a.scale_mode = qmm::kScaleNone;
  a.out_f32 = out_f32;
  return static_cast<int>(qmm::launch<qmm::Int4Weights>(
      a, mt, splits, static_cast<cudaStream_t>(stream)));
}

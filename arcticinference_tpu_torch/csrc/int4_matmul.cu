// Weight-only int4 matmul for Hopper (sm_90a): kernel 6.
//
// Replaces arcticinference_tpu/ops/pallas/int4_matmul.py
// int4_matmul_kernel (_mm_kernel): y = x_bf16 @ dequant(w) with w split-
// half packed (byte row u holds K row u in its low nibble and K row
// u + K/2 in its high nibble) and group-128 scales [K/128, N].
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at 16-256
// rows the packed weight bytes, half a byte per value plus 4 bytes of
// scale per 128 values, against 3.35 TB/s (w_gateup [4096, 28672]:
// 62.4 MB, 19 us); at a 2048-row prefill the products against the bf16
// tensor cores' 989 TFLOP/s (w_gateup: 0.49 ms).
//
// What the design does about it (quant_wgmma.cuh, shared with kernel 5):
// a stage of 64 packed rows feeds 128 rows of products, so each packed
// byte is read once and both nibbles are sign-extended in registers; the
// low nibble multiplies x columns [u], the high one [u + K/2], two x
// tiles that TMA brings in beside the weight tile, with the stage's two
// scale rows (u / 128 and (u + K/2) / 128) by bulk copy.  The scale is
// folded into the bf16 weight value, bf16(q * s), which is what the JAX
// package's CPU path and int4_matmul_reference compute (the TPU kernel
// scaled its fp32 partial sums instead), with the nibbles widened to
// float on the ALUs; the products run on wgmma with fp32 sums, narrow
// weights take two warpgroups along K and a cluster split of K summed on
// chip, as for fp8.

#include "quant_wgmma.cuh"

extern "C" int int4_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int m, int n,
                                  int k, int out_f32, int bm, int wgs,
                                  int kwgs, int splits, void* stream) {
  return static_cast<int>(qmm::launch<qmm::Int4>(
      x, w, static_cast<const float*>(scale), out, m, n, k, qmm::kScaleNone,
      out_f32, bm, wgs, kwgs, splits, static_cast<cudaStream_t>(stream)));
}

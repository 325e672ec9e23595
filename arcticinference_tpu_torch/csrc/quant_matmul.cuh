// The mma.sync tile pipeline of the weight-stream matmul variants
// (stream_matmul.cu, kernel 8: the microbench's comparison of dequant
// bodies, with no launch on the engine's path).  Kernels 5 and 6 (the
// fp8 / int8 and int4 matmuls of every quantized linear) ran on it until
// they moved to the wgmma pipeline of quant_wgmma.cuh; it stays, code
// unchanged, as kernel 8's yardstick, its int4 policy included: no
// instance uses it now, but removing it made ptxas schedule kernel 8's
// f16-trick variant 8% faster (NVIDIA H100 80GB HBM3, 700 W), and
// kernel 8 keeps its code and times.
//
//   out[M, N] = (x[M, K] bf16 @ bf16(w)[K, N]) * scale     fp32 sums
//
// Tiles.  A CTA of 4 warps owns kBN = 128 output columns (32 per warp)
// and MT * 16 rows; every warp covers all the CTA's rows, so each weight
// element is converted once per CTA, in the registers of the warp that
// multiplies it.  Per stage the CTA copies kBKW = 64 weight rows (packed
// rows for int4: 128 unpacked rows) and the matching x columns into
// shared memory with cp.async, kStages deep, so at decode (MT = 1)
// about 32 KB of weights per CTA are in flight.
//
// Products.  mma.sync.m16n8k16 bf16 with fp32 accumulators.  The weight
// is [K, N] with N contiguous, and a B fragment wants two consecutive k
// of one column.  A thread therefore reads four 32-bit words (rows 2c,
// 2c+1, 2c+8, 2c+9 of a 16-row step; bytes of columns 4g..4g+3) and
// takes byte j of each word for the fragment of n8-tile j: tile j's
// column g is the warp's column 4g + j.  The accumulator of tile j then
// holds columns 8c + j and 8c + 4 + j, so a thread ends with eight
// contiguous columns per row, stored with 16-byte writes.
//
// Split K.  When the grid has too few CTAs to keep 132 SMs streaming
// weights (decode rows against N = 4096), gridDim.z CTAs split the K
// tiles; each writes its fp32 partial sums to a workspace and a second
// kernel adds them in split order, then scales and converts: no atomics,
// so the result does not change from run to run.
//
// The wrapper (ops/cuda/stream_matmul.py) checks shapes, types,
// contiguity and 16-byte alignment; the C entry point re-checks what a
// launch needs and returns a CUDA error code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;            // output columns per CTA (32 per warp)
constexpr int kBKW = 64;            // weight rows per stage (packed for int4)
constexpr int kWStride = kBN + 16;  // bytes per weight row in shared memory
constexpr int kStages = 4;
constexpr int kGroup = 128;         // int4 scale group along K

struct Args {
  const uint16_t* x;   // [M, K] bf16
  const uint8_t* w;    // [K, N] one byte per value, or [K/2, N] packed int4
  const float* scale;  // scalar, [N] or [K/128, N]
  void* out;           // [M, N] bf16 or float32
  float* ws;           // [splits, M, N] float32 partial sums (splits > 1)
  int m, n, k;
  int k_tiles;         // kBKW-row weight stages along K
  int tiles_per_split;
  int scale_mode;      // 0: none (int4 folds it in), 1: scalar, 2: per column
  int out_f32;
};

enum ScaleMode { kScaleNone = 0, kScaleScalar = 1, kScaleColumn = 2 };

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> bf16x2 (round to nearest even); lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- weight formats ---------------------------------------------------------

// e4m3 -> bf16 is exact (3 mantissa bits).  The card converts e4m3 pairs
// to f16 pairs (also exact); f16 -> f32 -> bf16 keeps the value.
struct E4M3Weights {
  static constexpr int kXCols = kBKW;  // x columns per stage
  static constexpr bool kPacked = false;
  // (byte j of lo, byte j of hi) as bf16x2.
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    const uint16_t two =
        static_cast<uint16_t>(__byte_perm(lo, hi, j | ((j + 4) << 4)));
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3));
    const float2 f = __half22float2(h);
    return pack_bf16x2(f.x, f.y);
  }
};

// int8 values (|v| <= 127) are exact in bf16.
struct Int8Weights {
  static constexpr int kXCols = kBKW;
  static constexpr bool kPacked = false;
  static __device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi,
                                                  int j) {
    const float a = static_cast<float>(static_cast<int8_t>(lo >> (8 * j)));
    const float b = static_cast<float>(static_cast<int8_t>(hi >> (8 * j)));
    return pack_bf16x2(a, b);
  }
};

// Split-half packed int4: packed row u holds K row u (low nibble) and
// K row u + K/2 (high nibble).  A stage of kBKW packed rows multiplies
// x columns [t*kBKW, +kBKW) with the low nibbles and [K/2 + t*kBKW,
// +kBKW) with the high ones; both ranges lie inside one scale group.
struct Int4Weights {
  static constexpr int kXCols = 2 * kBKW;
  static constexpr bool kPacked = true;
  // Sign-extended low / high nibble of byte j.
  static __device__ __forceinline__ float lo_nib(uint32_t w, int j) {
    return static_cast<float>(static_cast<int32_t>(w << (28 - 8 * j)) >> 28);
  }
  static __device__ __forceinline__ float hi_nib(uint32_t w, int j) {
    return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 28);
  }
  // Scale rows of stage t's low and high halves.
  static __device__ __forceinline__ int scale_row_lo(int k, int t) {
    return t * kBKW / kGroup;
  }
  static __device__ __forceinline__ int scale_row_hi(int k, int t) {
    return (k / 2 + t * kBKW) / kGroup;
  }
};

template <class P, int MT>
struct Layout {
  static constexpr int kBM = MT * 16;
  static constexpr int kXStride = P::kXCols + 8;  // bf16 elements per x row
  static constexpr int kXBytes = kBM * kXStride * 2;
  static constexpr int kWBytes = kBKW * kWStride;
  static constexpr int kSBytes = P::kPacked ? 2 * kBN * 4 : 0;
  static constexpr int kStageBytes = kXBytes + kWBytes + kSBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

// x column of 16-byte chunk element offset c8 in stage t.
template <class P>
__device__ __forceinline__ int x_col(const Args& a, int t, int c8) {
  if constexpr (P::kPacked) {
    return c8 < kBKW ? t * kBKW + c8 : a.k / 2 + t * kBKW + (c8 - kBKW);
  } else {
    return t * kBKW + c8;
  }
}

template <class P, int MT>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* stage,
                                           int t, int m0, int n0, int tid) {
  using L = Layout<P, MT>;
  uint16_t* xs = reinterpret_cast<uint16_t*>(stage);
  uint8_t* wt = stage + L::kXBytes;
  const uint8_t* wsrc = a.w + static_cast<size_t>(t) * kBKW * a.n + n0;
  static_assert(kBKW * (kBN / 16) % kThreads == 0, "weight chunks");
#pragma unroll
  for (int q = 0; q < kBKW * (kBN / 16) / kThreads; ++q) {
    const int i = tid + q * kThreads;
    const int r = i / (kBN / 16), c = i % (kBN / 16);
    cp_async16(wt + r * kWStride + c * 16,
               wsrc + static_cast<size_t>(r) * a.n + c * 16, true);
  }
  constexpr int kChunks = P::kXCols / 8;  // 16-byte chunks per x row
  static_assert(L::kBM * kChunks % kThreads == 0, "x chunks");
#pragma unroll
  for (int q = 0; q < L::kBM * kChunks / kThreads; ++q) {
    const int i = tid + q * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int row = m0 + r;
    const bool ok = row < a.m;
    const uint16_t* src =
        ok ? a.x + static_cast<size_t>(row) * a.k + x_col<P>(a, t, c * 8)
           : a.x;
    cp_async16(xs + r * L::kXStride + c * 8, src, ok);
  }
  if constexpr (P::kPacked) {
    float* ss = reinterpret_cast<float*>(wt + L::kWBytes);
    if (tid < 2 * (kBN / 4)) {
      const int half = tid / (kBN / 4), c = tid % (kBN / 4);
      const int g = half ? P::scale_row_hi(a.k, t) : P::scale_row_lo(a.k, t);
      cp_async16(ss + half * kBN + c * 4,
                 a.scale + static_cast<size_t>(g) * a.n + n0 + c * 4, true);
    }
  }
}

template <class P, int MT>
__device__ __forceinline__ void compute_stage(const uint8_t* stage,
                                              float (&acc)[MT][4][4],
                                              int warp, int lane) {
  using L = Layout<P, MT>;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(stage);
  const uint8_t* wt = stage + L::kXBytes;
  const int g = lane >> 2, c = lane & 3;
  const uint8_t* wcol = wt + warp * 32 + 4 * g;
  // ldmatrix row address of this lane within an m16 x k16 A tile.
  const uint16_t* xa = xs + (lane & 15) * L::kXStride + (lane >> 4) * 8;
  float4 slo = make_float4(0.f, 0.f, 0.f, 0.f), shi = slo;
  if constexpr (P::kPacked) {
    const float* ss = reinterpret_cast<const float*>(wt + L::kWBytes);
    slo = *reinterpret_cast<const float4*>(ss + warp * 32 + 4 * g);
    shi = *reinterpret_cast<const float4*>(ss + kBN + warp * 32 + 4 * g);
  }
#pragma unroll
  for (int kk = 0; kk < kBKW / 16; ++kk) {
    const uint8_t* wr = wcol + (kk * 16 + 2 * c) * kWStride;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + kWStride);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wr + 8 * kWStride);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wr + 9 * kWStride);
    if constexpr (P::kPacked) {
      const float sl[4] = {slo.x, slo.y, slo.z, slo.w};
      const float sh[4] = {shi.x, shi.y, shi.z, shi.w};
      uint32_t blo[4][2], bhi[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // bf16(q * s), as the reference dequantizes before its product.
        blo[j][0] = pack_bf16x2(P::lo_nib(w0, j) * sl[j],
                                P::lo_nib(w1, j) * sl[j]);
        blo[j][1] = pack_bf16x2(P::lo_nib(w2, j) * sl[j],
                                P::lo_nib(w3, j) * sl[j]);
        bhi[j][0] = pack_bf16x2(P::hi_nib(w0, j) * sh[j],
                                P::hi_nib(w1, j) * sh[j]);
        bhi[j][1] = pack_bf16x2(P::hi_nib(w2, j) * sh[j],
                                P::hi_nib(w3, j) * sh[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, xa + i * 16 * L::kXStride + kk * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, blo[j]);
        ldmatrix_x4(a, xa + i * 16 * L::kXStride + kBKW + kk * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, bhi[j]);
      }
    } else {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = P::pair(w0, w1, j);
        b[j][1] = P::pair(w2, w3, j);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, xa + i * 16 * L::kXStride + kk * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j]);
      }
    }
  }
}

// Scale and store eight contiguous columns of one row.
__device__ __forceinline__ void store8(const Args& a, int row, int col,
                                       float (&v)[8]) {
  if (a.scale_mode == kScaleScalar) {
    const float s = a.scale[0];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] *= s;
  } else if (a.scale_mode == kScaleColumn) {
    const float4 s0 = *reinterpret_cast<const float4*>(a.scale + col);
    const float4 s1 = *reinterpret_cast<const float4*>(a.scale + col + 4);
    v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
    v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
  }
  const size_t off = static_cast<size_t>(row) * a.n + col;
  if (a.out_f32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out) + off);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 p;
    p.x = pack_bf16x2(v[0], v[1]);
    p.y = pack_bf16x2(v[2], v[3]);
    p.z = pack_bf16x2(v[4], v[5]);
    p.w = pack_bf16x2(v[6], v[7]);
    *reinterpret_cast<uint4*>(static_cast<uint16_t*>(a.out) + off) = p;
  }
}

template <class P, int MT>
__global__ void __launch_bounds__(kThreads) qmm_kernel(const Args a) {
  using L = Layout<P, MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * L::kBM;
  const int t0 = blockIdx.z * a.tiles_per_split;
  const int nt = min(a.tiles_per_split, a.k_tiles - t0);

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt)
      load_stage<P, MT>(a, smem + s * L::kStageBytes, t0 + s, m0, n0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // Refill the stage read in the previous iteration (every warp has
    // passed the barrier above, so none still reads it).
    const int pf = it + kStages - 1;
    if (pf < nt)
      load_stage<P, MT>(a, smem + (pf % kStages) * L::kStageBytes, t0 + pf,
                        m0, n0, tid);
    cp_async_commit();
    compute_stage<P, MT>(smem + (it % kStages) * L::kStageBytes, acc, warp,
                         lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, c = lane & 3;
  const int col = n0 + warp * 32 + 8 * c;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + i * 16 + g + 8 * h;
      if (row >= a.m) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h];
        v[4 + j] = acc[i][j][2 * h + 1];
      }
      if (gridDim.z > 1) {
        float4* o = reinterpret_cast<float4*>(
            a.ws + (static_cast<size_t>(blockIdx.z) * a.m + row) * a.n + col);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        store8(a, row, col, v);
      }
    }
  }
}

// Sum the split-K partials in split order, scale, convert: one thread
// per four outputs.
__global__ void __launch_bounds__(256) reduce_kernel(const Args a,
                                                     int splits) {
  const size_t total4 = static_cast<size_t>(a.m) * a.n / 4;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const float4* ws = reinterpret_cast<const float4*>(a.ws);
  float4 s = ws[i];
  for (int z = 1; z < splits; ++z) {
    const float4 p = ws[z * total4 + i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  const int col = static_cast<int>((i * 4) % a.n);
  if (a.scale_mode == kScaleScalar) {
    const float f = a.scale[0];
    s.x *= f; s.y *= f; s.z *= f; s.w *= f;
  } else if (a.scale_mode == kScaleColumn) {
    const float4 f = *reinterpret_cast<const float4*>(a.scale + col);
    s.x *= f.x; s.y *= f.y; s.z *= f.z; s.w *= f.w;
  }
  if (a.out_f32) {
    reinterpret_cast<float4*>(a.out)[i] = s;
  } else {
    uint2 p;
    p.x = pack_bf16x2(s.x, s.y);
    p.y = pack_bf16x2(s.z, s.w);
    reinterpret_cast<uint2*>(a.out)[i] = p;
  }
}

template <class P, int MT>
cudaError_t launch_mt(const Args& a, int splits, cudaStream_t stream) {
  using L = Layout<P, MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_kernel<P, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.n / kBN, (a.m + L::kBM - 1) / L::kBM, splits);
  qmm_kernel<P, MT><<<grid, kThreads, L::kSmemBytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total4 = static_cast<size_t>(a.m) * a.n / 4;
  reduce_kernel<<<static_cast<unsigned>((total4 + 255) / 256), 256, 0,
                  stream>>>(a, splits);
  return cudaGetLastError();
}

// Checks what a launch needs (the wrappers have checked it already).
template <class P>
cudaError_t launch(const Args& a, int mt, int splits, cudaStream_t stream) {
  const int k_rows = P::kPacked ? a.k / 2 : a.k;
  if (a.m <= 0 || a.n <= 0 || a.n % kBN || k_rows % kBKW ||
      a.k_tiles != k_rows / kBKW || a.tiles_per_split <= 0 || splits < 1 ||
      (splits - 1) * a.tiles_per_split >= a.k_tiles ||
      splits * a.tiles_per_split < a.k_tiles ||
      (splits > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  switch (mt) {
    case 1: return launch_mt<P, 1>(a, splits, stream);
    case 2: return launch_mt<P, 2>(a, splits, stream);
    case 4: return launch_mt<P, 4>(a, splits, stream);
    case 8: return launch_mt<P, 8>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace qmm

// Grouped matmul over expert-sorted rows for Hopper (sm_90a) on wgmma and
// TMA: the MoE expert products (row R of PERF.md's kernel table).
//
// Replaces no Pallas kernel: it is the port's counterpart of the XLA op
// jax.lax.ragged_dot in arcticinference_tpu/models/mixtral.py:234-239
// (_moe_mlp), over the expert stacks that _deq dequantizes to bf16 first:
//
//   out[r, :] = float32(xs[r, :] @ deq(W[e(r)]))   for offsets[e] <= r <
//   offsets[e + 1], and out[r, :] = 0 for rows past offsets[E].
//
// xs is [R, K] bf16, sorted by expert; W is [E, K, N] bf16, e4m3 (one
// float32 scale) or int8 (per-column [E, N] float32 scales), or int4
// packed split-half [E, K/2, N] (byte row u holds row u in its low nibble
// and row u + K/2 in its high nibble) with group-128 scales [E, K/128, N].
// deq is the JAX package's fp8_dequantize to bf16: each weight element
// becomes bf16(float(w) * scale) BEFORE the product (not kernel 5's
// function, which scales the float32 sums; the two differ by that bf16
// rounding).  offsets is int32 [E + 1] on the device; offsets[0] is taken
// as 0 and the others are clamped to be non-decreasing and at most R.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W): at decode
// (16-32 rows an expert) the weight bytes of every expert that has rows
// against 3.35 TB/s, and converting each of those weights to bf16 on the
// SMs that stream it; at a prefill chunk (hundreds of rows an expert) the
// bf16 products against 989 TFLOP/s.
//
// The design is quant_wgmma.cuh's pipeline (kernels 5 and 6), whose CTA
// shapes (qmm::Shape), ring and producer (ring_init, produce_ring,
// load_x) and consumer loop (consume) it runs, with the grouping added
// here (the expert walk, the 3-D weight map, the folded scales, the
// store):
//   * Grid.  A fixed function of (R, E, N) (ops/cuda/grouped_matmul.py,
//     launch_plan): ceil(R / BM) + E row tiles (the fast grid dimension,
//     so the row tiles of one expert stream the same weight columns at
//     once, from L2 after the first) by N / BN column tiles.  Each CTA
//     loads offsets and walks the groups to its tile: expert e, rows
//     [row0, row0 + rows), rows <= BM; the tiles after the last group's
//     zero the rows past offsets[E]; the rest exit.  Nothing is read back
//     to the host, and a CUDA graph replays the launch at any routing.
//   * Products ("swap AB").  The weight columns are wgmma's M, the x rows
//     its N (BM = 16, 32, 64 or 128), so a decode group multiplies little
//     padding.  The weight is the register operand A, converted to bf16
//     on the ALUs with its scale folded in, bf16(float(w) * s), rounded
//     once as _deq rounds it: the one e4m3 scale, the thread's four int8
//     column scales of its expert, int4's group scale of the stage's two
//     halves.  bf16 weights are repacked, not converted.  A warpgroup
//     converts its next batch of fragments while the current batch's
//     products run (two register sets).  x is operand B, read by wgmma
//     from shared memory.
//   * Pipeline.  One producer thread keeps the stages in flight with TMA:
//     the weight tile [64 rows, 128 columns] per consumer warpgroup from a
//     3-D map over [E, K, N] ([E, K/2, N] packed) at (n0, 64 t, e), so a
//     tile never crosses an expert (bf16: two [64, 64] boxes), and the x
//     tile [BM, 64] from [R, K] at (64 t, row0) (int4: also the high
//     half's at K/2 + 64 t, and two rows of group scales by bulk copy).
//     Rows of the next group inside the tile are multiplied and not
//     stored; rows past R arrive as zeros.  Each stage completes on a
//     "full" mbarrier and is released on an "empty" one; no block-wide
//     barrier paces the main loop.
//   * CTA shapes: one consumer warpgroup and two CTAs an SM up to 64 rows;
//     at 128 rows two warpgroups side by side on 256 columns share each x
//     tile (one, where N is not a multiple of 256).
//   * Row bits.  No split K and no warpgroups along K: every row's
//     float32 sums run over the same 64-row stages in the same order, so
//     its output bits depend only on its own x row and its expert's
//     weight, never on its neighbours, its index, the routing or BM (the
//     drafter's replay and chip_smoke.py phase 11 need that).

#include "quant_wgmma.cuh"

#include <type_traits>

namespace gmm {
namespace {

using qmm::kGroup;
using qmm::kWGCols;
using qmm::kWK;

constexpr int kMaxExperts = 256;
constexpr int kBoxBytes = kWK * 128;  // one [64, 128-byte] TMA box

// The weight formats: qmm's E4M3, Int8 and packed Int4, and bf16, whose
// warpgroup tile is two [64, 64] boxes.
struct Bf16 {
  static constexpr bool kPacked = false;
  static constexpr int kElem = 2;
};

// 3-D TMA tile (c0 along the contiguous dimension) into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(qmm::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(qmm::smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Columns col .. col + 3 (bf16) of row `row` of a warpgroup's bf16 weight
// tile: two [64 rows, 64 columns] boxes in 128-byte swizzle.
__device__ __forceinline__ uint2 lds_bf16x4(const uint8_t* tile, int row,
                                            int col) {
  const uint8_t* box = tile + (col >> 6) * kBoxBytes;
  const int b = (col & 63) * 2;
  return *reinterpret_cast<const uint2*>(
      box + row * 128 + ((((b >> 4) ^ (row & 7)) << 4) | (b & 15)));
}

// Byte j of lo and of hi (one weight column, two K rows) as floats.
template <class W>
__device__ __forceinline__ float2 byte_pair(uint32_t lo, uint32_t hi,
                                            int j) {
  if constexpr (std::is_same<W, qmm::E4M3>::value) {
    const uint16_t two =
        static_cast<uint16_t>(__byte_perm(lo, hi, j | ((j + 4) << 4)));
    return __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
  } else {
    return make_float2(qmm::small_int_to_float(qmm::signed_byte(lo, j)),
                       qmm::small_int_to_float(qmm::signed_byte(hi, j)));
  }
}

// bf16(a * s), bf16(b * s) as one bf16x2 word: the product rounded once
// to float32 and once to bf16, as _deq computes it.
__device__ __forceinline__ uint32_t deq2(float2 v, float s) {
  return qmm::pack_bf16x2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
}

// Weight fragments of batch b of a stage for one thread of the unpacked
// formats (int4 takes qmm's conversion, which folds its group scale in
// the same way): wt is its warpgroup's weight tile, sc its four columns'
// scales.  Product t takes the thread's columns bcol + 2t (A row g) and
// bcol + 2t + 1 (A row g + 8).
template <class W>
__device__ __forceinline__ void convert_batch(const uint8_t* wt, int b,
                                              const float (&sc)[4],
                                              typename qmm::Batch<W>::Regs& f,
                                              int bcol, int c) {
  using B = qmm::Batch<W>;
#pragma unroll
  for (int q = 0; q < B::kSteps; ++q) {
    const int r = (b * B::kSteps + q) * 16 + 2 * c;
    if constexpr (std::is_same<W, Bf16>::value) {
      const uint2 w0 = lds_bf16x4(wt, r, bcol), w1 = lds_bf16x4(wt, r + 1, bcol);
      const uint2 w2 = lds_bf16x4(wt, r + 8, bcol),
                  w3 = lds_bf16x4(wt, r + 9, bcol);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t a0 = t ? w0.y : w0.x, a1 = t ? w1.y : w1.x;
        const uint32_t a2 = t ? w2.y : w2.x, a3 = t ? w3.y : w3.x;
        f[q][t][0] = __byte_perm(a0, a1, 0x5410);  // column bcol + 2t
        f[q][t][1] = __byte_perm(a0, a1, 0x7632);  // column bcol + 2t + 1
        f[q][t][2] = __byte_perm(a2, a3, 0x5410);
        f[q][t][3] = __byte_perm(a2, a3, 0x7632);
      }
    } else {
      const uint32_t w0 = qmm::lds_word(wt, r, bcol);
      const uint32_t w1 = qmm::lds_word(wt, r + 1, bcol);
      const uint32_t w2 = qmm::lds_word(wt, r + 8, bcol);
      const uint32_t w3 = qmm::lds_word(wt, r + 9, bcol);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * t + h;  // A row g + 8h: column bcol + j
          f[q][t][h] = deq2(byte_pair<W>(w0, w1, j), sc[j]);
          f[q][t][2 + h] = deq2(byte_pair<W>(w2, w3, j), sc[j]);
        }
      }
    }
  }
}

// qmm::consume's converter for the unpacked formats: batch b of the
// thread's warpgroup tile in ring slot `slot`, with the thread's four
// column scales folded in (1 for bf16, which is repacked, not scaled).
template <class W, class S>
struct FoldedConvert {
  const uint8_t* ring;
  int cw, bcol, c;
  float sc[4] = {1.f, 1.f, 1.f, 1.f};

  __device__ __forceinline__ void operator()(
      int slot, int b, typename qmm::Batch<W>::Regs& f) {
    convert_batch<W>(ring + slot * S::kStageBytes + cw * S::kWGBytes, b, sc,
                     f, bcol, c);
  }
};

struct GArgs {
  const float* scale;   // e4m3 [1], int8 [E, N], int4 [E, K/128, N]
  const int* offsets;   // [E + 1]
  float* out;           // [R, N]
  int r, e, n, k;       // k unpacked
  int k_tiles;          // 64-row weight stages (packed rows for int4)
};

template <class W, int BM, int WGS>
__global__ void __launch_bounds__(qmm::Shape<W, BM, WGS>::kThreads,
                                  qmm::Shape<W, BM, WGS>::kCtasPerSm)
    grouped_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const GArgs a) {
  using S = qmm::Shape<W, BM, WGS>;
  static_assert(S::kSmemBytes + 4 * (kMaxExperts + 5) <=
                    (S::kCtasPerSm == 2 ? 113 * 1024 : 227 * 1024),
                "shared memory per block");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int bounds[kMaxExperts + 1];
  __shared__ int tile[4];  // expert, row0, rows, kind (0 mma, 1 zero, 2 exit)
  uint8_t* ring =
      smem_raw + ((1024 - (qmm::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kRingBytes);
  uint64_t* empty = full + S::kStages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * S::kBN;
  constexpr int kProducer = S::kConsumers;  // the producer thread
  qmm::ring_init<S>(&tm_x, &tm_w, full, empty, tid);
  for (int i = tid; i <= a.e; i += S::kThreads) bounds[i] = a.offsets[i];
  __syncthreads();
  if (tid == 0) {
    // Walk the groups (offsets clamped non-decreasing, <= R) to this
    // CTA's row tile; the tiles after the last group's zero the rows
    // past offsets[E]; the rest exit (kind 2).
    const int t = blockIdx.x;
    int cum = 0, prev = 0, kind = 2, e_t = 0, row0 = 0, rows = 0;
    for (int e = 0; e < a.e; ++e) {
      const int end = min(max(bounds[e + 1], prev), a.r);
      const int tiles = (end - prev + BM - 1) / BM;
      if (t < cum + tiles) {
        e_t = e;
        row0 = prev + (t - cum) * BM;
        rows = min(BM, end - row0);
        kind = 0;
        break;
      }
      cum += tiles;
      prev = end;
    }
    if (kind == 2) {
      row0 = prev + (t - cum) * BM;
      if (row0 < a.r) {
        rows = min(BM, a.r - row0);
        kind = 1;
      }
    }
    tile[0] = e_t; tile[1] = row0; tile[2] = rows; tile[3] = kind;
  }
  __syncthreads();
  const int expert = tile[0], row0 = tile[1], rows = tile[2], kind = tile[3];
  if (kind == 2) return;
  if (kind == 1) {
    for (int i = tid; i < rows * (S::kBN / 4); i += S::kThreads) {
      const int r = i / (S::kBN / 4), cc = (i % (S::kBN / 4)) * 4;
      *reinterpret_cast<float4*>(a.out + static_cast<size_t>(row0 + r) * a.n +
                                 n0 + cc) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  if (tid >= kProducer) {  // producer warpgroup: one thread copies
    if constexpr (S::kConsumerRegs > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kProducer) {
      // The expert's weight tiles at (n0, 64 t, expert) of the 3-D map,
      // then the x tile(s) at row0 and int4's group scales of the expert.
      const float* scale =
          a.scale + static_cast<size_t>(expert) * (a.k / kGroup) * a.n;
      const auto load = [&](uint8_t* st, int t, uint64_t* bar) {
#pragma unroll
        for (int w = 0; w < WGS; ++w)
#pragma unroll
          for (int h = 0; h < W::kElem; ++h)  // bf16: two 64-column boxes
            tma_load_3d(st + w * S::kWGBytes + h * kBoxBytes, &tm_w,
                        n0 + w * kWGCols + h * (128 / W::kElem), t * kWK,
                        expert, bar);
        qmm::load_x<W, BM, S>(st, &tm_x, scale, a.k, a.n, t, row0, n0, bar);
      };
      qmm::produce_ring<S>(ring, full, empty, a.k_tiles, load);
    }
    return;
  }
  if constexpr (S::kConsumerRegs > 0)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        S::kConsumerRegs));
  const int cw = tid >> 7;  // column group
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bcol = warp * 32 + 4 * g;   // the thread's 4 weight columns
  const int col = cw * kWGCols + bcol;  // ... within the CTA's columns
  float acc[2][BM / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[t][i] = 0.f;
  // The scales folded into the conversion: int4's group scales per
  // stage; the one e4m3 scale, or the expert's scales of the thread's
  // four int8 columns, once.
  using Convert = std::conditional_t<W::kPacked, qmm::StageConvert<W, S>,
                                     FoldedConvert<W, S>>;
  Convert convert{ring, cw, bcol, c};
  if constexpr (std::is_same<W, qmm::E4M3>::value) {
    convert.sc[0] = convert.sc[1] = convert.sc[2] = convert.sc[3] =
        a.scale[0];
  } else if constexpr (std::is_same<W, qmm::Int8>::value) {
    const float4 v = *reinterpret_cast<const float4*>(
        a.scale + static_cast<size_t>(expert) * a.n + n0 + col);
    convert.sc[0] = v.x; convert.sc[1] = v.y;
    convert.sc[2] = v.z; convert.sc[3] = v.w;
  }
  qmm::consume<W, BM, 1, S>(acc, ring, full, empty, 0, a.k_tiles, lane,
                            convert);

  // The thread's sums: x rows 8i + 2c + e of the tile, columns col ..
  // col + 3; only the tile's own rows are stored.
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * i + 2 * c + e;
      if (r < rows)
        *reinterpret_cast<float4*>(a.out +
                                   static_cast<size_t>(row0 + r) * a.n + n0 +
                                   col) =
            make_float4(acc[0][4 * i + e], acc[0][4 * i + 2 + e],
                        acc[1][4 * i + e], acc[1][4 * i + 2 + e]);
    }
}

// TMA map of the weight stack [e, rows, n] (rows: K, or K/2 packed) in
// boxes of [1, 64, 128 bytes], 128-byte swizzle.
bool weight_map(CUtensorMap* map, bool bf16, const void* base, int e,
                int rows, int n) {
  const qmm::EncodeTiled enc = qmm::encode_tiled();
  if (enc == nullptr) return false;
  const int eb = bf16 ? 2 : 1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(e)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(n) * eb,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(n) * eb};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / eb),
                             static_cast<cuuint32_t>(kWK), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class W, int BM, int WGS>
cudaError_t launch_shape(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                         const GArgs& a, int row_tiles,
                         cudaStream_t stream) {
  using S = qmm::Shape<W, BM, WGS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_matmul_kernel<W, BM, WGS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  grouped_matmul_kernel<W, BM, WGS>
      <<<dim3(row_tiles, a.n / S::kBN), S::kThreads, S::kSmemBytes,
         stream>>>(tm_x, tm_w, a);
  return cudaGetLastError();
}

// The plan's instance: (bm, wgs) is one of (16 | 32 | 64 | 128, 1) and
// (128, 2).
template <class W>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                   const GArgs& a, int bm, int wgs, int row_tiles,
                   cudaStream_t stream) {
#define GMM_CASE(BM, WGS)                                                   \
  if (bm == BM && wgs == WGS)                                               \
    return launch_shape<W, BM, WGS>(tm_x, tm_w, a, row_tiles, stream);
  GMM_CASE(16, 1) GMM_CASE(32, 1) GMM_CASE(64, 1) GMM_CASE(128, 1)
  GMM_CASE(128, 2)
#undef GMM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gmm

// w_format: 0 bf16, 1 e4m3, 2 int8, 3 packed int4.  bm, wgs and
// row_tiles: the wrapper's launch_plan.  Re-checks what a launch needs
// (the wrapper has checked it already), encodes the two TMA maps (by
// value into the launch's parameters, so a captured graph keeps them)
// and returns a CUDA error code.
extern "C" int grouped_matmul_launch(const void* xs, const void* w,
                                     const void* scale, const void* offsets,
                                     void* out, int r, int e, int n, int k,
                                     int w_format, int bm, int wgs,
                                     int row_tiles, void* stream) {
  const bool int4 = w_format == 3;
  const int k_rows = int4 ? k / 2 : k;
  if (e < 1 || e > gmm::kMaxExperts || r < 1 || row_tiles < 1 || k <= 0 ||
      k_rows % gmm::kWK || (int4 && k % gmm::kGroup) || w_format < 0 ||
      w_format > 3 || (wgs != 1 && wgs != 2) || (wgs == 2 && bm != 128) ||
      n <= 0 || n % (wgs * gmm::kWGCols))
    return static_cast<int>(cudaErrorInvalidValue);
  gmm::GArgs a;
  a.scale = static_cast<const float*>(scale);
  a.offsets = static_cast<const int*>(offsets);
  a.out = static_cast<float*>(out);
  a.r = r;
  a.e = e;
  a.n = n;
  a.k = k;
  a.k_tiles = k_rows / gmm::kWK;
  CUtensorMap tm_x, tm_w;
  if (!qmm::tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs, r, k,
                       bm, gmm::kWK) ||
      !gmm::weight_map(&tm_w, w_format == 0, w, e, k_rows, n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w_format) {
    case 0:
      err = gmm::launch<gmm::Bf16>(tm_x, tm_w, a, bm, wgs, row_tiles, st);
      break;
    case 1:
      err = gmm::launch<qmm::E4M3>(tm_x, tm_w, a, bm, wgs, row_tiles, st);
      break;
    case 2:
      err = gmm::launch<qmm::Int8>(tm_x, tm_w, a, bm, wgs, row_tiles, st);
      break;
    default:
      err = gmm::launch<qmm::Int4>(tm_x, tm_w, a, bm, wgs, row_tiles, st);
  }
  return static_cast<int>(err);
}

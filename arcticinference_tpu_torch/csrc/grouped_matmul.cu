// Grouped matmul over expert-sorted rows for Hopper (sm_90a): the MoE
// expert products.
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
// function, which scales the float32 sums).  offsets is int32 [E + 1] on
// the device; offsets[0] is taken as 0 and the others are clamped to be
// non-decreasing and at most R.
//
// What bounds it on an H100: at decode (16-32 rows an expert) the weight
// bytes of every expert that has rows, against 3.35 TB/s; at a prefill
// chunk (hundreds of rows an expert) the bf16 products.
//
// The design is the simple one:
//   * The grid is a fixed function of (R, E, N): N / 128 column tiles
//     times ceil(R / BM) + E row tiles, BM chosen from R / E.  Each CTA
//     reads offsets and walks the groups to find its tile: expert e, rows
//     [row0, row0 + rows), rows <= BM; the tiles after the last group's
//     zero the rows past offsets[E]; the rest exit.  Nothing is read back
//     to the host, and a CUDA graph replays the launch at any routing.
//   * K is walked in stages of 64 (unpacked) weight rows, 4 stages deep:
//     cp.async brings the stage's x rows (zero-filled past the tile's
//     rows) and raw weight bytes into shared memory; quantized bytes are
//     converted to a bf16 tile there (scale folded in), which ldmatrix
//     feeds to mma.sync m16n8k16 (bf16 in, float32 sums).  bf16 weights
//     are read by ldmatrix where they land.
//   * Each warp owns 32 output columns of BM / WM rows.  A row's sums run
//     over the same stages in the same order whatever its neighbours,
//     its index or BM, so its output bits depend only on its own x row and
//     its expert's weight (the drafter's replay needs that).
// Redesigning it on wgmma and TMA is a later speed item (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBN = 128;               // output columns per CTA
constexpr int kKS = 64;                // unpacked weight rows per stage
constexpr int kStages = 4;
constexpr int kMaxExperts = 256;
constexpr int kXRow = kKS + 8;         // bf16 elements per staged x row
constexpr int kWRow = kBN + 8;         // bf16 elements per compute w row
constexpr int kGroup = 128;            // int4 quantization group (rows)

// Weight formats: raw bytes per staged row, raw rows per stage, and the
// scale's layout (the layouts ops/fp8.py gives an expert stack: e4m3 one
// scale over the stack, int8 one per expert and column, int4 one per
// group of 128 rows, expert and column).
struct Bf16W {
  static constexpr int kRawRowBytes = kWRow * 2;  // read where it lands
  static constexpr int kRawRows = kKS;
  static constexpr bool kConvert = false;
};
struct E4M3W {
  static constexpr int kRawRowBytes = kBN;
  static constexpr int kRawRows = kKS;
  static constexpr bool kConvert = true;
};
struct Int8W {
  static constexpr int kRawRowBytes = kBN;
  static constexpr int kRawRows = kKS;
  static constexpr bool kConvert = true;
};
struct Int4W {
  static constexpr int kRawRowBytes = kBN;
  static constexpr int kRawRows = kKS / 2;        // two nibbles a byte
  static constexpr bool kConvert = true;
};

template <class W, int BM>
struct Smem {
  static constexpr int kXBytes = BM * kXRow * 2;
  static constexpr int kRawBytes = W::kRawRows * W::kRawRowBytes;
  // int4: the stage's two group-scale rows (low and high half).
  static constexpr int kScaleBytes =
      std::is_same<W, Int4W>::value ? 2 * kBN * 4 : 0;
  static constexpr int kStageBytes = kXBytes + kRawBytes + kScaleBytes;
  static constexpr int kTileBytes = W::kConvert ? kKS * kWRow * 2 : 0;
  static constexpr int kBytes =
      kStages * kStageBytes + kTileBytes + kBN * 4;  // + column scales
  static_assert(kXBytes % 16 == 0 && kRawBytes % 16 == 0, "alignment");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(a * sa), bf16(b * sb) as one bf16x2 word (round to nearest even).
__device__ __forceinline__ uint32_t deq2(float a, float sa, float b,
                                         float sb) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fmul_rn(a, sa), __fmul_rn(b, sb));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 e4m3x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two), __NV_E4M3);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// 16 one-byte weights (e4m3 or int8) of one row to bf16, each times its
// column's scale (sc[j]).
template <class W>
__device__ __forceinline__ void convert16(const uint4 raw, const float* sc,
                                          uint16_t* dst) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    if constexpr (std::is_same<W, E4M3W>::value) {
      const float2 lo = e4m3x2(w[i] & 0xffffu), hi = e4m3x2(w[i] >> 16);
      f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
    }
    o[2 * i] = deq2(f[0], sc[4 * i], f[1], sc[4 * i + 1]);
    o[2 * i + 1] = deq2(f[2], sc[4 * i + 2], f[3], sc[4 * i + 3]);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// 16 packed int4 bytes: the low nibbles to row lo, the high ones to hi.
__device__ __forceinline__ void convert16_int4(const uint4 raw,
                                               const float* sc_lo,
                                               const float* sc_hi,
                                               uint16_t* lo, uint16_t* hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t ol[8], oh[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float fl[4], fh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = static_cast<int>((w[i] >> (8 * j)) & 0xffu);
      fl[j] = static_cast<float>(static_cast<int8_t>(b << 4) >> 4);
      fh[j] = static_cast<float>(static_cast<int8_t>(b) >> 4);
    }
    const int c = 4 * i;
    ol[2 * i] = deq2(fl[0], sc_lo[c], fl[1], sc_lo[c + 1]);
    ol[2 * i + 1] = deq2(fl[2], sc_lo[c + 2], fl[3], sc_lo[c + 3]);
    oh[2 * i] = deq2(fh[0], sc_hi[c], fh[1], sc_hi[c + 1]);
    oh[2 * i + 1] = deq2(fh[2], sc_hi[c + 2], fh[3], sc_hi[c + 3]);
  }
  reinterpret_cast<uint4*>(lo)[0] = make_uint4(ol[0], ol[1], ol[2], ol[3]);
  reinterpret_cast<uint4*>(lo)[1] = make_uint4(ol[4], ol[5], ol[6], ol[7]);
  reinterpret_cast<uint4*>(hi)[0] = make_uint4(oh[0], oh[1], oh[2], oh[3]);
  reinterpret_cast<uint4*>(hi)[1] = make_uint4(oh[4], oh[5], oh[6], oh[7]);
}

// Warps along M (WM) and 16-row m-tiles per warp (MT) of each row tile;
// 4 warps along N, 32 columns each.
template <int BM> struct Layout;
template <> struct Layout<16> { static constexpr int WM = 1, MT = 1; };
template <> struct Layout<32> { static constexpr int WM = 1, MT = 2; };
template <> struct Layout<64> { static constexpr int WM = 2, MT = 2; };
template <> struct Layout<128> { static constexpr int WM = 2, MT = 4; };

template <class W, int BM>
__global__ void __launch_bounds__(Layout<BM>::WM * 128)
grouped_matmul_kernel(const uint16_t* __restrict__ xs,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int r_total, int n_experts,
                      int n, int k) {
  using L = Layout<BM>;
  using S = Smem<W, BM>;
  constexpr int kThreads = L::WM * 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tile[4];  // expert, row0, rows, kind (0 mma, 1 zero)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  if (tid == 0) {
    // Walk the groups (offsets clamped non-decreasing, <= R) to this
    // CTA's row tile; the tiles after the last group zero the rows past
    // offsets[E]; the rest exit (kind 2).
    const int t = blockIdx.y;
    int cum = 0, prev = 0, kind = 2, e_t = 0, row0 = 0, rows = 0;
    for (int e = 0; e < n_experts; ++e) {
      const int end = min(max(offsets[e + 1], prev), r_total);
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
      if (row0 < r_total) {
        rows = min(BM, r_total - row0);
        kind = 1;
      }
    }
    tile[0] = e_t; tile[1] = row0; tile[2] = rows; tile[3] = kind;
  }
  __syncthreads();
  const int expert = tile[0], row0 = tile[1], rows = tile[2], kind = tile[3];
  if (kind == 2) return;
  if (kind == 1) {
    for (int i = tid; i < rows * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * n +
                                 n0 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  constexpr bool kInt4 = std::is_same<W, Int4W>::value;
  float* col_scale =
      reinterpret_cast<float*>(smem + kStages * S::kStageBytes +
                               S::kTileBytes);
  uint16_t* wtile =
      reinterpret_cast<uint16_t*>(smem + kStages * S::kStageBytes);
  // The columns' scales (e4m3: the one scale; int8: the expert's).
  if constexpr (std::is_same<W, E4M3W>::value) {
    for (int j = tid; j < kBN; j += kThreads) col_scale[j] = scale[0];
  } else if constexpr (std::is_same<W, Int8W>::value) {
    for (int j = tid; j < kBN; j += kThreads)
      col_scale[j] = scale[static_cast<size_t>(expert) * n + n0 + j];
  }

  const int n_stages = k / kKS;
  const size_t w_rows = kInt4 ? k / 2 : k;  // stored rows per expert
  const size_t esize = std::is_same<W, Bf16W>::value ? 2 : 1;
  const uint8_t* w_e = w + static_cast<size_t>(expert) * w_rows * n * esize;

  auto load_stage = [&](int s) {
    unsigned char* base = smem + (s % kStages) * S::kStageBytes;
    uint16_t* xst = reinterpret_cast<uint16_t*>(base);
    // x rows: 8 chunks of 8 bf16 per row; int4 stages take columns
    // [32 s, 32 s + 32) and [K/2 + 32 s, K/2 + 32 s + 32).
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      int col;
      if constexpr (kInt4)
        col = (c < 4 ? s * (kKS / 2) + c * 8
                     : k / 2 + s * (kKS / 2) + (c - 4) * 8);
      else
        col = s * kKS + c * 8;
      const bool live = r < rows;
      const uint16_t* src =
          live ? xs + static_cast<size_t>(row0 + r) * k + col : xs;
      cp_async16(xst + r * kXRow + c * 8, src, live ? 16 : 0);
    }
    unsigned char* raw = base + S::kXBytes;
    constexpr int kChunksPerRow =
        kBN * (std::is_same<W, Bf16W>::value ? 2 : 1) / 16;
    const size_t row_bytes = static_cast<size_t>(n) * esize;
    const size_t r_first = static_cast<size_t>(s) * W::kRawRows;
    for (int i = tid; i < W::kRawRows * kChunksPerRow; i += kThreads) {
      const int r = i / kChunksPerRow, c = i % kChunksPerRow;
      cp_async16(raw + r * W::kRawRowBytes + c * 16,
                 w_e + (r_first + r) * row_bytes + n0 * esize + c * 16);
    }
    if constexpr (kInt4) {
      float* sc = reinterpret_cast<float*>(raw + S::kRawBytes);
      const int groups = k / kGroup;
      const int g_lo = (s * (kKS / 2)) / kGroup;
      const int g_hi = (k / 2 + s * (kKS / 2)) / kGroup;
      for (int i = tid; i < 2 * (kBN / 4); i += kThreads) {
        const int h = i / (kBN / 4), c = i % (kBN / 4);
        const int g = h ? g_hi : g_lo;
        cp_async16(sc + h * kBN + c * 4,
                   scale + (static_cast<size_t>(expert) * groups + g) * n +
                       n0 + c * 4);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int mi = lane >> 3, ri = lane & 7;
  float acc[L::MT][4][4];
#pragma unroll
  for (int a = 0; a < L::MT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // The slot refilled here was last read in the previous stage, which
    // every thread has finished (the barrier above).
    if (s + kStages - 1 < n_stages) load_stage(s + kStages - 1);
    cp_async_commit();
    unsigned char* base = smem + (s % kStages) * S::kStageBytes;
    const uint16_t* xst = reinterpret_cast<const uint16_t*>(base);
    const unsigned char* raw = base + S::kXBytes;
    const uint16_t* wst;
    if constexpr (W::kConvert) {
      if constexpr (kInt4) {
        const float* sc = reinterpret_cast<const float*>(raw + S::kRawBytes);
        for (int i = tid; i < (kKS / 2) * (kBN / 16); i += kThreads) {
          const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
          convert16_int4(
              *reinterpret_cast<const uint4*>(raw + r * kBN + c), sc + c,
              sc + kBN + c, wtile + r * kWRow + c,
              wtile + (r + kKS / 2) * kWRow + c);
        }
      } else {
        for (int i = tid; i < kKS * (kBN / 16); i += kThreads) {
          const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
          convert16<W>(*reinterpret_cast<const uint4*>(raw + r * kBN + c),
                       col_scale + c, wtile + r * kWRow + c);
        }
      }
      __syncthreads();
      wst = wtile;
    } else {
      wst = reinterpret_cast<const uint16_t*>(raw);
    }
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      uint32_t b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_trans(b[i], wst + (kk * 16 + (mi & 1) * 8 + ri) * kWRow +
                                wn * 32 + i * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) {
        const int m0 = (wm * L::MT + mt) * 16;
        if (m0 >= rows) continue;  // warp-uniform: an m-tile of padding
        uint32_t a[4];
        ldsm_x4(a, xst + (m0 + (mi & 1) * 8 + ri) * kXRow + kk * 16 +
                       (mi >> 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a, b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator (mt, nt): rows m0 + lane / 4 (+ 8), columns
  // 8 nt + 2 (lane % 4) (+ 1) of the warp's 32.
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    const int m0 = (wm * L::MT + mt) * 16;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + (lane >> 2) + 8 * h;
        if (r < rows)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>(row0 + r) * n + col) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

template <class W, int BM>
cudaError_t launch_one(const void* xs, const void* w, const float* scale,
                       const int* offsets, float* out, int r, int e, int n,
                       int k, int row_tiles, cudaStream_t stream) {
  auto* kernel = grouped_matmul_kernel<W, BM>;
  constexpr int smem = Smem<W, BM>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n / kBN, row_tiles);
  kernel<<<grid, Layout<BM>::WM * 128, smem, stream>>>(
      static_cast<const uint16_t*>(xs), static_cast<const uint8_t*>(w),
      scale, offsets, out, r, e, n, k);
  return cudaGetLastError();
}

template <class W>
cudaError_t launch_bm(int bm, const void* xs, const void* w,
                      const float* scale, const int* offsets, float* out,
                      int r, int e, int n, int k, int row_tiles,
                      cudaStream_t stream) {
  switch (bm) {
    case 16:
      return launch_one<W, 16>(xs, w, scale, offsets, out, r, e, n, k,
                               row_tiles, stream);
    case 32:
      return launch_one<W, 32>(xs, w, scale, offsets, out, r, e, n, k,
                               row_tiles, stream);
    case 64:
      return launch_one<W, 64>(xs, w, scale, offsets, out, r, e, n, k,
                               row_tiles, stream);
    case 128:
      return launch_one<W, 128>(xs, w, scale, offsets, out, r, e, n, k,
                                row_tiles, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// w_format: 0 bf16, 1 e4m3, 2 int8, 3 packed int4.
// bm and row_tiles: the wrapper's launch_plan.
extern "C" int grouped_matmul_launch(const void* xs, const void* w,
                                     const void* scale, const void* offsets,
                                     void* out, int r, int e, int n, int k,
                                     int w_format, int bm, int row_tiles,
                                     void* stream) {
  if (e < 1 || e > kMaxExperts || n % kBN || k % kKS || r < 1 ||
      row_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_format < 0 || w_format > 3 || (w_format == 3 && k % (2 * kGroup)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w_format) {
    case 0:
      err = launch_bm<Bf16W>(bm, xs, w, s, off, o, r, e, n, k, row_tiles,
                             st);
      break;
    case 1:
      err = launch_bm<E4M3W>(bm, xs, w, s, off, o, r, e, n, k, row_tiles,
                             st);
      break;
    case 2:
      err = launch_bm<Int8W>(bm, xs, w, s, off, o, r, e, n, k, row_tiles,
                             st);
      break;
    default:
      err = launch_bm<Int4W>(bm, xs, w, s, off, o, r, e, n, k, row_tiles,
                             st);
  }
  return static_cast<int>(err);
}

// Paged attention kernels for Hopper (sm_90a): the ragged work-item
// kernel, the grouped uniform-decode kernel and the per-sequence decode
// kernel.
//
// Replaces (arcticinference_tpu/ops/pallas/ragged_attention.py):
//   ragged_paged_attention_kernel   (_ragged_attention_call / _attn_kernel,
//                                    with its use_tree branch; "kernel 1")
//   grouped_decode_attention_kernel (_grouped_decode_call /
//                                    _grouped_decode_kernel; kernels 2, 3)
//   decode_paged_attention_kernel   (_decode_attention_call /
//                                    _decode_kernel; "kernel 4")
//
// What bounds them on an H100.  A decode row does 4 flops per KV element
// it reads (2 for q.k, 2 for p.v) and a bf16 element is 2 bytes, so decode
// attention sits far below the card's ~295 flops/byte ridge: its floor is
// KV bytes / 3.35 TB/s.  Prefill rows share each page among up to
// qb * group query rows (128 at qb 32 and the 8B's group of 4), which puts
// a long prefill on the compute side: its floor is its flops over the
// tensor cores' 989 TFLOP/s.
//
// Kernel 1 (prefill, mixed and verify steps) runs on the tensor cores:
//   * One CTA per (work item, kv head), 8 warps.  Warp w owns a 16-row
//     m-tile of the item's rows (every q head of the GQA group, every
//     token), so a 128-row item reads each page once.  Its q rows live in
//     registers as mma.sync m16n8k16 A fragments for the whole pass.
//   * K and V are staged by blocks of four pages (128 slots) with
//     16-byte cp.async into padded shared memory, three stages deep, so
//     the copy of the next blocks overlaps the MMAs of this one.
//     Fragments come from ldmatrix (V with .trans).  fp8 pages are
//     converted to fp16 in shared memory once per block (exact: e4m3
//     fits fp16).
//   * S = q K^T stays in float32 accumulators; the causal and tree masks
//     and a base-2 online softmax are applied there (each row's max and
//     sum over the 4 lanes of a quad), and P goes from the accumulators
//     straight into the A fragments of P V.
//   * Precision: q and P each run as a 16-bit value plus the 16-bit
//     remainder (two MMAs each), in bf16 for bf16 pages and fp16 for fp8
//     pages.  Rounding q and P to bf16 once, as the TPU kernel does,
//     misses the 1e-3 relative-norm bound against the float32 plain
//     version on bf16 outputs; this scheme stays near 1e-4
//     (tests/test_torch_attention_numerics.py).
//   * Slots past the item's last position, and pages past its last page,
//     are never read: cp.async zero-fills their rows, so a masked P of 0
//     never meets a stale or NaN V.
//   * An item of at most four m-tiles (a decode row, a short chunk) puts
//     two or four warps on each tile, each taking its share of the pages
//     of every block, and merges their states at the end.  Items wider
//     than 128 rows take further passes over the pages.
//
// Token-tree verification (kernel 1's tree-mask path): a work item may
// carry the frontier slot ts of its request and, per window offset, an
// ancestor bitmask.  A row whose mask is non-zero attends kv slot ts + r
// (r in 1..31) iff bit r is set, and every slot up to ts as usual; rows
// with mask 0 stay causal.  The causal limit stays on slots (a tree node's
// ancestors all sit at lower slots than the node), so the page cut-offs
// need no change; the mask is applied in the accumulators with the causal
// one.
//
// Kernels 2 and 3 (pure-decode and verify steps of qlen rows per
// sequence; kernel 3 with the step's new K/V rows injected) read each KV
// byte of a sequence once per kv head and do 4 flops per element and q
// row: their floor is KV bytes / 3.35 TB/s.  Their first design (fp32 FMA
// on the CUDA cores, 4- or 8-row tiles, one page in flight per warp) took
// 2.2x that floor at qlen 1, 5.8x at qlen 4 and 11x for kernel 3 at qlen
// 8, where its tiles took further passes over the pages (H100 80GB HBM3 at
// 700 W; PERF.md).  This design:
//   * One CTA per (sequence, kv head), 4 warps per 16-row m-tile: one tile
//     for qlen * group <= 16 rows, two for <= 32, further passes beyond
//     (kernel 3 takes up to 32 rows per sequence).  Every q head of the
//     GQA group is a row, so at group 4 a CTA reads each page once at qlen
//     1, 4 and 8; q rows are staged once by cp.async and held in
//     registers as mma.sync A fragments.
//   * A sequence's slots are cut into 16-slot chunks; chunk c goes to page
//     stream c % 4 (warp c % 4 of each tile), and the four streams' states
//     merge in stream order at the end.  The stream count is a constant,
//     never derived from qlen or the row count, and a chunk a row does
//     not attend leaves its state bit for bit as it was (alpha = 1, P = 0,
//     explicitly rounded updates), so a row's output does not depend on
//     its row index or on qlen: the bench's distilled drafter is accepted
//     only because the target replays its captured trajectory bit for bit.
//   * Each stream runs its own cp.async pipeline (16-byte copies into
//     padded shared memory, three stages deep) with a named barrier of its
//     own; fp8 chunks are converted to fp16 once per stage.
//     At ~102 KiB two one-tile CTAs fit an SM, which short sequences (the
//     decode step at a few pages each) need to overlap their latencies.
//   * q.k and p.v by mma.sync m16n8k16 with float32 sums; the causal limit
//     and the mask of padding rows in the accumulators; a base-2 online
//     softmax; q and P split into hi + lo as in kernel 1.
//   * Slots past the CTA's last position, pages past the sequence's last
//     page and new rows past new_len are never read: cp.async zero-fills
//     them, so a masked P of 0 never meets a stale or NaN V.
//
// Deferred KV writes (kernel 3): the step's new K/V rows arrive as
// operands ([t, Hkv*D] in cache dtype, already divided by the layer's k/v
// scale like cache rows) and their cache slots are not written yet.  Each
// row then reads the cache only below its sequence's pos_base, and the
// sequence's new rows (at most 32) are staged as one or two more chunks
// after its last cache chunk: row i attends new row j iff j <= i's token
// index and j < new_len (the count of the sequence's rows whose slot is
// >= 0; padding is a tail of slot -1).  The caller scatters the rows into
// the cache once for the whole model after the layer stack.
//
// Kernel 4 computes kernel 2's function (no deferral) and is bound the
// same way: KV bytes / 3.35 TB/s.  Its first design (one CTA per sequence,
// fp32 FMA on the CUDA cores, one page in flight, warps re-reading every
// page per 8 (kv head, row tile) units, whole token rows staged) took
// 5.1x that floor at qlen 1 and 22.6x at qlen 8 (H100 80GB HBM3 at 700 W;
// PERF.md).  This design is kernel 2's CTA on a finer grid:
//   * One CTA per (sequence, kv head, page range).  A range is a fixed
//     number of pages R (range_pages, a constant of the wrapper, never
//     derived from B, qlen, the rows or the lengths), so a long sequence
//     spreads over many SMs instead of holding one to the end of the
//     launch: the tail of long sequences that idles kernel 2's SMs.
//   * Inside a CTA, kernel 2's 16-slot chunks on four page streams
//     (chunk c of the range to stream c % 4), three cp.async stages of
//     per-head slices (one head's D columns per token, so any Hkv * D
//     width is staged), fp8 converted to fp16 once per stage, q and P
//     split hi + lo, mma.sync m16n8k16 with float32 sums, every q head
//     of the GQA group a row of 16-row m-tiles: a range is read once for
//     all 32 rows of qlen 8 at group 4.
//   * A sequence whose rows attend one range writes its output from the
//     CTA.  Otherwise each range's CTA writes its rows' float32 states
//     (o, m, l) to scratch, and the last CTA of the (sequence, kv head)
//     to finish, found by a counter that it resets, merges them in range
//     order 0, 1, 2, ...: no float atomics, no order that depends on
//     which CTA finishes first.
//   * A range a row does not attend leaves an empty state, which the
//     merge skips; within a range a chunk the row does not attend leaves
//     its state bit for bit.  So a row's output is the same bits at any
//     qlen, as kernel 2's rows are.
//
// The layout contract is the JAX package's: cache [L, N, 2, 32, Hkv*D],
// q / out [T, Hq, D] bf16, block_tables [B, MaxBlk] int32.  block_size is 32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

constexpr int kPage = 32;        // tokens per page == lanes per warp
constexpr int kZeroTokens = 32;  // padding rows zeroed per extra CTA
constexpr float kNegInf = -__builtin_huge_valf();

// ---- element types -------------------------------------------------------

struct Bf16 {
  using T = uint16_t;
  static __device__ __forceinline__ uint16_t from_float(float f) {
    // Round to nearest even (finite inputs), as a bf16 cast does.
    uint32_t u = __float_as_uint(f);
    u += 0x7fffu + ((u >> 16) & 1u);
    return static_cast<uint16_t>(u >> 16);
  }
};

struct Fp8 {
  using T = uint8_t;
};

// 16-byte asynchronous copy to shared memory; with src_bytes < 16 the
// rest of the 16 bytes is filled with zeros (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// ---- kernel 1: ragged work items, on tensor cores --------------------------

// One CTA per (work item, kv head) with 8 warps; warp w owns the 16-row
// m-tile w % mt of the pass's mt tiles (row i of the item: token i / group
// under q head h * group + i % group), so a 32-token item at group 4 (128
// rows) reads its pages once.  An item of at most 4 tiles (a decode row,
// a short chunk) puts 2 or 4 warps ("splits") on each tile: split j takes
// the pages j, j + splits, ... of every staged block, and the states are
// merged at the end.
constexpr int kRWarps = 8;
constexpr int kRThreads = kRWarps * 32;
constexpr int kMTile = 16;                   // rows per warp (mma's m)
constexpr int kPassRows = kRWarps * kMTile;  // rows per pass over the pages
constexpr int kBlkPages = 4;                 // pages per pipeline stage
constexpr int kBlk = kBlkPages * kPage;      // kv slots per pipeline stage
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of kernel 1: kStages stages of one block (K rows, then V
// rows, each padded by 16 bytes so ldmatrix's 8 rows fall on distinct
// banks) and, for fp8 pages, the block converted to fp16 (same padded
// layout).  After the last block the same bytes hold the split warps'
// states for the merge.
template <class KV, int D>
struct RaggedSmem {
  static constexpr int kRawRow =
      D * static_cast<int>(sizeof(typename KV::T)) + 16;
  static constexpr int kRow16 = D + 8;  // 16-bit elements per compute row
  static constexpr int kStageBytes = 2 * kBlk * kRawRow;
  static constexpr bool kConvert = sizeof(typename KV::T) == 1;
  static constexpr int kConvBytes = kConvert ? 2 * kBlk * kRow16 * 2 : 0;
  static constexpr int kMergeFloats = D / 2 + 4;  // per lane: o, m[2], l[2]
  static constexpr int kMergeBytes = (kRWarps - 1) * kMergeFloats * 32 * 4;
  static constexpr int kBytes =
      std::max(kStages * kStageBytes + kConvBytes, kMergeBytes);
  // bf16 pages are read where they land: their staged rows are the
  // compute rows.
  static_assert(kConvert || kRawRow == 2 * kRow16, "row layout");
};

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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tensor-core type of each cache type: bf16 pages go to the MMAs as
// they are, fp8 pages are converted to fp16 (exact).  q and P are each
// split into the 16-bit value and the 16-bit remainder (two MMAs each);
// one 16-bit q or P misses the 1e-3 bound against the float32 plain
// version on bf16 outputs (tests/test_torch_attention_numerics.py models
// the scheme).
template <class KV> struct Mma;

template <> struct Mma<Bf16> {
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    return pack_bf16(a, b);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Mma<Fp8> {
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t fp8x2_to_half2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// One staged fp8 block (2 * kBlk rows of kRawRow bytes) to fp16 rows of
// kRow16 elements; 8 elements per thread and step.
template <int D>
__device__ __forceinline__ void convert_fp8_block(const unsigned char* raw,
                                                  uint16_t* dst) {
  using S = RaggedSmem<Fp8, D>;
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < 2 * kBlk * kPerRow; i += kRThreads) {
    const int row = i / kPerRow, c8 = i % kPerRow;
    const uint2 v =
        *reinterpret_cast<const uint2*>(raw + row * S::kRawRow + c8 * 8);
    uint4 h;
    h.x = fp8x2_to_half2(v.x & 0xffffu);
    h.y = fp8x2_to_half2(v.x >> 16);
    h.z = fp8x2_to_half2(v.y & 0xffffu);
    h.w = fp8x2_to_half2(v.y >> 16);
    *reinterpret_cast<uint4*>(dst + row * S::kRow16 + c8 * 8) = h;
  }
}

// Fold one 32-slot page of the staged block into a warp's state.  sk / sv:
// the page's K and V rows (16-bit, kRow16 apart); base: its first slot.
// The thread holds rows g and g + 8 of the warp's m-tile (hr = 0, 1) with
// causal limits pos[hr] (-1: no row) and ancestor bitmasks msk[hr] against
// the frontier slot ts.  full: every slot of the page is attended by
// every row (no mask to apply).  q.k and p.v run as m16n8k16 MMAs with
// float32 sums; S stays in the accumulators, the masks and the base-2
// online softmax are applied there (each row's max and sum over the 4
// lanes of a quad), and P goes from the accumulators straight into the
// A fragments of p.v.
template <class KV, int D>
__device__ __forceinline__ void fold_page_mma(
    const uint16_t* __restrict__ sk, const uint16_t* __restrict__ sv,
    int base, const int (&pos)[2], const unsigned (&msk)[2], int ts,
    bool full, const uint32_t (&qh)[D / 16][4],
    const uint32_t (&ql)[D / 16][4], float (&o)[D / 8][4], float (&m)[2],
    float (&l)[2]) {
  using M = Mma<KV>;
  constexpr int R = RaggedSmem<KV, D>::kRow16;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix, its row
  const int c2 = (lane & 3) * 2;
  float s[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  // S = q K^T: 4 n-tiles of 8 slots; one ldmatrix.x4 gives the B
  // fragments of two n-tiles for one 16-wide k-step.  Consecutive MMAs
  // go to different accumulators.
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[2][4];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4(b[np], sk + ((np * 2 + (mi >> 1)) * 8 + ri) * R + kk * 16 +
                         (mi & 1) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      M::mma(s[nt], qh[kk], b[nt >> 1][(nt & 1) * 2],
             b[nt >> 1][(nt & 1) * 2 + 1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      M::mma(s[nt], ql[kk], b[nt >> 1][(nt & 1) * 2],
             b[nt >> 1][(nt & 1) * 2 + 1]);
  }
  if (!full) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = base + nt * 8 + c2 + (e & 1);
        const int hr = e >> 1;
        bool ok = slot <= pos[hr];
        const int rel = slot - ts;  // slot past the frontier
        if (msk[hr] != 0u && rel >= 1)
          ok = rel < 32 && ((msk[hr] >> rel) & 1u);
        if (!ok) s[nt][e] = kNegInf;
      }
  }
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    // m_use: a row with nothing attended yet keeps exp2(-inf) = 0.
    const float m_use = m_new == kNegInf ? 0.f : m_new;
    alpha[hr] = fast_exp2(m[hr] - m_use);
    m[hr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        s[nt][e] = fast_exp2(s[nt][e] - m_use);
        sum += s[nt][e];
      }
    l[hr] = l[hr] * alpha[hr] + sum;  // this lane's part; quad-summed later
  }
  // O is rescaled only when some row's max moved (once a row has met its
  // largest scores, most pages leave it alone).
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
  }
  // O += P V: two 16-slot k-steps; one ldmatrix.x4.trans gives the B
  // fragments of two 8-wide d tiles.
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const float* x0 = s[2 * kv];
    const float* x1 = s[2 * kv + 1];
    const float pv[4][2] = {{x0[0], x0[1]}, {x0[2], x0[3]},
                            {x1[0], x1[1]}, {x1[2], x1[3]}};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ph[j] = M::pack(pv[j][0], pv[j][1]);
      const float2 hf = M::unpack(ph[j]);
      pl[j] = M::pack(pv[j][0] - hf.x, pv[j][1] - hf.y);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; dp += 2) {
      uint32_t b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_trans(b[i], sv + (kv * 16 + (mi & 1) * 8 + ri) * R +
                                (dp + i) * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        M::mma(o[2 * dp + n], ph, b[n >> 1][(n & 1) * 2],
               b[n >> 1][(n & 1) * 2 + 1]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        M::mma(o[2 * dp + n], pl, b[n >> 1][(n & 1) * 2],
               b[n >> 1][(n & 1) * 2 + 1]);
    }
  }
}

template <class KV, int D>
__global__ void __launch_bounds__(kRThreads, 1) ragged_attention_kernel(
    const uint16_t* __restrict__ q, uint16_t* __restrict__ out,
    const typename KV::T* __restrict__ kv, const float* __restrict__ kv_scale,
    const int* __restrict__ item_req, const int* __restrict__ item_qstart,
    const int* __restrict__ item_qlen, const int* __restrict__ item_pages,
    const int* __restrict__ item_pos_base,
    const int* __restrict__ token_item, const int* __restrict__ req_idx,
    const int* __restrict__ block_tables,
    const int* __restrict__ item_tree_start,
    const int* __restrict__ item_tree_mask, int tree_qw, int layer,
    int n_items, int t, int hq, int hkv, int max_blk, int64_t layer_stride,
    float scale) {
  using E = typename KV::T;
  using M = Mma<KV>;
  using S = RaggedSmem<KV, D>;
  constexpr int KS = D / 16;  // k-steps of q.k
  constexpr int NT = D / 8;   // d tiles of p.v
  extern __shared__ __align__(16) unsigned char smem1[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y;
  const int group = hq / hkv;
  if (blockIdx.x >= n_items) {
    // Padding tokens (req_idx < 0) belong to no item: zero them here.
    const int t0 = (blockIdx.x - n_items) * kZeroTokens;
    for (int idx = tid; idx < kZeroTokens * group * D; idx += kRThreads) {
      const int tok = t0 + idx / (group * D);
      if (tok < t && req_idx[tok] < 0)
        out[(int64_t)tok * hq * D + h * group * D + idx % (group * D)] =
            Bf16::from_float(0.f);
    }
    return;
  }
  // Items in reverse: a request's later chunks attend more slots, so the
  // longest CTAs start first and the short ones fill the tail.
  const int item = n_items - 1 - blockIdx.x;
  const int qlen = item_qlen[item];
  if (qlen <= 0) return;
  // The host schedule aligns each item's window start down to a multiple
  // of 8 (a TPU tiling artefact kept for parity of the schedule arrays);
  // the item's first real token is the first window row it owns.
  const int qstart = item_qstart[item];
  int o0 = 0;
  while (o0 < 7 && qstart + o0 < t && token_item[qstart + o0] != item) ++o0;
  const int tok0 = qstart + o0;
  const int pos0 = item_pos_base[item] + o0;  // cache slot of token 0
  const int ntok = min(qlen, t - tok0);
  if (ntok <= 0) return;
  // Token-tree verification: the mask is indexed by window offset (row 0
  // of the window is the 8-aligned qstart, token 0 sits at offset o0).  A
  // row with a non-zero mask attends slot ts + r (r in 1..31) iff bit r is
  // set, and every slot up to ts as usual; the causal limit stays on
  // slots (a node's ancestors sit at lower slots than the node).
  const int* tmask = nullptr;
  int ts = -1;
  if (item_tree_mask != nullptr && item_tree_start[item] >= 0) {
    tmask = item_tree_mask + (int64_t)item * tree_qw + o0;
    ts = item_tree_start[item];
  }
  const int npages = min(item_pages[item], max_blk);
  const int* page_row = block_tables + (int64_t)item_req[item] * max_blk;
  const E* kv_layer = kv + layer * layer_stride;
  // k_scale (and log2 e, for exp2) folded into q, v_scale into the output.
  const float qs = scale * kv_scale[2 * layer] * kLog2e;
  const float v_scale = kv_scale[2 * layer + 1];
  const int hkv_d = hkv * D;
  const int nrows = ntok * group;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  for (int row0 = 0; row0 < nrows; row0 += kPassRows) {
    const int rows = min(kPassRows, nrows - row0);
    const int mt = (rows + kMTile - 1) / kMTile;
    int splits = 1;
    while (splits < kBlkPages && 2 * splits * mt <= kRWarps) splits *= 2;
    const int split = warp / mt;
    const bool active = split < splits;
    const int rbase = row0 + (warp % mt) * kMTile + g;  // rows rbase, +8
    int pos[2];
    unsigned msk[2];
    int wfirst = INT_MAX, wlast = -1;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rbase + 8 * hr;
      const bool live = active && r < row0 + rows;
      pos[hr] = live ? pos0 + r / group : -1;
      msk[hr] = (live && tmask != nullptr)
                    ? static_cast<unsigned>(tmask[r / group])
                    : 0u;
      if (live) wfirst = min(wfirst, pos[hr]);
      wlast = max(wlast, pos[hr]);
    }
    unsigned wtree = msk[0] | msk[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      wfirst = min(wfirst, __shfl_xor_sync(0xffffffffu, wfirst, off));
      wlast = max(wlast, __shfl_xor_sync(0xffffffffu, wlast, off));
      wtree |= __shfl_xor_sync(0xffffffffu, wtree, off);
    }

    // q rows as A fragments, scaled and split into hi + lo: register j of
    // k-step kk holds d = 16 kk + c2 + 8 (j / 2) of row rbase + 8 (j % 2).
    uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hr = j & 1, r = rbase + 8 * hr;
        float2 x = make_float2(0.f, 0.f);
        if (pos[hr] >= 0) {
          const uint32_t raw = *reinterpret_cast<const uint32_t*>(
              q + (int64_t)(tok0 + r / group) * hq * D +
              (h * group + r % group) * D + kk * 16 + c2 + (j >> 1) * 8);
          x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw));
          x.x *= qs;
          x.y *= qs;
        }
        qh[kk][j] = M::pack(x.x, x.y);
        const float2 hf = M::unpack(qh[kk][j]);
        ql[kk][j] = M::pack(x.x - hf.x, x.y - hf.y);
      }
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // Slots past the pass's last position (and past the item's pages) are
    // never read: cp.async fills their rows with zeros, so a masked P of 0
    // never meets a stale or NaN V.
    const int last_slot =
        min(pos0 + (row0 + rows - 1) / group, npages * kPage - 1);
    const int nblk = last_slot / kBlk + 1;
    auto load = [&](int blk) {
      unsigned char* dst = smem1 + (blk % kStages) * S::kStageBytes;
      constexpr int kChunks = D * static_cast<int>(sizeof(E)) / 16;
      for (int i = tid; i < 2 * kBlk * kChunks; i += kRThreads) {
        const int row = i / kChunks, ch = i % kChunks;  // K rows, V rows
        const int half = row / kBlk, slot = blk * kBlk + row % kBlk;
        const bool ok = slot <= last_slot;
        const E* src = kv_layer;
        if (ok)
          src += ((int64_t)(page_row[slot / kPage] * 2 + half) * kPage +
                  slot % kPage) * hkv_d + h * D + ch * (16 / sizeof(E));
        cp_async16(dst + row * S::kRawRow + ch * 16, src, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nblk) load(st);
      cp_async_commit();
    }
    for (int blk = 0; blk < nblk; ++blk) {
      if (blk + kStages - 1 < nblk) load(blk + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const unsigned char* staged = smem1 + (blk % kStages) * S::kStageBytes;
      const uint16_t* tile = reinterpret_cast<const uint16_t*>(staged);
      if constexpr (S::kConvert) {
        uint16_t* conv = reinterpret_cast<uint16_t*>(
            smem1 + kStages * S::kStageBytes);
        convert_fp8_block<D>(staged, conv);
        __syncthreads();
        tile = conv;
      }
      if (active) {
#pragma unroll 1
        for (int pp = 0; pp < kBlkPages; ++pp) {
          const int base = blk * kBlk + pp * kPage;
          if (pp % splits != split || base > wlast) continue;
          // No mask where every row attends the whole page and no tree
          // row's override window (ts, ts + 31] meets it.
          const bool full =
              base + kPage - 1 <= wfirst &&
              !(wtree != 0u && base + kPage - 1 > ts && base <= ts + 31);
          fold_page_mma<KV, D>(tile + pp * kPage * S::kRow16,
                               tile + (kBlk + pp * kPage) * S::kRow16, base,
                               pos, msk, ts, full, qh, ql, o, m, l);
        }
      }
      __syncthreads();  // the stage (and the fp8 buffer) is free again
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
    if (splits > 1) {
      // Splits 1.. hand their states to split 0 of the same m-tile through
      // shared memory (one float per lane and value: no bank conflict).
      float* mg0 = reinterpret_cast<float*>(smem1) +
                   (warp % mt) * S::kMergeFloats * 32 + lane;
      const int stride = mt * S::kMergeFloats * 32;  // from split to split
      if (active && split > 0) {
        float* mg = mg0 + (split - 1) * stride;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mg[(n * 4 + e) * 32] = o[n][e];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mg[(D / 2 + hr) * 32] = m[hr];
          mg[(D / 2 + 2 + hr) * 32] = l[hr];
        }
      }
      __syncthreads();
      for (int j = 1; active && split == 0 && j < splits; ++j) {
        const float* mg = mg0 + (j - 1) * stride;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float m1 = mg[(D / 2 + hr) * 32];
          const float l1 = mg[(D / 2 + 2 + hr) * 32];
          const float mx = fmaxf(m[hr], m1);
          const float mu = mx == kNegInf ? 0.f : mx;
          const float f0 = fast_exp2(m[hr] - mu), f1 = fast_exp2(m1 - mu);
          m[hr] = mx;
          l[hr] = l[hr] * f0 + l1 * f1;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e)
              o[n][e] = o[n][e] * f0 + mg[(n * 4 + e) * 32] * f1;
        }
      }
    }
    if (active && split == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = rbase + 8 * hr;
        if (pos[hr] < 0) continue;
        const float f = v_scale / fmaxf(l[hr], 1e-20f);
        uint16_t* orow = out + (int64_t)(tok0 + r / group) * hq * D +
                         (h * group + r % group) * D + c2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[n][2 * hr] * f, o[n][2 * hr + 1] * f);
      }
    }
    __syncthreads();  // the next pass reuses the shared memory
  }
}

// ---- kernels 2 and 3: grouped uniform decode, on tensor cores ---------------

// Page streams: a sequence's slots are cut into chunks of 16 (half a
// page), and chunk c goes to stream c % 4, a constant of the kernel
// (never derived from qlen or the row count).  A stage holds one chunk
// of each stream: K rows, then V rows, in kernel 1's padded row layout.
constexpr int kGStreams = 4;
constexpr int kGChunk = 16;
constexpr int kGStageRows = 2 * kGStreams * kGChunk;

// Shared memory of kernels 2 and 3: kStages stages, the fp16 buffer of a
// stage for fp8 pages and, after the last chunk, the states of streams
// 1..3 of each tile.  ~102 KiB at D=128 in bf16: two one-tile CTAs fit an
// SM, so short sequences (a few pages each) overlap their latencies.
template <class KV, int D, int TILES>
struct GroupedSmem {
  using R = RaggedSmem<KV, D>;
  static constexpr int kStageBytes = kGStageRows * R::kRawRow;
  static constexpr int kConvBytes =
      R::kConvert ? kGStageRows * R::kRow16 * 2 : 0;
  static constexpr int kMergeFloats = D / 2 + 4;  // per lane: o, m[2], l[2]
  static constexpr int kBytes =
      std::max(kStages * kStageBytes + kConvBytes,
               (kGStreams - 1) * TILES * kMergeFloats * 32 * 4);
  // A pass's q rows are staged in the last stage before the main loop.
  static_assert(TILES * kMTile * R::kRow16 * 2 <= kStageBytes, "q rows");
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One stream's staged fp8 chunk (its 16 K and 16 V rows) to fp16 rows in
// the same places of the fp16 buffer, by the stream's TILES warps.
template <int D, int TILES>
__device__ __forceinline__ void convert_fp8_chunk(const unsigned char* raw,
                                                  uint16_t* dst, int stream) {
  using S = RaggedSmem<Fp8, D>;
  constexpr int kPerRow = D / 8;
  const int t = (threadIdx.x >> 5) / kGStreams * 32 + (threadIdx.x & 31);
#pragma unroll 4
  for (int i = t; i < 2 * kGChunk * kPerRow; i += TILES * 32) {
    const int r = i / kPerRow, c8 = i % kPerRow;
    const int row =
        (r / kGChunk) * kGStreams * kGChunk + stream * kGChunk + r % kGChunk;
    const uint2 v =
        *reinterpret_cast<const uint2*>(raw + row * S::kRawRow + c8 * 8);
    uint4 h;
    h.x = fp8x2_to_half2(v.x & 0xffffu);
    h.y = fp8x2_to_half2(v.x >> 16);
    h.z = fp8x2_to_half2(v.y & 0xffffu);
    h.w = fp8x2_to_half2(v.y >> 16);
    *reinterpret_cast<uint4*>(dst + row * S::kRow16 + c8 * 8) = h;
  }
}

// Fold one 16-slot chunk into a warp's state (kernels 2 and 3): q.k and
// p.v as m16n8k16 MMAs with float32 sums, q and P as their 16-bit value
// and remainder; the mask and a base-2 online softmax in the
// accumulators, each row's max and sum over the 4 lanes of a quad.  Every
// update of the state is rounded explicitly (no contraction left to the
// compiler, so each instance of the kernel computes a row alike), and a
// row whose max does not move keeps alpha = 1: a chunk the row does not
// attend (P = 0 against finite V) leaves its state bit for bit as it was.
// The thread holds rows g and g + 8 of the warp's m-tile; row hr attends
// slots base.. up to lim[hr] (-1: none).  full: every row attends every
// slot of the chunk.
template <class KV, int D>
__device__ __forceinline__ void fold_chunk_grouped(
    const uint16_t* __restrict__ sk, const uint16_t* __restrict__ sv,
    int base, const int (&lim)[2], bool full,
    const uint32_t (&qh)[D / 16][4], const uint32_t (&ql)[D / 16][4],
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2]) {
  using M = Mma<KV>;
  constexpr int R = RaggedSmem<KV, D>::kRow16;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix, its row
  const int c2 = (lane & 3) * 2;
  // S = q K^T: two n-tiles of 8 slots; one ldmatrix.x4 gives both B
  // fragments of a 16-wide k-step.
  float s[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, sk + ((mi >> 1) * 8 + ri) * R + kk * 16 + (mi & 1) * 8);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      M::mma(s[nt], qh[kk], b[nt * 2], b[nt * 2 + 1]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      M::mma(s[nt], ql[kk], b[nt * 2], b[nt * 2 + 1]);
  }
  if (!full) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (base + nt * 8 + c2 + (e & 1) > lim[e >> 1]) s[nt][e] = kNegInf;
  }
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = fmaxf(fmaxf(s[0][2 * hr], s[0][2 * hr + 1]),
                     fmaxf(s[1][2 * hr], s[1][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    // m_use: a row with nothing attended yet keeps exp2(-inf) = 0.
    const float m_use = m_new == kNegInf ? 0.f : m_new;
    alpha[hr] = m_new == m[hr] ? 1.f : fast_exp2(__fsub_rn(m[hr], m_use));
    m[hr] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        s[nt][e] = fast_exp2(__fsub_rn(s[nt][e], m_use));
        sum = __fadd_rn(sum, s[nt][e]);
      }
    l[hr] = __fmaf_rn(l[hr], alpha[hr], sum);  // quad-summed at the end
  }
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], alpha[e >> 1]);
  }
  // O += P V: one 16-slot k-step; one ldmatrix.x4.trans gives the B
  // fragments of two 8-wide d tiles.
  const float pv[4][2] = {{s[0][0], s[0][1]}, {s[0][2], s[0][3]},
                          {s[1][0], s[1][1]}, {s[1][2], s[1][3]}};
  uint32_t ph[4], pl[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ph[j] = M::pack(pv[j][0], pv[j][1]);
    const float2 hf = M::unpack(ph[j]);
    pl[j] = M::pack(__fsub_rn(pv[j][0], hf.x), __fsub_rn(pv[j][1], hf.y));
  }
#pragma unroll
  for (int dp = 0; dp < D / 16; dp += 2) {
    uint32_t b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4_trans(b[i], sv + ((mi & 1) * 8 + ri) * R + (dp + i) * 16 +
                              (mi >> 1) * 8);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      M::mma(o[2 * dp + n], ph, b[n >> 1][(n & 1) * 2],
             b[n >> 1][(n & 1) * 2 + 1]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      M::mma(o[2 * dp + n], pl, b[n >> 1][(n & 1) * 2],
             b[n >> 1][(n & 1) * 2 + 1]);
  }
}

// One CTA per (sequence, kv head), 4 * TILES warps: warp w is page stream
// w % 4 of m-tile w / 4.  Row i of the (sequence, kv head) is token i /
// group under q head h * group + i % group; a pass covers 16 * TILES rows.
template <class KV, int D, int TILES>
__global__ void __launch_bounds__(kGStreams * TILES * 32, 2 / TILES)
    grouped_decode_kernel(
        const uint16_t* __restrict__ q, uint16_t* __restrict__ out,
        const typename KV::T* __restrict__ kv,
        const float* __restrict__ kv_scale, const int* __restrict__ pos_base,
        const int* __restrict__ seq_lens,
        const int* __restrict__ block_tables,
        const typename KV::T* __restrict__ knew,
        const typename KV::T* __restrict__ vnew,
        const int* __restrict__ slot_mapping, int layer, int b, int t,
        int qlen, int hq, int hkv, int max_blk, int64_t layer_stride,
        float scale) {
  using E = typename KV::T;
  using M = Mma<KV>;
  using S = RaggedSmem<KV, D>;
  using G = GroupedSmem<KV, D, TILES>;
  constexpr int kThreadsG = kGStreams * TILES * 32;
  constexpr int KS = D / 16;  // k-steps of q.k
  constexpr int NT = D / 8;   // d tiles of p.v
  extern __shared__ __align__(16) unsigned char smem2[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stream = warp % kGStreams, tile = warp / kGStreams;
  const int seq = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int tok0 = seq * qlen;
  // Sequence slots past b (the token bucket is wider than b * qlen) and
  // dead slots (seq_lens == 0) read no page: their rows come out zero.
  const int ntok = min(qlen, t - tok0);
  if (ntok <= 0) return;
  const int nrows = ntok * group;
  if (seq >= b || seq_lens[seq] <= 0) {
    for (int idx = tid; idx < nrows * D; idx += kThreadsG) {
      const int i = idx / D;
      out[(int64_t)(tok0 + i / group) * hq * D + (h * group + i % group) * D +
          idx % D] = 0;
    }
    return;
  }
  // No page past the block table's row (a step near max_model_len gives
  // its rows past the limit a longer seq_len).
  const int npages = min((seq_lens[seq] + kPage - 1) / kPage, max_blk);
  const int pos0 = pos_base[seq];
  const int* page_row = block_tables + (int64_t)seq * max_blk;
  const E* kv_layer = kv + layer * layer_stride;
  const bool deferred = knew != nullptr;
  // new_len: the sequence's rows with a real slot (rows past t are
  // padding, as the JAX dispatch pads slot_mapping with -1).
  int new_len = 0;
  for (int j = 0; deferred && j < qlen; ++j)
    new_len += tok0 + j < t && slot_mapping[tok0 + j] >= 0;
  // The last cache slot any row reads (with deferred writes: the one
  // before pos_base) and the chunks holding it; with deferred writes the
  // new rows follow as one or two more chunks.
  const int last_slot =
      min(deferred ? pos0 - 1 : pos0 + ntok - 1, npages * kPage - 1);
  const int ncc = last_slot < 0 ? 0 : last_slot / kGChunk + 1;
  const int nch = ncc + (new_len + kGChunk - 1) / kGChunk;
  // Each stream runs its own pipeline over its chunks 4 k + stream, k = 0,
  // 1, ..., kStages deep; its warps (one per tile) meet at a named barrier
  // of their own, so no stream waits for another.
  const int nk = nch > stream ? (nch - stream - 1) / kGStreams + 1 : 0;
  const int bar = 1 + stream;
  // k_scale (and log2 e, for exp2) folded into q, v_scale into the output.
  const float qs = __fmul_rn(__fmul_rn(scale, kv_scale[2 * layer]), kLog2e);
  const float v_scale = kv_scale[2 * layer + 1];
  const int hkv_d = hkv * D;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  // Chunk k of this stream into stage k % kStages.  Slots past last_slot,
  // new rows past new_len and chunks past the last are never read:
  // cp.async fills their rows with zeros, so a masked P of 0 never meets
  // a stale or NaN V.
  auto load = [&](int k) {
    const int c = k * kGStreams + stream;
    unsigned char* dst = smem2 + (k % kStages) * G::kStageBytes;
    constexpr int kChunks = D * static_cast<int>(sizeof(E)) / 16;
    constexpr int kElems = 16 / static_cast<int>(sizeof(E));
    // The chunk's first K and V row of head h and its rows to read.
    const E* kb = kv_layer;
    const E* vb = kv_layer;
    int n_ok = 0;
    if (c < ncc) {
      kb += ((int64_t)page_row[c / 2] * 2 * kPage + (c % 2) * kGChunk) *
                hkv_d + h * D;
      vb = kb + kPage * hkv_d;
      n_ok = min(kGChunk, last_slot - c * kGChunk + 1);
    } else if (c < nch) {
      const int j0 = (c - ncc) * kGChunk;
      kb = knew + (int64_t)(tok0 + j0) * hkv_d + h * D;
      vb = vnew + (int64_t)(tok0 + j0) * hkv_d + h * D;
      n_ok = min(kGChunk, new_len - j0);
    }
#pragma unroll 4
    for (int i = tile * 32 + lane; i < 2 * kGChunk * kChunks;
         i += TILES * 32) {
      const int row = i / kChunks, ch = i % kChunks;  // K rows, V rows
      const int j = row % kGChunk;
      const bool ok = j < n_ok;
      const E* src = row < kGChunk ? kb : vb;
      if (ok) src += (int64_t)j * hkv_d + ch * kElems;
      cp_async16(dst + ((row / kGChunk) * kGStreams * kGChunk +
                        stream * kGChunk + j) * S::kRawRow + ch * 16,
                 src, ok ? 16 : 0);
    }
  };

  for (int row0 = 0; row0 < nrows; row0 += TILES * kMTile) {
    // The pass's q rows (zeros past the last row) go to the last stage,
    // free until the main loop's first load, with the first chunk.
    uint16_t* sq = reinterpret_cast<uint16_t*>(
        smem2 + (kStages - 1) * G::kStageBytes);
    for (int i = tid; i < TILES * kMTile * (D / 8); i += kThreadsG) {
      const int r = i / (D / 8), ch = i % (D / 8), row = row0 + r;
      const uint16_t* src = q;
      if (row < nrows)
        src += ((int64_t)(tok0 + row / group) * hq + h * group +
                row % group) * D + ch * 8;
      cp_async16(sq + r * S::kRow16 + ch * 8, src, row < nrows ? 16 : 0);
    }
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) load(st);
      cp_async_commit();
    }
    // This thread's rows rbase and rbase + 8: lim[hr], the last cache
    // slot the row attends, and nlim[hr], the last new row (-1: none).
    const int rbase = row0 + tile * kMTile + g;
    bool live[2];
    int lim[2], nlim[2];
    int wfirst = INT_MAX, wlast = -1, nlast = -1;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rbase + 8 * hr;
      live[hr] = r < nrows;
      lim[hr] = !live[hr] ? -1 : deferred ? pos0 - 1 : pos0 + r / group;
      nlim[hr] = live[hr] ? min(r / group, new_len - 1) : -1;
      if (live[hr]) wfirst = min(wfirst, lim[hr]);
      wlast = max(wlast, lim[hr]);
      nlast = max(nlast, nlim[hr]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      wfirst = min(wfirst, __shfl_xor_sync(0xffffffffu, wfirst, off));
      wlast = max(wlast, __shfl_xor_sync(0xffffffffu, wlast, off));
      nlast = max(nlast, __shfl_xor_sync(0xffffffffu, nlast, off));
    }

    // q rows as A fragments (ldmatrix), scaled and split into hi + lo:
    // register j of k-step kk holds d = 16 kk + c2 + 8 (j / 2) of row
    // rbase + 8 (j % 2).
    cp_async_wait<kStages - 2>();
    __syncthreads();
    uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t raw[4];
      const int mi = lane >> 3, ri = lane & 7;
      ldsm_x4(raw, sq + (tile * kMTile + (mi & 1) * 8 + ri) * S::kRow16 +
                       kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw[j]));
        x.x = __fmul_rn(x.x, qs);
        x.y = __fmul_rn(x.y, qs);
        qh[kk][j] = M::pack(x.x, x.y);
        const float2 hf = M::unpack(qh[kk][j]);
        ql[kk][j] = M::pack(__fsub_rn(x.x, hf.x), __fsub_rn(x.y, hf.y));
      }
    }
    __syncthreads();  // the last stage is the main loop's again
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int k = 0; k < nk; ++k) {
      if (k + kStages - 1 < nk) load(k + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      named_barrier(bar, TILES * 32);
      const unsigned char* staged = smem2 + (k % kStages) * G::kStageBytes;
      const uint16_t* tile16 = reinterpret_cast<const uint16_t*>(staged);
      if constexpr (S::kConvert) {
        uint16_t* conv = reinterpret_cast<uint16_t*>(
            smem2 + kStages * G::kStageBytes);
        convert_fp8_chunk<D, TILES>(staged, conv, stream);
        named_barrier(bar, TILES * 32);
        tile16 = conv;
      }
      const int c = k * kGStreams + stream;
      const uint16_t* sk = tile16 + stream * kGChunk * S::kRow16;
      const uint16_t* sv =
          tile16 + (kGStreams + stream) * kGChunk * S::kRow16;
      if (c < ncc) {
        const int base = c * kGChunk;
        if (base <= wlast)
          fold_chunk_grouped<KV, D>(sk, sv, base, lim,
                                    base + kGChunk - 1 <= wfirst, qh, ql, o,
                                    m, l);
      } else if (nlast >= (c - ncc) * kGChunk) {
        // New rows (c - ncc) * 16 ..: row r attends new row j iff j <= its
        // token index and j < new_len.
        fold_chunk_grouped<KV, D>(sk, sv, (c - ncc) * kGChunk, nlim, false,
                                  qh, ql, o, m, l);
      }
      named_barrier(bar, TILES * 32);  // the stage is free again
    }
    cp_async_wait<0>();
    __syncthreads();  // every stream is done with the stages

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] = __fadd_rn(l[hr], __shfl_xor_sync(0xffffffffu, l[hr], 1));
      l[hr] = __fadd_rn(l[hr], __shfl_xor_sync(0xffffffffu, l[hr], 2));
    }
    // Streams 1..3 hand their states to stream 0 of the same tile, which
    // merges them in stream order (one float per lane and value).
    float* mg0 = reinterpret_cast<float*>(smem2) +
                 tile * G::kMergeFloats * 32 + lane;
    constexpr int kStride = TILES * G::kMergeFloats * 32;  // stream to stream
    if (stream > 0) {
      float* mg = mg0 + (stream - 1) * kStride;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mg[(n * 4 + e) * 32] = o[n][e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mg[(D / 2 + hr) * 32] = m[hr];
        mg[(D / 2 + 2 + hr) * 32] = l[hr];
      }
    }
    __syncthreads();
    if (stream == 0) {
      for (int j = 1; j < kGStreams; ++j) {
        const float* mg = mg0 + (j - 1) * kStride;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float m1 = mg[(D / 2 + hr) * 32];
          const float l1 = mg[(D / 2 + 2 + hr) * 32];
          const float mx = fmaxf(m[hr], m1);
          const float mu = mx == kNegInf ? 0.f : mx;
          const float f0 =
              m[hr] == mx ? 1.f : fast_exp2(__fsub_rn(m[hr], mu));
          const float f1 = m1 == mx ? 1.f : fast_exp2(__fsub_rn(m1, mu));
          m[hr] = mx;
          l[hr] = __fmaf_rn(l[hr], f0, __fmul_rn(l1, f1));
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e)
              o[n][e] =
                  __fmaf_rn(o[n][e], f0, __fmul_rn(mg[(n * 4 + e) * 32], f1));
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!live[hr]) continue;
        const int r = rbase + 8 * hr;
        const float f = __fdiv_rn(v_scale, fmaxf(l[hr], 1e-20f));
        uint16_t* orow = out + (int64_t)(tok0 + r / group) * hq * D +
                         (h * group + r % group) * D + c2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(__fmul_rn(o[n][2 * hr], f),
                        __fmul_rn(o[n][2 * hr + 1], f));
      }
    }
    __syncthreads();  // the next pass reuses the shared memory
  }
}

// ---- kernel 4: split over fixed page ranges, on tensor cores ----------------

// One CTA per (sequence, kv head, range): blockIdx (seq, h, r), range r
// covering pages [r * R, (r + 1) * R), R = range_pages.  The CTA is kernel
// 2's (4 * TILES warps, warp w page stream w % 4 of m-tile w / 4), chunk
// c of the range going to stream c % 4.  Range r's state of row i of the
// (sequence, kv head) lies at part + (((seq * hkv + h) * n_ranges + r) *
// rows_cap + i) * (D + kPartPad): o [D], m, l.
constexpr int kPartPad = 4;  // floats after a row's o in `part`: m, l, pad

template <class KV, int D, int TILES>
__global__ void __launch_bounds__(kGStreams * TILES * 32, 2 / TILES)
    decode_range_kernel(
        const uint16_t* __restrict__ q, uint16_t* __restrict__ out,
        const typename KV::T* __restrict__ kv,
        const float* __restrict__ kv_scale, const int* __restrict__ pos_base,
        const int* __restrict__ seq_lens,
        const int* __restrict__ block_tables, float* __restrict__ part,
        int* __restrict__ counter, int layer, int b, int t, int qlen, int hq,
        int hkv, int max_blk, int64_t layer_stride, int range_pages,
        int n_ranges, float scale) {
  using E = typename KV::T;
  using M = Mma<KV>;
  using S = RaggedSmem<KV, D>;
  using G = GroupedSmem<KV, D, TILES>;
  constexpr int kThreadsG = kGStreams * TILES * 32;
  constexpr int KS = D / 16;  // k-steps of q.k
  constexpr int NT = D / 8;   // d tiles of p.v
  constexpr int kPartRow = D + kPartPad;
  extern __shared__ __align__(16) unsigned char smem4[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stream = warp % kGStreams, tile = warp / kGStreams;
  const int seq = blockIdx.x, h = blockIdx.y, range = blockIdx.z;
  const int group = hq / hkv;
  const int tok0 = seq * qlen;
  // Sequence slots past b (the token bucket is wider than b * qlen) and
  // dead slots (seq_lens == 0) read no page: range 0 zeroes their rows.
  const int ntok = min(qlen, t - tok0);
  if (ntok <= 0) return;
  const int nrows = ntok * group;
  if (seq >= b || seq_lens[seq] <= 0) {
    for (int idx = tid; range == 0 && idx < nrows * D; idx += kThreadsG) {
      const int i = idx / D;
      out[(int64_t)(tok0 + i / group) * hq * D + (h * group + i % group) * D +
          idx % D] = 0;
    }
    return;
  }
  // No page past the block table's row (a step near max_model_len gives
  // its rows past the limit a longer seq_len).
  const int npages = min((seq_lens[seq] + kPage - 1) / kPage, max_blk);
  const int pos0 = pos_base[seq];
  // The last slot any row attends, the chunks up to it and the ranges
  // holding them (ops/cuda/ragged_attention.py: range_plan).
  const int last_slot = min(pos0 + ntok - 1, npages * kPage - 1);
  const int ncc = last_slot / kGChunk + 1;
  const int nr = (last_slot / kPage) / range_pages + 1;
  if (range >= nr) return;
  const int c0 = range * range_pages * (kPage / kGChunk);
  const int nch = min(ncc, c0 + range_pages * (kPage / kGChunk)) - c0;
  const int* page_row = block_tables + (int64_t)seq * max_blk;
  const E* kv_layer = kv + layer * layer_stride;
  const int nk = nch > stream ? (nch - stream - 1) / kGStreams + 1 : 0;
  const int bar = 1 + stream;
  // k_scale (and log2 e, for exp2) folded into q, v_scale into the output.
  const float qs = __fmul_rn(__fmul_rn(scale, kv_scale[2 * layer]), kLog2e);
  const float v_scale = kv_scale[2 * layer + 1];
  const int hkv_d = hkv * D;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // This (sequence, kv head)'s states: range r's row i at part_sh +
  // (r * rows_cap + i) * kPartRow; rows_cap = qlen * group.
  const int rows_cap = qlen * group;
  float* part_sh =
      nr > 1 ? part + ((int64_t)seq * hkv + h) * n_ranges * rows_cap * kPartRow
             : nullptr;

  // Chunk k of this stream into stage k % kStages.  Slots past last_slot
  // and chunks past the range are never read: cp.async fills their rows
  // with zeros, so a masked P of 0 never meets a stale or NaN V.
  auto load = [&](int k) {
    const int c = c0 + k * kGStreams + stream;
    unsigned char* dst = smem4 + (k % kStages) * G::kStageBytes;
    constexpr int kChunks = D * static_cast<int>(sizeof(E)) / 16;
    constexpr int kElems = 16 / static_cast<int>(sizeof(E));
    const E* kb = kv_layer +
                  ((int64_t)page_row[c / 2] * 2 * kPage + (c % 2) * kGChunk) *
                      hkv_d +
                  h * D;
    const E* vb = kb + kPage * hkv_d;
    const int n_ok = min(kGChunk, last_slot - c * kGChunk + 1);
#pragma unroll 4
    for (int i = tile * 32 + lane; i < 2 * kGChunk * kChunks;
         i += TILES * 32) {
      const int row = i / kChunks, ch = i % kChunks;  // K rows, V rows
      const int j = row % kGChunk;
      const bool ok = j < n_ok;
      const E* src = row < kGChunk ? kb : vb;
      if (ok) src += (int64_t)j * hkv_d + ch * kElems;
      cp_async16(dst + ((row / kGChunk) * kGStreams * kGChunk +
                        stream * kGChunk + j) * S::kRawRow + ch * 16,
                 src, ok ? 16 : 0);
    }
  };

  for (int row0 = 0; row0 < nrows; row0 += TILES * kMTile) {
    // The pass's q rows (zeros past the last row) go to the last stage,
    // free until the main loop's first load, with the first chunk.
    uint16_t* sq = reinterpret_cast<uint16_t*>(
        smem4 + (kStages - 1) * G::kStageBytes);
    for (int i = tid; i < TILES * kMTile * (D / 8); i += kThreadsG) {
      const int r = i / (D / 8), ch = i % (D / 8), row = row0 + r;
      const uint16_t* src = q;
      if (row < nrows)
        src += ((int64_t)(tok0 + row / group) * hq + h * group +
                row % group) * D + ch * 8;
      cp_async16(sq + r * S::kRow16 + ch * 8, src, row < nrows ? 16 : 0);
    }
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) load(st);
      cp_async_commit();
    }
    // This thread's rows rbase and rbase + 8 and lim[hr], the last slot
    // the row attends (-1: no row).
    const int rbase = row0 + tile * kMTile + g;
    bool live[2];
    int lim[2];
    int wfirst = INT_MAX, wlast = -1;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rbase + 8 * hr;
      live[hr] = r < nrows;
      lim[hr] = live[hr] ? pos0 + r / group : -1;
      if (live[hr]) wfirst = min(wfirst, lim[hr]);
      wlast = max(wlast, lim[hr]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      wfirst = min(wfirst, __shfl_xor_sync(0xffffffffu, wfirst, off));
      wlast = max(wlast, __shfl_xor_sync(0xffffffffu, wlast, off));
    }

    // q rows as A fragments (ldmatrix), scaled and split into hi + lo:
    // register j of k-step kk holds d = 16 kk + c2 + 8 (j / 2) of row
    // rbase + 8 (j % 2).
    cp_async_wait<kStages - 2>();
    __syncthreads();
    uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t raw[4];
      const int mi = lane >> 3, ri = lane & 7;
      ldsm_x4(raw, sq + (tile * kMTile + (mi & 1) * 8 + ri) * S::kRow16 +
                       kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw[j]));
        x.x = __fmul_rn(x.x, qs);
        x.y = __fmul_rn(x.y, qs);
        qh[kk][j] = M::pack(x.x, x.y);
        const float2 hf = M::unpack(qh[kk][j]);
        ql[kk][j] = M::pack(__fsub_rn(x.x, hf.x), __fsub_rn(x.y, hf.y));
      }
    }
    __syncthreads();  // the last stage is the main loop's again
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int k = 0; k < nk; ++k) {
      if (k + kStages - 1 < nk) load(k + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      named_barrier(bar, TILES * 32);
      const unsigned char* staged = smem4 + (k % kStages) * G::kStageBytes;
      const uint16_t* tile16 = reinterpret_cast<const uint16_t*>(staged);
      if constexpr (S::kConvert) {
        uint16_t* conv = reinterpret_cast<uint16_t*>(
            smem4 + kStages * G::kStageBytes);
        convert_fp8_chunk<D, TILES>(staged, conv, stream);
        named_barrier(bar, TILES * 32);
        tile16 = conv;
      }
      const int base = (c0 + k * kGStreams + stream) * kGChunk;
      if (base <= wlast)
        fold_chunk_grouped<KV, D>(
            tile16 + stream * kGChunk * S::kRow16,
            tile16 + (kGStreams + stream) * kGChunk * S::kRow16, base, lim,
            base + kGChunk - 1 <= wfirst, qh, ql, o, m, l);
      named_barrier(bar, TILES * 32);  // the stage is free again
    }
    cp_async_wait<0>();
    __syncthreads();  // every stream is done with the stages

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] = __fadd_rn(l[hr], __shfl_xor_sync(0xffffffffu, l[hr], 1));
      l[hr] = __fadd_rn(l[hr], __shfl_xor_sync(0xffffffffu, l[hr], 2));
    }
    // Streams 1..3 hand their states to stream 0 of the same tile, which
    // merges them in stream order (one float per lane and value).
    float* mg0 = reinterpret_cast<float*>(smem4) +
                 tile * G::kMergeFloats * 32 + lane;
    constexpr int kStride = TILES * G::kMergeFloats * 32;  // stream to stream
    if (stream > 0) {
      float* mg = mg0 + (stream - 1) * kStride;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mg[(n * 4 + e) * 32] = o[n][e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mg[(D / 2 + hr) * 32] = m[hr];
        mg[(D / 2 + 2 + hr) * 32] = l[hr];
      }
    }
    __syncthreads();
    if (stream == 0) {
      for (int j = 1; j < kGStreams; ++j) {
        const float* mg = mg0 + (j - 1) * kStride;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float m1 = mg[(D / 2 + hr) * 32];
          const float l1 = mg[(D / 2 + 2 + hr) * 32];
          const float mx = fmaxf(m[hr], m1);
          const float mu = mx == kNegInf ? 0.f : mx;
          const float f0 =
              m[hr] == mx ? 1.f : fast_exp2(__fsub_rn(m[hr], mu));
          const float f1 = m1 == mx ? 1.f : fast_exp2(__fsub_rn(m1, mu));
          m[hr] = mx;
          l[hr] = __fmaf_rn(l[hr], f0, __fmul_rn(l1, f1));
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e)
              o[n][e] =
                  __fmaf_rn(o[n][e], f0, __fmul_rn(mg[(n * 4 + e) * 32], f1));
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!live[hr]) continue;
        const int r = rbase + 8 * hr;
        if (nr > 1) {
          // The range's state of row r, for the merge.
          float* prow = part_sh + ((int64_t)range * rows_cap + r) * kPartRow;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<float2*>(prow + n * 8 + c2) =
                make_float2(o[n][2 * hr], o[n][2 * hr + 1]);
          if (c2 == 0) *reinterpret_cast<float2*>(prow + D) =
              make_float2(m[hr], l[hr]);
          continue;
        }
        const float f = __fdiv_rn(v_scale, fmaxf(l[hr], 1e-20f));
        uint16_t* orow = out + (int64_t)(tok0 + r / group) * hq * D +
                         (h * group + r % group) * D + c2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(__fmul_rn(o[n][2 * hr], f),
                        __fmul_rn(o[n][2 * hr + 1], f));
      }
    }
    __syncthreads();  // the next pass reuses the shared memory
  }
  if (nr == 1) return;

  // The last CTA of the (sequence, kv head) to arrive merges the ranges.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(counter + (int64_t)seq * hkv + h, 1) == nr - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Row i, columns c4 .. c4 + 3: range 0's state (every row attends slot
  // 0), then ranges 1, 2, ... in order; a range the row does not attend
  // (m = -inf) is skipped, so it changes no bit.  The same arithmetic as
  // the stream merge and the single-range store.
  for (int idx = tid; idx < nrows * (D / 4); idx += kThreadsG) {
    const int i = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
    const float* p = part_sh + (int64_t)i * kPartRow;
    float4 acc = __ldcg(reinterpret_cast<const float4*>(p + c4));
    float2 ml = __ldcg(reinterpret_cast<const float2*>(p + D));
    for (int rr = 1; rr < nr; ++rr) {
      p += (int64_t)rows_cap * kPartRow;
      const float2 ml1 = __ldcg(reinterpret_cast<const float2*>(p + D));
      if (ml1.x == kNegInf) continue;
      const float4 o1 = __ldcg(reinterpret_cast<const float4*>(p + c4));
      const float mx = fmaxf(ml.x, ml1.x);
      const float f0 = ml.x == mx ? 1.f : fast_exp2(__fsub_rn(ml.x, mx));
      const float f1 = ml1.x == mx ? 1.f : fast_exp2(__fsub_rn(ml1.x, mx));
      ml = make_float2(mx, __fmaf_rn(ml.y, f0, __fmul_rn(ml1.y, f1)));
      acc.x = __fmaf_rn(acc.x, f0, __fmul_rn(o1.x, f1));
      acc.y = __fmaf_rn(acc.y, f0, __fmul_rn(o1.y, f1));
      acc.z = __fmaf_rn(acc.z, f0, __fmul_rn(o1.z, f1));
      acc.w = __fmaf_rn(acc.w, f0, __fmul_rn(o1.w, f1));
    }
    const float f = __fdiv_rn(v_scale, fmaxf(ml.y, 1e-20f));
    *reinterpret_cast<uint2*>(out + (int64_t)(tok0 + i / group) * hq * D +
                              (h * group + i % group) * D + c4) =
        make_uint2(pack_bf16(__fmul_rn(acc.x, f), __fmul_rn(acc.y, f)),
                   pack_bf16(__fmul_rn(acc.z, f), __fmul_rn(acc.w, f)));
  }
  if (tid == 0) counter[(int64_t)seq * hkv + h] = 0;  // for the next launch
}

template <class KV, int D, int TILES>
cudaError_t launch_decode_range(void* q, void* out, const void* kv,
                                const float* kv_scale, const int* pos_base,
                                const int* seq_lens, const int* block_tables,
                                float* part, int* counter, int layer, int b,
                                int t, int qlen, int hq, int hkv, int max_blk,
                                int64_t layer_stride, int range_pages,
                                float scale, cudaStream_t stream) {
  auto* kernel = decode_range_kernel<KV, D, TILES>;
  constexpr int smem = GroupedSmem<KV, D, TILES>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_seq = std::max(b, (t + qlen - 1) / qlen);
  const int n_ranges = (max_blk + range_pages - 1) / range_pages;
  if (n_ranges > 1 && (part == nullptr || counter == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid(n_seq, hkv, n_ranges);
  using E = typename KV::T;
  kernel<<<grid, kGStreams * TILES * 32, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out),
      static_cast<const E*>(kv), kv_scale, pos_base, seq_lens, block_tables,
      part, counter, layer, b, t, qlen, hq, hkv, max_blk, layer_stride,
      range_pages, n_ranges, scale);
  return cudaGetLastError();
}

// ---- dispatch ----------------------------------------------------------------

template <class KV, int D>
cudaError_t launch_ragged(void* q, void* out, const void* kv,
                          const float* kv_scale, const int* item_req,
                          const int* item_qstart, const int* item_qlen,
                          const int* item_pages, const int* item_pos_base,
                          const int* token_item, const int* req_idx,
                          const int* block_tables, const int* item_tree_start,
                          const int* item_tree_mask, int tree_qw, int layer,
                          int n_items, int t, int hq, int hkv, int max_blk,
                          int64_t layer_stride, float scale,
                          cudaStream_t stream) {
  auto* kernel = ragged_attention_kernel<KV, D>;
  constexpr int smem = RaggedSmem<KV, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_items + (t + kZeroTokens - 1) / kZeroTokens, hkv);
  kernel<<<grid, kRThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out),
      static_cast<const typename KV::T*>(kv), kv_scale, item_req, item_qstart,
      item_qlen, item_pages, item_pos_base, token_item, req_idx, block_tables,
      item_tree_start, item_tree_mask, tree_qw, layer, n_items, t, hq, hkv,
      max_blk, layer_stride, scale);
  return cudaGetLastError();
}

template <class KV, int D, int TILES>
cudaError_t launch_grouped(void* q, void* out, const void* kv,
                           const float* kv_scale, const int* pos_base,
                           const int* seq_lens, const int* block_tables,
                           const void* knew, const void* vnew,
                           const int* slot_mapping, int layer, int b, int t,
                           int qlen, int hq, int hkv, int max_blk,
                           int64_t layer_stride, float scale,
                           cudaStream_t stream) {
  auto* kernel = grouped_decode_kernel<KV, D, TILES>;
  constexpr int smem = GroupedSmem<KV, D, TILES>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_seq = std::max(b, (t + qlen - 1) / qlen);
  dim3 grid(n_seq, hkv);
  using E = typename KV::T;
  kernel<<<grid, kGStreams * TILES * 32, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out),
      static_cast<const E*>(kv), kv_scale, pos_base, seq_lens, block_tables,
      static_cast<const E*>(knew), static_cast<const E*>(vnew), slot_mapping,
      layer, b, t, qlen, hq, hkv, max_blk, layer_stride, scale);
  return cudaGetLastError();
}

// Kernel 1's instances: (kv dtype, head dim).
template <class... A>
cudaError_t dispatch_ragged(int kv_fp8, int d, A... args) {
  if (d == 64)
    return kv_fp8 ? launch_ragged<Fp8, 64>(args...)
                  : launch_ragged<Bf16, 64>(args...);
  if (d == 128)
    return kv_fp8 ? launch_ragged<Fp8, 128>(args...)
                  : launch_ragged<Bf16, 128>(args...);
  return cudaErrorInvalidValue;
}

// Kernel 2's (and 3's) instances: (kv dtype, head dim, rows per pass:
// one or two 16-row m-tiles).
template <class... A>
cudaError_t dispatch_grouped(int kv_fp8, int d, int rows, A... args) {
#define ARCTIC_CASE(KVT, DD, TT)                                         \
  if ((kv_fp8 != 0) == std::is_same<KVT, Fp8>::value && d == DD &&      \
      rows == TT * kMTile)                                               \
    return launch_grouped<KVT, DD, TT>(args...);
#define ARCTIC_CASES(KVT) \
  ARCTIC_CASE(KVT, 64, 1) ARCTIC_CASE(KVT, 64, 2) \
  ARCTIC_CASE(KVT, 128, 1) ARCTIC_CASE(KVT, 128, 2)
  ARCTIC_CASES(Bf16)
  ARCTIC_CASES(Fp8)
#undef ARCTIC_CASES
#undef ARCTIC_CASE
  return cudaErrorInvalidValue;
}

// Kernel 4's instances: (kv dtype, head dim, rows per pass: one or two
// 16-row m-tiles).
template <class... A>
cudaError_t dispatch_decode_range(int kv_fp8, int d, int rows, A... args) {
#define ARCTIC_CASE(KVT, DD, TT)                                         \
  if ((kv_fp8 != 0) == std::is_same<KVT, Fp8>::value && d == DD &&      \
      rows == TT * kMTile)                                               \
    return launch_decode_range<KVT, DD, TT>(args...);
#define ARCTIC_CASES(KVT) \
  ARCTIC_CASE(KVT, 64, 1) ARCTIC_CASE(KVT, 64, 2) \
  ARCTIC_CASE(KVT, 128, 1) ARCTIC_CASE(KVT, 128, 2)
  ARCTIC_CASES(Bf16)
  ARCTIC_CASES(Fp8)
#undef ARCTIC_CASES
#undef ARCTIC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers;
// q and out are bf16, the int32 metadata arrays are contiguous.  Returns cudaGetLastError()
// right after the launch (0 = launched).  item_tree_start [n_items] and
// item_tree_mask [n_items, tree_qw] are null for a step without a tree;
// the ragged kernel takes rows_per_tile = 16 (its rows per warp) only.
// The grouped kernel takes rows_per_tile = 16 or 32: the rows of a
// (sequence, kv head) it covers per pass over the pages (one or two m16
// tiles).  knew / vnew [t, Hkv*D] (cache dtype) and slot_mapping [t] are
// null for a grouped step without deferred writes (qlen <= 32 with them).
extern "C" int ragged_attention_launch(
    void* q, void* out, const void* kv, const void* kv_scale,
    const void* item_req, const void* item_qstart, const void* item_qlen,
    const void* item_pages, const void* item_pos_base,
    const void* token_item, const void* req_idx, const void* block_tables,
    const void* item_tree_start, const void* item_tree_mask, int tree_qw,
    int layer, int n_items, int t, int hq, int hkv, int d, int max_blk,
    int64_t layer_stride, int kv_fp8, int rows_per_tile, float scale,
    void* stream) {
  if (rows_per_tile != kMTile) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_ragged(
      kv_fp8, d, q, out, kv,
      static_cast<const float*>(kv_scale),
      static_cast<const int*>(item_req), static_cast<const int*>(item_qstart),
      static_cast<const int*>(item_qlen), static_cast<const int*>(item_pages),
      static_cast<const int*>(item_pos_base),
      static_cast<const int*>(token_item), static_cast<const int*>(req_idx),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(item_tree_start),
      static_cast<const int*>(item_tree_mask), tree_qw, layer, n_items, t, hq,
      hkv, max_blk, layer_stride, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" int grouped_decode_launch(
    void* q, void* out, const void* kv, const void* kv_scale,
    const void* pos_base, const void* seq_lens, const void* block_tables,
    const void* knew, const void* vnew, const void* slot_mapping, int layer,
    int b, int t, int qlen, int hq, int hkv, int d, int max_blk,
    int64_t layer_stride, int kv_fp8, int rows_per_tile, float scale,
    void* stream) {
  if (knew != nullptr && (qlen > kPage || vnew == nullptr ||
                          slot_mapping == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_grouped(
      kv_fp8, d, rows_per_tile, q, out, kv,
      static_cast<const float*>(kv_scale), static_cast<const int*>(pos_base),
      static_cast<const int*>(seq_lens),
      static_cast<const int*>(block_tables), knew, vnew,
      static_cast<const int*>(slot_mapping), layer, b, t, qlen, hq, hkv,
      max_blk, layer_stride, scale, static_cast<cudaStream_t>(stream)));
}

// Kernel 4: q / out [t, hq, D] bf16, rows of sequence s at [s*qlen,
// (s+1)*qlen); one CTA per (sequence, kv head, range of range_pages
// pages), rows_per_tile 16 or 32 as for the grouped kernel.  part: float32
// scratch of [B, hkv, ceil(max_blk / range_pages), qlen * hq / hkv, D + 4]
// and counter: [B, hkv] int32, zero before the first launch (each launch
// leaves it zero); both may be null when one range covers max_blk pages.
extern "C" int decode_paged_launch(
    void* q, void* out, const void* kv, const void* kv_scale,
    const void* pos_base, const void* seq_lens, const void* block_tables,
    void* part, void* counter, int layer, int b, int t, int qlen, int hq,
    int hkv, int d, int max_blk, int64_t layer_stride, int kv_fp8,
    int rows_per_tile, int range_pages, float scale, void* stream) {
  if (range_pages < 1 || max_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_decode_range(
      kv_fp8, d, rows_per_tile, q, out, kv,
      static_cast<const float*>(kv_scale), static_cast<const int*>(pos_base),
      static_cast<const int*>(seq_lens),
      static_cast<const int*>(block_tables), static_cast<float*>(part),
      static_cast<int*>(counter), layer, b, t, qlen, hq, hkv, max_blk,
      layer_stride, range_pages, scale, static_cast<cudaStream_t>(stream)));
}

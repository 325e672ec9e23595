// Paged attention kernels for Hopper (sm_90a): the ragged work-item
// kernel, the grouped uniform-decode kernel and the per-sequence decode
// kernel.
//
// Replaces (arcticinference_tpu/ops/pallas/ragged_attention.py):
//   ragged_paged_attention_kernel   (_ragged_attention_call / _attn_kernel,
//                                    with its use_tree branch)
//   grouped_decode_attention_kernel (_grouped_decode_call /
//                                    _grouped_decode_kernel)
//   decode_paged_attention_kernel   (_decode_attention_call /
//                                    _decode_kernel; see "kernel 4" below
//                                    for its own design)
//
// What bounds them on an H100: the KV bytes each step reads.  A decode
// row does 4 flops per KV element it reads (2 for q.k, 2 for p.v) and a
// bf16 element is 2 bytes, so decode attention sits far below the card's
// ~295 flops/byte ridge: its floor is KV bytes / 3.35 TB/s.  Prefill
// rows share each page among up to qb*group query rows, which moves a
// long prefill toward the compute side.
//
// What this design does about it in kernels 1-3 (a first, simple
// version: CUDA cores and fp32 FMA, no tensor cores, no TMA):
//   * One CTA per (work item or sequence, kv head).  Its query rows
//     (qlen * group of them: every q head of the GQA group, every token)
//     share the head's K/V pages, so each page is read once per CTA row
//     tile instead of once per q head.
//   * The CTA's 4 warps split the request's pages (warp w takes pages
//     w, w+4, ...) and each keeps its own fp32 online-softmax state; the
//     states are merged once at the end.  Four independent page streams
//     per CTA keep loads in flight at decode, where a CTA has few rows.
//   * Lane j of a warp owns token j of a 32-token page for q.k (it reads
//     its K row with 16-byte loads), and dims [lane*D/32, ...) for p.v
//     (V rows are read coalesced, 32 lanes on one contiguous row).
//   * The per-layer k_scale is folded into q and v_scale into the
//     output, so fp8 pages are only converted, never multiplied.
//   * Rows beyond the CTA's row tile of RW rows are done in further
//     passes over the pages (the repeat reads mostly hit L2).
//
// Token-tree verification (the ragged kernel's tree-mask path): a work
// item may carry the frontier slot ts of its request and, per window
// offset, an ancestor bitmask.  A row whose mask is non-zero attends kv
// slot ts + r (r in 1..31) iff bit r is set, and every slot up to ts as
// usual; rows with mask 0 stay causal.  The causal limit stays on slots
// (a tree node's ancestors all sit at lower slots than the node), so the
// page and token cut-offs below need no change.
//
// Deferred KV writes (the grouped kernel's knew / vnew path): the step's
// new K/V rows arrive as operands ([t, Hkv*D] in cache dtype, already
// divided by the layer's k/v scale like cache rows) and their cache slots
// are not written yet.  Each row then reads the cache only below its
// sequence's pos_base, and after the pages the CTA folds the sequence's
// new rows into the same online softmax as one more chunk of at most 32
// tokens: lane j owns new row j, which row i attends iff j <= i's token
// index and j < new_len (the count of the sequence's rows whose slot is
// >= 0; padding is a tail of slot -1).  The caller scatters the rows into
// the cache once for the whole model after the layer stack.
//
// The layout contract is the JAX package's: cache [L, N, 2, 32, Hkv*D],
// q / out [T, Hq, D] bf16, block_tables [B, MaxBlk] int32.  block_size is 32.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPage = 32;        // tokens per page == lanes per warp
constexpr int kZeroTokens = 32;  // padding rows zeroed per extra CTA
constexpr float kNegInf = -__builtin_huge_valf();

// ---- element types -------------------------------------------------------

struct Bf16 {
  using T = uint16_t;
  static __device__ __forceinline__ float cvt(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ uint16_t from_float(float f) {
    // Round to nearest even (finite inputs), as a bf16 cast does.
    uint32_t u = __float_as_uint(f);
    u += 0x7fffu + ((u >> 16) & 1u);
    return static_cast<uint16_t>(u >> 16);
  }
};

struct Fp8 {
  using T = uint8_t;
  static __device__ __forceinline__ float cvt(uint8_t b) {
    __nv_fp8_e4m3 x;
    x.__x = b;
    return static_cast<float>(x);
  }
};

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };

// Load N consecutive elements with one vector load; convert to fp32.
template <class E, int N>
__device__ __forceinline__ void load_cvt(const typename E::T* p, float* f) {
  using V = typename Vec<N * sizeof(typename E::T)>::type;
  union {
    V v;
    typename E::T e[N];
  } u;
  u.v = *reinterpret_cast<const V*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = E::cvt(u.e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the shared online-softmax loop ---------------------------------------

// The rows of one CTA: row i is token tok0 + i / group (cache slot
// pos0 + i / group) under q head h * group + i % group.  Tokens at or past
// t_limit do not exist (their rows are neither read nor written).  With a
// tree mask, token tok0 + j has ancestor bitmask tree_mask[j] against the
// frontier slot tree_start; tree_mask == nullptr means no tree.  With
// knew / vnew (deferred writes; cache-dtype rows, token tok0 + j at row
// tok0 + j) the cache is read only below pos0 and new rows j < new_len are
// folded in after the pages; knew == nullptr means no injection.
struct Rows {
  int tok0;
  int pos0;
  int ntok;
  int t_limit;
  const int* tree_mask = nullptr;
  int tree_start = -1;
  const void* knew = nullptr;
  const void* vnew = nullptr;
  int new_len = 0;
};

template <int D, int RW>
struct Smem {
  float q[RW][D];
  float p[kWarps][RW][kPage];
  float m[kWarps][RW];
  float l[kWarps][RW];
  float acc[kWarps][RW][D];
};

// Fold one chunk of at most 32 tokens into a warp's online-softmax state:
// lane j owns token j, whose K row is krow (read only when k_ok) and whose
// V row is vbase + j * v_stride (this lane's dims); K and V may lie in
// device or shared memory.  q: the warp's RW query rows (fp32, scaled);
// p: the warp's [RW][32] scratch.  ok[r]: row r attends this lane's
// token; tokens at or past jmax carry no weight for any row.
template <class KV, int D, int RW>
__device__ __forceinline__ void fold_chunk(
    float (*__restrict__ q)[D], float (*__restrict__ p)[kPage],
    const typename KV::T* __restrict__ krow, bool k_ok,
    const typename KV::T* __restrict__ vbase, int64_t v_stride,
    const bool (&ok)[RW], int jmax, float (&m)[RW], float (&l)[RW],
    float (&acc)[RW][D / 32]) {
  constexpr int DPL = D / 32;
  const int lane = threadIdx.x & 31;
  float s[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) s[r] = 0.f;
  if (k_ok) {
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      float kf[8];
      load_cvt<KV, 8>(krow + c, kf);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(&q[r][c]);
        const float4 qb = *reinterpret_cast<const float4*>(&q[r][c + 4]);
        s[r] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float sv = ok[r] ? s[r] : kNegInf;
    const float m_new = fmaxf(m[r], warp_max(sv));
    // m_safe: an all-masked row keeps exp(-inf - 0) = 0 (no NaN).
    const float m_safe = m_new == kNegInf ? 0.f : m_new;
    const float alpha = m[r] == kNegInf ? 0.f : __expf(m[r] - m_safe);
    const float pj = ok[r] ? __expf(sv - m_safe) : 0.f;
    l[r] = l[r] * alpha + pj;  // per-lane partial; summed at the end
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
    m[r] = m_new;
    p[r][lane] = pj;
  }
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < jmax; ++j) {
    float vf[DPL];
    load_cvt<KV, DPL>(vbase + (int64_t)j * v_stride, vf);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float pj = p[r][j];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] += pj * vf[e];
    }
  }
  __syncwarp();
}

template <class KV, int D, int RW>
__device__ void attend(Smem<D, RW>& sm, const uint16_t* __restrict__ q,
                       uint16_t* __restrict__ out,
                       const typename KV::T* __restrict__ kv_layer,
                       const int* __restrict__ page_row, int npages,
                       Rows rows, int h, int hq, int hkv, float q_scale,
                       float v_scale) {
  constexpr int DPL = D / 32;  // p.v dims per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = hq / hkv;
  const int hkv_d = hkv * D;
  const int nrows = rows.ntok * group;
  const bool deferred = rows.knew != nullptr;

  for (int tile0 = 0; tile0 < nrows; tile0 += RW) {
    // Stage this tile's q rows (fp32, pre-scaled by scale * k_scale).
    for (int idx = threadIdx.x; idx < RW * D; idx += kThreads) {
      const int r = idx / D, dd = idx % D, i = tile0 + r;
      const int tok = rows.tok0 + i / group;
      float val = 0.f;
      if (i < nrows && tok < rows.t_limit) {
        const int head = h * group + i % group;
        val = Bf16::cvt(q[(int64_t)tok * hq * D + head * D + dd]) * q_scale;
      }
      sm.q[r][dd] = val;
    }
    // pos[r]: the last cache slot row r may attend (-1: none); with
    // deferred writes every live row stops below pos0.  tix[r]: the row's
    // token index in the CTA (-1: not live), which bounds the new rows it
    // attends.
    int pos[RW], tix[RW];
    unsigned mask[RW];  // ancestor bitmask of each row (0: causal)
    int max_pos = -1, max_tok = -1;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = tile0 + r;
      const bool live = i < nrows && rows.tok0 + i / group < rows.t_limit;
      tix[r] = live ? i / group : -1;
      pos[r] = !live ? -1 : deferred ? rows.pos0 - 1 : rows.pos0 + i / group;
      mask[r] = (live && rows.tree_mask != nullptr)
                    ? static_cast<unsigned>(rows.tree_mask[i / group])
                    : 0u;
      max_pos = max(max_pos, pos[r]);
      max_tok = max(max_tok, tix[r]);
    }
    __syncthreads();

    float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
    }
    // Pages past the tile's last position hold nothing it may attend.
    const int last_page = min(npages, max_pos < 0 ? 0 : max_pos / kPage + 1);
    for (int pg_i = warp; pg_i < last_page; pg_i += kWarps) {
      const int64_t page = page_row[pg_i];
      const typename KV::T* krow =
          kv_layer + (page * 2 * kPage + lane) * hkv_d + h * D;
      const typename KV::T* vbase =
          kv_layer + ((page * 2 + 1) * kPage) * hkv_d + h * D + lane * DPL;
      const int kv_pos = pg_i * kPage + lane;
      const int rel = kv_pos - rows.tree_start;  // slot past the frontier
      bool ok[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        ok[r] = kv_pos <= pos[r];
        if (mask[r] != 0u && rel >= 1)
          ok[r] = rel < 32 && ((mask[r] >> rel) & 1u);
      }
      // Only tokens at or before the tile's last position carry weight.
      fold_chunk<KV, D, RW>(sm.q, sm.p[warp], krow, true, vbase, hkv_d,
                            ok, min(kPage, max_pos - pg_i * kPage + 1), m,
                            l, acc);
    }
    if (deferred && warp == last_page % kWarps) {
      // The new rows, as one more chunk, on the warp whose turn is next.
      const auto* knew = static_cast<const typename KV::T*>(rows.knew);
      const auto* vnew = static_cast<const typename KV::T*>(rows.vnew);
      const bool has = lane < rows.new_len;
      bool ok[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) ok[r] = has && lane <= tix[r];
      fold_chunk<KV, D, RW>(
          sm.q, sm.p[warp],
          knew + (int64_t)(rows.tok0 + lane) * hkv_d + h * D, has,
          vnew + (int64_t)rows.tok0 * hkv_d + h * D + lane * DPL, hkv_d, ok,
          min(rows.new_len, max_tok + 1), m, l, acc);
    }

    // Merge the warps' states: out = sum_w acc_w e^(m_w-M) /
    // sum_w l_w e^(m_w-M), times v_scale.
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float lr = warp_sum(l[r]);
      if (lane == 0) {
        sm.m[warp][r] = m[r];
        sm.l[warp][r] = lr;
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) sm.acc[warp][r][lane * DPL + e] = acc[r][e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < RW * D; idx += kThreads) {
      const int r = idx / D, dd = idx % D, i = tile0 + r;
      const int tok = rows.tok0 + i / group;
      if (i >= nrows || tok >= rows.t_limit) continue;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m[w][r]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm.m[w][r];
        if (mw == kNegInf) continue;
        const float f = __expf(mw - mx);
        lsum += sm.l[w][r] * f;
        a += sm.acc[w][r][dd] * f;
      }
      const int head = h * group + i % group;
      out[(int64_t)tok * hq * D + head * D + dd] =
          Bf16::from_float(a * (v_scale / fmaxf(lsum, 1e-20f)));
    }
    __syncthreads();
  }
}

// ---- kernel 1: ragged work items -------------------------------------------

template <class KV, int D, int RW>
__global__ void __launch_bounds__(kThreads) ragged_attention_kernel(
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
  __shared__ __align__(16) Smem<D, RW> sm;
  const int item = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  if (item >= n_items) {
    // Padding tokens (req_idx < 0) belong to no item: zero them here.
    const int t0 = (item - n_items) * kZeroTokens;
    for (int idx = threadIdx.x; idx < kZeroTokens * group * D;
         idx += kThreads) {
      const int tok = t0 + idx / (group * D);
      if (tok < t && req_idx[tok] < 0)
        out[(int64_t)tok * hq * D + h * group * D + idx % (group * D)] =
            Bf16::from_float(0.f);
    }
    return;
  }
  const int qlen = item_qlen[item];
  if (qlen <= 0) return;
  // The host schedule aligns each item's window start down to a multiple
  // of 8 (a TPU tiling artefact kept for parity of the schedule arrays);
  // the item's first real token is the first window row it owns.
  const int qstart = item_qstart[item];
  int o0 = 0;
  while (o0 < 7 && qstart + o0 < t && token_item[qstart + o0] != item) ++o0;
  Rows rows{qstart + o0, item_pos_base[item] + o0, qlen, t};
  if (item_tree_mask != nullptr && item_tree_start[item] >= 0) {
    // The mask is indexed by window offset: row 0 of the window is the
    // 8-aligned qstart, and this CTA's first token sits at offset o0.
    rows.tree_mask = item_tree_mask + (int64_t)item * tree_qw + o0;
    rows.tree_start = item_tree_start[item];
  }
  attend<KV, D, RW>(sm, q, out, kv + layer * layer_stride,
                        block_tables + (int64_t)item_req[item] * max_blk,
                        item_pages[item], rows, h, hq, hkv,
                        scale * kv_scale[2 * layer], kv_scale[2 * layer + 1]);
}

// ---- kernel 2: grouped uniform decode --------------------------------------

template <class KV, int D, int RW>
__global__ void __launch_bounds__(kThreads) grouped_decode_kernel(
    const uint16_t* __restrict__ q, uint16_t* __restrict__ out,
    const typename KV::T* __restrict__ kv, const float* __restrict__ kv_scale,
    const int* __restrict__ pos_base, const int* __restrict__ seq_lens,
    const int* __restrict__ block_tables,
    const typename KV::T* __restrict__ knew,
    const typename KV::T* __restrict__ vnew,
    const int* __restrict__ slot_mapping, int layer, int b, int t, int qlen,
    int hq, int hkv, int max_blk, int64_t layer_stride, float scale) {
  __shared__ __align__(16) Smem<D, RW> sm;
  const int seq = blockIdx.x, h = blockIdx.y;
  // Sequence slots past b (the token bucket is wider than b * qlen) and
  // dead slots (seq_lens == 0) read no page and inject no row: their rows
  // come out zero.
  int npages = 0, pos0 = 0;
  const int* page_row = block_tables;
  const bool live = seq < b && seq_lens[seq] > 0;
  if (seq < b) {
    // No page past the block table's row (a step near max_model_len
    // gives its rows past the limit a longer seq_len).
    npages = min((seq_lens[seq] + kPage - 1) / kPage, max_blk);
    pos0 = pos_base[seq];
    page_row = block_tables + (int64_t)seq * max_blk;
  }
  Rows rows{seq * qlen, pos0, qlen, t};
  if (knew != nullptr) {
    rows.knew = knew;
    rows.vnew = vnew;
    // new_len: the sequence's rows with a real slot (rows past t are
    // padding, as the JAX dispatch pads slot_mapping with -1).
    for (int j = 0; live && j < qlen; ++j) {
      const int row = seq * qlen + j;
      rows.new_len += row < t && slot_mapping[row] >= 0;
    }
  }
  attend<KV, D, RW>(sm, q, out, kv + layer * layer_stride, page_row,
                        npages, rows, h, hq, hkv,
                        scale * kv_scale[2 * layer], kv_scale[2 * layer + 1]);
}

// ---- kernel 4: one CTA per sequence ------------------------------------------

// The TPU kernel's grid (one program per sequence) on Hopper: the CTA's
// 8 warps cover every (kv head, row tile) unit of the sequence's rows, a
// warp holding one unit's fp32 online-softmax state (RW rows) in
// registers.  Each page is copied once per pass into shared memory as
// whole token rows (Hkv*D contiguous elements per token, K then V, with
// cp.async; rows padded by 16 bytes so a warp's 32 token rows fall on
// distinct banks) and serves every unit's kv head from there.  A pass
// covers 8 units: one pass reads each page once when qlen * group <= 16
// rows per kv head and Hkv <= 8 (the 8B shape at qlen <= 4).
constexpr int kWarps4 = 8;
constexpr int kThreads4 = kWarps4 * 32;
constexpr int kRowPad = 16;  // bytes after each token row in shared memory

template <class KV, int D, int RW>
__host__ __device__ constexpr int smem4_bytes(int hkv_d) {
  return 2 * kPage * (hkv_d * static_cast<int>(sizeof(typename KV::T)) +
                      kRowPad) +
         kWarps4 * RW * (D + kPage) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

template <class KV, int D, int RW>
__global__ void __launch_bounds__(kThreads4) decode_paged_kernel(
    const uint16_t* __restrict__ q, uint16_t* __restrict__ out,
    const typename KV::T* __restrict__ kv, const float* __restrict__ kv_scale,
    const int* __restrict__ pos_base, const int* __restrict__ seq_lens,
    const int* __restrict__ block_tables, int layer, int b, int t, int qlen,
    int hq, int hkv, int max_blk, int64_t layer_stride, float scale) {
  using E = typename KV::T;
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seq = blockIdx.x;
  const int group = hq / hkv;
  const int hkv_d = hkv * D;
  const int tok0 = seq * qlen;
  const int ntok = min(qlen, t - tok0);  // this sequence's rows in q
  if (ntok <= 0) return;
  if (seq >= b || seq_lens[seq] <= 0) {
    // A slot past b or a dead slot: its rows come out zero.
    for (int idx = threadIdx.x; idx < ntok * hq * D; idx += kThreads4)
      out[(int64_t)tok0 * hq * D + idx] = Bf16::from_float(0.f);
    return;
  }
  // Shared memory: K rows | V rows of one page, then per warp its RW q
  // rows and its [RW][32] softmax scratch.
  const int row_elems = hkv_d + kRowPad / static_cast<int>(sizeof(E));
  E* sk = reinterpret_cast<E*>(smem4);
  E* sv = sk + kPage * row_elems;
  float(*sq)[D] = reinterpret_cast<float(*)[D]>(sv + kPage * row_elems);
  float(*sp)[kPage] = reinterpret_cast<float(*)[kPage]>(sq + kWarps4 * RW);
  float(*wq)[D] = sq + warp * RW;
  float(*wp)[kPage] = sp + warp * RW;

  const E* kv_layer = kv + layer * layer_stride;
  const int* page_row = block_tables + (int64_t)seq * max_blk;
  const int pos0 = pos_base[seq];
  const float q_scale = scale * kv_scale[2 * layer];
  const float v_scale = kv_scale[2 * layer + 1];
  // The sequence's last position bounds the pages any row attends.
  const int npages = min((seq_lens[seq] + kPage - 1) / kPage, max_blk);
  const int last_page = min(npages, (pos0 + ntok - 1) / kPage + 1);
  const int rows_head = ntok * group;
  const int tiles = (rows_head + RW - 1) / RW;
  const int units = hkv * tiles;
  const int chunks16 = hkv_d * static_cast<int>(sizeof(E)) / 16;

  for (int unit0 = 0; unit0 < units; unit0 += kWarps4) {
    const int unit = unit0 + warp;
    const bool has = unit < units;
    const int h = has ? unit / tiles : 0;
    const int r0 = has ? (unit % tiles) * RW : 0;
    // This warp's rows: row i of head h is token i / group under q head
    // h * group + i % group; pos[r] is its causal limit (-1: no row).
    int pos[RW];
    int max_pos = -1;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = r0 + r;
      pos[r] = (has && i < rows_head) ? pos0 + i / group : -1;
      max_pos = max(max_pos, pos[r]);
    }
    for (int idx = lane; idx < RW * D; idx += 32) {
      const int r = idx / D, dd = idx % D, i = r0 + r;
      float val = 0.f;
      if (has && i < rows_head) {
        const int head = h * group + i % group;
        val = Bf16::cvt(q[(int64_t)(tok0 + i / group) * hq * D + head * D +
                          dd]) *
              q_scale;
      }
      wq[r][dd] = val;
    }
    __syncwarp();
    float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
    }
    for (int pg = 0; pg < last_page; ++pg) {
      // Whole token rows of the page, K then V, into shared memory.
      const E* src = kv_layer + (int64_t)page_row[pg] * 2 * kPage * hkv_d;
      for (int c = threadIdx.x; c < 2 * kPage * chunks16; c += kThreads4) {
        const int row = c / chunks16;  // 0..63: K rows, then V rows
        const int col = c % chunks16;
        cp_async16(reinterpret_cast<unsigned char*>(sk + row * row_elems) +
                       col * 16,
                   reinterpret_cast<const unsigned char*>(
                       src + (int64_t)row * hkv_d) +
                       col * 16);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (has) {
        const int kv_pos = pg * kPage + lane;
        bool ok[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) ok[r] = kv_pos <= pos[r];
        fold_chunk<KV, D, RW>(wq, wp, sk + lane * row_elems + h * D, true,
                              sv + h * D + lane * DPL, row_elems, ok,
                              min(kPage, max_pos - pg * kPage + 1), m, l,
                              acc);
      }
      __syncthreads();  // the page buffer is free again
    }
    if (has) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float lr = warp_sum(l[r]);
        if (pos[r] < 0) continue;
        const int i = r0 + r;
        const int head = h * group + i % group;
        uint16_t* o =
            out + (int64_t)(tok0 + i / group) * hq * D + head * D + lane * DPL;
        const float f = v_scale / fmaxf(lr, 1e-20f);
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[e] = Bf16::from_float(acc[r][e] * f);
      }
    }
  }
}

template <class KV, int D, int RW>
cudaError_t launch_decode_paged(void* q, void* out, const void* kv,
                                const float* kv_scale, const int* pos_base,
                                const int* seq_lens, const int* block_tables,
                                int layer, int b, int t, int qlen, int hq,
                                int hkv, int max_blk, int64_t layer_stride,
                                float scale, cudaStream_t stream) {
  auto* kernel = decode_paged_kernel<KV, D, RW>;
  const int smem = smem4_bytes<KV, D, RW>(hkv * D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_seq = std::max(b, (t + qlen - 1) / qlen);
  kernel<<<n_seq, kThreads4, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out),
      static_cast<const typename KV::T*>(kv), kv_scale, pos_base, seq_lens,
      block_tables, layer, b, t, qlen, hq, hkv, max_blk, layer_stride, scale);
  return cudaGetLastError();
}

// ---- dispatch ----------------------------------------------------------------

template <class KV, int D, int RW>
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
  dim3 grid(n_items + (t + kZeroTokens - 1) / kZeroTokens, hkv);
  ragged_attention_kernel<KV, D, RW><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out),
      static_cast<const typename KV::T*>(kv), kv_scale, item_req, item_qstart,
      item_qlen, item_pages, item_pos_base, token_item, req_idx, block_tables,
      item_tree_start, item_tree_mask, tree_qw, layer, n_items, t, hq, hkv,
      max_blk, layer_stride, scale);
  return cudaGetLastError();
}

template <class KV, int D, int RW>
cudaError_t launch_grouped(void* q, void* out, const void* kv,
                           const float* kv_scale, const int* pos_base,
                           const int* seq_lens, const int* block_tables,
                           const void* knew, const void* vnew,
                           const int* slot_mapping, int layer, int b, int t,
                           int qlen, int hq, int hkv, int max_blk,
                           int64_t layer_stride, float scale,
                           cudaStream_t stream) {
  const int n_seq = std::max(b, (t + qlen - 1) / qlen);
  dim3 grid(n_seq, hkv);
  using E = typename KV::T;
  grouped_decode_kernel<KV, D, RW><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out),
      static_cast<const E*>(kv), kv_scale, pos_base, seq_lens, block_tables,
      static_cast<const E*>(knew), static_cast<const E*>(vnew), slot_mapping,
      layer, b, t, qlen, hq, hkv, max_blk, layer_stride, scale);
  return cudaGetLastError();
}

// Picks the template instance for (kv dtype, head dim, rows per tile) and
// calls F::run<...>.  q and out are bf16.
template <class F, class... A>
cudaError_t dispatch(int kv_fp8, int d, int rw, A... args) {
#define ARCTIC_CASE(KVT, DD, RWW)                                        \
  if ((kv_fp8 != 0) == std::is_same<KVT, Fp8>::value && d == DD &&      \
      rw == RWW)                                                         \
    return F::template run<KVT, DD, RWW>(args...);
#define ARCTIC_CASES(KVT) \
  ARCTIC_CASE(KVT, 64, 4) ARCTIC_CASE(KVT, 64, 8) \
  ARCTIC_CASE(KVT, 128, 4) ARCTIC_CASE(KVT, 128, 8)
  ARCTIC_CASES(Bf16)
  ARCTIC_CASES(Fp8)
#undef ARCTIC_CASES
#undef ARCTIC_CASE
  return cudaErrorInvalidValue;
}

struct RaggedF {
  template <class KV, int D, int RW, class... A>
  static cudaError_t run(A... args) {
    return launch_ragged<KV, D, RW>(args...);
  }
};

struct GroupedF {
  template <class KV, int D, int RW, class... A>
  static cudaError_t run(A... args) {
    return launch_grouped<KV, D, RW>(args...);
  }
};

// Kernel 4's instances: (kv dtype, head dim, rows per warp 4 / 8 / 16).
template <class... A>
cudaError_t dispatch_decode_paged(int kv_fp8, int d, int rw, A... args) {
#define ARCTIC_CASE(KVT, DD, RWW)                                        \
  if ((kv_fp8 != 0) == std::is_same<KVT, Fp8>::value && d == DD &&      \
      rw == RWW)                                                         \
    return launch_decode_paged<KVT, DD, RWW>(args...);
#define ARCTIC_CASES(KVT)                                                \
  ARCTIC_CASE(KVT, 64, 4) ARCTIC_CASE(KVT, 64, 8) ARCTIC_CASE(KVT, 64, 16) \
  ARCTIC_CASE(KVT, 128, 4) ARCTIC_CASE(KVT, 128, 8)                        \
  ARCTIC_CASE(KVT, 128, 16)
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
// knew / vnew [t, Hkv*D] (cache dtype) and slot_mapping [t] are null for a
// grouped step without deferred writes (qlen <= 32 with them).
extern "C" int ragged_attention_launch(
    void* q, void* out, const void* kv, const void* kv_scale,
    const void* item_req, const void* item_qstart, const void* item_qlen,
    const void* item_pages, const void* item_pos_base,
    const void* token_item, const void* req_idx, const void* block_tables,
    const void* item_tree_start, const void* item_tree_mask, int tree_qw,
    int layer, int n_items, int t, int hq, int hkv, int d, int max_blk,
    int64_t layer_stride, int kv_fp8, int rows_per_tile, float scale,
    void* stream) {
  return static_cast<int>(dispatch<RaggedF>(
      kv_fp8, d, rows_per_tile, q, out, kv,
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
  return static_cast<int>(dispatch<GroupedF>(
      kv_fp8, d, rows_per_tile, q, out, kv,
      static_cast<const float*>(kv_scale), static_cast<const int*>(pos_base),
      static_cast<const int*>(seq_lens),
      static_cast<const int*>(block_tables), knew, vnew,
      static_cast<const int*>(slot_mapping), layer, b, t, qlen, hq, hkv,
      max_blk, layer_stride, scale, static_cast<cudaStream_t>(stream)));
}

// Kernel 4: q / out [t, hq, D] bf16, rows of sequence s at [s*qlen,
// (s+1)*qlen); one CTA per sequence.  Hkv*D elements of the cache must
// fit 2 KiB (the host checks).
extern "C" int decode_paged_launch(void* q, void* out, const void* kv,
                                   const void* kv_scale, const void* pos_base,
                                   const void* seq_lens,
                                   const void* block_tables, int layer, int b,
                                   int t, int qlen, int hq, int hkv, int d,
                                   int max_blk, int64_t layer_stride,
                                   int kv_fp8, int rows_per_warp, float scale,
                                   void* stream) {
  return static_cast<int>(dispatch_decode_paged(
      kv_fp8, d, rows_per_warp, q, out, kv,
      static_cast<const float*>(kv_scale), static_cast<const int*>(pos_base),
      static_cast<const int*>(seq_lens),
      static_cast<const int*>(block_tables), layer, b, t, qlen, hq, hkv,
      max_blk, layer_stride, scale, static_cast<cudaStream_t>(stream)));
}

// HBM read probe for Hopper (sm_90a): a read stream over a large buffer.
//
// Replaces bench.py _measure_dma_read (the pallas_call at bench.py:120):
// a double-buffered HBM -> VMEM stream over a [1024, 32, 512, 128] bf16
// buffer (4 GiB in 1024 chunks of 4 MiB) whose value is
//
//   sum over chunks c, in chunk order, of f32 sum(x[c, 0, 0, :]).
//
// Every byte is read once; only each chunk's first row (128 values) is
// summed, which keeps the copies consumed.  The GB/s it reads is the
// bench's measured ceiling for the decode step's weight stream.
//
// What bounds it on an H100: nothing but the bytes: 4 GiB against
// 3.35 TB/s is 1.28 ms.
//
// Design.  The TPU kernel's single sequential stream is not copied: the
// buffer is cut into kTileBytes tiles, and CTA b of G streams the
// contiguous tiles [b*T/G, (b+1)*T/G) through kStages shared-memory
// buffers with 16-byte cp.async copies (kStages - 1 tiles in flight per
// CTA, one CTA per SM).  When a tile that starts a chunk has landed,
// warp 0 sums the chunk's first row (lane l adds values 4l..4l+3, then a
// fixed xor-shuffle tree) and writes the chunk's partial.  A second
// kernel adds the partials in chunk order, so the result is the same in
// every run and every grid.
//
// The wrapper (ops/cuda/hbm_probe.py) checks the buffer and computes the
// grid; the C entry re-checks what a launch needs and returns a CUDA
// error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopiesPerThread = 8;  // 16-byte copies per thread per tile
constexpr int kTileBytes = kThreads * kCopiesPerThread * 16;  // 32 KiB
constexpr int kStages = 6;
constexpr int kSmemBytes = kStages * kTileBytes;  // 192 KiB
constexpr int kRowElems = 128;                    // bf16 values per row
constexpr int kReduceThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load_tile(const uint8_t* x, long long tile,
                                          uint8_t* dst, int tid) {
  const uint8_t* src = x + tile * kTileBytes;
#pragma unroll
  for (int q = 0; q < kCopiesPerThread; ++q) {
    const int off = (q * kThreads + tid) * 16;
    cp_async16(dst + off, src + off);
  }
}

__global__ void __launch_bounds__(kThreads)
    read_stream_kernel(const uint8_t* x, long long n_tiles,
                       int tiles_per_chunk, float* chunk_sums) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long g = gridDim.x, b = blockIdx.x;
  const long long t0 = b * n_tiles / g;
  const int nt = static_cast<int>((b + 1) * n_tiles / g - t0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load_tile(x, t0 + s, smem + s * kTileBytes, tid);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // Refill the buffer read in the previous iteration (every warp has
    // passed the barrier above, so none still reads it).
    const int pf = it + kStages - 1;
    if (pf < nt) load_tile(x, t0 + pf, smem + (pf % kStages) * kTileBytes, tid);
    cp_async_commit();
    const long long t = t0 + it;
    if (warp == 0 && t % tiles_per_chunk == 0) {
      const __nv_bfloat16* row = reinterpret_cast<const __nv_bfloat16*>(
          smem + (it % kStages) * kTileBytes);
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < kRowElems / 32; ++j)
        v += __bfloat162float(row[lane * (kRowElems / 32) + j]);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      if (lane == 0) chunk_sums[t / tiles_per_chunk] = v;
    }
  }
  cp_async_wait<0>();
}

// out[0] = sum of the chunk partials in chunk order: the block stages a
// window of partials in shared memory, thread 0 adds them one by one.
__global__ void __launch_bounds__(kReduceThreads)
    sum_partials_kernel(const float* chunk_sums, int n_chunks, float* out) {
  __shared__ float win[4096];
  float acc = 0.f;
  for (int lo = 0; lo < n_chunks; lo += 4096) {
    const int n = min(4096, n_chunks - lo);
    for (int i = threadIdx.x; i < n; i += kReduceThreads)
      win[i] = chunk_sums[lo + i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < n; ++i) acc += win[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

extern "C" int hbm_probe_tile_bytes() { return kTileBytes; }

extern "C" int hbm_probe_launch(const void* x, long long n_bytes,
                                long long chunk_bytes, int ctas,
                                void* chunk_sums, void* out, void* stream) {
  if (n_bytes <= 0 || chunk_bytes < kRowElems * 2 ||
      chunk_bytes % kTileBytes || n_bytes % chunk_bytes || ctas <= 0 ||
      ctas > n_bytes / kTileBytes ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      read_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tiles = n_bytes / kTileBytes;
  const int tiles_per_chunk = static_cast<int>(chunk_bytes / kTileBytes);
  const int n_chunks = static_cast<int>(n_bytes / chunk_bytes);
  read_stream_kernel<<<ctas, kThreads, kSmemBytes, st>>>(
      static_cast<const uint8_t*>(x), n_tiles, tiles_per_chunk,
      static_cast<float*>(chunk_sums));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kReduceThreads, 0, st>>>(
      static_cast<const float*>(chunk_sums), n_chunks,
      static_cast<float*>(out));
  return cudaGetLastError();
}

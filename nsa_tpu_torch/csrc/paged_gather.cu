// The block gather for Hopper (sm_90a): S blocks of Bs rows per (batch row,
// KV head) out of a dense cache [b, kvh, L, D] into [b, kvh, S * Bs, D].
//
// Replaces the TPU kernel nsa_tpu/ops/pallas/paged_gather.py::paged_gather
// (_gather_kernel :25, pallas_call :73), one DMA per block there.  The
// ragged split decode route gathers the selected and trailing blocks with
// it (nsa_tpu/ops/nsa.py:939-942).
//
// What bounds it on this card: bytes, a pure copy of S * Bs rows per (row,
// head) read once and written once, 2.36 MB each way at the engine cell
// (16 slots x 4 heads x 9 blocks of 16 x 256 B).  So every byte has to be
// in flight at once, on every SM: one CTA of 64 threads per (row, head,
// block), 576 CTAs at the engine cell and 2,304 at 64 rows, all resident
// in one wave (32 CTAs fit an SM).  A CTA reads its block id once, a
// broadcast load, before any data load, with no divide; each thread then
// copies its vectors in rounds of four 16-byte loads, all before their
// stores: one round, unguarded, at the cell's 16 x 256-byte blocks, whose
// vector count is a compile-time constant; guarded rounds at other sizes.
// A block id outside the cache is clamped to [0, L / Bs - 1], as the plain
// version does.  The id rows are read by their strides, so the caller
// passes the first S columns of its info rows as they are.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 4;                       // 16-byte loads in flight per thread
constexpr int kCellVecs = kThreads * kUnroll;    // 16 rows of 256 bytes

// kVecs: vectors a block, a multiple of kCellVecs known when compiled, or 0:
// `vecs`, known at run time
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
    paged_gather_kernel(const uint4* __restrict__ cache, const int* __restrict__ idx,
                        uint4* __restrict__ out, int nblocks, int vecs, int stride_b,
                        int stride_h) {
  static_assert(kVecs % kCellVecs == 0, "a whole number of rounds");
  const int s = blockIdx.x, h = blockIdx.y, i = blockIdx.z;
  const int blk = min(max(idx[(size_t)i * stride_b + (size_t)h * stride_h + s], 0), nblocks - 1);
  const size_t bh = (size_t)i * gridDim.y + h;
  if constexpr (kVecs > 0) vecs = kVecs;
  const uint4* src = cache + (bh * nblocks + blk) * vecs;
  uint4* dst = out + (bh * gridDim.x + s) * vecs;
  const int rounds = kVecs ? kVecs / kCellVecs : (vecs + kCellVecs - 1) / kCellVecs;
  for (int r = 0; r < rounds; ++r) {
    const int v = r * kCellVecs + threadIdx.x;
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (kVecs || v + u * kThreads < vecs) x[u] = src[v + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (kVecs || v + u * kThreads < vecs) dst[v + u * kThreads] = x[u];
  }
}

}  // namespace

// cache [b, kvh, L, D] (row bytes a multiple of 16), idx int32 block ids,
// id (i, h, s) at idx[i * stride_b + h * stride_h + s] -> out
// [b, kvh, S * Bs, D]; row_bytes = D * element size.
extern "C" int nsa_paged_gather(const void* cache, const void* idx, void* out, int b, int kvh,
                                int L, int S, int Bs, int row_bytes, int stride_b, int stride_h,
                                void* stream) {
  if (row_bytes % 16 || L % Bs || b > 65535 || kvh > 65535) return (int)cudaErrorInvalidValue;
  const int nblocks = L / Bs, vecs = Bs * (row_bytes / 16);
  const dim3 grid(S, kvh, b);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vecs == kCellVecs)
    paged_gather_kernel<kCellVecs><<<grid, kThreads, 0, st>>>(
        (const uint4*)cache, (const int*)idx, (uint4*)out, nblocks, vecs, stride_b, stride_h);
  else
    paged_gather_kernel<0><<<grid, kThreads, 0, st>>>(
        (const uint4*)cache, (const int*)idx, (uint4*)out, nblocks, vecs, stride_b, stride_h);
  return (int)cudaGetLastError();
}

// The block gather for Hopper (sm_90a): S blocks of Bs rows per (batch row,
// KV head) out of a dense cache [b, kvh, L, D] into [b, kvh, S * Bs, D].
//
// Replaces the TPU kernel nsa_tpu/ops/pallas/paged_gather.py::paged_gather
// (_gather_kernel :25, pallas_call :73), one DMA per block there.  The
// ragged split decode route gathers the selected and trailing blocks with
// it (nsa_tpu/ops/nsa.py:939-942).
//
// What bounds it on this card: bytes, a pure copy of S * Bs rows per (row,
// head) read once and written once.  One block of 256 threads per (row,
// head) walks its rows in 16-byte vectors, neighbouring threads on
// neighbouring addresses, four loads in flight per thread; a block id
// outside the cache is clamped to the last block, as the plain version
// does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // 16-byte loads in flight per thread

__global__ void paged_gather_kernel(const uint4* __restrict__ cache, const int* __restrict__ idx,
                                    uint4* __restrict__ out, int L, int S, int Bs, int vec) {
  const int bh = blockIdx.x;
  const int nblocks = L / Bs, per_block = Bs * vec, n = S * per_block;
  const uint4* src = cache + (size_t)bh * L * vec;
  const int* ids = idx + (size_t)bh * S;
  uint4* dst = out + (size_t)bh * n;
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * blockDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {        // all loads first, then the stores
      const int i = i0 + u * blockDim.x;
      if (i >= n) break;
      const int blk = min(max(ids[i / per_block], 0), nblocks - 1);
      v[u] = src[(size_t)blk * per_block + i % per_block];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

}  // namespace

// cache [b, kvh, L, D] (row bytes a multiple of 16), idx [b, kvh, S] int32
// block ids -> out [b, kvh, S * Bs, D]; row_bytes = D * element size.
extern "C" int nsa_paged_gather(const void* cache, const void* idx, void* out, int bkvh, int L,
                                int S, int Bs, int row_bytes, void* stream) {
  if (row_bytes % 16 || L % Bs) return (int)cudaErrorInvalidValue;
  paged_gather_kernel<<<bkvh, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)cache, (const int*)idx, (uint4*)out, L, S, Bs, row_bytes / 16);
  return (int)cudaGetLastError();
}

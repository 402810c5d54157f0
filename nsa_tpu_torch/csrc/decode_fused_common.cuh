// Device code shared by the select-emit kernels (one position: row 6,
// nsa_decode_fused.cu; per-row positions: row 8, nsa_decode_ragged.cu), the
// one-launch attend kernel (rows 7, 9, 10, nsa_decode_ragged.cu) and the
// whole-model decode kernel (row 12, nsa_decode_mega.cu): the block size,
// bf16 rounding, the emission test, the emitted row from its chunk
// partials (rows 6, 8, 12), the ring shift (rows 6, 8) and the
// shared-memory attribute of a launch.  Every sum is taken in a fixed
// order; there are no atomics.
#pragma once

#include "decode_common.cuh"

namespace nsa {
namespace {

constexpr int kThreads = 32 * kBodyWarps;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Whether the step at position t, with num_cb compressed rows cached,
// completes a compressed block (JAX's run_fill + 1 == Bc).
__device__ __forceinline__ bool emits_at(int t, int num_cb, int stride) {
  return t - num_cb * stride + 1 == stride;
}

// The emitted row of (batch row bi, KV head h): the nchunks partials
// partial[h][chunk][bi][2kD] in chunk order, plus b2, rounded to bf16, into
// `row`.
template <typename BiasT>
__device__ void emit_row_body(const float* partial, const BiasT* __restrict__ b2, bf16* row,
                              int nchunks, int b, int bi, int h) {
  for (int e = threadIdx.x; e < 2 * kD; e += blockDim.x) {
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c) s += partial[(((size_t)h * nchunks + c) * b + bi) * 2 * kD + e];
    row[e] = __float2bfloat16(s + ldf(b2[h * 2 * kD + e]));
  }
}

// The ring shift of one (batch row, KV head): rows 1.. of `rg` [Bc][2kD]
// move down one and the new token's unrotated k || v (`new_row`, 2kD values)
// becomes the last; every source row is read into shared memory before any
// is written.  Ends with a barrier.
__device__ void ring_shift_body(bf16* rg, const bf16* new_row, int Bc, unsigned char* smem_raw) {
  constexpr int kVec = 2 * kD / 8;            // 16-byte vectors per packed row
  uint4* stage = reinterpret_cast<uint4*>(smem_raw);
  for (int i = threadIdx.x; i < Bc * kVec; i += blockDim.x) {
    const int j = i / kVec, c = i % kVec;
    const bf16* src = j < Bc - 1 ? rg + (size_t)(j + 1) * 2 * kD : new_row;
    stage[i] = reinterpret_cast<const uint4*>(src)[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Bc * kVec; i += blockDim.x)
    reinterpret_cast<uint4*>(rg)[i] = stage[i];
  __syncthreads();
}

cudaError_t set_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
}  // namespace nsa

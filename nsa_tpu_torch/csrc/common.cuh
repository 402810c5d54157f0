// Shared helpers for the port's CUDA kernels (bf16 in, float32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace nsa {

typedef __nv_bfloat16 bf16;

// Finite "minus infinity" for masked logits, as the TPU kernels use, so a
// fully masked tile leaves exp(m_old - m_new) = 1 instead of a NaN.
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// One value of a bf16 or float32 tensor as a float.
__device__ __forceinline__ float ldf(float x) { return x; }
__device__ __forceinline__ float ldf(bf16 x) { return __bfloat162float(x); }

// Two consecutive bf16 values as floats (the caller's pointer is 4-byte aligned).
__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned), L2 only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Wait for this thread's copies; a __syncthreads() must follow before other
// threads read them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q.k for G heads: q in shared memory as float [G][D], k a 16-byte aligned
// row of D bf16 (shared or global).
template <int G, int D>
__device__ __forceinline__ void dot_heads(const float* qs, const bf16* krow, float* s) {
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + 8 * u);
    const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 kf = __bfloat1622float2(kp[e]);
#pragma unroll
      for (int g = 0; g < G; ++g)
        s[g] += qs[g * D + 8 * u + 2 * e] * kf.x + qs[g * D + 8 * u + 2 * e + 1] * kf.y;
    }
  }
}

// Block-wide reduction of one value; `scratch` holds at least 32 floats.
// Every thread of the block must call it; all get the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = lane < nwarps ? scratch[lane] : (kMax ? kNeg : 0.f);
  return kMax ? warp_max(r) : warp_sum(r);
}

}  // namespace nsa

// NSA decode-step kernels for Hopper (sm_90a): select, then attend.
//
// Replaces the TPU kernels of nsa_tpu/ops/pallas/nsa_decode.py:
//   decode_select  (_select_kernel :55, pallas_call :195)
//   decode_attend  (_attend_kernel :212, pallas_call :325), with the block
//                  gather of nsa_tpu/ops/nsa.py:830-832 folded in.
//
// What bounds them on this card: bytes.  A decode step does a few FLOPs per
// byte of cache it reads, far below the H100's ~295 bf16 FLOP/byte ridge.
//   select reads the live compressed cache, num_cb rows of packed k||v
//     (256 B each at d = 64): ~32 MB per layer at bs 64 / 4 KV heads /
//     num_cb 487-500, about 10 us at 3.35 TB/s.
//   attend reads the (S + n_slide) * Bs = 144 gathered rows: ~9.4 MB per
//     layer, about 2.8 us.
// What the design does about it: one thread block per (batch row, KV head)
// reads its rows once and keeps every intermediate (logits, probabilities,
// scores, the top-k state) in shared memory; only c_out, the packed info row
// and the combined output go back.  The rows are staged into shared memory
// with 16-byte cp.async copies issued by all threads at once (up to 512 rows
// per tile), so the block has its whole read in flight instead of one
// dependent load per row; the dot products, softmaxes and weighted sums then
// run out of shared memory (rows padded by 16 bytes so a quarter-warp's
// 16-byte reads hit distinct banks).  select reads only the num_cb live rows,
// its k halves for the logits and then its v halves for c_out; attend stages
// only the rows that one of its two masks keeps.  The top-k is one warp's
// work and stays serial; no tensor cores (two query heads per KV head is too
// narrow a product for them).  The block bodies live in decode_common.cuh,
// shared with the fused route's kernels (nsa_decode_fused.cu).
#include "decode_common.cuh"

namespace nsa {
namespace {

template <int G>
__global__ void select_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ckv,
                              const bf16* __restrict__ mem_kv, bf16* __restrict__ c_out,
                              int* __restrict__ info, int kvh, int Wc, int M, int t,
                              int num_cb, int stride, int sel_block, int num_sel,
                              int n_slide, int max_blocks, int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  select_body<G>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb, stride, sel_block,
                 num_sel, n_slide, max_blocks, info_width, scale, blockIdx.x, smem_raw);
}

template <int G>
__global__ void attend_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ kv,
                              const int* __restrict__ info, const bf16* __restrict__ c_out,
                              const bf16* __restrict__ gates, bf16* __restrict__ out,
                              int max_len, int t, int sel_block, int window, int num_sel,
                              int n_slide, int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const float* comb = attend_body<G>(rq, DenseRows{const_cast<bf16*>(kv), max_len}, info, c_out,
                                     gates, nullptr, t, sel_block, window, num_sel, n_slide,
                                     info_width, scale, bh, smem_raw);
  for (int o = threadIdx.x; o < G * kD; o += blockDim.x)
    out[(size_t)bh * G * kD + o] = __float2bfloat16(comb[o]);
}

constexpr int kThreads = 256;

template <int G>
cudaError_t launch_select(const void* q, const void* ckv, const void* mem_kv, void* c_out,
                          void* info, int bkvh, int kvh, int Wc, int M, int t, int num_cb,
                          int stride, int sel_block, int num_sel, int n_slide, int max_blocks,
                          int info_width, float scale, cudaStream_t stream) {
  const int Wf = Wc / (sel_block / stride);
  const size_t shmem = select_smem_bytes<G>(Wc, M, Wf, kThreads);
  auto kern = select_kernel<G>;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  kern<<<bkvh, kThreads, shmem, stream>>>(
      (const bf16*)q, (const bf16*)ckv, (const bf16*)mem_kv, (bf16*)c_out, (int*)info, kvh,
      Wc, M, t, num_cb, stride, sel_block, num_sel, n_slide, max_blocks, info_width, scale);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_attend(const void* rq, const void* kv, const void* info, const void* c_out,
                          const void* gates, void* out, int bkvh, int max_len, int t,
                          int sel_block, int window, int num_sel, int n_slide, int info_width,
                          float scale, cudaStream_t stream) {
  const int J = (num_sel + n_slide) * sel_block;
  const size_t shmem = attend_smem_bytes<G>(J, kThreads);
  auto kern = attend_kernel<G>;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return e;
  }
  kern<<<bkvh, kThreads, shmem, stream>>>(
      (const bf16*)rq, (const bf16*)kv, (const int*)info, (const bf16*)c_out,
      (const bf16*)gates, (bf16*)out, max_len, t, sel_block, window, num_sel, n_slide,
      info_width, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// q [b, kvh, G, 64] bf16 (unrotated); ckv [b, kvh, Wc, 128] bf16; mem_kv
// [2, kvh, M, 64] bf16 -> c_out [b, kvh, G, 64] bf16, info [b, kvh,
// info_width] int32.  Returns the launch's cudaError_t.
extern "C" int nsa_decode_select(const void* q, const void* ckv, const void* mem_kv,
                                 void* c_out, void* info, int b, int kvh, int G, int Wc, int M,
                                 int t, int num_cb, int stride, int sel_block, int num_sel,
                                 int n_slide, int max_blocks, int info_width, float scale,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int bkvh = b * kvh;
#define NSA_SELECT(GG)                                                                   \
  return (int)nsa::launch_select<GG>(q, ckv, mem_kv, c_out, info, bkvh, kvh, Wc, M, t,   \
                                     num_cb, stride, sel_block, num_sel, n_slide,        \
                                     max_blocks, info_width, scale, s)
  switch (G) {
    case 1: NSA_SELECT(1);
    case 2: NSA_SELECT(2);
    case 4: NSA_SELECT(4);
    case 8: NSA_SELECT(8);
  }
#undef NSA_SELECT
  return (int)cudaErrorInvalidValue;
}

// rq [b, kvh, G, 64] bf16 (rotated); kv [b, kvh, max_len, 128] bf16 packed
// k||v cache; info [b, kvh, info_width] int32 from nsa_decode_select; c_out
// [b, kvh, G, 64] bf16; gates [b, kvh, G, 3] bf16 -> out [b, kvh, G, 64] bf16.
extern "C" int nsa_decode_attend(const void* rq, const void* kv, const void* info,
                                 const void* c_out, const void* gates, void* out, int b, int kvh,
                                 int G, int max_len, int t, int sel_block, int window,
                                 int num_sel, int n_slide, int info_width, float scale,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int bkvh = b * kvh;
#define NSA_ATTEND(GG)                                                                  \
  return (int)nsa::launch_attend<GG>(rq, kv, info, c_out, gates, out, bkvh, max_len, t, \
                                     sel_block, window, num_sel, n_slide, info_width,   \
                                     scale, s)
  switch (G) {
    case 1: NSA_ATTEND(1);
    case 2: NSA_ATTEND(2);
    case 4: NSA_ATTEND(4);
    case 8: NSA_ATTEND(8);
  }
#undef NSA_ATTEND
  return (int)cudaErrorInvalidValue;
}

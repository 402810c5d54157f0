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
//     (256 B each at d = 64): ~32.7 MB per layer at bs 64 / 4 KV heads /
//     num_cb 499, about 9.8 us at 3.35 TB/s.
//   attend reads the rows its two masks keep of the (S + n_slide) * Bs =
//     144 gathered rows: ~8.6 MB per layer, about 2.6 us.
// What the design does about it: one block of 256 threads per (batch row,
// KV head), 256 blocks at bs 64, each the split softmax of flash decoding
// inside the block (the bodies in decode_common.cuh, shared with the fused,
// ragged and whole-model kernels).  select streams each live row once, as
// its whole 256-byte packed row: the rows go to the warps in chunks of 16,
// and each warp keeps one chunk of cp.async copies in flight in its own
// 2-slot ring (76 KB of shared memory a block) while it takes a chunk's
// logits (one lane per row and head, in dot_heads's float32 order, kept for
// the importance), folds them with the chunk's v halves into its running
// c_out (max, sum and weighted v in registers, shuffles only) and pools the
// chunk's fine blocks.  After one barrier warp 0 takes the score softmax
// and the top-k (a warp max a selected id; only the lane that gave it looks
// again) while the other warps merge their running sums into c_out.  attend
// reads the info row and c_out, and each warp copies the kept rows of its
// own 16-column tiles at once; per tile one lane per (column, head) takes
// the logit, both masked softmaxes fold into the warp's running sums, and
// one merge across the warps gives the combined output.  No tensor cores:
// two query heads per KV head is too narrow a product for them.  Both read
// the position t from one int32 in device memory (select derives num_cb =
// t / stride from it), so a captured CUDA graph replays them at whatever
// position the step before it wrote there.
#include "decode_common.cuh"

namespace nsa {
namespace {

constexpr int kThreads = 32 * kBodyWarps;

template <int G>
__global__ void __launch_bounds__(kThreads)
    select_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ckv,
                  const bf16* __restrict__ mem_kv, bf16* __restrict__ c_out,
                  int* __restrict__ info, int kvh, int Wc, int M, const int* __restrict__ tp,
                  int stride, int sel_block, int num_sel, int n_slide, int max_blocks,
                  int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = *tp, num_cb = t / stride;
  select_body<G, bf16>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb, stride, sel_block,
                       num_sel, n_slide, max_blocks, info_width, scale, blockIdx.x, smem_raw);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    attend_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ kv,
                  const int* __restrict__ info, const bf16* __restrict__ c_out,
                  const bf16* __restrict__ gates, bf16* __restrict__ out, int max_len,
                  const int* __restrict__ tp, int sel_block, int window, int num_sel,
                  int n_slide, int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, t = *tp;
  const float* comb = attend_body<G>(rq, DenseRows{const_cast<bf16*>(kv), max_len}, info, c_out,
                                     gates, nullptr, t, sel_block, window, num_sel, n_slide,
                                     info_width, scale, bh, smem_raw);
  for (int o = threadIdx.x; o < G * kD; o += blockDim.x)
    out[(size_t)bh * G * kD + o] = __float2bfloat16(comb[o]);
}

// Lets `kern` take `shmem` bytes of dynamic shared memory.
cudaError_t allow_smem(const void* kern, size_t shmem) {
  if (shmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
}

template <int G>
cudaError_t launch_select(const void* q, const void* ckv, const void* mem_kv, void* c_out,
                          void* info, int bkvh, int kvh, int Wc, int M, const int* t,
                          int stride, int sel_block, int num_sel, int n_slide, int max_blocks,
                          int info_width, float scale, cudaStream_t stream) {
  const int Wf = Wc / (sel_block / stride);
  const size_t shmem = select_smem_bytes<G, bf16>(Wc, M, Wf);
  auto kern = select_kernel<G>;
  const cudaError_t e = allow_smem((const void*)kern, shmem);
  if (e != cudaSuccess) return e;
  kern<<<bkvh, kThreads, shmem, stream>>>(
      (const bf16*)q, (const bf16*)ckv, (const bf16*)mem_kv, (bf16*)c_out, (int*)info, kvh,
      Wc, M, t, stride, sel_block, num_sel, n_slide, max_blocks, info_width, scale);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_attend(const void* rq, const void* kv, const void* info, const void* c_out,
                          const void* gates, void* out, int bkvh, int max_len, const int* t,
                          int sel_block, int window, int num_sel, int n_slide, int info_width,
                          float scale, cudaStream_t stream) {
  const int J = (num_sel + n_slide) * sel_block;
  const size_t shmem = attend_smem_bytes<G>(J);
  auto kern = attend_kernel<G>;
  const cudaError_t e = allow_smem((const void*)kern, shmem);
  if (e != cudaSuccess) return e;
  kern<<<bkvh, kThreads, shmem, stream>>>(
      (const bf16*)rq, (const bf16*)kv, (const int*)info, (const bf16*)c_out,
      (const bf16*)gates, (bf16*)out, max_len, t, sel_block, window, num_sel, n_slide,
      info_width, scale);
  return cudaGetLastError();
}

// The two kernels' shared memory a block and blocks an SM, and the card's
// opt-in limit a block, into out[5].
template <int G>
cudaError_t split_plan(int Wc, int M, int Wf, int J, int* out) {
  const size_t ss = select_smem_bytes<G, bf16>(Wc, M, Wf);
  const size_t as = attend_smem_bytes<G>(J);
  cudaError_t e;
  int dev;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&out[4], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (e = allow_smem((const void*)select_kernel<G>, ss)) != cudaSuccess ||
      (e = allow_smem((const void*)attend_kernel<G>, as)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], select_kernel<G>, kThreads,
                                                         ss)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], attend_kernel<G>, kThreads,
                                                         as)) != cudaSuccess)
    return e;
  out[0] = (int)ss;
  out[2] = (int)as;
  return cudaSuccess;
}

}  // namespace
}  // namespace nsa

// q [b, kvh, G, 64] bf16 (unrotated); ckv [b, kvh, Wc, 128] bf16; mem_kv
// [2, kvh, M, 64] bf16; t one int32 on the device, the position (the kernel
// reads it, and num_cb = t / stride) -> c_out [b, kvh, G, 64] bf16, info
// [b, kvh, info_width] int32.  Returns the launch's cudaError_t.
extern "C" int nsa_decode_select(const void* q, const void* ckv, const void* mem_kv,
                                 void* c_out, void* info, const void* t, int b, int kvh, int G,
                                 int Wc, int M, int stride, int sel_block, int num_sel,
                                 int n_slide, int max_blocks, int info_width, float scale,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int bkvh = b * kvh;
#define NSA_SELECT(GG)                                                                   \
  return (int)nsa::launch_select<GG>(q, ckv, mem_kv, c_out, info, bkvh, kvh, Wc, M,      \
                                     (const int*)t, stride, sel_block, num_sel, n_slide, \
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
// [b, kvh, G, 64] bf16; gates [b, kvh, G, 3] bf16; t one int32 on the
// device, the position -> out [b, kvh, G, 64] bf16.
extern "C" int nsa_decode_attend(const void* rq, const void* kv, const void* info,
                                 const void* c_out, const void* gates, void* out, const void* t,
                                 int b, int kvh, int G, int max_len, int sel_block, int window,
                                 int num_sel, int n_slide, int info_width, float scale,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int bkvh = b * kvh;
#define NSA_ATTEND(GG)                                                                  \
  return (int)nsa::launch_attend<GG>(rq, kv, info, c_out, gates, out, bkvh, max_len,    \
                                     (const int*)t,                                     \
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

// The launch geometry of both kernels at G heads a KV head, ckv width Wc, M
// mem slots, Wf fine blocks and J attended columns, written to out[5]:
// select's shared memory a block, its blocks an SM, attend's two, and the
// card's opt-in shared memory a block.  Returns the first failing call's
// cudaError_t.
extern "C" int nsa_decode_split_plan(int G, int Wc, int M, int Wf, int J, void* out) {
  int* o = (int*)out;
  switch (G) {
    case 1: return (int)nsa::split_plan<1>(Wc, M, Wf, J, o);
    case 2: return (int)nsa::split_plan<2>(Wc, M, Wf, J, o);
    case 4: return (int)nsa::split_plan<4>(Wc, M, Wf, J, o);
    case 8: return (int)nsa::split_plan<8>(Wc, M, Wf, J, o);
  }
  return (int)cudaErrorInvalidValue;
}

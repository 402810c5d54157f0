// The one-position select-emit kernel for Hopper (sm_90a): one NSA layer's
// selection, ring shift and compressed-block emission at small batch, every
// row at one position t, read from an int32 in device memory (so a captured
// CUDA graph replays it at each step's position).  Its partner on the fused
// route, decode_attend_fused, is the one-launch attend kernel of
// nsa_decode_ragged.cu at that one device position.
//
// Replaces the TPU kernel of nsa_tpu/ops/pallas/nsa_decode_fused.py:
//   decode_select_emit   (_select_emit_kernel :216, _select_math :100,
//                         pallas_call :441)
//
// It is the ragged select-emit of nsa_decode_ragged.cu (row 8) at one
// position, with the bodies that row owns.  Both launches run on every
// step; each reads t and decides on the device whether the step emits
// ((t + 1) % stride == 0): launch 1 returns at once on the other steps.
// What bounds it on this card: bytes on an emitting step, the four
// compressors' weights (w1k + w1v + w2, 17.6 MB at the reference model, 5.3
// us at 3.35 TB/s), read once for all b rows; on the other steps the live
// compressed rows each (row, KV head) reads for its selection, which is
// latency-bound (a chain of staging, reductions and a top-k on one block
// per (row, KV head), 32 blocks at bs 8).
//
// Launch 1 (work on emitting steps only): one block per (KV head, half, 64
// compressor hidden columns), 128 at the reference model, runs the
// tensor-core emission body (emit_tc_body, decode_tc_common.cuh) over all b
// rows as 16-row tiles: the window (the SHIFTED ring: rows 1.. of the old
// ring, then the new token, rows before position 0 zeroed, + pos_kv,
// rounded to bf16) times the block's 64 columns of w1k or w1v, streamed by
// TMA through an 8-stage mbarrier ring, + b1, relu, rounded; times its 64
// rows of w2: float32 partials per (head, chunk).  Launch 2, one block per
// (batch row, KV head), reads the old ring and the new token into shared
// memory before it writes the shifted ring (launch 1 has finished reading
// it: launches on one stream run in order), on emitting steps sums the
// partials in chunk order, adds b2 and writes the emitted row into
// ckv[num_cb] (emit_row_body), then runs the selection body (select_body,
// decode_common.cuh), which reads only ckv rows below num_cb.  The bits are
// row 8's at the same position.  Deterministic: no atomics.
#include "decode_tc_common.cuh"

namespace nsa {
namespace {

// Launch 1: the partials of all b rows on the tensor cores, one block per
// (KV head, half, 64 compressor hidden columns).  Dynamic shared memory:
// 1024-byte alignment slack, then the body's.
__global__ void __launch_bounds__(kThreads)
    emit_partial_kernel(const bf16* __restrict__ ring, const bf16* __restrict__ kv_new,
                        const bf16* __restrict__ pos_kv, const float* __restrict__ b1k,
                        const float* __restrict__ b1v, float* __restrict__ partial, int b,
                        int kvh, int Bc, int hid, const int* __restrict__ tp, int stride,
                        const __grid_constant__ CUtensorMap m_w1k,
                        const __grid_constant__ CUtensorMap m_w1v,
                        const __grid_constant__ CUtensorMap m_w2) {
  const int t = *tp;
  if ((t + 1) % stride != 0) return;           // not an emitting step: nothing to do
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kEmitBars];
  unsigned char* base =
      smem_raw + ((kEmitAlign - (smem_u32(smem_raw) & (kEmitAlign - 1))) & (kEmitAlign - 1));
  emit_ring_init(bars);
  __syncthreads();
  EmitRing er{bars, 0u, 0u};
  emit_tc_body(ring, kv_new, kv_new + kD, kvh * 2 * kD, 2 * kD, pos_kv, b1k, b1v, &m_w1k, &m_w1v,
               &m_w2, 0, partial, b, kvh, Bc, hid, t, blockIdx.x, er, base);
}

// Launch 2: one block per (batch row, KV head): the ring shift, the emitted
// row (emitting steps), then selection.
template <int G>
__global__ void select_emit_kernel(const bf16* __restrict__ q, bf16* ckv, bf16* __restrict__ ring,
                                   const bf16* __restrict__ kv_new,
                                   const bf16* __restrict__ mem_kv,
                                   const float* __restrict__ partial,
                                   const float* __restrict__ b2, bf16* __restrict__ c_out,
                                   int* __restrict__ info, int b, int kvh, int Wc, int M, int Bc,
                                   int nchunks, const int* __restrict__ tp, int stride,
                                   int sel_block, int num_sel, int n_slide, int max_blocks,
                                   int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, t = *tp, num_cb = t / stride;
  const bool emit = (t + 1) % stride == 0;
  ring_shift_body(ring + (size_t)bh * Bc * 2 * kD, kv_new + (size_t)bh * 2 * kD, Bc, smem_raw);
  if (emit)
    emit_row_body(partial, b2, ckv + ((size_t)bh * Wc + num_cb) * 2 * kD, nchunks, b, bh / kvh,
                  bh % kvh);
  __syncthreads();
  select_body<G, bf16>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb,
                                        stride, sel_block, num_sel, n_slide, max_blocks,
                                        info_width, scale, bh, smem_raw);
}

template <int G>
cudaError_t launch_select_emit(const bf16* q, bf16* ckv, bf16* ring, const bf16* kv_new,
                               const bf16* mem_kv, const bf16* pos_kv, const bf16* w1k,
                               const float* b1k, const bf16* w1v, const float* b1v,
                               const bf16* w2, const float* b2, bf16* c_out, int* info,
                               float* partial, int b, int kvh, int Wc, int M, int Bc, int hid,
                               const int* t, int stride, int sel_block, int num_sel,
                               int n_slide, int max_blocks, int info_width, float scale,
                               cudaStream_t stream) {
  cudaError_t e;
  const int nchunks = hid / kEmitCols, K = Bc * kD;
  CUtensorMap maps[3] = {};
  if (!encode_tiles(&maps[0], w1k, kvh * K, hid, kEmitCols) ||
      !encode_tiles(&maps[1], w1v, kvh * K, hid, kEmitCols) ||
      !encode_tiles(&maps[2], w2, kvh * hid, 2 * kD, kEmitCols))
    return cudaErrorInvalidValue;
  const size_t shmem_e = kEmitAlign + emit_tc_smem_bytes(K);
  if ((e = set_smem((const void*)emit_partial_kernel, shmem_e)) != cudaSuccess) return e;
  emit_partial_kernel<<<kvh * 2 * nchunks, kThreads, shmem_e, stream>>>(
      ring, kv_new, pos_kv, b1k, b1v, partial, b, kvh, Bc, hid, t, stride, maps[0], maps[1],
      maps[2]);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int Wf = Wc / (sel_block / stride);
  size_t shmem = select_smem_bytes<G, bf16>(Wc, M, Wf);
  const size_t ring_bytes = (size_t)Bc * 2 * kD * sizeof(bf16);
  if (shmem < ring_bytes) shmem = ring_bytes;
  auto kern = select_emit_kernel<G>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(q, ckv, ring, kv_new, mem_kv, partial, b2, c_out,
                                             info, b, kvh, Wc, M, Bc, nchunks, t, stride,
                                             sel_block, num_sel, n_slide, max_blocks,
                                             info_width, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// q [b, kvh, G, 64] bf16 (unrotated); ckv [b, kvh, Wc, 128] and ring [b,
// kvh, Bc, 128] bf16 caches (updated in place); kv_new [b, kvh, 1, 128]
// bf16; mem_kv [2, kvh, M, 64] bf16; pos_kv [kvh, Bc, 128] bf16; w1k, w1v
// [kvh, Bc*64, hid] bf16, b1k, b1v [kvh, hid] f32; w2 [kvh, hid, 128] bf16,
// b2 [kvh, 128] f32; t one int32 on the device, the position (num_cb = t /
// stride; the step emits when (t + 1) % stride == 0); partial [kvh, hid/64,
// b, 128] f32 scratch -> c_out [b, kvh, G, 64] bf16, info [b, kvh *
// info_width] int32.
// The emission launch takes row 8's plan (nsa_decode_emit_plan).  Returns
// the first failing launch's cudaError_t.
extern "C" int nsa_decode_select_emit(
    const void* q, void* ckv, void* ring, const void* kv_new, const void* mem_kv,
    const void* pos_kv, const void* w1k, const void* b1k, const void* w1v, const void* b1v,
    const void* w2, const void* b2, const void* t, void* c_out, void* info, void* partial,
    int b, int kvh, int G, int Wc, int M, int Bc, int hid, int stride, int sel_block,
    int num_sel, int n_slide, int max_blocks, int info_width, float scale, void* stream) {
  using nsa::bf16;
#define NSA_SELECT_EMIT(GG)                                                                   \
  return (int)nsa::launch_select_emit<GG>(                                                    \
      (const bf16*)q, (bf16*)ckv, (bf16*)ring, (const bf16*)kv_new, (const bf16*)mem_kv,     \
      (const bf16*)pos_kv, (const bf16*)w1k, (const float*)b1k, (const bf16*)w1v,            \
      (const float*)b1v, (const bf16*)w2, (const float*)b2, (bf16*)c_out, (int*)info,        \
      (float*)partial, b, kvh, Wc, M, Bc, hid, (const int*)t, stride, sel_block, num_sel,    \
      n_slide, max_blocks, info_width, scale, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_SELECT_EMIT(1);
    case 2: NSA_SELECT_EMIT(2);
    case 4: NSA_SELECT_EMIT(4);
    case 8: NSA_SELECT_EMIT(8);
  }
#undef NSA_SELECT_EMIT
  return (int)cudaErrorInvalidValue;
}

// The fused decode-step kernels for Hopper (sm_90a): one NSA layer's decode
// step at small batch as two kernels, each one or more launches from one C
// entry point.
//
// Replaces the TPU kernels of nsa_tpu/ops/pallas/nsa_decode_fused.py:
//   decode_select_emit   (_select_emit_kernel :216, _select_math :100,
//                         pallas_call :441)
//   decode_attend_fused  (_attend_fused_kernel :580, _attend_math :464,
//                         _ff_tail :556, pallas_call :830)
//
// What bounds them on this card: bytes.  At the reference model and bs 8:
//   decode_select_emit reads the live compressed cache (~1 MB at num_cb
//     499) every step, and on the 1 step in `stride` that emits, the
//     GroupedMLP compressor's weights (w1k + w1v + w2, ~4.4 MB per KV head).
//   decode_attend_fused reads the 144 gathered kv rows per (row, KV head),
//     w_out (0.5 MB) and the FF's two matrices (2 x 2 MB).
// A decode step does a few FLOPs per byte of weights at b <= 8, far below
// the H100's ~295 bf16 FLOP/byte ridge, so the design reads every weight
// once per launch for all batch rows (up to kBG = 8 rows at a time) and
// splits the weight columns over many blocks to have enough of the card's
// memory system in flight:
//
// decode_select_emit: on emission steps a first launch runs one block per
//   (KV head, 64 hidden columns of the compressor): it builds the emission
//   window (the SHIFTED ring: rows 1.. of the old ring, then the new
//   token, rows before position 0 zeroed, k_pos||v_pos added, rounded to
//   bf16), multiplies it by its 64 columns of w1k / w1v, adds the bias,
//   applies relu and rounds, and multiplies those 64 hidden values by their
//   64 rows of w2: a partial sum of the emitted row per (head, chunk).  The
//   second launch, one block per (batch row, KV head), reads the old ring
//   and the new token into shared memory before it writes the shifted ring
//   (the first launch has finished reading it: launches on one stream run
//   in order), sums the partials in chunk order, adds b2 and writes the
//   emitted row into ckv[num_cb] (on emission steps only), then runs the
//   split route's selection body, which reads only rows below num_cb.
//   Deterministic: no atomics.
// decode_attend_fused: launch 1, one block per (batch row, KV head), writes
//   the new token's row into kv[t], runs the split route's attention body
//   with row t staged from the new token, rounds the combined output to
//   bf16 and multiplies it by its head's rows of w_out: a partial
//   projection per (row, head) in float32.  Launch 2, one block per 64 FF
//   hidden columns (one block without the FF), adds x and the heads'
//   partials in head order in float32 and rounds once (y); block 0 writes
//   y to the output; with the FF it normalizes y, multiplies by its
//   columns of w1, adds b1 and applies the exact erf GELU into a bf16
//   hidden row.  Launch 3, one block per 16 output columns, multiplies the
//   hidden row by its columns of w2, adds b2 and y, and writes the output.
//   Deterministic: every sum in a fixed order, no atomics.
// Rounding points follow the TPU kernels (see ops/cuda/nsa_decode_fused.py).
// No tensor cores: at <= 8 rows a product is a few matrix-vector products.
// The bodies of these kernels live in decode_fused_common.cuh, shared with
// the whole-model decode kernel (nsa_decode_mega.cu); the kernels here are
// thin wrappers, one work item per block.
#include "decode_fused_common.cuh"

namespace nsa {
namespace {

constexpr int kEmitCols = 64;     // compressor hidden columns per emission block

// decode_select_emit, launch 1 (emission steps only): one block per (KV
// head, kEmitCols hidden columns); partial[h][chunk][b][2*kD].
__global__ void emit_partial_kernel(const bf16* __restrict__ ring, const bf16* __restrict__ kv_new,
                                    const bf16* __restrict__ pos_kv,
                                    const bf16* __restrict__ w1k, const float* __restrict__ b1k,
                                    const bf16* __restrict__ w1v, const float* __restrict__ b1v,
                                    const bf16* __restrict__ w2, float* __restrict__ partial,
                                    int b, int kvh, int Bc, int hid, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  emit_partial_body<kEmitCols>(ring, kv_new, kv_new + kD, kvh * 2 * kD, 2 * kD, pos_kv, w1k, b1k,
                               w1v, b1v, w2, partial, b, kvh, Bc, hid, t, blockIdx.x, smem_raw);
}

// decode_select_emit, launch 2: one block per (batch row, KV head): the ring
// shift, the emitted row (emission steps), then selection.
template <int G>
__global__ void select_emit_kernel(const bf16* __restrict__ q, bf16* ckv, bf16* __restrict__ ring,
                                   const bf16* __restrict__ kv_new,
                                   const bf16* __restrict__ mem_kv,
                                   const float* __restrict__ partial,
                                   const float* __restrict__ b2, bf16* __restrict__ c_out,
                                   int* __restrict__ info, int b, int kvh, int Wc, int M, int Bc,
                                   int nchunks, int t, int num_cb, int emit, int stride,
                                   int sel_block, int num_sel, int n_slide, int max_blocks,
                                   int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  ring_shift_body(ring + (size_t)bh * Bc * 2 * kD, kv_new + (size_t)bh * 2 * kD, Bc, smem_raw);
  if (emit)
    emit_row_body(partial, b2, ckv + ((size_t)bh * Wc + num_cb) * 2 * kD, nchunks, b, bh / kvh,
                  bh % kvh);
  __syncthreads();
  select_body<G>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb, stride, sel_block,
                 num_sel, n_slide, max_blocks, info_width, scale, bh, smem_raw);
}

// decode_attend_fused, launch 1: one block per (batch row, KV head): the kv
// row write, attention, the head's partial projection part[b][h][dim].
template <int G>
__global__ void attend_fused_kernel(const bf16* __restrict__ rq, bf16* kv,
                                    const bf16* __restrict__ kv_new, const int* __restrict__ info,
                                    const bf16* __restrict__ c_out,
                                    const bf16* __restrict__ gates,
                                    const bf16* __restrict__ w_out, float* __restrict__ part,
                                    int kvh, int max_len, int dim, int t, int sel_block,
                                    int window, int num_sel, int n_slide, int info_width,
                                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attend_out_body<G>(rq, DenseRows{kv, max_len}, kv_new, info, c_out, gates, w_out, part, kvh,
                     dim, t, sel_block, window, num_sel, n_slide, info_width, scale, blockIdx.x,
                     smem_raw);
}

template <int G>
cudaError_t launch_select_emit(const bf16* q, bf16* ckv, bf16* ring, const bf16* kv_new,
                               const bf16* mem_kv, const bf16* pos_kv, const bf16* w1k,
                               const float* b1k, const bf16* w1v, const float* b1v,
                               const bf16* w2, const float* b2, bf16* c_out, int* info,
                               float* partial, int b, int kvh, int Wc, int M, int Bc, int hid,
                               int t, int num_cb, int stride, int sel_block, int num_sel,
                               int n_slide, int max_blocks, int info_width, int emit,
                               float scale, cudaStream_t stream) {
  cudaError_t e;
  const int nchunks = hid / kEmitCols;
  if (emit) {
    const size_t shmem = emit_smem_bytes<kEmitCols>(Bc);
    if ((e = set_smem((const void*)emit_partial_kernel, shmem)) != cudaSuccess) return e;
    emit_partial_kernel<<<kvh * nchunks, kThreads, shmem, stream>>>(
        ring, kv_new, pos_kv, w1k, b1k, w1v, b1v, w2, partial, b, kvh, Bc, hid, t);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const int Wf = Wc / (sel_block / stride);
  size_t shmem = select_smem_bytes<G>(Wc, M, Wf, kThreads);
  const size_t ring_bytes = (size_t)Bc * 2 * kD * sizeof(bf16);
  if (shmem < ring_bytes) shmem = ring_bytes;
  auto kern = select_emit_kernel<G>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(q, ckv, ring, kv_new, mem_kv, partial, b2, c_out,
                                             info, b, kvh, Wc, M, Bc, nchunks, t, num_cb, emit,
                                             stride, sel_block, num_sel, n_slide, max_blocks,
                                             info_width, scale);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_attend_fused(const bf16* rq, bf16* kv, const bf16* kv_new, const int* info,
                                const bf16* c_out, const bf16* gates, const bf16* x,
                                const bf16* w_out, const float* ff_norm, const bf16* ff_w1,
                                const float* ff_b1, const bf16* ff_w2, const float* ff_b2,
                                float* part, bf16* hbuf, bf16* out, int b, int kvh,
                                int max_len, int dim, int hid4, int t, int sel_block,
                                int window, int num_sel, int n_slide, int info_width,
                                float scale, float eps, cudaStream_t stream) {
  cudaError_t e;
  const int J = (num_sel + n_slide) * sel_block;
  const size_t shmem = attend_smem_bytes<G>(J, kThreads);
  auto kern = attend_fused_kernel<G>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(rq, kv, kv_new, info, c_out, gates, w_out, part,
                                             kvh, max_len, dim, t, sel_block, window, num_sel,
                                             n_slide, info_width, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_resid_ff(x, part, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2, hbuf, out, b, kvh, dim,
                         hid4, eps, stream);
}

}  // namespace
}  // namespace nsa

// q [b, kvh, G, 64] bf16 (unrotated); ckv [b, kvh, Wc, 128] and ring [b,
// kvh, Bc, 128] bf16 caches (updated in place); kv_new [b, kvh, 1, 128]
// bf16; mem_kv [2, kvh, M, 64] bf16; pos_kv [kvh, Bc, 128] bf16; w1k, w1v
// [kvh, Bc*64, hid] bf16, b1k, b1v [kvh, hid] f32; w2 [kvh, hid, 128] bf16,
// b2 [kvh, 128] f32; partial [kvh, hid/64, b, 128] f32 scratch (emission
// steps) -> c_out [b, kvh, G, 64] bf16, info [b, kvh * info_width] int32.
// Returns the first failing launch's cudaError_t.
extern "C" int nsa_decode_select_emit(
    const void* q, void* ckv, void* ring, const void* kv_new, const void* mem_kv,
    const void* pos_kv, const void* w1k, const void* b1k, const void* w1v, const void* b1v,
    const void* w2, const void* b2, void* c_out, void* info, void* partial, int b, int kvh,
    int G, int Wc, int M, int Bc, int hid, int t, int num_cb, int stride, int sel_block,
    int num_sel, int n_slide, int max_blocks, int info_width, int emit, float scale,
    void* stream) {
  using nsa::bf16;
#define NSA_SELECT_EMIT(GG)                                                                   \
  return (int)nsa::launch_select_emit<GG>(                                                    \
      (const bf16*)q, (bf16*)ckv, (bf16*)ring, (const bf16*)kv_new, (const bf16*)mem_kv,     \
      (const bf16*)pos_kv, (const bf16*)w1k, (const float*)b1k, (const bf16*)w1v,            \
      (const float*)b1v, (const bf16*)w2, (const float*)b2, (bf16*)c_out, (int*)info,        \
      (float*)partial, b, kvh, Wc, M, Bc, hid, t, num_cb, stride, sel_block, num_sel,        \
      n_slide, max_blocks, info_width, emit, scale, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_SELECT_EMIT(1);
    case 2: NSA_SELECT_EMIT(2);
    case 4: NSA_SELECT_EMIT(4);
    case 8: NSA_SELECT_EMIT(8);
  }
#undef NSA_SELECT_EMIT
  return (int)cudaErrorInvalidValue;
}

// rq [b, kvh, G, 64] bf16 (rotated); kv [b, kvh, max_len, 128] bf16 (row t
// written in place); kv_new [b, kvh, 1, 128] bf16 (rotated k || v); info
// [b, kvh * info_width] int32; c_out [b, kvh, G, 64] bf16; gates [b, kvh, G,
// 3] bf16; x [b, 1, dim] bf16; w_out [kvh*G*64, dim] bf16; the FF (null
// pointers and hid4 0 without it): norm [dim] f32, w1 [dim, hid4] bf16, b1
// [hid4] f32, w2 [hid4, dim] bf16, b2 [dim] f32; scratch part [b, kvh, dim]
// f32 and hbuf [b, hid4] bf16 -> out [b, 1, dim] bf16.  Returns the first
// failing launch's cudaError_t.
extern "C" int nsa_decode_attend_fused(
    const void* rq, void* kv, const void* kv_new, const void* info, const void* c_out,
    const void* gates, const void* x, const void* w_out, const void* ff_norm, const void* ff_w1,
    const void* ff_b1, const void* ff_w2, const void* ff_b2, void* part, void* hbuf, void* out,
    int b, int kvh, int G, int max_len, int dim, int hid4, int t, int sel_block, int window,
    int num_sel, int n_slide, int info_width, float scale, float eps, void* stream) {
  using nsa::bf16;
#define NSA_ATTEND_FUSED(GG)                                                                 \
  return (int)nsa::launch_attend_fused<GG>(                                                  \
      (const bf16*)rq, (bf16*)kv, (const bf16*)kv_new, (const int*)info, (const bf16*)c_out, \
      (const bf16*)gates, (const bf16*)x, (const bf16*)w_out, (const float*)ff_norm,        \
      (const bf16*)ff_w1, (const float*)ff_b1, (const bf16*)ff_w2, (const float*)ff_b2,     \
      (float*)part, (bf16*)hbuf, (bf16*)out, b, kvh, max_len, dim, hid4, t, sel_block,       \
      window, num_sel, n_slide, info_width, scale, eps, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_ATTEND_FUSED(1);
    case 2: NSA_ATTEND_FUSED(2);
    case 4: NSA_ATTEND_FUSED(4);
    case 8: NSA_ATTEND_FUSED(8);
  }
#undef NSA_ATTEND_FUSED
  return (int)cudaErrorInvalidValue;
}

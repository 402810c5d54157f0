// The ragged decode-step kernels for Hopper (sm_90a): the fused pair of
// nsa_decode_fused.cu with one position per batch row, as the serving
// engine's slot pool decodes (every slot at its own length), and the attend
// kernel over a paged kv pool.
//
// Replaces the TPU kernels of nsa_tpu/ops/pallas/nsa_decode_fused.py:
//   decode_select_emit_ragged   (_select_emit_ragged_kernel, pallas_call :1059)
//   decode_attend_fused_ragged  (_attend_fused_ragged_kernel, pallas_call :1317)
//   decode_attend_fused_paged   (_attend_fused_paged_kernel, pallas_call :1608)
//
// What bounds them on this card: bytes, as for the scalar pair (see
// nsa_decode_fused.cu): each (row, KV head) reads its live compressed rows
// and its gathered kv rows, the emission reads the compressor's weights
// (~4.4 MB per KV head at the reference model), the attend kernel w_out and
// the FF's matrices.  The design is the scalar pair's, with the position
// read per row from a device vector t [b] (int32) and num_cb [b], so a step
// needs no position from the host and no host sync:
//
// decode_select_emit_ragged: launch 1 always runs, one block per (KV head,
//   64 compressor hidden columns).  Warp 0 lists the rows that emit this
//   step (t - num_cb * stride + 1 == stride) with a ballot, in row order;
//   a block with no emitting row returns at once, and the others run the
//   emission body over the listed rows only, each at its own position
//   (window rows before position 0 zeroed), reading the weights once per 8
//   emitting rows.  Launch 2, one block per (batch row, KV head), reads
//   the old ring and the new token into shared memory before it writes the
//   shifted ring (launch 1 has finished reading it: launches on one stream
//   run in order); on an emitting row it sums the partials in chunk order
//   into ckv[min(num_cb, Wc - 1)]; then it runs the selection body at the
//   row's own t and num_cb, which reads only ckv rows below num_cb.
// decode_attend_fused_ragged / _paged: launch 1, one block per (batch row,
//   KV head), writes the new token's row at the row's own t and runs the
//   attention body with that row staged from the new token, then the head's
//   share of w_out; launches 2 and 3 are the scalar kernel's residual and FF
//   (decode_fused_common.cuh), which do not depend on t.  The paged kernel
//   is the same body with one address function (PagedRows): logical row r of
//   batch row i lives in page page_table[i][r / page] at row r % page, so
//   under any table it computes bit for bit what the dense kernel computes
//   on the same logical cache.  A block of a selection never straddles a
//   page (page % sel_block == 0).  Inactive slots (t = 0, a table of trash
//   pages) decode into their own row 0 or the trash page, as on the TPU.
// Deterministic: every sum in a fixed order, no atomics.  No tensor cores:
// at <= 16 rows every product is a few matrix-vector products.
#include "decode_fused_common.cuh"

namespace nsa {
namespace {

constexpr int kEmitColsR = 64;    // compressor hidden columns per emission block

// Launch 1: the emitting rows' partials, one block per (KV head, chunk).
// Dynamic shared memory: the emission body's, then the row list [b].
__global__ void emit_partial_ragged_kernel(const bf16* __restrict__ ring,
                                           const bf16* __restrict__ kv_new,
                                           const bf16* __restrict__ pos_kv,
                                           const bf16* __restrict__ w1k,
                                           const float* __restrict__ b1k,
                                           const bf16* __restrict__ w1v,
                                           const float* __restrict__ b1v,
                                           const bf16* __restrict__ w2, const int* __restrict__ tvec,
                                           const int* __restrict__ ncb, float* __restrict__ partial,
                                           int b, int kvh, int Bc, int hid, int stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_emit;
  int* rows = reinterpret_cast<int*>(smem_raw + emit_smem_bytes<kEmitColsR>(Bc));
  if (threadIdx.x < 32) {           // warp 0: the emitting rows, in row order
    const int lane = threadIdx.x;
    int n = 0;
    for (int r0 = 0; r0 < b; r0 += 32) {
      const int r = r0 + lane;
      const bool e = r < b && emits_at(tvec[r], ncb[r], stride);
      const unsigned m = __ballot_sync(kFull, e);
      if (e) rows[n + __popc(m & ((1u << lane) - 1u))] = r;
      n += __popc(m);
    }
    if (lane == 0) n_emit = n;
  }
  __syncthreads();
  if (n_emit == 0) return;
  emit_partial_body<kEmitColsR>(ring, kv_new, kv_new + kD, kvh * 2 * kD, 2 * kD, pos_kv, w1k, b1k,
                                w1v, b1v, w2, partial, b, kvh, Bc, hid, 0, blockIdx.x, smem_raw,
                                rows, n_emit, tvec);
}

// Launch 2: one block per (batch row, KV head): the ring shift, the emitted
// row (emitting rows), then selection at the row's own position.
template <int G>
__global__ void select_emit_ragged_kernel(const bf16* __restrict__ q, bf16* ckv,
                                          bf16* __restrict__ ring, const bf16* __restrict__ kv_new,
                                          const bf16* __restrict__ mem_kv,
                                          const float* __restrict__ partial,
                                          const float* __restrict__ b2,
                                          const int* __restrict__ tvec,
                                          const int* __restrict__ ncb, bf16* __restrict__ c_out,
                                          int* __restrict__ info, int b, int kvh, int Wc, int M,
                                          int Bc, int nchunks, int stride, int sel_block,
                                          int num_sel, int n_slide, int max_blocks,
                                          int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, bi = bh / kvh;
  const int t = tvec[bi], num_cb = ncb[bi];
  ring_shift_body(ring + (size_t)bh * Bc * 2 * kD, kv_new + (size_t)bh * 2 * kD, Bc, smem_raw);
  if (emits_at(t, num_cb, stride)) {
    const int slot = min(max(num_cb, 0), Wc - 1);
    emit_row_body(partial, b2, ckv + ((size_t)bh * Wc + slot) * 2 * kD, nchunks, b, bi, bh % kvh);
  }
  __syncthreads();
  select_body<G>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb, stride, sel_block, num_sel,
                 n_slide, max_blocks, info_width, scale, bh, smem_raw);
}

// Attend launch 1: one block per (batch row, KV head) at the row's own t;
// `Rows` addresses the dense cache or the page pool.
template <int G, typename Rows>
__global__ void attend_ragged_kernel(const bf16* __restrict__ rq, const Rows kv,
                                     const bf16* __restrict__ kv_new,
                                     const int* __restrict__ info, const bf16* __restrict__ c_out,
                                     const bf16* __restrict__ gates,
                                     const bf16* __restrict__ w_out, const int* __restrict__ tvec,
                                     float* __restrict__ part, int kvh, int dim, int sel_block,
                                     int window, int num_sel, int n_slide, int info_width,
                                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  attend_out_body<G>(rq, kv, kv_new, info, c_out, gates, w_out, part, kvh, dim, tvec[bh / kvh],
                     sel_block, window, num_sel, n_slide, info_width, scale, bh, smem_raw);
}

template <int G>
cudaError_t launch_select_emit_ragged(const bf16* q, bf16* ckv, bf16* ring, const bf16* kv_new,
                                      const bf16* mem_kv, const bf16* pos_kv, const bf16* w1k,
                                      const float* b1k, const bf16* w1v, const float* b1v,
                                      const bf16* w2, const float* b2, const int* tvec,
                                      const int* ncb, bf16* c_out, int* info, float* partial,
                                      int b, int kvh, int Wc, int M, int Bc, int hid, int stride,
                                      int sel_block, int num_sel, int n_slide, int max_blocks,
                                      int info_width, float scale, cudaStream_t stream) {
  cudaError_t e;
  const int nchunks = hid / kEmitColsR;
  const size_t shmem_e = emit_smem_bytes<kEmitColsR>(Bc) + sizeof(int) * b;
  if ((e = set_smem((const void*)emit_partial_ragged_kernel, shmem_e)) != cudaSuccess) return e;
  emit_partial_ragged_kernel<<<kvh * nchunks, kThreads, shmem_e, stream>>>(
      ring, kv_new, pos_kv, w1k, b1k, w1v, b1v, w2, tvec, ncb, partial, b, kvh, Bc, hid, stride);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int Wf = Wc / (sel_block / stride);
  size_t shmem = select_smem_bytes<G>(Wc, M, Wf, kThreads);
  const size_t ring_bytes = (size_t)Bc * 2 * kD * sizeof(bf16);
  if (shmem < ring_bytes) shmem = ring_bytes;
  auto kern = select_emit_ragged_kernel<G>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(q, ckv, ring, kv_new, mem_kv, partial, b2, tvec, ncb,
                                             c_out, info, b, kvh, Wc, M, Bc, nchunks, stride,
                                             sel_block, num_sel, n_slide, max_blocks, info_width,
                                             scale);
  return cudaGetLastError();
}

template <int G, typename Rows>
cudaError_t launch_attend_ragged(const bf16* rq, const Rows kv, const bf16* kv_new,
                                 const int* info, const bf16* c_out, const bf16* gates,
                                 const bf16* x, const bf16* w_out, const float* ff_norm,
                                 const bf16* ff_w1, const float* ff_b1, const bf16* ff_w2,
                                 const float* ff_b2, const int* tvec, float* part, bf16* hbuf,
                                 bf16* out, int b, int kvh, int dim, int hid4, int sel_block,
                                 int window, int num_sel, int n_slide, int info_width,
                                 float scale, float eps, cudaStream_t stream) {
  cudaError_t e;
  const int J = (num_sel + n_slide) * sel_block;
  const size_t shmem = attend_smem_bytes<G>(J, kThreads);
  auto kern = attend_ragged_kernel<G, Rows>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(rq, kv, kv_new, info, c_out, gates, w_out, tvec,
                                             part, kvh, dim, sel_block, window, num_sel, n_slide,
                                             info_width, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_resid_ff(x, part, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2, hbuf, out, b, kvh, dim,
                         hid4, eps, stream);
}

template <typename Rows>
int attend_ragged_entry(int G, const void* rq, const Rows kv, const void* kv_new,
                        const void* info, const void* c_out, const void* gates, const void* x,
                        const void* w_out, const void* ff_norm, const void* ff_w1,
                        const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t,
                        void* part, void* hbuf, void* out, int b, int kvh, int dim, int hid4,
                        int sel_block, int window, int num_sel, int n_slide, int info_width,
                        float scale, float eps, void* stream) {
#define NSA_ATTEND_RAGGED(GG)                                                                \
  return (int)launch_attend_ragged<GG, Rows>(                                               \
      (const bf16*)rq, kv, (const bf16*)kv_new, (const int*)info, (const bf16*)c_out,       \
      (const bf16*)gates, (const bf16*)x, (const bf16*)w_out, (const float*)ff_norm,        \
      (const bf16*)ff_w1, (const float*)ff_b1, (const bf16*)ff_w2, (const float*)ff_b2,     \
      (const int*)t, (float*)part, (bf16*)hbuf, (bf16*)out, b, kvh, dim, hid4, sel_block,   \
      window, num_sel, n_slide, info_width, scale, eps, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_ATTEND_RAGGED(1);
    case 2: NSA_ATTEND_RAGGED(2);
    case 4: NSA_ATTEND_RAGGED(4);
    case 8: NSA_ATTEND_RAGGED(8);
  }
#undef NSA_ATTEND_RAGGED
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace nsa

// As nsa_decode_select_emit, with t and num_cb [b] int32 on the device (one
// position per row) and partial [kvh, hid/64, b, 128] f32 scratch (every
// step: which rows emit is read on the device).  Returns the first failing
// launch's cudaError_t.
extern "C" int nsa_decode_select_emit_ragged(
    const void* q, void* ckv, void* ring, const void* kv_new, const void* mem_kv,
    const void* pos_kv, const void* w1k, const void* b1k, const void* w1v, const void* b1v,
    const void* w2, const void* b2, const void* t, const void* num_cb, void* c_out, void* info,
    void* partial, int b, int kvh, int G, int Wc, int M, int Bc, int hid, int stride,
    int sel_block, int num_sel, int n_slide, int max_blocks, int info_width, float scale,
    void* stream) {
  using nsa::bf16;
#define NSA_SELECT_EMIT_RAGGED(GG)                                                            \
  return (int)nsa::launch_select_emit_ragged<GG>(                                             \
      (const bf16*)q, (bf16*)ckv, (bf16*)ring, (const bf16*)kv_new, (const bf16*)mem_kv,     \
      (const bf16*)pos_kv, (const bf16*)w1k, (const float*)b1k, (const bf16*)w1v,            \
      (const float*)b1v, (const bf16*)w2, (const float*)b2, (const int*)t,                   \
      (const int*)num_cb, (bf16*)c_out, (int*)info, (float*)partial, b, kvh, Wc, M, Bc, hid, \
      stride, sel_block, num_sel, n_slide, max_blocks, info_width, scale, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_SELECT_EMIT_RAGGED(1);
    case 2: NSA_SELECT_EMIT_RAGGED(2);
    case 4: NSA_SELECT_EMIT_RAGGED(4);
    case 8: NSA_SELECT_EMIT_RAGGED(8);
  }
#undef NSA_SELECT_EMIT_RAGGED
  return (int)cudaErrorInvalidValue;
}

// As nsa_decode_attend_fused, with t [b] int32 on the device; kv [b, kvh,
// max_len, 128] bf16, row t[i] of batch row i written in place.
extern "C" int nsa_decode_attend_fused_ragged(
    const void* rq, void* kv, const void* kv_new, const void* info, const void* c_out,
    const void* gates, const void* x, const void* w_out, const void* ff_norm, const void* ff_w1,
    const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t, void* part, void* hbuf,
    void* out, int b, int kvh, int G, int max_len, int dim, int hid4, int sel_block, int window,
    int num_sel, int n_slide, int info_width, float scale, float eps, void* stream) {
  return nsa::attend_ragged_entry(G, rq, nsa::DenseRows{(nsa::bf16*)kv, max_len}, kv_new, info,
                                  c_out, gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2, t,
                                  part, hbuf, out, b, kvh, dim, hid4, sel_block, window, num_sel,
                                  n_slide, info_width, scale, eps, stream);
}

// As nsa_decode_attend_fused_ragged over a page pool [P, kvh, page, 128]
// bf16 and a page table [b, max_pages] int32 on the device: row t[i] of
// batch row i is written into page table[i][t[i] / page] in place.
extern "C" int nsa_decode_attend_fused_paged(
    const void* rq, void* pool, const void* page_table, const void* kv_new, const void* info,
    const void* c_out, const void* gates, const void* x, const void* w_out, const void* ff_norm,
    const void* ff_w1, const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t,
    void* part, void* hbuf, void* out, int b, int kvh, int G, int page, int max_pages, int dim,
    int hid4, int sel_block, int window, int num_sel, int n_slide, int info_width, float scale,
    float eps, void* stream) {
  return nsa::attend_ragged_entry(
      G, rq, nsa::PagedRows{(nsa::bf16*)pool, (const int*)page_table, kvh, page, max_pages},
      kv_new, info, c_out, gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2, t, part, hbuf,
      out, b, kvh, dim, hid4, sel_block, window, num_sel, n_slide, info_width, scale, eps, stream);
}

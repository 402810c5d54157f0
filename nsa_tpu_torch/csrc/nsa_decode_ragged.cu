// The ragged decode-step kernels for Hopper (sm_90a): the fused pair with
// one position per batch row, as the serving engine's slot pool decodes
// (every slot at its own length), and the one-launch attend kernel, which
// also serves the fused route at one position and a paged kv pool.
//
// Replaces the TPU kernels of nsa_tpu/ops/pallas/nsa_decode_fused.py:
//   decode_attend_fused         (_attend_fused_kernel, :734 -> pallas_call :830)
//   decode_select_emit_ragged   (_select_emit_ragged_kernel, pallas_call :1059)
//   decode_attend_fused_ragged  (_attend_fused_ragged_kernel, :1223 -> pallas_call :1317)
//   decode_attend_fused_paged   (_attend_fused_paged_kernel, :1507 -> pallas_call :1608)
//
// decode_select_emit_ragged.  What bounds it on this card: bytes on the
// steps that emit: the four compressors' weights (17.6 MB at the reference
// model, 5.3 us at 3.35 TB/s), read once per 16 emitting rows; each (row,
// KV head) reads its live compressed rows for the selection.  The position
// is read per row from a device vector t [b] (int32) and num_cb [b], so a
// step needs no position from the host and no host sync.  Launch 1 always
// runs, one block per (KV head, half, 64 compressor hidden columns), so
// all 128 of them at the reference model read weight bytes.  Warp 0 lists
// the rows that emit this step (t - num_cb * stride + 1 == stride) with a
// ballot, in row order; a block with no emitting row returns at once, and
// the others run the tensor-core emission body (emit_tc_body,
// decode_tc_common.cuh, shared with the one-position select-emit of
// nsa_decode_fused.cu and the whole-model kernel) over the listed rows as
// 16-row tiles, each row at its own position (window rows before position 0
// zeroed): the window tile times its 64 columns of w1k or w1v, streamed by
// TMA through an 8-stage mbarrier ring, + b1, relu, rounded; times its 64
// rows of w2: float32 partials.  Launch 2, one block per (batch row, KV
// head), reads the old ring and the new token into shared memory before it
// writes the shifted ring (ring_shift_body; launch 1 has finished reading
// it: launches on one stream run in order); on an emitting row it sums the
// partials in chunk order into ckv[min(num_cb, Wc - 1)] (emit_row_body);
// then it runs the selection body (select_body) at the row's own t and
// num_cb, which reads only ckv rows below num_cb.  Launch 2 is bound by the
// selection body's latency (a chain of staging, reductions and the top-k of
// one block per (row, KV head), 64 blocks at 16 slots), not by its bytes.
//
// decode_attend_fused / _ragged / _paged: one kernel, templated on where a
// row lives (DenseRows, PagedRows) and on how an item reads its position
// (one per row from a device vector t [b], or one device int t for the
// whole batch: the fused route).  Neither reads a position from the host,
// so a captured CUDA graph replays them at each step's positions.
// What bounds it on this card: not bytes (the weights, 4.5 MB at the
// reference model with the FF, and the ~2 MB of kv rows the masks keep at
// 16 slots take ~2 us at 3.35 TB/s) but latency: the attention of b x kvh
// items, then three products that each need every row of the one before
// (w_out, the FF's w1 and w2), each a few MFLOP.  The design: one
// cooperative, persistent launch of one block per SM, phases separated by
// grid syncs, no float atomics.  At entry each block issues TMA loads of
// its own column tiles of w_out, ff w1 and ff w2 (8 columns x all K rows
// each, in 1 KB boxes, tile i of a product on block (offset + i) % grid)
// into shared memory, completing on one mbarrier per product, so every
// weight byte is read once and all of them are in flight while the
// attention runs.  (a) Per (batch row, KV head) item, grid-stride: the new
// token's row written in place at the row's t, attend_body with that row
// staged from the new token, the combined output rounded to bf16 into comb
// [b, kvh*G*64] (device scratch, or the caller's tensor).  (b) Per owned
// w_out tile, per 16-row tile of the batch: comb's rows staged in shared
// memory, each head's product on the tensor cores (mma.sync m16n8k16, bf16
// in, float32 sums; A by ldmatrix, B from the staged tile by
// ldmatrix.trans), y = x + the heads' products in head order in float32,
// rounded once, into y (or the output without the FF).  (c) Per owned w1
// tile: y's rows staged, RMSNorm in float32 rounded to bf16 (every block
// the same), the product, + b1 and the exact erf GELU at the plain
// version's rounding points, into the FF's hidden rows.  (d) Per owned w2
// tile: the hidden rows staged, the product, + b2, + y, rounded, into the
// output.  Within a tile each warp sums its own k-steps (warp w takes steps
// w, w + 8, ...) and the 8 warps' partials are added in warp order, so the
// bits depend on neither the grid nor which block owns a tile: a second
// launch, the paged kernel on the same logical cache, and the one-position
// kernel at a position every row shares give the same bits.  Without the
// FF the kernel stops after (b).  A grid that cannot be co-resident, or
// slices that do not fit in shared memory, is an error and never runs.
// The paged kernel is the same body with one address function (PagedRows):
// logical row r of batch row i lives in page page_table[i][r / page] at row
// r % page.  A block of a selection never straddles a page (page %
// sel_block == 0).  Inactive slots (t = 0, a table of trash pages) decode
// into their own row 0 or the trash page, as on the TPU.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_tc_common.cuh"

namespace cg = cooperative_groups;

namespace nsa {
namespace {

// Launch 1: the emitting rows' partials on the tensor cores, one block per
// (KV head, half, 64 compressor hidden columns) (emit_tc_body).  Dynamic
// shared memory: 1024-byte alignment slack, the body's, then the row list
// [b].
__global__ void __launch_bounds__(kThreads)
    emit_partial_ragged_kernel(const bf16* __restrict__ ring, const bf16* __restrict__ kv_new,
                               const bf16* __restrict__ pos_kv, const float* __restrict__ b1k,
                               const float* __restrict__ b1v, const int* __restrict__ tvec,
                               const int* __restrict__ ncb, float* __restrict__ partial, int b,
                               int kvh, int Bc, int hid, int stride,
                               const __grid_constant__ CUtensorMap m_w1k,
                               const __grid_constant__ CUtensorMap m_w1v,
                               const __grid_constant__ CUtensorMap m_w2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_emit;
  __shared__ __align__(8) uint64_t bars[kEmitBars];
  unsigned char* base =
      smem_raw + ((kEmitAlign - (smem_u32(smem_raw) & (kEmitAlign - 1))) & (kEmitAlign - 1));
  int* rows = reinterpret_cast<int*>(base + emit_tc_smem_bytes(Bc * kD));
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
  emit_ring_init(bars);
  __syncthreads();
  if (n_emit == 0) return;
  EmitRing er{bars, 0u, 0u};
  emit_tc_body(ring, kv_new, kv_new + kD, kvh * 2 * kD, 2 * kD, pos_kv, b1k, b1v, &m_w1k, &m_w1v,
               &m_w2, 0, partial, b, kvh, Bc, hid, 0, blockIdx.x, er, base, rows, n_emit, tvec);
}

size_t emit_launch_smem(int b, int Bc) {
  return kEmitAlign + emit_tc_smem_bytes(Bc * kD) + sizeof(int) * b;
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
  select_body<G, bf16>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb,
                                        stride, sel_block, num_sel, n_slide, max_blocks,
                                        info_width, scale, bh, smem_raw);
}

// ---------------------------------------------------------------------------
// The attend kernels: one cooperative launch (see the note at the top).
// ---------------------------------------------------------------------------
constexpr int kProducts = 3;               // w_out, ff w1, ff w2

using Plan = TilePlan<kProducts>;

template <int G>
Plan make_plan(int kvh, int dim, int hid4, int J, int grid) {
  Plan p = {};
  p.grid = grid;
  p.rows[0] = kvh * G * kD;
  p.rows[1] = dim;
  p.rows[2] = hid4;
  p.tiles[0] = dim / kTileCols;
  p.tiles[1] = hid4 / kTileCols;
  p.tiles[2] = hid4 ? dim / kTileCols : 0;
  p.off[0] = 0;                            // w2's tiles after w_out's, w1's after both
  p.off[2] = p.tiles[0] % grid;
  p.off[1] = (p.tiles[0] + p.tiles[2]) % grid;
  plan_slices(p);
  const int kmax = std::max(p.rows[0], std::max(dim, hid4));
  const size_t stage = (size_t)kRowTile * (kmax + 8) * sizeof(bf16) +
                       sizeof(float) * kWarps * std::max(kvh, 1) * 32 * 4;
  const size_t work = std::max(attend_smem_bytes<G>(J), stage);
  p.work_bytes = (int)((work + 15) / 16 * 16);
  p.smem_bytes = 128 + (p.slice_bytes + 127) / 128 * 128 + 64 + p.work_bytes;
  return p;
}

// How an item reads its batch row's position: from a device vector t [b]
// (the ragged and paged kernels), or one device int for every row (the
// fused route).
struct RowPositions {
  const int* t;
  __device__ __forceinline__ int at(int bi) const { return t[bi]; }
};

struct OnePosition {
  const int* t;
  __device__ __forceinline__ int at(int) const { return *t; }
};

template <typename Rows, typename Pos>
struct AttendArgs {
  const bf16* rq;
  Rows kv;
  const bf16* kv_new;
  const int* info;
  const bf16* c_out;
  const bf16* gates;
  const bf16* x;
  const float* ff_norm;
  const float* ff_b1;
  const float* ff_b2;
  Pos pos;
  // written during the launch and read by other blocks after a grid sync:
  // no __restrict__, read through L2 only (cp.async.cg, ld.global.cg)
  bf16* comb;                              // [b, kvh * G * kD]
  bf16* y;                                 // [b, dim]
  bf16* hbuf;                              // [b, hid4]
  bf16* out;                               // [b, dim]
  unsigned long long* phase_ns;            // null, or kPhaseMarks global-timer marks
  int b, kvh, dim, hid4, sel_block, window, num_sel, n_slide, info_width;
  float scale, eps;
  Plan plan;
};

// Block 0 records the global timer into a.phase_ns[k], when asked to: at the
// start and after each grid sync; the block that holds tile 0 of the last
// product records the end of its share of it.
constexpr int kPhaseMarks = 5;

template <typename Rows, typename Pos>
__device__ __forceinline__ void mark(const AttendArgs<Rows, Pos>& a, int k, int block = 0) {
  if (a.phase_ns != nullptr && blockIdx.x == block && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.phase_ns[k] = ns;
  }
}

template <int G, typename Rows, typename Pos>
__global__ void __launch_bounds__(kThreads, 1)
    attend_persistent_kernel(const AttendArgs<Rows, Pos> a,
                             const __grid_constant__ CUtensorMap m_out,
                             const __grid_constant__ CUtensorMap m_w1,
                             const __grid_constant__ CUtensorMap m_w2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const Plan& p = a.plan;
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  bf16* wsm = reinterpret_cast<bf16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (p.slice_bytes + 127) / 128 * 128);
  unsigned char* work = reinterpret_cast<unsigned char*>(bars) + 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = blockIdx.x;
  const CUtensorMap* maps[kProducts] = {&m_out, &m_w1, &m_w2};
  int count[kProducts], first[kProducts], at[kProducts];   // at: the product's tiles, in bf16
  plan_slice(p, g, first, count, at);

  // ---- every weight tile of this block in flight, before the attention --
  mark(a, 0);
  if (tid == 0) {
    for (int q = 0; q < kProducts; ++q) mbar_init(&bars[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0)
      for (int q = 0; q < kProducts; ++q)
        if (count[q]) mbar_expect_tx(&bars[q], (uint32_t)plan_bytes(p, q, g));
    __syncwarp();
    for (int q = 0; q < kProducts; ++q) {
      const int boxes = p.rows[q] / kBoxRows;
      for (int j = lane; j < count[q] * boxes; j += 32) {
        const int tile = j / boxes, box = j % boxes;
        tma_load_2d(wsm + at[q] + (tile * p.rows[q] + box * kBoxRows) * kTileCols, maps[q],
                    &bars[q], (first[q] + tile * p.grid) * kTileCols, box * kBoxRows);
      }
    }
  }

  // ---- (a) attention of the (batch row, KV head) items ------------------
  constexpr int outs = G * kD;
  for (int bh = g; bh < a.b * a.kvh; bh += gridDim.x) {
    const int t = a.pos.at(bh / a.kvh);
    const bf16* row_t = a.kv_new + (size_t)bh * 2 * kD;
    if (tid < 2 * kD / 8)          // the new token's row, written in place
      reinterpret_cast<uint4*>(a.kv.row(bh, t))[tid] = reinterpret_cast<const uint4*>(row_t)[tid];
    const float* comb = attend_body<G>(a.rq, a.kv, a.info, a.c_out, a.gates, row_t, t,
                                              a.sel_block, a.window, a.num_sel, a.n_slide,
                                              a.info_width, a.scale, bh, work);
    for (int o = tid; o < outs; o += blockDim.x)
      a.comb[(size_t)bh * outs + o] = __float2bfloat16(comb[o]);
    __syncthreads();               // comb is shared memory the next item reuses
  }
  grid.sync();
  mark(a, 1);

  const int nrt = (a.b + kRowTile - 1) / kRowTile;
  const int o = tid;               // threads 0..127: one element of a 16 x 8 tile
  const int m = o >> 3, n = o & 7;

  // ---- (b) y = x + the heads' shares of comb . w_out, in head order ------
  {
    const int K = p.rows[0], lda = K + 8;
    bf16* As = reinterpret_cast<bf16*>(work);
    float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
    bf16* dst = a.hid4 ? a.y : a.out;
    if (count[0]) mbar_wait(&bars[0], 0);
    for (int rt = 0; rt < nrt && count[0]; ++rt) {
      stage_rows(As, a.comb, a.b, K, rt * kRowTile);
      for (int j = 0; j < count[0]; ++j) {
        const int row = rt * kRowTile + m, col = (first[0] + j * p.grid) * kTileCols + n;
        const bool mine = o < 128 && row < a.b;
        const float x = mine ? __bfloat162float(a.x[(size_t)row * a.dim + col]) : 0.f;
        const float y = tile_dot(As, lda, wsm + at[0] + j * K * kTileCols, K, a.kvh, x, red);
        if (mine) dst[(size_t)row * a.dim + col] = __float2bfloat16(y);
        __syncthreads();
      }
    }
  }
  if (a.hid4 == 0) {               // the same in every block: no grid sync follows
    mark(a, 4, p.off[0]);
    return;
  }
  grid.sync();
  mark(a, 2);

  // ---- (c) the FF's hidden rows: gelu(round(norm(y) . w1) + round(b1)) ---
  {
    const int K = a.dim, lda = K + 8;
    bf16* As = reinterpret_cast<bf16*>(work);
    float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
    if (count[1]) mbar_wait(&bars[1], 0);
    for (int rt = 0; rt < nrt && count[1]; ++rt) {
      stage_rows(As, a.y, a.b, K, rt * kRowTile);
      norm_rows(As, K, a.ff_norm, a.eps);
      for (int j = 0; j < count[1]; ++j) {
        const float v = tile_dot(As, lda, wsm + at[1] + j * K * kTileCols, K, 1, 0.f, red);
        const int row = rt * kRowTile + m, col = (first[1] + j * p.grid) * kTileCols + n;
        if (o < 128 && row < a.b) {
          const float hv = round_bf16(round_bf16(v) + round_bf16(a.ff_b1[col]));
          a.hbuf[(size_t)row * a.hid4 + col] =
              __float2bfloat16(0.5f * hv * (1.f + erff(hv * 0.7071067811865476f)));
        }
        __syncthreads();
      }
    }
  }
  grid.sync();
  mark(a, 3);

  // ---- (d) out = y + round(round(h . w2) + round(b2)) --------------------
  {
    const int K = a.hid4, lda = K + 8;
    bf16* As = reinterpret_cast<bf16*>(work);
    float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
    if (count[2]) mbar_wait(&bars[2], 0);
    for (int rt = 0; rt < nrt && count[2]; ++rt) {
      stage_rows(As, a.hbuf, a.b, K, rt * kRowTile);
      for (int j = 0; j < count[2]; ++j) {
        const float v = tile_dot(As, lda, wsm + at[2] + j * K * kTileCols, K, 1, 0.f, red);
        const int row = rt * kRowTile + m, col = (first[2] + j * p.grid) * kTileCols + n;
        if (o < 128 && row < a.b) {
          const size_t i = (size_t)row * a.dim + col;
          const float ov = round_bf16(round_bf16(v) + round_bf16(a.ff_b2[col]));
          a.out[i] = __float2bfloat16(ldcg_bf16(a.y + i) + ov);
        }
        __syncthreads();
      }
    }
  }
  mark(a, 4, p.off[2]);
}

// The plan at one block per SM, and how many such blocks fit on an SM (0:
// the shared memory a block needs exceeds what the card allows).  The
// kernel's shared-memory attribute and occupancy are set and read once per
// device and size.
template <int G, typename Rows, typename Pos>
cudaError_t attend_plan(int kvh, int dim, int hid4, int J, Plan* plan, int* per_sm,
                        int* smem_optin) {
  static int cached[kMaxDevices][2] = {};       // shared-memory bytes, blocks an SM
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = device_limits(&sms, smem_optin)) != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  *plan = make_plan<G>(kvh, dim, hid4, J, sms);
  *per_sm = 0;
  if (plan->smem_bytes > *smem_optin) return cudaSuccess;
  if (cached[dev][0] != plan->smem_bytes) {
    auto kern = attend_persistent_kernel<G, Rows, Pos>;
    if ((e = set_smem((const void*)kern, plan->smem_bytes)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev][1], kern, kThreads,
                                                           plan->smem_bytes)) != cudaSuccess)
      return e;
    cached[dev][0] = plan->smem_bytes;
  }
  *per_sm = cached[dev][1];
  return cudaSuccess;
}

template <int G, typename Rows, typename Pos>
cudaError_t launch_attend_persistent(AttendArgs<Rows, Pos>& a, const bf16* w_out,
                                     const bf16* w1, const bf16* w2, cudaStream_t stream) {
  const int J = (a.num_sel + a.n_slide) * a.sel_block;
  int per_sm = 0, optin = 0;
  cudaError_t e = attend_plan<G, Rows, Pos>(a.kvh, a.dim, a.hid4, J, &a.plan, &per_sm, &optin);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;   // never a grid that waits forever
  CUtensorMap maps[kProducts] = {};
  if (!encode_tiles(&maps[0], w_out, a.plan.rows[0], a.dim)) return cudaErrorInvalidValue;
  if (a.hid4 && (!encode_tiles(&maps[1], w1, a.dim, a.hid4) ||
                 !encode_tiles(&maps[2], w2, a.hid4, a.dim)))
    return cudaErrorInvalidValue;
  void* args[] = {&a, &maps[0], &maps[1], &maps[2]};
  if ((e = cudaLaunchCooperativeKernel((const void*)attend_persistent_kernel<G, Rows, Pos>,
                                       dim3(a.plan.grid), dim3(kThreads), args,
                                       a.plan.smem_bytes, stream)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

template <typename Rows, typename Pos>
int attend_entry(int G, const void* rq, const Rows kv, const void* kv_new, const void* info,
                 const void* c_out, const void* gates, const void* x, const void* w_out,
                 const void* ff_norm, const void* ff_w1, const void* ff_b1, const void* ff_w2,
                 const void* ff_b2, const Pos pos, void* comb, void* y, void* hbuf, void* out,
                 void* phase_ns, int b, int kvh, int dim, int hid4, int sel_block, int window,
                 int num_sel, int n_slide, int info_width, float scale, float eps,
                 void* stream) {
  AttendArgs<Rows, Pos> a = {(const bf16*)rq, kv, (const bf16*)kv_new, (const int*)info,
                             (const bf16*)c_out, (const bf16*)gates, (const bf16*)x,
                             (const float*)ff_norm, (const float*)ff_b1, (const float*)ff_b2,
                             pos, (bf16*)comb, (bf16*)y, (bf16*)hbuf, (bf16*)out,
                             (unsigned long long*)phase_ns, b, kvh, dim, hid4, sel_block, window,
                             num_sel, n_slide, info_width, scale, eps, Plan{}};
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16 *wo = (const bf16*)w_out, *w1 = (const bf16*)ff_w1, *w2 = (const bf16*)ff_w2;
  switch (G) {
    case 1: return (int)launch_attend_persistent<1, Rows, Pos>(a, wo, w1, w2, s);
    case 2: return (int)launch_attend_persistent<2, Rows, Pos>(a, wo, w1, w2, s);
    case 4: return (int)launch_attend_persistent<4, Rows, Pos>(a, wo, w1, w2, s);
    case 8: return (int)launch_attend_persistent<8, Rows, Pos>(a, wo, w1, w2, s);
  }
  return (int)cudaErrorInvalidValue;
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
  const int nchunks = hid / kEmitCols, K = Bc * kD;
  const size_t shmem_e = emit_launch_smem(b, Bc);
  CUtensorMap maps[3] = {};
  if (!encode_tiles(&maps[0], w1k, kvh * K, hid, kEmitCols) ||
      !encode_tiles(&maps[1], w1v, kvh * K, hid, kEmitCols) ||
      !encode_tiles(&maps[2], w2, kvh * hid, 2 * kD, kEmitCols))
    return cudaErrorInvalidValue;
  if ((e = set_smem((const void*)emit_partial_ragged_kernel, shmem_e)) != cudaSuccess) return e;
  emit_partial_ragged_kernel<<<kvh * 2 * nchunks, kThreads, shmem_e, stream>>>(
      ring, kv_new, pos_kv, b1k, b1v, tvec, ncb, partial, b, kvh, Bc, hid, stride, maps[0],
      maps[1], maps[2]);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int Wf = Wc / (sel_block / stride);
  size_t shmem = select_smem_bytes<G, bf16>(Wc, M, Wf);
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

// rq [b, kvh, G, 64] bf16 (rotated); kv [b, kvh, max_len, 128] bf16 (row t
// written in place); kv_new [b, kvh, 1, 128] bf16 (rotated k || v); info
// [b, kvh * info_width] int32; c_out [b, kvh, G, 64] bf16; gates [b, kvh, G,
// 3] bf16; x [b, 1, dim] bf16; w_out [kvh*G*64, dim] bf16; the FF (null
// pointers and hid4 0 without it): norm [dim] f32, w1 [dim, hid4] bf16, b1
// [hid4] f32, w2 [hid4, dim] bf16, b2 [dim] f32; t one int32 on the
// device, every row's position -> out [b, 1, dim] bf16.  Scratch: comb [b, kvh*G*64] bf16 (the rounded attention output; the
// caller may read it), y [b, dim] bf16, hbuf [b, hid4] bf16; phase_ns null
// or 5 uint64 (the global timer at the start, after each grid sync, and
// where the block holding the last product's first tile ends; marks 2-3
// stay unwritten without the FF).  One cooperative launch; returns its
// cudaError_t (cudaErrorCooperativeLaunchTooLarge when a block's weight
// tiles and work space do not fit, see nsa_decode_attend_ragged_plan).
extern "C" int nsa_decode_attend_fused(
    const void* rq, void* kv, const void* kv_new, const void* info, const void* c_out,
    const void* gates, const void* x, const void* w_out, const void* ff_norm, const void* ff_w1,
    const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t, void* comb, void* y,
    void* hbuf, void* out, void* phase_ns, int b, int kvh, int G, int max_len, int dim, int hid4,
    int sel_block, int window, int num_sel, int n_slide, int info_width, float scale, float eps,
    void* stream) {
  return nsa::attend_entry(G, rq, nsa::DenseRows{(nsa::bf16*)kv, max_len}, kv_new, info, c_out,
                           gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2,
                           nsa::OnePosition{(const int*)t}, comb, y, hbuf, out, phase_ns, b, kvh,
                           dim, hid4, sel_block, window, num_sel, n_slide, info_width, scale, eps,
                           stream);
}

// As nsa_decode_attend_fused, with t [b] int32 on the device: row t[i] of
// batch row i written in place.
extern "C" int nsa_decode_attend_fused_ragged(
    const void* rq, void* kv, const void* kv_new, const void* info, const void* c_out,
    const void* gates, const void* x, const void* w_out, const void* ff_norm, const void* ff_w1,
    const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t, void* comb, void* y,
    void* hbuf, void* out, void* phase_ns, int b, int kvh, int G, int max_len, int dim, int hid4,
    int sel_block, int window, int num_sel, int n_slide, int info_width, float scale, float eps,
    void* stream) {
  return nsa::attend_entry(G, rq, nsa::DenseRows{(nsa::bf16*)kv, max_len}, kv_new, info, c_out,
                           gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2,
                           nsa::RowPositions{(const int*)t}, comb, y, hbuf, out, phase_ns, b,
                           kvh, dim, hid4, sel_block, window, num_sel, n_slide, info_width,
                           scale, eps, stream);
}

// As nsa_decode_attend_fused_ragged over a page pool [P, kvh, page, 128]
// bf16 and a page table [b, max_pages] int32 on the device: row t[i] of
// batch row i is written into page table[i][t[i] / page] in place.
extern "C" int nsa_decode_attend_fused_paged(
    const void* rq, void* pool, const void* page_table, const void* kv_new, const void* info,
    const void* c_out, const void* gates, const void* x, const void* w_out, const void* ff_norm,
    const void* ff_w1, const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t,
    void* comb, void* y, void* hbuf, void* out, void* phase_ns, int b, int kvh, int G, int page,
    int max_pages, int dim, int hid4, int sel_block, int window, int num_sel, int n_slide,
    int info_width, float scale, float eps, void* stream) {
  return nsa::attend_entry(
      G, rq, nsa::PagedRows{(nsa::bf16*)pool, (const int*)page_table, kvh, page, max_pages},
      kv_new, info, c_out, gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2,
      nsa::RowPositions{(const int*)t}, comb, y, hbuf, out, phase_ns, b, kvh, dim, hid4,
      sel_block, window, num_sel, n_slide, info_width, scale, eps, stream);
}

// The emission launch of nsa_decode_select_emit_ragged on the current
// device, written to out[3]: blocks, dynamic shared memory a block, the
// card's limit a block.  Returns a cudaError_t.
extern "C" int nsa_decode_emit_plan(int b, int kvh, int Bc, int hid, int* out) {
  int sms = 0, optin = 0;
  const cudaError_t e = nsa::device_limits(&sms, &optin);
  if (e != cudaSuccess) return (int)e;
  out[0] = kvh * 2 * (hid / nsa::kEmitCols);
  out[1] = (int)nsa::emit_launch_smem(b, Bc);
  out[2] = optin;
  return 0;
}

// The attend kernels' launch plan on the current device (paged 0: the
// dense kernel, 1: the paged one, both at per-row positions; the
// one-position kernel takes the dense one's plan), written to out[7]: grid,
// blocks that fit
// on an SM (0: a block needs more shared memory than the card allows; the
// kernel then refuses to launch), the largest block's weight-tile bytes,
// all blocks' weight-tile bytes, the work space a block, the shared memory
// a block, the card's limit a block.  Returns a cudaError_t.
extern "C" int nsa_decode_attend_ragged_plan(int b, int kvh, int G, int dim, int hid4,
                                             int sel_block, int num_sel, int n_slide, int paged,
                                             int* out) {
  (void)b;   // the plan does not depend on b: rows go in tiles of 16
  const int J = (num_sel + n_slide) * sel_block;
  nsa::Plan p;
  int per_sm = 0, optin = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define NSA_ATTEND_PLAN(GG)                                                                    \
  e = paged ? nsa::attend_plan<GG, nsa::PagedRows, nsa::RowPositions>(kvh, dim, hid4, J, &p,  \
                                                                      &per_sm, &optin)       \
            : nsa::attend_plan<GG, nsa::DenseRows, nsa::RowPositions>(kvh, dim, hid4, J, &p,  \
                                                                      &per_sm, &optin);      \
  break
  switch (G) {
    case 1: NSA_ATTEND_PLAN(1);
    case 2: NSA_ATTEND_PLAN(2);
    case 4: NSA_ATTEND_PLAN(4);
    case 8: NSA_ATTEND_PLAN(8);
  }
#undef NSA_ATTEND_PLAN
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {p.grid, per_sm, p.slice_bytes, p.slice_total, p.work_bytes,
                       p.smem_bytes, optin};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

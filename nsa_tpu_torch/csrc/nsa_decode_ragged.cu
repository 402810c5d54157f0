// The ragged decode-step kernels for Hopper (sm_90a): the fused pair of
// nsa_decode_fused.cu with one position per batch row, as the serving
// engine's slot pool decodes (every slot at its own length), and the attend
// kernel over a paged kv pool.
//
// Replaces the TPU kernels of nsa_tpu/ops/pallas/nsa_decode_fused.py:
//   decode_select_emit_ragged   (_select_emit_ragged_kernel, pallas_call :1059)
//   decode_attend_fused_ragged  (_attend_fused_ragged_kernel, :1223 -> pallas_call :1317)
//   decode_attend_fused_paged   (_attend_fused_paged_kernel, :1507 -> pallas_call :1608)
//
// decode_select_emit_ragged.  What bounds it on this card: bytes, as for the
// scalar pair (see nsa_decode_fused.cu): each (row, KV head) reads its live
// compressed rows, the emission the compressor's weights (~4.4 MB per KV
// head at the reference model).  The design is the scalar pair's, with the
// position read per row from a device vector t [b] (int32) and num_cb [b],
// so a step needs no position from the host and no host sync.  Launch 1
// always runs, one block per (KV head, 64 compressor hidden columns).  Warp
// 0 lists the rows that emit this step (t - num_cb * stride + 1 == stride)
// with a ballot, in row order; a block with no emitting row returns at
// once, and the others run the emission body over the listed rows only,
// each at its own position (window rows before position 0 zeroed), reading
// the weights once per 8 emitting rows.  Launch 2, one block per (batch
// row, KV head), reads the old ring and the new token into shared memory
// before it writes the shifted ring (launch 1 has finished reading it:
// launches on one stream run in order); on an emitting row it sums the
// partials in chunk order into ckv[min(num_cb, Wc - 1)]; then it runs the
// selection body at the row's own t and num_cb, which reads only ckv rows
// below num_cb.
//
// decode_attend_fused_ragged / _paged.  What bounds them on this card: not
// bytes (the weights, 4.5 MB at the reference model with the FF, and the
// ~2 MB of kv rows the masks keep at 16 slots take ~2 us at 3.35 TB/s) but
// latency: the attention of b x kvh items, then three products that each
// need every row of the one before (w_out, the FF's w1 and w2), each a few
// MFLOP.  The design: one cooperative, persistent launch of one block per
// SM, phases separated by grid syncs, no float atomics.  At entry each block
// issues TMA loads of its own column tiles of w_out, ff w1 and ff w2 (8
// columns x all K rows each, in 1 KB boxes, tile i of a product on block
// (offset + i) % grid) into shared memory, completing on one mbarrier per
// product, so every weight byte is read once and all of them are in flight
// while the attention runs.  (a) Per (batch row, KV head) item, grid-stride:
// the new token's row written in place at the row's own t, attend_body with
// that row staged from the new token, the combined output rounded to bf16
// into comb [b, kvh*G*64] (device scratch, or the caller's tensor).  (b) Per
// owned w_out tile, per 16-row tile of the batch: comb's rows staged in
// shared memory, each head's product on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 sums; A by ldmatrix, B from the staged tile by
// ldmatrix.trans), y = x + the heads' products in head order in float32,
// rounded once, into y (or the output without the FF).  (c) Per owned w1
// tile: y's rows staged, RMSNorm in float32 rounded to bf16 (every block
// the same), the product, + b1 and the exact erf GELU at the plain
// version's rounding points, into the FF's hidden rows.  (d) Per owned w2
// tile: the hidden rows staged, the product, + b2, + y, rounded, into the
// output.  Within a tile each warp sums its own k-steps (warp w takes steps
// w, w + 8, ...) and the 8 warps' partials are added in warp order, so the
// bits depend on neither the grid nor which block owns a tile: a second
// launch, and the paged kernel on the same logical cache, give the same
// bits.  Without the FF the kernel stops after (b).  A grid that cannot be
// co-resident, or slices that do not fit in shared memory, is an error and
// never runs.  The paged kernel is the same body with one address function
// (PagedRows): logical row r of batch row i lives in page page_table[i][r /
// page] at row r % page.  A block of a selection never straddles a page
// (page % sel_block == 0).  Inactive slots (t = 0, a table of trash pages)
// decode into their own row 0 or the trash page, as on the TPU.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_fused_common.cuh"
#include "hopper_common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The attend kernels: one cooperative launch (see the note at the top).
// ---------------------------------------------------------------------------
constexpr int kTileCols = 8;               // columns of a weight tile: one mma n8
constexpr int kBoxRows = 64;               // rows of a TMA box of a weight tile (1 KB)
constexpr int kTileRowBytes = kTileCols * 2;
constexpr int kRowTile = 16;               // batch rows of an mma row tile
constexpr int kWarps = kThreads / 32;
constexpr int kProducts = 3;               // w_out, ff w1, ff w2

// Which block holds which weight tiles, and the shared memory that takes.
// Product q has tiles[q] tiles of rows[q] x 8 columns; tile i lives on block
// (off[q] + i) % grid, after the block's tiles of the products before q.
struct Plan {
  int grid;
  int rows[kProducts];
  int tiles[kProducts];
  int off[kProducts];
  int slice_bytes;                         // the largest block's tiles
  int slice_total;                         // every block's tiles
  int work_bytes;                          // attention, or the staged rows + partials
  int smem_bytes;                          // all of it, + alignment slack
};

__host__ __device__ __forceinline__ int plan_first(const Plan& p, int q, int g) {
  return ((g - p.off[q]) % p.grid + p.grid) % p.grid;
}

__host__ __device__ __forceinline__ int plan_count(const Plan& p, int q, int g) {
  const int i0 = plan_first(p, q, g);
  return i0 < p.tiles[q] ? (p.tiles[q] - i0 + p.grid - 1) / p.grid : 0;
}

__host__ __device__ __forceinline__ int plan_bytes(const Plan& p, int q, int g) {
  return plan_count(p, q, g) * p.rows[q] * kTileRowBytes;
}

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
  for (int g = 0; g < grid; ++g) {
    int s = 0;
    for (int q = 0; q < kProducts; ++q) s += plan_bytes(p, q, g);
    p.slice_bytes = std::max(p.slice_bytes, s);
    p.slice_total += s;
  }
  const int kmax = std::max(p.rows[0], std::max(dim, hid4));
  const size_t stage = (size_t)kRowTile * (kmax + 8) * sizeof(bf16) +
                       sizeof(float) * kWarps * std::max(kvh, 1) * 32 * 4;
  const size_t work = std::max(attend_smem_bytes<G>(J, kThreads), stage);
  p.work_bytes = (int)((work + 15) / 16 * 16);
  p.smem_bytes = 128 + (p.slice_bytes + 127) / 128 * 128 + 64 + p.work_bytes;
  return p;
}

template <typename Rows>
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
  const int* tvec;
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

template <typename Rows>
__device__ __forceinline__ void mark(const AttendArgs<Rows>& a, int k, int block = 0) {
  if (a.phase_ns != nullptr && blockIdx.x == block && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.phase_ns[k] = ns;
  }
}

// Rows [r0, r0 + 16) of src [b, K] bf16 into As [16][K + 8] (rows past b
// zero); ends with a barrier.
__device__ void stage_rows(bf16* As, const bf16* src, int b, int K, int r0) {
  const int vec = K / 8, lda = K + 8;
  for (int i = threadIdx.x; i < kRowTile * vec; i += blockDim.x) {
    const int m = i / vec, c = i % vec;
    bf16* dst = As + m * lda + 8 * c;
    if (r0 + m < b)
      cp_async16(dst, src + (size_t)(r0 + m) * K + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();
}

// This warp's share of As[:, k0:k1) . W[k0:k1, 0:8) for one 8-column tile W
// [K][8] in shared memory: the k-steps k0 + 16 (warp + 8 j), summed in order
// on the tensor cores, into red[0:128) as [16 rows][8 columns].
__device__ __forceinline__ void warp_partial(const bf16* As, int lda, const bf16* W, int k0,
                                             int k1, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = k0 + 16 * warp; k < k1; k += 16 * kWarps) {
    uint32_t a[4], bb[2];
    ldmatrix_x4(a, As + (lane & 15) * lda + k + (lane >> 4) * 8);
    ldmatrix_x2_trans(bb, W + (k + (lane & 15)) * kTileCols);
    mma_bf16(acc, a, bb);
  }
  const int grp = lane >> 2, tq = lane & 3;
  red[grp * 8 + 2 * tq] = acc[0];
  red[grp * 8 + 2 * tq + 1] = acc[1];
  red[(grp + 8) * 8 + 2 * tq] = acc[2];
  red[(grp + 8) * 8 + 2 * tq + 1] = acc[3];
}

// Thread o < 128's element of a tile: the warps' partials in warp order.
__device__ __forceinline__ float warp_sum_in_order(const float* red, int o) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w * 128 + o];
  return s;
}

__device__ __forceinline__ float ldcg_bf16(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <int G, typename Rows>
__global__ void __launch_bounds__(kThreads, 1)
    attend_persistent_kernel(const AttendArgs<Rows> a, const __grid_constant__ CUtensorMap m_out,
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
  for (int q = 0, o = 0; q < kProducts; ++q) {
    count[q] = plan_count(p, q, g);
    first[q] = plan_first(p, q, g);
    at[q] = o;
    o += count[q] * p.rows[q] * kTileCols;
  }

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
    const int t = a.tvec[bh / a.kvh];
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
    const int K = p.rows[0], Kh = G * kD, lda = K + 8;
    bf16* As = reinterpret_cast<bf16*>(work);
    float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
    bf16* dst = a.hid4 ? a.y : a.out;
    if (count[0]) mbar_wait(&bars[0], 0);
    for (int rt = 0; rt < nrt && count[0]; ++rt) {
      stage_rows(As, a.comb, a.b, K, rt * kRowTile);
      for (int j = 0; j < count[0]; ++j) {
        const bf16* W = wsm + at[0] + j * K * kTileCols;
        for (int h = 0; h < a.kvh; ++h)
          warp_partial(As, lda, W, h * Kh, (h + 1) * Kh, red + (h * kWarps + warp) * 128);
        __syncthreads();
        const int row = rt * kRowTile + m, col = (first[0] + j * p.grid) * kTileCols + n;
        if (o < 128 && row < a.b) {
          float y = __bfloat162float(a.x[(size_t)row * a.dim + col]);
          for (int h = 0; h < a.kvh; ++h) y += warp_sum_in_order(red + h * kWarps * 128, o);
          dst[(size_t)row * a.dim + col] = __float2bfloat16(y);
        }
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
      for (int r = warp; r < kRowTile; r += kWarps) {   // RMSNorm, in place
        bf16* yr = As + r * lda;
        float ss = 0.f;
        for (int c = lane; c < K; c += 32) {
          const float v = __bfloat162float(yr[c]);
          ss += v * v;
        }
        const float inv = rsqrtf(warp_sum(ss) / K + a.eps);
        for (int c = lane; c < K; c += 32)
          yr[c] = __float2bfloat16(__bfloat162float(yr[c]) * inv * a.ff_norm[c]);
      }
      __syncthreads();
      for (int j = 0; j < count[1]; ++j) {
        warp_partial(As, lda, wsm + at[1] + j * K * kTileCols, 0, K, red + warp * 128);
        __syncthreads();
        const int row = rt * kRowTile + m, col = (first[1] + j * p.grid) * kTileCols + n;
        if (o < 128 && row < a.b) {
          const float hv = round_bf16(round_bf16(warp_sum_in_order(red, o)) +
                                      round_bf16(a.ff_b1[col]));
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
        warp_partial(As, lda, wsm + at[2] + j * K * kTileCols, 0, K, red + warp * 128);
        __syncthreads();
        const int row = rt * kRowTile + m, col = (first[2] + j * p.grid) * kTileCols + n;
        if (o < 128 && row < a.b) {
          const size_t i = (size_t)row * a.dim + col;
          const float ov = round_bf16(round_bf16(warp_sum_in_order(red, o)) +
                                      round_bf16(a.ff_b2[col]));
          a.out[i] = __float2bfloat16(ldcg_bf16(a.y + i) + ov);
        }
        __syncthreads();
      }
    }
  }
  mark(a, 4, p.off[2]);
}

// A [K, N] row-major bf16 matrix as boxes of 64 rows x 8 columns.  A map
// holds only the address, the sizes and the strides, so the maps of the
// last few matrices are kept and reused (the weights of every layer).
bool encode_tiles(CUtensorMap* map, const void* w, int K, int N) {
  struct Entry {
    const void* w;
    int K, N;
    CUtensorMap map;
  };
  constexpr int kKept = 64;
  static Entry kept[kKept] = {};
  static int next = 0;
  for (const Entry& e : kept)
    if (e.w == w && e.K == K && e.N == N) {
      *map = e.map;
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kTileCols, (cuuint32_t)kBoxRows};
  const cuuint32_t elem[2] = {1u, 1u};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  kept[next] = Entry{w, K, N, *map};
  next = (next + 1) % kKept;
  return true;
}

// The plan at one block per SM, and how many such blocks fit on an SM (0:
// the shared memory a block needs exceeds what the card allows).
// The SM count and shared-memory limit of a device, read once.
constexpr int kMaxDevices = 64;

cudaError_t device_limits(int* sms, int* smem_optin) {
  static int cache[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev][0] == 0) {
    if ((e = cudaDeviceGetAttribute(&cache[dev][0], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&cache[dev][1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess) {
      cache[dev][0] = 0;
      return e;
    }
  }
  *sms = cache[dev][0];
  *smem_optin = cache[dev][1];
  return cudaSuccess;
}

// The plan at one block per SM, and how many such blocks fit on an SM (0:
// the shared memory a block needs exceeds what the card allows).  The
// kernel's shared-memory attribute and occupancy are set and read once per
// device and size.
template <int G, typename Rows>
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
    auto kern = attend_persistent_kernel<G, Rows>;
    if ((e = set_smem((const void*)kern, plan->smem_bytes)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev][1], kern, kThreads,
                                                           plan->smem_bytes)) != cudaSuccess)
      return e;
    cached[dev][0] = plan->smem_bytes;
  }
  *per_sm = cached[dev][1];
  return cudaSuccess;
}

template <int G, typename Rows>
cudaError_t launch_attend_persistent(AttendArgs<Rows>& a, const bf16* w_out, const bf16* w1,
                                     const bf16* w2, cudaStream_t stream) {
  const int J = (a.num_sel + a.n_slide) * a.sel_block;
  int per_sm = 0, optin = 0;
  cudaError_t e = attend_plan<G, Rows>(a.kvh, a.dim, a.hid4, J, &a.plan, &per_sm, &optin);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;   // never a grid that waits forever
  CUtensorMap maps[kProducts] = {};
  if (!encode_tiles(&maps[0], w_out, a.plan.rows[0], a.dim)) return cudaErrorInvalidValue;
  if (a.hid4 && (!encode_tiles(&maps[1], w1, a.dim, a.hid4) ||
                 !encode_tiles(&maps[2], w2, a.hid4, a.dim)))
    return cudaErrorInvalidValue;
  void* args[] = {&a, &maps[0], &maps[1], &maps[2]};
  if ((e = cudaLaunchCooperativeKernel((const void*)attend_persistent_kernel<G, Rows>,
                                       dim3(a.plan.grid), dim3(kThreads), args,
                                       a.plan.smem_bytes, stream)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

template <typename Rows>
int attend_ragged_entry(int G, const void* rq, const Rows kv, const void* kv_new,
                        const void* info, const void* c_out, const void* gates, const void* x,
                        const void* w_out, const void* ff_norm, const void* ff_w1,
                        const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t,
                        void* comb, void* y, void* hbuf, void* out, void* phase_ns, int b,
                        int kvh, int dim, int hid4, int sel_block, int window, int num_sel,
                        int n_slide, int info_width, float scale, float eps, void* stream) {
  AttendArgs<Rows> a = {(const bf16*)rq, kv, (const bf16*)kv_new, (const int*)info,
                        (const bf16*)c_out, (const bf16*)gates, (const bf16*)x,
                        (const float*)ff_norm, (const float*)ff_b1, (const float*)ff_b2,
                        (const int*)t, (bf16*)comb, (bf16*)y, (bf16*)hbuf, (bf16*)out,
                        (unsigned long long*)phase_ns, b, kvh, dim, hid4, sel_block, window,
                        num_sel, n_slide, info_width, scale, eps, Plan{}};
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16 *wo = (const bf16*)w_out, *w1 = (const bf16*)ff_w1, *w2 = (const bf16*)ff_w2;
  switch (G) {
    case 1: return (int)launch_attend_persistent<1, Rows>(a, wo, w1, w2, s);
    case 2: return (int)launch_attend_persistent<2, Rows>(a, wo, w1, w2, s);
    case 4: return (int)launch_attend_persistent<4, Rows>(a, wo, w1, w2, s);
    case 8: return (int)launch_attend_persistent<8, Rows>(a, wo, w1, w2, s);
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
// max_len, 128] bf16, row t[i] of batch row i written in place.  Scratch:
// comb [b, kvh*G*64] bf16 (the rounded attention output; the caller may
// read it), y [b, dim] bf16, hbuf [b, hid4] bf16; phase_ns null or 5 uint64
// (the global timer at the start, after each grid sync, and where the block
// holding the last product's first tile ends; marks 2-3 stay unwritten
// without the FF).  One cooperative launch;
// returns its cudaError_t (cudaErrorCooperativeLaunchTooLarge when a block's
// weight tiles and work space do not fit, see nsa_decode_attend_ragged_plan).
extern "C" int nsa_decode_attend_fused_ragged(
    const void* rq, void* kv, const void* kv_new, const void* info, const void* c_out,
    const void* gates, const void* x, const void* w_out, const void* ff_norm, const void* ff_w1,
    const void* ff_b1, const void* ff_w2, const void* ff_b2, const void* t, void* comb, void* y,
    void* hbuf, void* out, void* phase_ns, int b, int kvh, int G, int max_len, int dim, int hid4,
    int sel_block, int window, int num_sel, int n_slide, int info_width, float scale, float eps,
    void* stream) {
  return nsa::attend_ragged_entry(G, rq, nsa::DenseRows{(nsa::bf16*)kv, max_len}, kv_new, info,
                                  c_out, gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2, t,
                                  comb, y, hbuf, out, phase_ns, b, kvh, dim, hid4, sel_block,
                                  window, num_sel, n_slide, info_width, scale, eps, stream);
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
  return nsa::attend_ragged_entry(
      G, rq, nsa::PagedRows{(nsa::bf16*)pool, (const int*)page_table, kvh, page, max_pages},
      kv_new, info, c_out, gates, x, w_out, ff_norm, ff_w1, ff_b1, ff_w2, ff_b2, t, comb, y,
      hbuf, out, phase_ns, b, kvh, dim, hid4, sel_block, window, num_sel, n_slide, info_width,
      scale, eps, stream);
}

// The attend kernels' launch plan on the current device (paged 0: the
// dense kernel, 1: the paged one), written to out[7]: grid, blocks that fit
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
  e = paged ? nsa::attend_plan<GG, nsa::PagedRows>(kvh, dim, hid4, J, &p, &per_sm, &optin)    \
            : nsa::attend_plan<GG, nsa::DenseRows>(kvh, dim, hid4, J, &p, &per_sm, &optin); \
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

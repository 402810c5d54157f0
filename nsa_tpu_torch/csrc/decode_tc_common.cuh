// Tensor-core pieces shared by the decode kernels that run their products on
// Hopper's tensor cores: the one-launch attend kernel (rows 7, 9 and 10)
// and the ragged select-emit (row 8) in nsa_decode_ragged.cu, the
// one-position select-emit (row 6) in nsa_decode_fused.cu, and the
// whole-model decode kernel (row 12) in nsa_decode_mega.cu.
//
// * Weight tiles: a [K, N] row-major bf16 matrix is read as 8-column tiles
//   [K][8] (16 bytes a row, so ldmatrix.trans reads them without bank
//   conflicts), by TMA in boxes of 64 rows x 8 columns (encode_tiles).
// * Products at small batch: up to 16 rows of activations staged in shared
//   memory [16][K + 8] (stage_rows) times one weight tile on mma.sync
//   m16n8k16 (bf16 in, float32 sums).  Each warp sums its own k-steps
//   (warp w takes steps w, w + 8, ...) and the 8 warps' partials are added
//   in warp order (tile_dot), so the bits depend on neither the grid nor
//   which block owns a tile.
// * The compressed-block emission (emit_tc_body): the GroupedMLP compressor
//   of the emitting rows as one 16-row tile, its first product streaming
//   w1k / w1v through a ring of mbarrier stages fed by TMA.
// Every sum is taken in a fixed order; there are no atomics.
#pragma once

#include <algorithm>

#include "decode_fused_common.cuh"
#include "hopper_common.cuh"

namespace nsa {
namespace {

constexpr int kTileCols = 8;               // columns of a weight tile: one mma n8
constexpr int kBoxRows = 64;               // rows of a TMA box of a weight tile (1 KB)
constexpr int kTileRowBytes = kTileCols * 2;
constexpr int kRowTile = 16;               // batch rows of an mma row tile
constexpr int kWarps = kThreads / 32;

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

// One 16 x 8 tile of As[16][K] . W[K][8] with K cut into nseg equal
// segments (w_out's heads; 1 elsewhere): every warp's share of every
// segment, then for thread o < 128 (row o / 8, column o % 8) init plus the
// segments' sums in segment order.  red holds nseg * 8 * 128 floats.  Ends
// after a barrier; the caller uses the value, then syncs before red or As
// is written again.
__device__ __forceinline__ float tile_dot(const bf16* As, int lda, const bf16* W, int K, int nseg,
                                          float init, float* red) {
  const int warp = threadIdx.x >> 5, o = threadIdx.x, Ks = K / nseg;
  for (int s = 0; s < nseg; ++s)
    warp_partial(As, lda, W, s * Ks, (s + 1) * Ks, red + (s * kWarps + warp) * 128);
  __syncthreads();
  float acc = init;
  if (o < 128)
    for (int s = 0; s < nseg; ++s) acc += warp_sum_in_order(red + s * kWarps * 128, o);
  return acc;
}

// RMSNorm of the 16 staged rows of As [16][K + 8] in place, float32, rounded
// to bf16: warp w takes rows w, w + 8; kPipe of the scale's values are
// loaded before they are used.  Ends with a barrier.
template <typename T>
__device__ void norm_rows(bf16* As, int K, const T* scale, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, lda = K + 8;
  for (int r = warp; r < kRowTile; r += kWarps) {
    bf16* yr = As + r * lda;
    float ss = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float v = __bfloat162float(yr[c]);
      ss += v * v;
    }
    const float inv = rsqrtf(warp_sum(ss) / K + eps);
    int c = lane;
    for (; c + 32 * (kPipe - 1) < K; c += 32 * kPipe) {
      float sc[kPipe];
#pragma unroll
      for (int u = 0; u < kPipe; ++u) sc[u] = ldf(scale[c + 32 * u]);
#pragma unroll
      for (int u = 0; u < kPipe; ++u)
        yr[c + 32 * u] = __float2bfloat16(__bfloat162float(yr[c + 32 * u]) * inv * sc[u]);
    }
    for (; c < K; c += 32)
      yr[c] = __float2bfloat16(__bfloat162float(yr[c]) * inv * ldf(scale[c]));
  }
  __syncthreads();
}

__device__ __forceinline__ float ldcg_bf16(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Order this thread's earlier generic accesses to shared memory before its
// later bulk (TMA) copies into it: a stage is rewritten by TMA after the
// warps read it with ldmatrix, or after other phases used it as work space.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A [K, N] row-major bf16 matrix as boxes of box_rows rows x box_cols
// columns: 8 columns (a weight tile, 16-byte rows), or 64 with the 128-byte
// swizzle (the emission's stages; see swizzled).  A map holds only the
// address, the sizes and the strides, so the maps of the last few matrices
// are kept and reused (the weights of every layer).
bool encode_tiles(CUtensorMap* map, const void* w, int K, int N, int box_cols = kTileCols,
                  int box_rows = kBoxRows) {
  struct Entry {
    const void* w;
    int K, N, box_cols, box_rows;
    CUtensorMap map;
  };
  constexpr int kKept = 64;
  static Entry kept[kKept] = {};
  static int next = 0;
  for (const Entry& e : kept)
    if (e.w == w && e.K == K && e.N == N && e.box_cols == box_cols && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUtensorMapSwizzle swizzle =
      box_cols == kTileCols ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  kept[next] = Entry{w, K, N, box_cols, box_rows, *map};
  next = (next + 1) % kKept;
  return true;
}

// Row k, 16-byte chunk c (columns 8c..8c+7) of a [64][64] bf16 box that TMA
// wrote with the 128-byte swizzle: chunk c of row k sits at chunk c ^ (k %
// 8) of the row (the box starts on a 1024-byte boundary).
__device__ __forceinline__ const bf16* swizzled(const bf16* box, int k, int c) {
  return box + k * 64 + ((c ^ (k & 7)) << 3);
}

// Which block holds which weight tiles of a kernel's NP products, and the
// shared memory that takes.  Product q has tiles[q] tiles of rows[q] x 8
// columns; tile i lives on block (off[q] + i) % grid, after the block's
// tiles of the products before q.
template <int NP>
struct TilePlan {
  int grid;
  int rows[NP];
  int tiles[NP];
  int off[NP];
  int slice_bytes;                         // the largest block's tiles
  int slice_total;                         // every block's tiles
  int work_bytes;                          // the block's work space
  int smem_bytes;                          // all of it, + alignment slack
};

template <int NP>
__host__ __device__ __forceinline__ int plan_first(const TilePlan<NP>& p, int q, int g) {
  return ((g - p.off[q]) % p.grid + p.grid) % p.grid;
}

template <int NP>
__host__ __device__ __forceinline__ int plan_count(const TilePlan<NP>& p, int q, int g) {
  const int i0 = plan_first(p, q, g);
  return i0 < p.tiles[q] ? (p.tiles[q] - i0 + p.grid - 1) / p.grid : 0;
}

template <int NP>
__host__ __device__ __forceinline__ int plan_bytes(const TilePlan<NP>& p, int q, int g) {
  return plan_count(p, q, g) * p.rows[q] * kTileRowBytes;
}

// slice_bytes and slice_total from the tiles' placement.
template <int NP>
void plan_slices(TilePlan<NP>& p) {
  p.slice_bytes = p.slice_total = 0;
  for (int g = 0; g < p.grid; ++g) {
    int s = 0;
    for (int q = 0; q < NP; ++q) s += plan_bytes(p, q, g);
    p.slice_bytes = std::max(p.slice_bytes, s);
    p.slice_total += s;
  }
}

// Block g's first tile, tile count and offset (in bf16) of each product's
// tiles in its slice.
template <int NP>
__device__ __forceinline__ void plan_slice(const TilePlan<NP>& p, int g, int* first, int* count,
                                           int* at) {
  for (int q = 0, o = 0; q < NP; ++q) {
    count[q] = plan_count(p, q, g);
    first[q] = plan_first(p, q, g);
    at[q] = o;
    o += count[q] * p.rows[q] * kTileCols;
  }
}

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

// ---------------------------------------------------------------------------
// The compressed-block emission on the tensor cores, one item = (KV head h,
// half, 64 hidden columns c0..c0+64) = item / (2 nchunks), item / nchunks %
// 2, item % nchunks.  For every emitting row (all b rows at position t, or
// the `nrows` rows listed in `rows`, each at its own tvec[row]), the window
// [t+1-Bc, t+1) of this half — rows 1.. of the OLD ring, then the new
// token's unrotated k or v — zero before the sequence start, plus pos_kv,
// rounded to bf16 as the cache dtype: one row of the 16-row A tile [16][K]
// (K = Bc * 64).  Then hidden = round(relu(A . w1[h][:, c0:c0+64] + b1)),
// w1's K tiles streaming through kEmitStages stages of 64 rows x 64
// columns (one TMA box each with the 128-byte swizzle, completing on the
// stage's mbarrier; a stage is refilled once every warp has read it), warp
// w owning hidden columns c0 + 8w.. on mma.sync and summing k in ascending
// order.  Then hidden . w2[h][c0:c0+64, half*64:(half+1)*64] (8 KB, one
// swizzled box an item) on the tensor cores into
// partial[h][chunk][row][half*64 + e], the chunk's share
// of the emitted row, which the caller sums over chunks in order (+ b2,
// emit_row_body).  More than 16 emitting rows: one pass over w1 per 16.
// The weights are read through tensor maps over [rows, columns] views in
// boxes of 64 x 64 (encode_tiles with box_cols kEmitCols): w1k / w1v
// [(head0 + h) * K + k, c], w2 [(head0 + h) * hid + c, e], so one map covers
// the stacked layers of the whole-model kernel (head0 = layer * kvh).  The new token's k half of row bi is at new_k + bi * new_row + h *
// new_head, its v half likewise at new_v.
// ---------------------------------------------------------------------------
constexpr int kEmitCols = 64;        // hidden columns of an item: one n8 tile a warp
constexpr int kEmitKTile = 64;       // rows of w1 a stage holds
constexpr int kEmitStages = 8;
constexpr int kEmitStageBytes = kEmitKTile * kEmitCols * 2;   // one swizzled 64 x 64 box
constexpr int kEmitW2Bytes = kEmitCols * kD * 2;              // the same
constexpr int kEmitBars = kEmitStages + 1;                     // the stages', w2's
constexpr int kEmitAlign = 1024;   // the 128-byte swizzle's boxes start on this

// Shared memory of the body (the caller aligns its start to kEmitAlign):
// the stages, w2's tile, the A tile [16][K + 8], the hidden tile [16][72].
__host__ __device__ constexpr size_t emit_tc_smem_bytes(int K) {
  return (size_t)kEmitStages * kEmitStageBytes + kEmitW2Bytes + (size_t)kRowTile * (K + 8) * 2 +
         (size_t)kRowTile * (kEmitCols + 8) * 2;
}

// A block's emission barriers and how many loads each has taken, so that
// successive items (and, in the whole-model kernel, layers and steps) wait
// for the right phase.  Every thread keeps the same counts.
struct EmitRing {
  uint64_t* bars;        // [kEmitBars] in shared memory, initialised once
  uint32_t loads;        // K tiles issued through the stages so far
  uint32_t w2_loads;     // w2 tiles issued so far
};

// Thread 0 initialises the barriers; the caller syncs before any use.
__device__ __forceinline__ void emit_ring_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kEmitBars; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

template <typename BiasT>
__device__ void emit_tc_body(const bf16* ring, const bf16* new_k, const bf16* new_v, int new_row,
                             int new_head, const bf16* __restrict__ pos_kv,
                             const BiasT* __restrict__ b1k, const BiasT* __restrict__ b1v,
                             const CUtensorMap* m_w1k, const CUtensorMap* m_w1v,
                             const CUtensorMap* m_w2, int head0, float* partial, int b, int kvh,
                             int Bc, int hid, int t, int item, EmitRing& er,
                             unsigned char* smem, const int* rows = nullptr, int nrows = 0,
                             const int* tvec = nullptr) {
  const int K = Bc * kD, nchunks = hid / kEmitCols, nk = K / kEmitKTile;
  const int h = item / (2 * nchunks), half = (item / nchunks) & 1, chunk = item % nchunks;
  const int c0 = chunk * kEmitCols;
  bf16* stages = reinterpret_cast<bf16*>(smem);                   // [S][64][64] swizzled
  bf16* w2s = stages + kEmitStages * kEmitStageBytes / 2;         // [64][64] swizzled
  bf16* As = w2s + kEmitW2Bytes / 2;                              // [16][K + 8]
  bf16* Hs = As + kRowTile * (K + 8);                             // [16][72]
  const int lda = K + 8, ldh = kEmitCols + 8;
  const CUtensorMap* m_w1 = half ? m_w1v : m_w1k;
  const int w1row = (head0 + h) * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int n_emit = rows != nullptr ? nrows : b;
  const bf16* nw = (half ? new_v : new_k) + (size_t)h * new_head;

  // K tile kt of this item into the stage of global load number n
  auto issue = [&](uint32_t n, int kt) {
    uint64_t* bar = &er.bars[n % kEmitStages];
    bf16* dst = stages + (n % kEmitStages) * (kEmitStageBytes / 2);
    mbar_expect_tx(bar, kEmitStageBytes);
    tma_load_2d(dst, m_w1, bar, c0, w1row + kt * kEmitKTile);
  };

  __syncthreads();                   // earlier readers of the work space are done
  if (tid == 0) {
    fence_proxy_async();
    uint64_t* bar = &er.bars[kEmitStages];
    mbar_expect_tx(bar, kEmitW2Bytes);
    tma_load_2d(w2s, m_w2, bar, half * kD, (head0 + h) * hid + c0);
  }
  for (int r0 = 0; r0 < n_emit; r0 += kRowTile) {
    const int nb = min(kRowTile, n_emit - r0);
    const uint32_t base = er.loads;
    if (tid == 0)
      for (int kt = 0; kt < min(kEmitStages, nk); ++kt) issue(base + kt, kt);

    // the window rows of this half, while the first stages load
    const int vecs = K / 8;
    for (int i = tid; i < kRowTile * vecs; i += blockDim.x) {
      const int m = i / vecs, r = (i % vecs) * 8, j = r / kD, e = r % kD;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (m < nb) {
        const int bi = rows != nullptr ? rows[r0 + m] : r0 + m;
        const int tr = tvec != nullptr ? tvec[bi] : t;
        const size_t bh = (size_t)bi * kvh + h;
        const uint4 praw = *reinterpret_cast<const uint4*>(
            pos_kv + ((size_t)h * Bc + j) * 2 * kD + half * kD + e);
        const bf16* pp = reinterpret_cast<const bf16*>(&praw);
        float v[8];
        if (tr + 1 - Bc + j < 0) {
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = 0.f;
        } else if (j < Bc - 1) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              ring + (bh * Bc + j + 1) * 2 * kD + half * kD + e);
          const bf16* rp = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(rp[u]);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(nw[(size_t)bi * new_row + e + u]);
        }
        uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pk[u] = pack_bf16(v[2 * u] + __bfloat162float(pp[2 * u]),
                            v[2 * u + 1] + __bfloat162float(pp[2 * u + 1]));
      }
      *reinterpret_cast<uint4*>(As + m * lda + r) = packed;
    }
    __syncthreads();

    // hidden columns c0 + 8 warp.. : A . w1, k ascending
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t n = base + kt;
      mbar_wait(&er.bars[n % kEmitStages], (n / kEmitStages) & 1);
      const bf16* W = stages + (n % kEmitStages) * (kEmitStageBytes / 2);
#pragma unroll
      for (int kk = 0; kk < kEmitKTile; kk += 16) {
        uint32_t a[4], bb[2];
        ldmatrix_x4(a, As + (lane & 15) * lda + kt * kEmitKTile + kk + (lane >> 4) * 8);
        ldmatrix_x2_trans(bb, swizzled(W, kk + (lane & 15), warp));
        mma_bf16(acc, a, bb);
      }
      __syncthreads();               // every warp has read stage n
      if (tid == 0 && kt + kEmitStages < nk) {
        fence_proxy_async();
        issue(n + kEmitStages, kt + kEmitStages);
      }
    }
    er.loads = base + nk;
    {
      const BiasT* b1 = (half ? b1v : b1k) + (size_t)h * hid + c0 + warp * kTileCols + 2 * tq;
      const float bias0 = ldf(b1[0]), bias1 = ldf(b1[1]);
      bf16* hp = Hs + grp * ldh + warp * kTileCols + 2 * tq;
      *reinterpret_cast<uint32_t*>(hp) =
          pack_bf16(fmaxf(acc[0] + bias0, 0.f), fmaxf(acc[1] + bias1, 0.f));
      *reinterpret_cast<uint32_t*>(hp + 8 * ldh) =
          pack_bf16(fmaxf(acc[2] + bias0, 0.f), fmaxf(acc[3] + bias1, 0.f));
    }
    __syncthreads();

    // this chunk's share of the emitted row's half: hidden . w2 tile
    if (r0 == 0) mbar_wait(&er.bars[kEmitStages], er.w2_loads & 1);
    float out[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kEmitCols; kk += 16) {
      uint32_t a[4], bb[2];
      ldmatrix_x4(a, Hs + (lane & 15) * ldh + kk + (lane >> 4) * 8);
      ldmatrix_x2_trans(bb, swizzled(w2s, kk + (lane & 15), warp));
      mma_bf16(out, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = grp + 8 * i;
      if (m >= nb) continue;
      const int bi = rows != nullptr ? rows[r0 + m] : r0 + m;
      float* dst = partial + (((size_t)h * nchunks + chunk) * b + bi) * 2 * kD + half * kD +
                   warp * kTileCols + 2 * tq;
      *reinterpret_cast<float2*>(dst) = make_float2(out[2 * i], out[2 * i + 1]);
    }
    __syncthreads();                 // As and Hs are rewritten next
  }
  ++er.w2_loads;
}

}  // namespace
}  // namespace nsa

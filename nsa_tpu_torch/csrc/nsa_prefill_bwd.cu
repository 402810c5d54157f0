// NSA fine + sliding attention backward (prefill / training) for Hopper (sm_90a).
//
// Replaces the two TPU kernels of nsa_tpu/ops/pallas/nsa_prefill.py::
// _backward_kernels (:597): the q-major _dq_kernel (:412, pallas_call :657)
// and the kv-major _dkv_kernel (:509, pallas_call :677), which the custom VJP
// of nsa_fine_sliding_attention (:704-774) runs in training.
//
// Same results, linearised at straight-through gate value 1.0 like the
// forward: with s = scale * q.k, p = exp(min(s - lse, 30)) on the keys each
// branch's mask keeps, dS = p * (do.v - delta), delta = rowsum(o * do):
//   dq      = scale * sum_keys (dS_fine + dS_slide) k
//   d_gates = per slot, sum over the keys of the slot's block that the fine
//             mask keeps and over the G heads of dS_fine * s; 0 if invalid
//   dk      = sum_rows (dS_fine + dS_slide) * scale * q
//   dv      = sum_rows p_fine * do_fine + p_slide * do_slide
//
// What bounds it on this card: bytes.  At the training cell (b 16, n 4096,
// 4 KV heads, G 2) a row needs at most (S + 1) * Bs + window + 1 = 145 keys;
// each (row, key, head) costs ~8d FLOPs in the backward: ~20 GFLOP per layer,
// 0.02 ms at the bf16 peak, against a least traffic of q, k, v, o, do (both
// branches), the LSEs and the outputs once, ~0.46 GB, 0.14 ms at 3.35 TB/s.
// What the design does about it: like the forward, it visits only the keys
// each row needs, not the causal triangle the TPU kernels scan with masks
// (~13x the work at n 4096), and it shares every load across a tile of rows
// or keys and runs the products on the tensor cores (mma.sync m16n8k16 bf16
// with float32 accumulators).
//
// * bwd_dq_kernel: the forward's query tiles run backwards.  One block owns
//   a (batch, KV head, tile of query rows) for all G heads; a warp's 16 mma
//   rows are 16 / G query rows x G heads (Tile<G>).  It streams the band and
//   then the sorted union of its rows' blocks through the forward's ring
//   (KeyStream, csrc/prefill_common.cuh), each key once per tile, and per
//   16-key sub-tile a warp's rows use takes S = Q.K^T, dP = dO.V^T (both
//   dfo and dso on a band sub-tile that serves both branches), P from the
//   saved LSEs, dS, and dQ += dS.K with K by ldmatrix.trans.  dS enters
//   that product as a bf16 pair hi + lo, so dq keeps dS's float32
//   precision.  The deltas are computed in the prologue and written out
//   (the dkv kernel reads them).  d_gates: per (lane, mma row, block the
//   row uses) the sum of dS_fine * s over the lane's kept keys of the
//   block, added in stream order into shared memory at the row's slot for
//   the block (a cursor into the row's sorted blocks: the stream visits
//   them in order), then summed over a row's four lanes and its G heads in
//   a fixed order and handed to every valid slot that names the block.
// * bwd_dkv_kernel: gathered row tiles.  A pre-pass builds, for each
//   (batch, KV head, selection block), the ascending list of the rows whose
//   valid selection names the block, before the row's own block (counts,
//   an exclusive scan, a fill, then each list sorted through a bitmap of
//   rows, so the order does not depend on the atomics').  A block owns a
//   tile of 16 keys and walks its rows in tiles of 16 mma columns (16 / G
//   rows x G heads): first the contiguous rows [t0, end] that the band or
//   the keys' own blocks reach (their fine masks from their selections),
//   then the listed rows past them of each block that overlaps the tile.
//   Each warp gathers its own row tiles (q, dfo, dso of band rows, LSEs,
//   deltas) into a two-stage cp.async ring and takes S^T = K.Q^T and
//   dP^T = V.dO^T (K and V fragments in registers), P, dS, dV += P^T.dO
//   (P rounded to bf16, as in the forward's P.V) and dK += dS^T.Q (dS as a
//   bf16 pair hi + lo).  The four warps' sums are added in a fixed order.
//   A tile with more rows than a work item takes (512 at the cell) (a block many rows select, a
//   "sink") is split over several work items, which write float32
//   partials that a last pass adds in order.  No float atomics anywhere:
//   both kernels are deterministic.
#include <algorithm>

#include "prefill_common.cuh"

namespace nsa {
namespace {

constexpr float kClamp2 = 30.f * kLog2e;   // exp(min(s - lse, 30)) in base 2

// ---------------------------------------------------------------- dq ----

template <int G>
__global__ void __launch_bounds__(Tile<G>::kThreads, 2)
    bwd_dq_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ rk,
                  const bf16* __restrict__ v, const int* __restrict__ sel_idx,
                  const uint8_t* __restrict__ sel_mask, const bf16* __restrict__ fo,
                  const bf16* __restrict__ so, const float* __restrict__ flse,
                  const float* __restrict__ slse, const bf16* __restrict__ dfo,
                  const bf16* __restrict__ dso, bf16* __restrict__ dq,
                  float* __restrict__ dgates, float* __restrict__ fdel,
                  float* __restrict__ sdel, int num_tiles, int n, int S, int sel_block,
                  int window, int align, int max_union, int max_words, float scale) {
  constexpr int R = Tile<G>::kRows, RW = Tile<G>::kWarpRows, W = Tile<G>::kWarps;
  constexpr int T = Tile<G>::kThreads;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x / num_tiles;
  const int r0 = (num_tiles - 1 - (int)(blockIdx.x % num_tiles)) * R;   // heavy tiles first
  const int last = min(r0 + R, n) - 1, rows = last - r0 + 1;
  const int* idx = sel_idx + ((size_t)bh * n + r0) * S;
  const uint8_t* msk = sel_mask + ((size_t)bh * n + r0) * S;
  KeyStream<G> ks(smem_raw, max_union, max_words, rk, v, bh, n, r0, last, sel_block);
  // past the stream's arrays: each warp's dso rows, each row's blocks (its
  // valid selections before its own block, once each, then its own block)
  // and each mma row's d_gates sums per block of that list and lane
  const int L = S + 1;
  uint8_t* extra = smem_raw + ((sizeof(Stage) + (size_t)max_union * 12 + (size_t)max_words * 8
                                + 15) & ~(size_t)15);
  bf16* dso_s = reinterpret_cast<bf16*>(extra) + warp * 16 * kLd;
  int* row_blk = reinterpret_cast<int*>(extra + W * 16 * kLd * sizeof(bf16));
  int* row_cnt = row_blk + R * L;
  float* gsum = reinterpret_cast<float*>(row_cnt + R);
  ks.build(idx, msk, S, window, align);
  Stage& st = ks.st;
  const WarpRows<G> wr(bh, r0, n, warp, lane);
  ks.start(warp, lane);

  for (int i = tid; i < W * 16 * L * 4; i += T) gsum[i] = 0.f;
  if (tid < rows) {
    const int qb = (r0 + tid) / sel_block;
    int* lst = row_blk + tid * L;
    int nb = 0;
    for (int s = 0; s < S; ++s) {
      const int blk = idx[tid * S + s];
      if (!msk[tid * S + s] || blk < 0 || blk >= qb) continue;
      bool dup = false;
      for (int r = 0; r < nb; ++r) dup |= lst[r] == blk;
      if (!dup) lst[nb++] = blk;
    }
    for (int i = 1; i < nb; ++i)   // ascending, the order the stream visits them in
      for (int r = i; r > 0 && lst[r - 1] > lst[r]; --r) {
        const int t = lst[r];
        lst[r] = lst[r - 1];
        lst[r - 1] = t;
      }
    lst[nb++] = qb;
    row_cnt[tid] = nb;
  }
  // deltas: two lanes an mma row, 32 dims each; the warp's dso rows into
  // shared memory for the band's dP
  float del_f[2], del_s[2];
  {
    const int m = lane >> 1, half = lane & 1;
    const int row = wr.wr0 + m % RW;
    const size_t at = ((size_t)bh * G + m / RW) * n + row;
    float f = 0.f, sl = 0.f;
    bf16* dst = dso_s + m * kLd + half * 32;
    for (int u = 0; u < 4; ++u) {
      uint4 d4 = make_uint4(0u, 0u, 0u, 0u);
      if (row < n) {
        const size_t off = at * kD + half * 32 + u * 8;
        const uint4 o1 = *reinterpret_cast<const uint4*>(fo + off);
        const uint4 g1 = *reinterpret_cast<const uint4*>(dfo + off);
        const uint4 o2 = *reinterpret_cast<const uint4*>(so + off);
        d4 = *reinterpret_cast<const uint4*>(dso + off);
        const __nv_bfloat162* a1 = reinterpret_cast<const __nv_bfloat162*>(&o1);
        const __nv_bfloat162* b1 = reinterpret_cast<const __nv_bfloat162*>(&g1);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&o2);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x1 = __bfloat1622float2(a1[e]), y1 = __bfloat1622float2(b1[e]);
          const float2 x2 = __bfloat1622float2(a2[e]), y2 = __bfloat1622float2(b2[e]);
          f += x1.x * y1.x + x1.y * y1.y;
          sl += x2.x * y2.x + x2.y * y2.y;
        }
      }
      *reinterpret_cast<uint4*>(dst + u * 8) = d4;
    }
    f += __shfl_xor_sync(kFull, f, 1);
    sl += __shfl_xor_sync(kFull, sl, 1);
    if (row < n && half == 0) {
      fdel[at] = f;
      sdel[at] = sl;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      del_f[h] = __shfl_sync(kFull, f, 2 * (wr.grp + 8 * h));
      del_s[h] = __shfl_sync(kFull, sl, 2 * (wr.grp + 8 * h));
    }
  }
  uint32_t qf[4][4], dof[4][4];
  wr.load(rq, qf, lane);
  wr.load(dfo, dof, lane);
  float lse_f[2], lse_s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_f[h] = wr.live[h] ? flse[wr.at[h]] * kLog2e : 0.f;
    lse_s[h] = wr.live[h] ? slse[wr.at[h]] * kLog2e : 0.f;
  }
  __syncthreads();   // the row lists and the zeroed sums

  const float sl2 = scale * kLog2e;
  float acc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  // the fine terms of one sub-tile: adds dS_fine to ds; g = dS_fine * q.k
  // (s / scale: the gates' sums are scaled once, at the end)
  auto fine_terms = [&](const float (&sc)[2][4], const float (&dp)[2][4], const bool (&ok)[2][4],
                        float (&ds)[2][4], float (&g)[2][4]) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = ok[t][e] ? ex2(fminf(fmaf(sc[t][e], sl2, -lse_f[h]), kClamp2)) : 0.f;
        const float d = p * (dp[t][e] - del_f[h]);
        ds[t][e] += d;
        g[t][e] = d * sc[t][e];
      }
  };
  // d_gates: the sub-tile's keys in blocks; seg(j) of key j (0..15) is a
  // block id (band) or a union rank (union), non-decreasing in j.  For each
  // block each lane adds its keys' sum for each of its two rows, if the row
  // uses the block, to the row's slot of the block, one float a lane (the
  // four lanes of a row are added in a fixed order at the end).  The band
  // and then the union visit a row's blocks in ascending order, so the slot
  // is a cursor into the row's sorted list: it starts at the row's first
  // block at or after kb0 for the band, at 0 for the union, and moves on at
  // each new block the row uses.
  int cur[2], cur_b[2] = {-1, -1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cur[h] = 0;
    if (wr.live[h]) {
      const int lr = wr.rows_l[h] - r0;
      for (int r = 0; r < row_cnt[lr]; ++r) cur[h] += row_blk[lr * L + r] < ks.kb0 / sel_block;
    }
  }
  auto gate_sums = [&](const float (&g)[2][4], int seg0, int seg_last, bool in_band,
                       int j0) {
    for (int seg = seg0; seg <= seg_last; ++seg) {   // uniform over the warp
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int j = t * 8 + 2 * wr.tq + c2;
          if (seg0 == seg_last || (j0 + j) / sel_block == seg) {
            part[0] += g[t][c2];
            part[1] += g[t][c2 + 2];
          }
        }
      const int B = in_band ? seg : ks.blocks[seg];
      const int ub = in_band ? (ks.in_union(B) ? union_rank(ks.bitmap, ks.words_before, B) : -1)
                             : seg;
      const uint32_t use = ub < 0 ? 0u : (uint32_t)(ks.members[ub] >> wr.wbit);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!wr.live[h] || !((use >> wr.sh_l[h]) & 1u)) continue;
        if (B != cur_b[h]) {
          cur_b[h] = B;
          ++cur[h];
        }
        gsum[((warp * 16 + wr.grp + 8 * h) * L + cur[h] - 1) * 4 + wr.tq] += part[h];
      }
    }
  };
  // dQ += dS . K, dS as bf16 hi + lo
  auto add_dq = [&](const float (&ds)[2][4], const bf16* kt) {
    uint32_t hi[4], lo[4];
    pack_a_split(ds, hi, lo);
    product_nn2(hi, lo, kt, acc, lane);
  };

  // the band: both branches from one S per sub-tile
  for (int c = 0; c < ks.band_chunks; ++c) {
    ks.enter(c, warp, lane);
    const int buf = c % kStages;
#pragma unroll 1
    for (int s4 = 0; s4 < kSub; ++s4) {
      const int k0 = ks.kb0 + c * kChunk + s4 * 16;
      if (k0 > last) break;
      const bool f = ks.fine_rows(buf, s4, wr.wbit, WarpRows<G>::kRowBits, lane);
      const bool sl = k0 <= wr.wr0 + RW - 1 && k0 + 15 >= wr.wr0 - window && wr.wr0 < n;
      if (!f && !sl) continue;   // uniform over the warp
      const bf16* kt = st.k[buf] + s4 * 16 * kLd;
      const bf16* vt = st.v[buf] + s4 * 16 * kLd;
      float sc[2][4], dp[2][4], ds[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      int kp[2][2];
      uint32_t km[2][2];
      bool ok[2][4];
      float g[2][4];
      product_nt(qf, kt, sc, lane);
      wr.key_meta(st, buf, s4, kp, km);
      if (f) {
        product_nt(dof, vt, dp, lane);
        wr.keep(false, kp, km, window, ok);
        fine_terms(sc, dp, ok, ds, g);
      }
      if (sl) {
        uint32_t dos[4][4];
#pragma unroll
        for (int ds4 = 0; ds4 < 4; ++ds4)
          ldmatrix_x4(dos[ds4], dso_s + (lane & 15) * kLd + ds4 * 16 + (lane >> 4) * 8);
        product_nt(dos, vt, dp, lane);
        wr.keep(true, kp, km, window, ok);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float p =
                ok[t][e] ? ex2(fminf(fmaf(sc[t][e], sl2, -lse_s[h]), kClamp2)) : 0.f;
            ds[t][e] += p * (dp[t][e] - del_s[h]);
          }
      }
      add_dq(ds, kt);   // first, so that its products run while the gate sums wait
      if (f) gate_sums(g, k0 / sel_block, min(k0 + 15, last) / sel_block, true, k0);
    }
    ks.leave(c, lane);
  }

  // the union blocks: the fine branch alone
  cur[0] = cur[1] = 0;
  cur_b[0] = cur_b[1] = -1;
  for (int c = ks.band_chunks; c < ks.n_chunks; ++c) {
    ks.enter(c, warp, lane);
    const int buf = c % kStages;
    const int u0 = (c - ks.band_chunks) * kChunk;
#pragma unroll 1
    for (int s4 = 0; s4 < kSub; ++s4) {
      const int uk = u0 + s4 * 16;
      if (uk >= ks.union_keys) break;
      if (!ks.fine_rows(buf, s4, wr.wbit, WarpRows<G>::kRowBits, lane)) continue;
      const bf16* kt = st.k[buf] + s4 * 16 * kLd;
      float sc[2][4], dp[2][4], g[2][4], ds[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      int kp[2][2];
      uint32_t km[2][2];
      bool ok[2][4];
      product_nt(qf, kt, sc, lane);
      product_nt(dof, st.v[buf] + s4 * 16 * kLd, dp, lane);
      wr.key_meta(st, buf, s4, kp, km);
      wr.keep(false, kp, km, window, ok);
      fine_terms(sc, dp, ok, ds, g);
      add_dq(ds, kt);
      gate_sums(g, uk / sel_block, min(uk + 15, ks.union_keys - 1) / sel_block, false, uk);
    }
    ks.leave(c, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!wr.live[h]) continue;
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      store_bf16x2(dq + wr.at[h] * kD + t * 8 + 2 * wr.tq, acc[t][2 * h] * scale,
                   acc[t][2 * h + 1] * scale);
  }
  __syncthreads();   // every warp's gate sums
  if (tid < rows) {
    const int* lst = row_blk + tid * L;
    const int wq = tid / RW, m0 = tid % RW;
    for (int s = 0; s < S; ++s) {
      float val = 0.f;
      if (msk[tid * S + s]) {
        for (int r = 0; r < row_cnt[tid]; ++r)
          if (lst[r] == idx[tid * S + s]) {
            for (int g = 0; g < G; ++g)
              for (int q = 0; q < 4; ++q) val += gsum[((wq * 16 + g * RW + m0) * L + r) * 4 + q];
            val *= scale;
          }
      }
      dgates[((size_t)bh * n + r0 + tid) * S + s] = val;
    }
  }
}

// --------------------------------------------------------------- dkv ----

constexpr int kKeys = 16;           // keys a dkv tile
constexpr int kKvWarps = 4;         // warps a dkv block, each with its own row tiles
constexpr int kRowStages = 2;       // a warp's gather ring
constexpr int kMinRowsPerItem = 512;
constexpr int kSortWarps = 4;

// One row tile in shared memory: 16 mma columns, column c = row c % RW of
// head c / RW.
struct RowStage {
  bf16 q[16 * kLd];
  bf16 dfo[16 * kLd];
  bf16 dso[16 * kLd];     // zero for a row outside the band
  float term[4][16];      // per column: fine and sliding LSE, fine and sliding delta
  int row[16];            // per row slot: position, -1 past the item
  uint32_t fine[16];      // per row slot: the tile's keys in its fine set
};

struct KvSmem {
  RowStage st[kKvWarps][kRowStages];
  int seg_ptr[kKeys];     // per block of the tile: its first listed row past the contiguous ones
  int seg_start[kKeys + 1];
};

// How a dkv launch is laid out: the work items and their bounds.
struct KvPlan {
  int nblk, n_tiles, n_lists, n_tiles_all, rows_per_item;
  long long list_entries, items_bound, slots_bound;
  size_t off_cnt, off_cur, off_off, off_rows, off_tcnt, off_toff, off_items, off_part, bytes;
};

inline KvPlan kv_plan(int b, int kvh, int n, int S, int sel_block, int window) {
  KvPlan p;
  p.nblk = (n + sel_block - 1) / sel_block;
  p.n_tiles = (n + kKeys - 1) / kKeys;
  p.n_lists = b * kvh * p.nblk;
  p.n_tiles_all = b * kvh * p.n_tiles;
  // contiguous rows of a tile: the band's and the keys' own blocks'
  const long long contig = std::max(kKeys + window, kKeys - 1 + sel_block);
  p.rows_per_item = (int)std::max((long long)kMinRowsPerItem, (2 * contig + 15) / 16 * 16);
  int tpb = 1;   // most key tiles one block overlaps
  for (int B = 0; B < 16; ++B)
    tpb = std::max(tpb, (B * sel_block + sel_block - 1) / kKeys - B * sel_block / kKeys + 1);
  p.list_entries = (long long)b * kvh * n * S;
  const long long lsum = p.list_entries * tpb;    // list rows over all tiles, at most
  // items: sum over tiles of ceil(rows / R) <= tiles + (tiles * contig + lsum) / R;
  // split tiles' items (rows > R each, > R - contig of them listed):
  // < 2 * lsum / (R - contig)
  const long long R = p.rows_per_item;
  p.items_bound = p.n_tiles_all + (p.n_tiles_all * contig + lsum) / R + 1;
  p.slots_bound = 2 * lsum / (R - contig) + 1;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t o = at;
    at = (at + bytes + 255) / 256 * 256;
    return o;
  };
  p.off_cnt = take(sizeof(int) * p.n_lists);
  p.off_cur = take(sizeof(int) * p.n_lists);
  p.off_off = take(sizeof(int) * (p.n_lists + 1));
  p.off_rows = take(sizeof(int) * std::max(1LL, p.list_entries));
  p.off_tcnt = take(sizeof(long long) * p.n_tiles_all);
  p.off_toff = take(sizeof(long long) * (p.n_tiles_all + 1));
  p.off_items = take(sizeof(int) * p.items_bound);
  p.off_part = take(sizeof(float) * 2 * kKeys * kD * p.slots_bound);
  p.bytes = at;
  return p;
}

// Each row's valid selections before its own block, once each, counted
// (fill = false) or written to their block's list (fill = true).
template <bool kFill>
__global__ void list_rows_kernel(const int* __restrict__ sel_idx,
                                 const uint8_t* __restrict__ sel_mask, int* cnt,
                                 const int* __restrict__ off, int* __restrict__ rows,
                                 long long n_rows, int n, int S, int sel_block, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const long long bh = i / n;
  const int r = (int)(i % n), qb = r / sel_block;
  const int* idx = sel_idx + i * S;
  const uint8_t* msk = sel_mask + i * S;
  for (int s = 0; s < S; ++s) {
    const int B = idx[s];
    if (!msk[s] || B < 0 || B >= qb) continue;
    bool dup = false;
    for (int e = 0; e < s; ++e) dup |= msk[e] && idx[e] == B;
    if (dup) continue;
    const long long list = bh * nblk + B;
    if (kFill)
      rows[off[list] + atomicAdd(&cnt[list], 1)] = r;
    else
      atomicAdd(&cnt[list], 1);
  }
}

// Exclusive scan of len values into out[0 .. len] (out[len] the total), by
// one block of 1024 threads.
template <typename V>
__global__ void __launch_bounds__(1024) exclusive_scan_kernel(const V* __restrict__ in,
                                                              V* __restrict__ out, int len) {
  constexpr int kPer = 16;
  __shared__ V part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V carry = 0;
  for (int base = 0; base < len; base += 1024 * kPer) {
    const int i0 = base + threadIdx.x * kPer;
    V loc[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      loc[k] = i0 + k < len ? in[i0 + k] : V(0);
      sum += loc[k];
    }
    V inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) part[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      V w = part[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const V y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      part[lane] = w;
    }
    __syncthreads();
    V run = carry + (warp ? part[warp - 1] : V(0)) + inc - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (i0 + k < len) out[i0 + k] = run;
      run += loc[k];
    }
    carry += part[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[len] = carry;
}

// Each list in ascending row order: one warp a list, through a bitmap of the
// sequence's rows in shared memory.
__global__ void list_sort_kernel(int* __restrict__ rows, const int* __restrict__ off,
                                 int n_lists, int nwords) {
  extern __shared__ uint32_t bitmaps[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int list = blockIdx.x * kSortWarps + warp;
  if (list >= n_lists) return;   // uniform over the warp
  const int lo = off[list], hi = off[list + 1];
  if (hi - lo <= 1) return;
  uint32_t* bm = bitmaps + warp * nwords;
  for (int w = lane; w < nwords; w += 32) bm[w] = 0u;
  __syncwarp();
  for (int i = lo + lane; i < hi; i += 32) atomicOr(&bm[rows[i] >> 5], 1u << (rows[i] & 31));
  __syncwarp();
  int run = lo;
  for (int base = 0; base < nwords; base += 32) {
    const int w = base + lane;
    uint32_t bits = w < nwords ? bm[w] : 0u;
    const int c = __popc(bits);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    for (int p = run + inc - c; bits; ++p) {
      rows[p] = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
    }
    run += __shfl_sync(kFull, inc, 31);
  }
}

// A key tile's rows: the contiguous ones [t0, end], then per block j of
// the tile (block lo + j) its listed rows past end, from rows[ptr[j]] on.
struct TileRows {
  int t0, blk_lo, nb, band_end, end, n_contig;
};

__device__ __forceinline__ TileRows tile_rows(int t0, int n, int sel_block, int window) {
  TileRows tr;
  tr.t0 = t0;
  const int t1 = min(t0 + kKeys, n) - 1;
  tr.blk_lo = t0 / sel_block;
  tr.nb = t1 / sel_block - tr.blk_lo + 1;
  tr.band_end = min(n - 1, t1 + window);
  tr.end = max(tr.band_end, min(n - 1, (t1 / sel_block + 1) * sel_block - 1));
  tr.n_contig = tr.end - t0 + 1;
  return tr;
}

// The first entry of the ascending rows[lo, hi) above `row`.
__device__ __forceinline__ int first_above(const int* rows, int lo, int hi, int row) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] <= row) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Per key tile: its work items (ceil(rows / rows_per_item)) in the low
// half, and as many partial slots in the high half when there is more than
// one.
__global__ void plan_kernel(const int* __restrict__ off, const int* __restrict__ rows,
                            long long* __restrict__ tcnt, int n_tiles_all, int n_tiles, int n,
                            int sel_block, int window, int nblk, int rows_per_item) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n_tiles_all) return;
  const int bh = tile / n_tiles;
  const TileRows tr = tile_rows((tile % n_tiles) * kKeys, n, sel_block, window);
  long long total = tr.n_contig;
  for (int j = 0; j < tr.nb; ++j) {
    const int list = bh * nblk + tr.blk_lo + j;
    total += off[list + 1] - first_above(rows, off[list], off[list + 1], tr.end);
  }
  const long long items = (total + rows_per_item - 1) / rows_per_item;
  tcnt[tile] = items | (items > 1 ? items << 32 : 0LL);
}

__global__ void items_kernel(const long long* __restrict__ toff, int* __restrict__ items,
                             int n_tiles_all) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n_tiles_all) return;
  const int first = (int)(toff[tile] & 0xffffffffLL);
  const int end = (int)(toff[tile + 1] & 0xffffffffLL);
  for (int i = first; i < end; ++i) items[i] = tile;
}

template <int G>
__global__ void __launch_bounds__(kKvWarps * 32, 3)
    bwd_dkv_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ rk,
                   const bf16* __restrict__ v, const int* __restrict__ sel_idx,
                   const uint8_t* __restrict__ sel_mask, const float* __restrict__ flse,
                   const float* __restrict__ slse, const float* __restrict__ fdel,
                   const float* __restrict__ sdel, const bf16* __restrict__ dfo,
                   const bf16* __restrict__ dso, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   const int* __restrict__ off, const int* __restrict__ list_rows,
                   const long long* __restrict__ toff, const int* __restrict__ items,
                   float* __restrict__ partial, int n_tiles_all, int n_tiles, int n, int S,
                   int sel_block, int window, int nblk, int rows_per_item, float scale) {
  constexpr int RW = 16 / G;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  KvSmem& sm = *reinterpret_cast<KvSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int item = blockIdx.x;
  if (item >= (int)(toff[n_tiles_all] & 0xffffffffLL)) return;
  const int tile = items[item];
  const long long first_item = toff[tile] & 0xffffffffLL;
  const int chunk = item - (int)first_item;
  const int n_items = (int)((toff[tile + 1] & 0xffffffffLL) - first_item);
  const long long bh = tile / n_tiles;
  const TileRows tr = tile_rows((tile % n_tiles) * kKeys, n, sel_block, window);
  const int t0 = tr.t0;

  // the listed rows' segments: where each block's rows start in the tile's
  // row sequence
  if (warp == 0) {
    int len = 0;
    if (lane < tr.nb) {
      const int list = (int)(bh * nblk) + tr.blk_lo + lane;
      const int p = first_above(list_rows, off[list], off[list + 1], tr.end);
      sm.seg_ptr[lane] = p;
      len = off[list + 1] - p;
    }
    int inc = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane <= tr.nb) sm.seg_start[lane] = tr.n_contig + inc - len;
  }
  __syncthreads();
  const int v0 = chunk * rows_per_item;
  const int v1 = min(v0 + rows_per_item, sm.seg_start[tr.nb]);
  const int n_rt = (v1 - v0 + RW - 1) / RW;

  // the tile's keys and values as A fragments (mma rows = keys)
  const size_t kr0 = (size_t)bh * n + t0;
  uint32_t kf[4][4], vf[4][4];
  load_a(rk + (kr0 + grp) * kD, rk + (kr0 + grp + 8) * kD, t0 + grp < n, t0 + grp + 8 < n, kf,
         lane);
  load_a(v + (kr0 + grp) * kD, v + (kr0 + grp + 8) * kD, t0 + grp < n, t0 + grp + 8 < n, vf,
         lane);
  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[t][e] = acc_v[t][e] = 0.f;

  // gather row tile k of the item into stage buf
  auto issue = [&](int k, int buf) {
    RowStage& rs = sm.st[warp][buf];
    if (lane < RW) {
      const int vr = v0 + k * RW + lane;
      int row = -1;
      uint32_t fine = 0u;
      if (vr < v1) {
        if (vr < tr.n_contig) {
          // fine: the keys <= row of its own block and of its valid
          // selections before it
          row = t0 + vr;
          const int qb = row / sel_block;
          const int* idx = sel_idx + ((size_t)bh * n + row) * S;
          const uint8_t* msk = sel_mask + ((size_t)bh * n + row) * S;
          for (int j = 0; j < kKeys; ++j) {
            const int kpos = t0 + j;
            if (kpos < n && kpos <= row && kpos / sel_block == qb) fine |= 1u << j;
          }
          for (int s = 0; s < S; ++s) {
            const int B = idx[s];
            if (!msk[s] || B < tr.blk_lo || B >= tr.blk_lo + tr.nb || B >= qb) continue;
            for (int j = 0; j < kKeys; ++j)
              if (t0 + j < n && (t0 + j) / sel_block == B) fine |= 1u << j;
          }
        } else {
          int j = 0;
          while (j + 1 < tr.nb && sm.seg_start[j + 1] <= vr) ++j;
          row = list_rows[sm.seg_ptr[j] + vr - sm.seg_start[j]];
          const int B = tr.blk_lo + j;
          for (int jj = 0; jj < kKeys; ++jj)
            if (t0 + jj < n && (t0 + jj) / sel_block == B) fine |= 1u << jj;
        }
      }
      rs.row[lane] = row;
      rs.fine[lane] = fine;
    }
    __syncwarp();
    // q, dfo, dso rows: 16 columns x 8 pieces of 16 bytes each
    for (int e = lane; e < 16 * 8; e += 32) {
      const int c = e >> 3, piece = (e & 7) * 8;
      const int row = rs.row[c % RW];
      bf16* dq_ = rs.q + c * kLd + piece;
      bf16* df_ = rs.dfo + c * kLd + piece;
      bf16* ds_ = rs.dso + c * kLd + piece;
      if (row >= 0) {
        const size_t src = (((size_t)bh * G + c / RW) * n + row) * kD + piece;
        cp_async16(dq_, rq + src);
        cp_async16(df_, dfo + src);
        if (row <= tr.band_end)
          cp_async16(ds_, dso + src);
        else
          *reinterpret_cast<uint4*>(ds_) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        *reinterpret_cast<uint4*>(dq_) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(df_) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(ds_) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // the columns' LSEs and deltas: 16 columns x 4 terms
    for (int e = lane; e < 64; e += 32) {
      const int c = e & 15, which = e >> 4;
      const int row = rs.row[c % RW];
      const float* src = which == 0 ? flse : which == 1 ? slse : which == 2 ? fdel : sdel;
      if (row >= 0)
        cp_async4(&rs.term[which][c], src + ((size_t)bh * G + c / RW) * n + row);
      else
        rs.term[which][c] = 0.f;
    }
    cp_async_commit();
  };

  const float sl2 = scale * kLog2e;
  const int first_rt = warp;
  if (first_rt < n_rt) issue(first_rt, 0);
  for (int k = first_rt, it = 0; k < n_rt; k += kKvWarps, ++it) {
    const int buf = it % kRowStages;
    if (k + kKvWarps < n_rt) {
      issue(k + kKvWarps, (it + 1) % kRowStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const RowStage& rs = sm.st[warp][buf];
    const bool any_fine = __any_sync(kFull, lane < RW && rs.fine[lane] != 0u);
    const bool any_band =
        __any_sync(kFull, lane < RW && rs.row[lane] >= 0 && rs.row[lane] <= tr.band_end);
    float sc[2][4], pf[2][4], ps[2][4], ds[2][4];
    product_nt(kf, rs.q, sc, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[t][e] = ps[t][e] = ds[t][e] = 0.f;
    if (any_fine) {
      float dp[2][4];
      product_nt(vf, rs.dfo, dp, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = grp + 8 * (e >> 1), c = t * 8 + 2 * tq + (e & 1);
          if ((rs.fine[c % RW] >> key) & 1u) {
            pf[t][e] = ex2(fminf(fmaf(sc[t][e], sl2, -rs.term[0][c] * kLog2e), kClamp2));
            ds[t][e] = pf[t][e] * (dp[t][e] - rs.term[2][c]);
          }
        }
      uint32_t a[4];
      pack_a(pf[0], pf[1], a);
      product_nn(a, rs.dfo, acc_v, lane);
    }
    if (any_band) {
      float dp[2][4];
      product_nt(vf, rs.dso, dp, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = grp + 8 * (e >> 1), c = t * 8 + 2 * tq + (e & 1);
          const int row = rs.row[c % RW];
          if (row >= 0 && row <= tr.band_end && (unsigned)(row - t0 - key) <= (unsigned)window) {
            ps[t][e] = ex2(fminf(fmaf(sc[t][e], sl2, -rs.term[1][c] * kLog2e), kClamp2));
            ds[t][e] += ps[t][e] * (dp[t][e] - rs.term[3][c]);
          }
        }
      uint32_t a[4];
      pack_a(ps[0], ps[1], a);
      product_nn(a, rs.dso, acc_v, lane);
    }
    uint32_t hi[4], lo[4];
    pack_a_split(ds, hi, lo);
    product_nn2(hi, lo, rs.q, acc_k, lane);
    __syncwarp();   // the stage is refilled two row tiles on
  }

  // the four warps' sums, added in a fixed order in shared memory (over the
  // row stages, which every warp is done with)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);   // [2][16][64]
  for (int w = 0; w < kKvWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int t = 0; t < kD / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = grp + 8 * (e >> 1), d = t * 8 + 2 * tq + (e & 1);
          float* rk_ = red + key * kD + d;
          float* rv_ = red + kKeys * kD + key * kD + d;
          *rk_ = w ? *rk_ + acc_k[t][e] : acc_k[t][e];
          *rv_ = w ? *rv_ + acc_v[t][e] : acc_v[t][e];
        }
    }
    __syncthreads();
  }
  if (n_items == 1) {
    for (int e = tid; e < kKeys * kD / 2; e += kKvWarps * 32) {
      const int key = e / (kD / 2), d = 2 * (e % (kD / 2));
      if (t0 + key >= n) continue;
      const size_t o = (kr0 + key) * kD + d;
      store_bf16x2(dk + o, red[key * kD + d] * scale, red[key * kD + d + 1] * scale);
      store_bf16x2(dv + o, red[kKeys * kD + key * kD + d], red[kKeys * kD + key * kD + d + 1]);
    }
  } else {
    float* dst = partial + ((toff[tile] >> 32) + chunk) * (2 * kKeys * kD);
    for (int e = tid; e < 2 * kKeys * kD / 4; e += kKvWarps * 32)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(red)[e];
  }
}

// The split tiles: their items' partials added in item order.
__global__ void __launch_bounds__(kKvWarps * 32)
    dkv_reduce_kernel(const long long* __restrict__ toff, const float* __restrict__ partial,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int n_tiles, int n,
                      float scale) {
  const int tile = blockIdx.x;
  const long long lo = toff[tile], hi = toff[tile + 1];
  const int n_items = (int)((hi & 0xffffffffLL) - (lo & 0xffffffffLL));
  if (n_items <= 1) return;
  const float* src = partial + (lo >> 32) * (2 * kKeys * kD);
  const int t0 = (tile % n_tiles) * kKeys;
  const size_t kr0 = (size_t)(tile / n_tiles) * n + t0;
  for (int e = threadIdx.x; e < kKeys * kD; e += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < n_items; ++i) {
      a += src[i * 2 * kKeys * kD + e];
      b += src[i * 2 * kKeys * kD + kKeys * kD + e];
    }
    const int key = e / kD;
    if (t0 + key < n) {
      dk[(kr0 + key) * kD + e % kD] = __float2bfloat16(a * scale);
      dv[(kr0 + key) * kD + e % kD] = __float2bfloat16(b);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= (48 << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int G>
cudaError_t launch_dq(const void* rq, const void* rk, const void* v, const void* sel_idx,
                      const void* sel_mask, const void* fo, const void* so, const void* flse,
                      const void* slse, const void* dfo, const void* dso, void* dq,
                      void* dgates, void* fdel, void* sdel, int bkvh, int n, int S,
                      int sel_block, int window, float scale, cudaStream_t stream) {
  constexpr int R = Tile<G>::kRows, W = Tile<G>::kWarps;
  const int num_tiles = (n + R - 1) / R;
  const long long grid = (long long)num_tiles * bkvh;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffffLL || sel_block <= 0 || window < 0) return cudaErrorInvalidValue;
  int max_union, max_words;
  const size_t base = (union_smem(R, n, S, sel_block, max_union, max_words) + 15) & ~(size_t)15;
  const size_t smem = base + (size_t)W * 16 * kLd * sizeof(bf16) + (size_t)R * (S + 2) * 4 +
                      (size_t)W * 16 * (S + 1) * 16;
  const cudaError_t e = allow_smem(bwd_dq_kernel<G>, smem);
  if (e != cudaSuccess) return e;
  typedef const bf16* B;
  bwd_dq_kernel<G><<<(unsigned)grid, Tile<G>::kThreads, smem, stream>>>(
      (B)rq, (B)rk, (B)v, (const int*)sel_idx, (const uint8_t*)sel_mask, (B)fo, (B)so,
      (const float*)flse, (const float*)slse, (B)dfo, (B)dso, (bf16*)dq, (float*)dgates,
      (float*)fdel, (float*)sdel, num_tiles, n, S, sel_block, window, lcm16(sel_block),
      max_union, max_words, scale);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_dkv(const void* rq, const void* rk, const void* v, const void* sel_idx,
                       const void* sel_mask, const void* flse, const void* slse,
                       const void* fdel, const void* sdel, const void* dfo, const void* dso,
                       void* dk, void* dv, uint8_t* ws, int b, int kvh, int n, int S,
                       int sel_block, int window, float scale, cudaStream_t stream) {
  const KvPlan p = kv_plan(b, kvh, n, S, sel_block, window);
  if (p.n_tiles_all == 0) return cudaSuccess;
  if (p.items_bound > 0x7fffffffLL || p.list_entries > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int* cnt = reinterpret_cast<int*>(ws + p.off_cnt);
  int* cur = reinterpret_cast<int*>(ws + p.off_cur);
  int* off = reinterpret_cast<int*>(ws + p.off_off);
  int* rows = reinterpret_cast<int*>(ws + p.off_rows);
  long long* tcnt = reinterpret_cast<long long*>(ws + p.off_tcnt);
  long long* toff = reinterpret_cast<long long*>(ws + p.off_toff);
  int* items = reinterpret_cast<int*>(ws + p.off_items);
  float* part = reinterpret_cast<float*>(ws + p.off_part);
  const long long n_rows = (long long)b * kvh * n;
  const unsigned row_blocks = (unsigned)((n_rows + 255) / 256);
  const unsigned tile_blocks = (unsigned)((p.n_tiles_all + 255) / 256);
  const int nwords = (n + 31) / 32;
  const size_t sort_smem = (size_t)kSortWarps * nwords * 4;
  cudaError_t e = cudaMemsetAsync(ws + p.off_cnt, 0, p.off_off - p.off_cnt, stream);  // cnt, cur
  if (e != cudaSuccess) return e;
  if ((e = allow_smem(list_sort_kernel, sort_smem)) != cudaSuccess) return e;
  const size_t kv_smem = sizeof(KvSmem);
  if ((e = allow_smem(bwd_dkv_kernel<G>, kv_smem)) != cudaSuccess) return e;
  typedef const int* I;
  list_rows_kernel<false><<<row_blocks, 256, 0, stream>>>(
      (I)sel_idx, (const uint8_t*)sel_mask, cnt, off, rows, n_rows, n, S, sel_block, p.nblk);
  exclusive_scan_kernel<int><<<1, 1024, 0, stream>>>(cnt, off, p.n_lists);
  list_rows_kernel<true><<<row_blocks, 256, 0, stream>>>(
      (I)sel_idx, (const uint8_t*)sel_mask, cur, off, rows, n_rows, n, S, sel_block, p.nblk);
  list_sort_kernel<<<(p.n_lists + kSortWarps - 1) / kSortWarps, kSortWarps * 32, sort_smem,
                     stream>>>(rows, off, p.n_lists, nwords);
  plan_kernel<<<tile_blocks, 256, 0, stream>>>(off, rows, tcnt, p.n_tiles_all, p.n_tiles, n,
                                                sel_block, window, p.nblk, p.rows_per_item);
  exclusive_scan_kernel<long long><<<1, 1024, 0, stream>>>(tcnt, toff, p.n_tiles_all);
  items_kernel<<<tile_blocks, 256, 0, stream>>>(toff, items, p.n_tiles_all);
  typedef const bf16* B;
  typedef const float* F;
  bwd_dkv_kernel<G><<<(unsigned)p.items_bound, kKvWarps * 32, kv_smem, stream>>>(
      (B)rq, (B)rk, (B)v, (I)sel_idx, (const uint8_t*)sel_mask, (F)flse, (F)slse, (F)fdel,
      (F)sdel, (B)dfo, (B)dso, (bf16*)dk, (bf16*)dv, off, rows, toff, items, part,
      p.n_tiles_all, p.n_tiles, n, S, sel_block, window, p.nblk, p.rows_per_item, scale);
  dkv_reduce_kernel<<<(unsigned)p.n_tiles_all, kKvWarps * 32, 0, stream>>>(
      toff, part, (bf16*)dk, (bf16*)dv, p.n_tiles, n, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// rq, fo, so, dfo, dso [b, kvh*G, n, 64] bf16; rk, v [b, kvh, n, 64] bf16;
// sel_idx [b, kvh, n, S] int32; sel_mask [b, kvh, n, S] bool; flse, slse
// [b, kvh*G, n] float32 -> dq [b, kvh*G, n, 64] bf16, dgates [b, kvh, n, S]
// float32, fdel, sdel [b, kvh*G, n] float32.
extern "C" int nsa_prefill_bwd_dq(const void* rq, const void* rk, const void* v,
                                  const void* sel_idx, const void* sel_mask, const void* fo,
                                  const void* so, const void* flse, const void* slse,
                                  const void* dfo, const void* dso, void* dq, void* dgates,
                                  void* fdel, void* sdel, int b, int kvh, int G, int n, int S,
                                  int sel_block, int window, float scale, void* stream) {
  if (S > nsa::kMaxSel) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define NSA_BWD_DQ(GG)                                                                     \
  return (int)nsa::launch_dq<GG>(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse, dfo, dso, \
                                 dq, dgates, fdel, sdel, b * kvh, n, S, sel_block, window,  \
                                 scale, st)
  switch (G) {
    case 1: NSA_BWD_DQ(1);
    case 2: NSA_BWD_DQ(2);
    case 4: NSA_BWD_DQ(4);
    case 8: NSA_BWD_DQ(8);
  }
#undef NSA_BWD_DQ
  return (int)cudaErrorInvalidValue;
}

// Bytes of device workspace nsa_prefill_bwd_dkv needs at these shapes, into
// *bytes.
extern "C" int nsa_prefill_bwd_dkv_workspace(int b, int kvh, int n, int S, int sel_block,
                                             int window, long long* bytes) {
  if (S > nsa::kMaxSel || sel_block <= 0 || window < 0 || n < 0) return (int)cudaErrorInvalidValue;
  *bytes = (long long)nsa::kv_plan(b, kvh, n, S, sel_block, window).bytes;
  return (int)cudaSuccess;
}

// fdel, sdel from nsa_prefill_bwd_dq; the rest as there; workspace of the
// bytes nsa_prefill_bwd_dkv_workspace gives -> dk, dv [b, kvh, n, 64] bf16.
extern "C" int nsa_prefill_bwd_dkv(const void* rq, const void* rk, const void* v,
                                   const void* sel_idx, const void* sel_mask, const void* flse,
                                   const void* slse, const void* fdel, const void* sdel,
                                   const void* dfo, const void* dso, void* dk, void* dv,
                                   void* workspace, long long workspace_bytes, int b, int kvh,
                                   int G, int n, int S, int sel_block, int window, float scale,
                                   void* stream) {
  if (S > nsa::kMaxSel || sel_block <= 0 || window < 0) return (int)cudaErrorInvalidValue;
  if ((long long)nsa::kv_plan(b, kvh, n, S, sel_block, window).bytes > workspace_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  uint8_t* ws = (uint8_t*)workspace;
#define NSA_BWD_DKV(GG)                                                                    \
  return (int)nsa::launch_dkv<GG>(rq, rk, v, sel_idx, sel_mask, flse, slse, fdel, sdel,    \
                                  dfo, dso, dk, dv, ws, b, kvh, n, S, sel_block, window,   \
                                  scale, st)
  switch (G) {
    case 1: NSA_BWD_DKV(1);
    case 2: NSA_BWD_DKV(2);
    case 4: NSA_BWD_DKV(4);
    case 8: NSA_BWD_DKV(8);
  }
#undef NSA_BWD_DKV
  return (int)cudaErrorInvalidValue;
}

// Device pieces shared by the prefill forward (csrc/nsa_prefill.cu) and the
// prefill backward (csrc/nsa_prefill_bwd.cu): the mma A-operand packing, the
// mbarrier ring, and a query tile's key stream (the sorted
// union of its rows' blocks, then the band and the union streamed through
// shared memory, each key once per tile).
#pragma once

#include "hopper_common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;
constexpr int kMaxSel = 16;        // selected blocks per row the kernels take
constexpr int kChunk = 64;         // keys a pipeline stage
constexpr int kSub = kChunk / 16;  // 16-key sub-tiles a stage
constexpr int kStages = 4;         // stages in the ring
constexpr int kLd = kD + 8;        // shared-memory row stride in bf16: 144 bytes
constexpr int kNoKey = 0x3fffffff;  // a padding key's position: past every row
constexpr float kLog2e = 1.4426950408889634f;

// A warp's 16 mma rows are kWarpRows query rows x G heads: row m is query
// row m % kWarpRows of head m / kWarpRows, so the G heads of a row, which
// share its selection, share a warp.
template <int G>
struct Tile {
  static constexpr int kRows = G >= 4 ? 128 / G : 64;   // query rows a block
  static constexpr int kWarpRows = 16 / G;
  static constexpr int kWarps = kRows / kWarpRows;       // 4 at G = 1, else 8
  static constexpr int kThreads = 32 * kWarps;
};

// The fixed part of a query tile's shared memory, the ring of key stages;
// the union's masks, blocks, bitmap and word counts follow it (sized by the
// launcher, union_smem()).
struct Stage {
  bf16 k[kStages][kChunk * kLd];
  bf16 v[kStages][kChunk * kLd];
  unsigned long long mask[kStages][kChunk];   // fine: the tile's rows that use the key
  int pos[kStages][kChunk];                   // key position, kNoKey past the sequence
  uint64_t full[kStages];    // the stage's keys and metadata are in (one warp loads it)
  uint64_t empty[kStages];   // every warp is done with the stage
};

// A 16 x 16 accumulator (two 8-wide tiles) as an mma A operand in bf16.
__device__ __forceinline__ void pack_a(const float (&p0)[4], const float (&p1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(p0[0], p0[1]);
  a[1] = pack_bf16(p0[2], p0[3]);
  a[2] = pack_bf16(p1[0], p1[1]);
  a[3] = pack_bf16(p1[2], p1[3]);
}

// The same as a bf16 pair hi + lo, hi + lo = p to about 2^-16 of p: the two
// products with them keep a float32 operand's precision.
__device__ __forceinline__ void pack_a_split(const float (&p)[2][4], uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  pack_a(p[0], p[1], hi);
  float r[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[2 * t + (e >> 1)]));
      r[t][e] = p[t][e] - h.x;
      r[t][e + 1] = p[t][e + 1] - h.y;
    }
  pack_a(r[0], r[1], lo);
}

// 4-byte asynchronous copy global -> shared, through L1.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 x 64 A fragments (four 16-wide k-steps) of the rows at p0 (mma row grp)
// and p1 (mma row grp + 8), each a row of 64 bf16 in device memory; zeros
// for a row that is not live.
__device__ __forceinline__ void load_a(const bf16* p0, const bf16* p1, bool l0, bool l1,
                                       uint32_t (&f)[4][4], int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = s * 16 + 2 * tq + (r >> 1) * 8;
      const bool live = r & 1 ? l1 : l0;
      f[s][r] = live ? *reinterpret_cast<const uint32_t*>((r & 1 ? p1 : p0) + col) : 0u;
    }
}

// sc = A . X^T for 16 rows of X in shared memory (stride kLd): A 16 x 64
// from load_a, sc two 8-wide tiles of 16 x 16.
__device__ __forceinline__ void product_nt(const uint32_t (&a)[4][4], const bf16* x,
                                           float (&sc)[2][4], int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
  const int row = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int ds = 0; ds < kD / 16; ++ds) {
    uint32_t b[4];
    ldmatrix_x4(b, x + row * kLd + ds * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(sc[0], a[ds], b);
    mma_bf16(sc[1], a[ds], b + 2);
  }
}

// acc += A . X for 16 rows of X in shared memory (stride kLd, 64 columns):
// A 16 x 16 (pack_a), acc eight 8-wide tiles of 16 x 64.
__device__ __forceinline__ void product_nn(const uint32_t (&a)[4], const bf16* x,
                                           float (&acc)[kD / 8][4], int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int dp = 0; dp < kD / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, x + row * kLd + dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], a, b);
    mma_bf16(acc[2 * dp + 1], a, b + 2);
  }
}

// acc += (A1 + A2) . X, X's fragments loaded once (A1, A2 a bf16 pair from
// pack_a_split).
__device__ __forceinline__ void product_nn2(const uint32_t (&a1)[4], const uint32_t (&a2)[4],
                                            const bf16* x, float (&acc)[kD / 8][4], int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int dp = 0; dp < kD / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, x + row * kLd + dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], a1, b);
    mma_bf16(acc[2 * dp + 1], a1, b + 2);
    mma_bf16(acc[2 * dp], a2, b);
    mma_bf16(acc[2 * dp + 1], a2, b + 2);
  }
}

// The number of union blocks before block B: B's position in the sorted
// union when B is in it.
__device__ __forceinline__ int union_rank(const uint32_t* bitmap, const int* words_before,
                                          int B) {
  return words_before[B >> 5] + __popc(bitmap[B >> 5] & ((1u << (B & 31)) - 1u));
}

inline int lcm16(int x) {
  int a = 16, b = x;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return 16 / a * x;
}

// Bytes of dynamic shared memory the key stream of a tile of R query rows
// needs: the ring, then per union block a row mask and its id, then the
// bitmap and the words' prefix counts.
inline size_t union_smem(int R, int n, int S, int sel_block, int& max_union, int& max_words) {
  max_union = R * (S + 1);                     // each row: S blocks + its own
  max_words = ((n - 1) / sel_block) / 32 + 1;
  return sizeof(Stage) + (size_t)max_union * (8 + 4) + (size_t)max_words * 8;
}

// The keys one query tile (rows r0 .. last of one batch and KV head) needs,
// streamed once through a ring of kStages stages of kChunk keys.  The block
// first builds, in shared memory, the sorted union of the blocks its rows
// need (a bitmap of the valid selections before each row's own block, plus
// each row's own block, compacted in order) and, for each union block, a
// 64-bit mask of the rows that use it: OR-ing a row's bit in once per slot
// makes a block selected twice count once and the diagonal block count
// once.  The stream is first the contiguous band [kb0, last], where kb0 is
// max(0, r0 - window) rounded down to a multiple of lcm(16, Bs), then the
// keys of the union blocks wholly before kb0, gathered block by block; no
// block is split between the two, so each key is loaded once per tile.
// The warps take turns to fill a stage with cp.async, and mbarriers (not
// block barriers) say when a stage is full and when every warp is done with
// it, so each warp keeps its own pace: warp c % kWarps loads chunk c,
// kStages - 1 chunks ahead of its own place.
template <int G>
struct KeyStream {
  static constexpr int W = Tile<G>::kWarps, T = Tile<G>::kThreads;
  Stage& st;
  unsigned long long* members;
  int* blocks;
  uint32_t* bitmap;
  int* words_before;
  const bf16* kbase;
  const bf16* vbase;
  int r0, last, sel_block;
  int kb0, union_keys, band_chunks, n_chunks;

  __device__ KeyStream(uint8_t* smem, int max_union, int max_words, const bf16* rk,
                       const bf16* v, long long bh, int n, int r0_, int last_, int sel_block_)
      : st(*reinterpret_cast<Stage*>(smem)),
        members(reinterpret_cast<unsigned long long*>(smem + sizeof(Stage))),
        blocks(reinterpret_cast<int*>(members + max_union)),
        bitmap(reinterpret_cast<uint32_t*>(blocks + max_union)),
        words_before(reinterpret_cast<int*>(bitmap + max_words)),
        kbase(rk + (size_t)bh * n * kD),
        vbase(v + (size_t)bh * n * kD),
        r0(r0_),
        last(last_),
        sel_block(sel_block_) {}

  __device__ __forceinline__ bool in_union(int B) const {
    return (bitmap[B >> 5] >> (B & 31)) & 1u;
  }

  // The union and the stream's extent; idx / msk are the tile's first row's
  // selections.  Every thread of the block calls it; it ends with a block
  // barrier.
  __device__ void build(const int* idx, const uint8_t* msk, int S, int window, int align) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rows = last - r0 + 1;
    const int nw = last / sel_block / 32 + 1;
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&st.full[s], 64);    // a loading warp's 32 lanes, twice
        mbar_init(&st.empty[s], W);    // each warp once
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // 1. the union as a bitmap: each row's own block and its valid
    // selections before it (later blocks hold no key <= the row)
    for (int w = tid; w < nw; w += T) bitmap[w] = 0u;
    __syncthreads();
    if (tid < rows) {
      const int qb = (r0 + tid) / sel_block;
      atomicOr(&bitmap[qb >> 5], 1u << (qb & 31));
      for (int s = 0; s < S; ++s) {
        const int blk = idx[tid * S + s];
        if (msk[tid * S + s] && blk >= 0 && blk < qb) atomicOr(&bitmap[blk >> 5], 1u << (blk & 31));
      }
    }
    __syncthreads();
    // 2. set bits before each word (one warp's scan)
    if (warp == 0) {
      int run = 0;
      for (int base = 0; base < nw; base += 32) {
        const int w = base + lane;
        const int c = w < nw ? __popc(bitmap[w]) : 0;
        int inc = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += y;
        }
        if (w < nw) words_before[w] = run + inc - c;
        run += __shfl_sync(kFull, inc, 31);
      }
    }
    __syncthreads();
    // 3. the sorted union, its membership masks cleared
    for (int w = tid; w < nw; w += T) {
      uint32_t bits = bitmap[w];
      for (int p = words_before[w]; bits; ++p) {
        blocks[p] = w * 32 + __ffs(bits) - 1;
        members[p] = 0ull;
        bits &= bits - 1;
      }
    }
    __syncthreads();
    // 4. row t of the tile as bit t of each block it uses, once however
    // often it was selected
    if (tid < rows) {
      const unsigned long long bit = 1ull << tid;
      const int qb = (r0 + tid) / sel_block;
      atomicOr(&members[union_rank(bitmap, words_before, qb)], bit);
      for (int s = 0; s < S; ++s) {
        const int blk = idx[tid * S + s];
        if (msk[tid * S + s] && blk >= 0 && blk < qb)
          atomicOr(&members[union_rank(bitmap, words_before, blk)], bit);
      }
    }
    __syncthreads();
    kb0 = max(0, r0 - window) / align * align;
    union_keys = union_rank(bitmap, words_before, kb0 / sel_block) * sel_block;
    band_chunks = (last + 1 - kb0 + kChunk - 1) / kChunk;
    n_chunks = band_chunks + (union_keys + kChunk - 1) / kChunk;
  }

  // One warp loads chunk c into stage c % kStages: each key's position and
  // fine mask (two keys a lane), then its key and value rows (cp.async),
  // zeros where there is no key (their weights are zero, and zero times
  // zero stays finite).  Every lane arrives on the stage's "full" barrier
  // twice: for its stores, and once its copies have landed.
  __device__ void load_chunk(int c, int lane) {
    const int buf = c % kStages;
    for (int kc = lane; kc < kChunk; kc += 32) {
      int pos = kNoKey;
      unsigned long long mk = 0ull;
      if (c < band_chunks) {
        const int key = kb0 + c * kChunk + kc;
        if (key <= last) {
          pos = key;
          const int B = key / sel_block;
          if (in_union(B)) mk = members[union_rank(bitmap, words_before, B)];
        }
      } else {
        const int u = (c - band_chunks) * kChunk + kc;
        if (u < union_keys) {
          const int ub = u / sel_block;
          pos = blocks[ub] * sel_block + (u - ub * sel_block);
          mk = members[ub];
        }
      }
      st.pos[buf][kc] = pos;
      st.mask[buf][kc] = mk;
    }
    __syncwarp();
    for (int e = lane; e < kChunk * (kD / 8); e += 32) {
      const int kc = e >> 3, col = (e & 7) * 8;
      const int pos = st.pos[buf][kc];
      bf16* kd = st.k[buf] + kc * kLd + col;
      bf16* vd = st.v[buf] + kc * kLd + col;
      if (pos != kNoKey) {
        cp_async16(kd, kbase + (size_t)pos * kD + col);
        cp_async16(vd, vbase + (size_t)pos * kD + col);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    mbar_arrive_copies(&st.full[buf]);
    mbar_arrive(&st.full[buf]);
  }

  // The warp's first chunks (before its loop over the stream).
  __device__ void start(int warp, int lane) {
    for (int c = warp; c < min(kStages - 1, n_chunks); c += W) load_chunk(c, lane);
  }

  // Wait for chunk c, first loading chunk c + kStages - 1 if it is this
  // warp's turn, once every warp is done with the chunk that held its stage.
  __device__ void enter(int c, int warp, int lane) {
    const int ahead = c + kStages - 1;
    if (ahead < n_chunks && ahead % W == warp) {
      if (ahead >= kStages) mbar_wait(&st.empty[ahead % kStages], ((ahead / kStages) - 1) & 1);
      load_chunk(ahead, lane);
    }
    mbar_wait(&st.full[c % kStages], (c / kStages) & 1);
  }

  __device__ void leave(int c, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&st.empty[c % kStages]);   // this warp is done with the stage
  }

  // Does a row of the warp (mask bits wbit .. wbit + rw - 1) use a key of
  // sub-tile s4 (fine)?
  __device__ __forceinline__ bool fine_rows(int buf, int s4, int wbit, uint32_t row_bits,
                                            int lane) const {
    const uint32_t mine =
        lane < 16 ? (uint32_t)(st.mask[buf][s4 * 16 + lane] >> wbit) & row_bits : 0u;
    return __reduce_or_sync(kFull, mine) != 0u;
  }
};

// A warp's query rows in a query tile: rows wr0 .. wr0 + kWarpRows - 1 (bits
// wbit .. of the union's masks) of all G heads; the lane's mma rows grp and
// grp + 8 (with G >= 2 one query row of two heads).
template <int G>
struct WarpRows {
  static constexpr int RW = Tile<G>::kWarpRows;
  static constexpr uint32_t kRowBits = RW == 16 ? 0xFFFFu : (1u << RW) - 1u;
  int grp, tq, wbit, wr0;
  int rows_l[2], sh_l[2];   // the lane's query rows, and their bits past wbit
  size_t at[2];             // (head * n + row) of the lane's mma rows
  bool live[2];

  __device__ WarpRows(long long bh, int r0, int n, int warp, int lane)
      : grp(lane >> 2), tq(lane & 3), wbit(warp * RW), wr0(r0 + warp * RW) {
    rows_l[0] = wr0 + grp % RW;
    rows_l[1] = wr0 + (grp + 8) % RW;
    sh_l[0] = grp % RW;
    sh_l[1] = (grp + 8) % RW;
    at[0] = ((size_t)bh * G + grp / RW) * n + rows_l[0];
    at[1] = ((size_t)bh * G + (grp + 8) / RW) * n + rows_l[1];
    live[0] = rows_l[0] < n;
    live[1] = rows_l[1] < n;
  }

  // The warp's 16 mma rows of a [b, kvh * G, n, 64] tensor as A fragments.
  __device__ __forceinline__ void load(const bf16* x, uint32_t (&f)[4][4], int lane) const {
    load_a(x + at[0] * kD, x + at[1] * kD, live[0], live[1], f, lane);
  }

  // The positions and fine-mask bits (past wbit) of the lane's four keys of
  // sub-tile s4.
  __device__ __forceinline__ void key_meta(const Stage& st, int buf, int s4, int (&kp)[2][2],
                                           uint32_t (&km)[2][2]) const {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int kc = s4 * 16 + t * 8 + 2 * tq + c2;
        kp[t][c2] = st.pos[buf][kc];
        km[t][c2] = (uint32_t)(st.mask[buf][kc] >> wbit);
      }
  }

  // Which of the lane's logits of a sub-tile the fine set (or the band)
  // keeps: ok[t][c2 + 2 h] for key (t, c2) and mma row grp + 8 h.
  __device__ __forceinline__ void keep(bool band, const int (&kp)[2][2],
                                       const uint32_t (&km)[2][2], int window,
                                       bool (&ok)[2][4]) const {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = kp[t][c2], row = rows_l[h];
          ok[t][c2 + 2 * h] = (G >= 2 && h == 1) ? ok[t][c2]
                              : band ? (unsigned)(row - pos) <= (unsigned)window
                                     : pos <= row && ((km[t][c2] >> sh_l[h]) & 1u);
        }
  }
};

}  // namespace
}  // namespace nsa

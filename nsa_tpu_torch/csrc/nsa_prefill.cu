// NSA fine + sliding attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel nsa_tpu/ops/pallas/nsa_prefill.py::_forward (:254,
// pallas_call :315; bodies _kernel :76, _kernel_stream :161, _masks :60),
// which nsa_fine_sliding_attention (:707) runs in the prefill at
// nsa_tpu/ops/nsa.py:330.
//
// Same outputs: for every query row, the fine output (one softmax over the
// selected blocks that are marked valid, united with the block-causal
// diagonal block) and the sliding output (one softmax over the causal band
// 0 <= i - j <= window), both in bf16, and both log-sum-exps in float32.
//
// What bounds it on this card: bytes.  Each query row needs at most
// S * Bs + Bs + window + 1 keys (145 at the reference config) and 4d FLOPs
// per key and head: ~74 GFLOP per layer at bs 64 / n 3900, 0.075 ms at the
// bf16 peak, against a least traffic of q, k, v and both outputs once,
// ~1.05 GB, 0.31 ms at 3.35 TB/s.  So what counts is that a key is fetched
// once for all the rows and heads that use it, and that the arithmetic on
// it runs in parallel.
// What the design does about it: the TPU kernel scans the whole causal
// triangle with masks, because VMEM and the MXU make that cheap there; here
// that would be ~13x the needed work.  Instead one block owns one
// (batch, KV head, tile of kRows query rows) for all G query heads (kRows
// = 64 for G <= 2, 128 / G above).  A warp's 16 mma rows are 16 / G query
// rows of all G heads, which share the rows' selections, so a warp spans
// as few rows, and so as few selected blocks, as it can.  The block first
// builds, in shared memory, the sorted union of the blocks its rows need (a
// bitmap of the valid selections at or before each row's own block, plus
// each row's own block, compacted in order) and, for each union block, a
// 64-bit mask of the rows that use it: OR-ing a row's bit in once per slot
// makes a block selected twice count once and the diagonal block count
// once.  It then streams one key sequence through shared memory in stages
// of 64 keys: first the contiguous band [kb0, last row], where kb0 is
// max(0, first row - window) rounded down to a multiple of lcm(16, Bs),
// then the keys of the union blocks wholly before kb0, gathered block by
// block; no block is split between the two, so each key is loaded once per
// query tile.  The stages form a ring of 4: the warps take turns to fill a
// stage with cp.async, and mbarriers (not block barriers) say when a stage
// is full and when every warp is done with it, so each warp keeps its own
// pace.  A warp takes each 16-key sub-tile one of its rows uses (or, in
// the band, is near): S = Q.K^T as mma.sync m16n8k16 bf16 with float32
// accumulators (q fragments in registers, K by ldmatrix), masked per
// element by the row's membership bit and key <= row (fine) or the band
// (sliding), an online softmax per (row, head) and branch in float32 in
// base 2 (no test for masked logits: the running max starts finite), and
// O += P.V with P rounded to bf16 (V by ldmatrix.trans).  A band sub-tile
// serves both branches from one S; the sliding output is written when the
// band is done, and the union's sub-tiles then go two to one softmax
// update.  P's rounding is the one departure from the TPU kernel, which
// keeps P float32 (so does the plain version); ``fine_sliding_tolerance``
// states what it costs.  The blocks of one (batch, KV head) are adjacent,
// so the few KV heads in flight keep their keys in L2; within them the
// late query tiles, which have the most blocks to choose from, start first.
#include <type_traits>

#include "common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;
constexpr int kMaxSel = 16;        // selected blocks per row the kernel takes
constexpr int kChunk = 64;         // keys a pipeline stage
constexpr int kSub = kChunk / 16;  // 16-key sub-tiles a stage
constexpr int kStages = 4;         // stages in the ring
constexpr int kLd = kD + 8;        // shared-memory row stride in bf16: 144 bytes
constexpr int kNoKey = 0x3fffffff;  // a padding key's position: past every row
constexpr float kLog2e = 1.4426950408889634f;
// The running max before any key, in base-2 units: finite and below every
// logit, so a masked logit (kNeg) gets the weight ex2(kNeg * scale * log2e
// - max) = 0 with no test, even in a row that has had no key yet.
constexpr float kInit = -1e20f;

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

// The fixed part of the block's shared memory, the ring of key stages; the
// union's masks, blocks, bitmap and word counts follow it (sized by the
// launcher).
struct Stage {
  bf16 k[kStages][kChunk * kLd];
  bf16 v[kStages][kChunk * kLd];
  unsigned long long mask[kStages][kChunk];   // fine: the tile's rows that use the key
  int pos[kStages][kChunk];                   // key position, kNoKey past the sequence
  uint64_t full[kStages];    // the stage's keys and metadata are in (one warp loads it)
  uint64_t empty[kStages];   // every warp is done with the stage
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive (release): this thread's earlier shared-memory writes are seen by
// whoever waits for the phase.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a . b for one m16n8k16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax state of one branch for a warp's 16 mma rows, in base 2:
// m is the running max of the scaled logits times log2(e).  In the mma
// fragments lane = 4 * grp + tq owns rows grp and grp + 8 and columns
// 2 tq, 2 tq + 1 of every 8-wide tile.
struct Online {
  float m[2], l[2];
  float acc[kD / 8][4];
  __device__ __forceinline__ void init() {
    m[0] = m[1] = kInit;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  }

  // NT 16-key sub-tiles at once: x the raw logits q.k (kNeg where masked),
  // two 8-key tiles a sub-tile; sl2 = scale * log2(e); vt[i] the i-th
  // sub-tile's first V row in shared memory.
  template <int NT>
  __device__ __forceinline__ void update(const float (&x)[2 * NT][4], float sl2,
                                         const bf16* const (&vt)[NT], int lane) {
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int t = 0; t < 2 * NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[t][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float p[2 * NT][4];
#pragma unroll
    for (int t = 0; t < 2 * NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[t][e] = ex2(fmaf(x[t][e], sl2, -m[e >> 1]));
        rs[e >> 1] += p[t][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {   // a row's max moved
#pragma unroll
      for (int t = 0; t < kD / 8; ++t) {
        acc[t][0] *= alpha[0];
        acc[t][1] *= alpha[0];
        acc[t][2] *= alpha[1];
        acc[t][3] *= alpha[1];
      }
    }
    const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]),
                             pack_bf16(p[2 * i][2], p[2 * i][3]),
                             pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                             pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt[i] + key * kLd + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b);
        mma_bf16(acc[2 * dp + 1], a, b + 2);
      }
    }
  }

  // the lane's two rows at (head * n + row) ``at`` (rows past n skipped)
  __device__ __forceinline__ void finish(bf16* o, float* lse, const size_t (&at)[2],
                                         const bool (&live)[2], int lane) {
    const int tq = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
      if (!live[r]) continue;
#pragma unroll
      for (int t = 0; t < kD / 8; ++t)
        store_bf16x2(o + at[r] * kD + t * 8 + 2 * tq, acc[t][2 * r] / l[r],
                     acc[t][2 * r + 1] / l[r]);
      if (tq == 0) lse[at[r]] = m[r] * 0.6931471805599453f + logf(l[r]);
    }
  }
};

// The number of union blocks before block B: B's position in the sorted
// union when B is in it.
__device__ __forceinline__ int union_rank(const uint32_t* bitmap, const int* words_before,
                                          int B) {
  return words_before[B >> 5] + __popc(bitmap[B >> 5] & ((1u << (B & 31)) - 1u));
}

template <int G>
__global__ void __launch_bounds__(Tile<G>::kThreads, 2)
    prefill_fwd_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ rk,
                       const bf16* __restrict__ v, const int* __restrict__ sel_idx,
                       const uint8_t* __restrict__ sel_mask, bf16* __restrict__ fo,
                       bf16* __restrict__ so, float* __restrict__ flse,
                       float* __restrict__ slse, int num_tiles, int n, int S, int sel_block,
                       int window, int align, int max_union, int max_words, float scale) {
  constexpr int R = Tile<G>::kRows, T = Tile<G>::kThreads;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Stage& st = *reinterpret_cast<Stage*>(smem_raw);
  unsigned long long* members = reinterpret_cast<unsigned long long*>(smem_raw + sizeof(Stage));
  int* blocks = reinterpret_cast<int*>(members + max_union);
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(blocks + max_union);
  int* words_before = reinterpret_cast<int*>(bitmap + max_words);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x / num_tiles;                  // a KV head's tiles adjacent
  const int r0 = (num_tiles - 1 - (int)(blockIdx.x % num_tiles)) * R;   // heavy tiles first
  const int rows = min(R, n - r0), last = r0 + rows - 1;
  const int nw = last / sel_block / 32 + 1;
  const int* idx = sel_idx + ((size_t)bh * n + r0) * S;
  const uint8_t* msk = sel_mask + ((size_t)bh * n + r0) * S;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&st.full[s], 64);                  // a loading warp's 32 lanes, twice
      mbar_init(&st.empty[s], Tile<G>::kWarps);    // each warp once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // 1. the union of the tile's blocks, as a bitmap: each row's own block and
  // its valid selections before it (later blocks hold no key <= the row)
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
  // 4. row t of the tile as bit t of each block it uses, once however often
  // it was selected
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

  // the key sequence, in chunks of 64 keys: first the contiguous band
  // [kb0, last], then the keys of the union blocks wholly before kb0,
  // gathered block by block
  const int kb0 = max(0, r0 - window) / align * align;
  const int union_keys = union_rank(bitmap, words_before, kb0 / sel_block) * sel_block;
  const int band_chunks = (last + 1 - kb0 + kChunk - 1) / kChunk;
  const int n_chunks = band_chunks + (union_keys + kChunk - 1) / kChunk;
  const bf16* kbase = rk + (size_t)bh * n * kD;
  const bf16* vbase = v + (size_t)bh * n * kD;

  // One warp loads chunk c into stage c % kStages: each key's position and
  // fine mask (two keys a lane), then its key and value rows (cp.async),
  // zeros where there is no key (their weights are zero, and zero times
  // zero stays finite).  Every lane arrives on the stage's "full" barrier
  // twice: for its stores, and once its copies have landed.
  auto load_chunk = [&](int c) {
    const int buf = c % kStages;
    for (int kc = lane; kc < kChunk; kc += 32) {
      int pos = kNoKey;
      unsigned long long mk = 0ull;
      if (c < band_chunks) {
        const int key = kb0 + c * kChunk + kc;
        if (key <= last) {
          pos = key;
          const int B = key / sel_block;
          if ((bitmap[B >> 5] >> (B & 31)) & 1u)
            mk = members[union_rank(bitmap, words_before, B)];
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
  };

  // the warp: query rows wr0 .. wr0 + kWarpRows - 1 (bits wbit .. of the
  // masks) of all G heads; the lane's mma rows grp and grp + 8
  constexpr int RW = Tile<G>::kWarpRows;
  constexpr uint32_t kRowBits = RW == 16 ? 0xFFFFu : (1u << RW) - 1u;
  const int grp = lane >> 2, tq = lane & 3;
  const int wbit = warp * RW, wr0 = r0 + wbit;
  const int rows_l[2] = {wr0 + grp % RW, wr0 + (grp + 8) % RW};
  const int sh_l[2] = {grp % RW, (grp + 8) % RW};          // the rows' bits past wbit
  const size_t at[2] = {((size_t)bh * G + grp / RW) * n + rows_l[0],
                        ((size_t)bh * G + (grp + 8) / RW) * n + rows_l[1]};
  const bool live[2] = {rows_l[0] < n, rows_l[1] < n};
  uint32_t qf[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = s * 16 + 2 * tq + (r >> 1) * 8;
      qf[s][r] = live[r & 1] ? *reinterpret_cast<const uint32_t*>(rq + at[r & 1] * kD + col) : 0u;
    }
  const float sl2 = scale * kLog2e;
  Online fine, slide;
  fine.init();
  slide.init();

  // The warps go through the chunks each at its own pace; warp c % kWarps
  // loads chunk c, kStages - 1 chunks ahead of its own place, once every
  // warp is done with the chunk that held the stage before.
  constexpr int W = Tile<G>::kWarps;
  for (int c = warp; c < min(kStages - 1, n_chunks); c += W) load_chunk(c);
  auto enter = [&](int c) {
    const int ahead = c + kStages - 1;
    if (ahead < n_chunks && ahead % W == warp) {
      if (ahead >= kStages) mbar_wait(&st.empty[ahead % kStages], ((ahead / kStages) - 1) & 1);
      load_chunk(ahead);
    }
    mbar_wait(&st.full[c % kStages], (c / kStages) & 1);
  };
  auto leave = [&](int c) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&st.empty[c % kStages]);   // this warp is done with the stage
  };
  // does a row of the warp use a key of sub-tile s4 (fine)?
  auto fine_rows = [&](int buf, int s4) {
    const uint32_t mine =
        lane < 16 ? (uint32_t)(st.mask[buf][s4 * 16 + lane] >> wbit) & kRowBits : 0u;
    return __reduce_or_sync(kFull, mine) != 0u;
  };
  // S = Q . K^T for the warp's 16 rows and sub-tile s4's 16 keys, with each
  // lane's four keys' positions and fine-mask bits
  auto logits = [&](int buf, int s4, float (&sc)[2][4], int (&kp)[2][2], uint32_t (&km)[2][2]) {
    const bf16* kt = st.k[buf] + s4 * 16 * kLd;
#pragma unroll
    for (int t = 0; t < 2; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int ds = 0; ds < kD / 16; ++ds) {
      uint32_t b[4];
      const int key = (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, kt + key * kLd + ds * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], qf[ds], b);
      mma_bf16(sc[1], qf[ds], b + 2);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int kc = s4 * 16 + t * 8 + 2 * tq + c2;
        kp[t][c2] = st.pos[buf][kc];
        km[t][c2] = (uint32_t)(st.mask[buf][kc] >> wbit);
      }
  };
  // the lane's logits of one sub-tile under the fine set (or the band);
  // with G >= 2 the lane's two mma rows are one query row of two heads
  auto masked = [&](bool band, const float (&sc)[2][4], const int (&kp)[2][2],
                    const uint32_t (&km)[2][2], float (*x)[4]) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        bool ok[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = kp[t][c2], row = rows_l[h];
          ok[h] = (G >= 2 && h == 1) ? ok[0]
                  : band ? (unsigned)(row - pos) <= (unsigned)window
                         : pos <= row && ((km[t][c2] >> sh_l[h]) & 1u);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) x[t][c2 + 2 * h] = ok[h] ? sc[t][c2 + 2 * h] : kNeg;
      }
  };

  // the band: both branches from one S per sub-tile, for the sub-tiles a
  // row of the warp uses (fine) or is near (sliding); then the sliding
  // output is done and its registers are free
  for (int c = 0; c < band_chunks; ++c) {
    enter(c);
    const int buf = c % kStages;
#pragma unroll 1
    for (int s4 = 0; s4 < kSub; ++s4) {
      const int k0 = kb0 + c * kChunk + s4 * 16;
      if (k0 > last) break;
      const bool f = fine_rows(buf, s4);
      const bool sl = k0 <= wr0 + RW - 1 && k0 + 15 >= wr0 - window && wr0 < n;
      if (!f && !sl) continue;   // uniform over the warp
      float sc[2][4], x[2][4];
      int kp[2][2];
      uint32_t km[2][2];
      logits(buf, s4, sc, kp, km);
      const bf16* const vt[1] = {st.v[buf] + s4 * 16 * kLd};
      if (f) {
        masked(false, sc, kp, km, x);
        fine.update<1>(x, sl2, vt, lane);
      }
      if (sl) {
        masked(true, sc, kp, km, x);
        slide.update<1>(x, sl2, vt, lane);
      }
    }
    leave(c);
  }
  slide.finish(so, slse, at, live, lane);

  // the union blocks: the fine branch alone, for the sub-tiles a row of the
  // warp uses, two of them to one softmax update
  auto group = [&](auto size, int buf, uint32_t& todo) {
    constexpr int K = decltype(size)::value;
    float x[2 * K][4];
    const bf16* vt[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s4 = __ffs(todo) - 1;
      todo &= todo - 1;
      float sc[2][4];
      int kp[2][2];
      uint32_t km[2][2];
      logits(buf, s4, sc, kp, km);
      masked(false, sc, kp, km, x + 2 * i);
      vt[i] = st.v[buf] + s4 * 16 * kLd;
    }
    fine.update<K>(x, sl2, vt, lane);
  };
  for (int c = band_chunks; c < n_chunks; ++c) {
    enter(c);
    const int buf = c % kStages;
    const int u0 = (c - band_chunks) * kChunk;
    uint32_t todo = 0u;
#pragma unroll
    for (int s4 = 0; s4 < kSub; ++s4)
      if (u0 + s4 * 16 < union_keys && fine_rows(buf, s4))
        todo |= 1u << s4;
    while (todo) {                       // uniform over the warp
      if (todo & (todo - 1))
        group(std::integral_constant<int, 2>(), buf, todo);
      else
        group(std::integral_constant<int, 1>(), buf, todo);
    }
    leave(c);
  }
  fine.finish(fo, flse, at, live, lane);
}

int lcm16(int x) {
  int a = 16, b = x;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return 16 / a * x;
}

template <int G>
cudaError_t launch(const void* rq, const void* rk, const void* v, const void* sel_idx,
                   const void* sel_mask, void* fo, void* so, void* flse, void* slse, int bkvh,
                   int n, int S, int sel_block, int window, float scale, cudaStream_t stream) {
  constexpr int R = Tile<G>::kRows;
  const int num_tiles = (n + R - 1) / R;
  const long long grid = (long long)num_tiles * bkvh;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffffLL || sel_block <= 0 || window < 0) return cudaErrorInvalidValue;
  const int max_union = R * (S + 1);                     // each row: S blocks + its own
  const int max_words = ((n - 1) / sel_block) / 32 + 1;
  const size_t smem = sizeof(Stage) + (size_t)max_union * (8 + 4) + (size_t)max_words * 8;
  static size_t sized = 48 << 10;
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_fwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    sized = smem;
  }
  prefill_fwd_kernel<G><<<(unsigned)grid, Tile<G>::kThreads, smem, stream>>>(
      (const bf16*)rq, (const bf16*)rk, (const bf16*)v, (const int*)sel_idx,
      (const uint8_t*)sel_mask, (bf16*)fo, (bf16*)so, (float*)flse, (float*)slse, num_tiles, n,
      S, sel_block, window, lcm16(sel_block), max_union, max_words, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// rq [b, kvh*G, n, 64] bf16 (rotated, heads of one KV head adjacent); rk, v
// [b, kvh, n, 64] bf16; sel_idx [b, kvh, n, S] int32; sel_mask [b, kvh, n, S]
// bool -> fo, so [b, kvh*G, n, 64] bf16; flse, slse [b, kvh*G, n] float32.
extern "C" int nsa_prefill_fwd(const void* rq, const void* rk, const void* v,
                               const void* sel_idx, const void* sel_mask, void* fo, void* so,
                               void* flse, void* slse, int b, int kvh, int G, int n, int S,
                               int sel_block, int window, float scale, void* stream) {
  if (S > nsa::kMaxSel) return (int)cudaErrorInvalidValue;
  const int bkvh = b * kvh;
  const cudaStream_t s = (cudaStream_t)stream;
#define NSA_PREFILL(GG)                                                                       \
  return (int)nsa::launch<GG>(rq, rk, v, sel_idx, sel_mask, fo, so, flse, slse, bkvh, n, S, \
                              sel_block, window, scale, s)
  switch (G) {
    case 1: NSA_PREFILL(1);
    case 2: NSA_PREFILL(2);
    case 4: NSA_PREFILL(4);
    case 8: NSA_PREFILL(8);
  }
#undef NSA_PREFILL
  return (int)cudaErrorInvalidValue;
}

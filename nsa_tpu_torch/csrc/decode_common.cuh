// Device code shared by the decode kernels of nsa_decode.cu (the split
// route: decode_select, decode_attend), nsa_decode_fused.cu and
// nsa_decode_ragged.cu (the fused and ragged select-emit, the one-launch
// attend) and nsa_decode_mega.cu (the whole-model decode step): the body of
// one thread block's compressed attention + selection, and of its fine +
// sliding attention with the gate combine.  Each body works on one (batch
// row, KV head) pair, `bh`, inside a block of 256 threads (kBodyWarps
// warps), out of the dynamic shared memory it is handed.  Pointers to
// buffers that the whole-model kernel writes during its own launch carry no
// __restrict__, so the compiler never reads them through the non-coherent
// read-only path.
//
// Both bodies are flash-decoding's split softmax inside one block: each
// warp streams its own rows through shared memory with 16-byte cp.async
// copies, waits only for its own copies (cp.async.wait_group, __syncwarp),
// keeps a running max, sum and weighted v sum per query head in registers
// (softmax_fold: shuffles, no block barrier), and one merge across the
// warps in shared memory ends the body.  Sums are taken in a fixed order:
// a launch's bits depend on nothing but its inputs.
#pragma once

#include "common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;             // dim_head; each lane owns two dims
constexpr float kScoreEps = 1e-10f;
constexpr int kPad = 8;                 // bf16 padding of a staged row
constexpr int kFullRow = 2 * kD + kPad; // staged packed-row stride (272 B)
constexpr int kBodyWarps = 8;           // the bodies run in blocks of 256 threads
constexpr int kChunkRows = 16;          // rows of a selection chunk, columns of an attention tile
constexpr int kSelDepth = 2;            // ring slots a warp: one chunk in flight while one is used
constexpr int kPipe = 8;                // loads kept in flight by norm_rows (decode_tc_common.cuh)

// q.k of one row of kD values: bf16 as dot_heads takes it (the same float32
// order), or float32 (the whole-model kernel's mem slots).
__device__ __forceinline__ float dot_row(const float* q, const bf16* k) {
  float s;
  dot_heads<1, kD>(q, k, &s);
  return s;
}

__device__ __forceinline__ float dot_row(const float* q, const float* k) {
  float s = 0.f;
#pragma unroll 16
  for (int e = 0; e < kD; ++e) s += q[e] * k[e];
  return s;
}

__device__ __forceinline__ float2 load2(const bf16* p) { return load_bf16x2(p); }
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Folds one chunk of R = kChunkRows rows into a warp's running softmax over
// G heads.  Pair 32 k + lane of the chunk is (row p % R, head p / R); s[k] is its
// scaled logit, or -inf where the row is out.  m[g] is the running max
// (kNeg before any row), l[g] the running sum, acc[g] the weighted sums of
// v over dims 2 lane and 2 lane + 1; every lane keeps all three.  `live`
// has bit r set for the rows whose v is read (vrow(r): the lane's two
// dims); a row outside it must have p = 0.  Shuffles only.
template <int G, typename VRow>
__device__ __forceinline__ void softmax_fold(float (&m)[G], float (&l)[G], float (&acc)[G][2],
                                             const float (&s)[(kChunkRows * G + 31) / 32],
                                             unsigned live, VRow vrow) {
  constexpr int R = kChunkRows, NP = (R * G + 31) / 32;
  const int lane = threadIdx.x & 31;
  float red[NP], p[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    red[k] = s[k];
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1) red[k] = fmaxf(red[k], __shfl_xor_sync(kFull, red[k], o));
  }
  float mn[G], alpha[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mn[g] = fmaxf(m[g], __shfl_sync(kFull, red[g * R / 32], (g * R) % 32));
    alpha[g] = expf(m[g] - mn[g]);
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int own = (32 * k + lane) / R;       // the lane's head in pair k (>= G: none)
    float mo = kNeg;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g == own) mo = mn[g];
    p[k] = expf(s[k] - mo);                     // 0 where s is -inf
    red[k] = p[k];
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1) red[k] += __shfl_xor_sync(kFull, red[k], o);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = l[g] * alpha[g] + __shfl_sync(kFull, red[g * R / 32], (g * R) % 32);
    acc[g][0] *= alpha[g];
    acc[g][1] *= alpha[g];
    m[g] = mn[g];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!((live >> r) & 1u)) continue;          // the same for every lane
    const float2 v = vrow(r);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pr = __shfl_sync(kFull, p[(g * R + r) / 32], (g * R + r) % 32);
      acc[g][0] += pr * v.x;
      acc[g][1] += pr * v.y;
    }
  }
}

// Orders floats as unsigned ints (for the warp's max reduction).
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int G, typename MemT>
size_t select_smem_bytes(int Wc, int M, int Wf) {
  return sizeof(bf16) * kBodyWarps * kSelDepth * kChunkRows * kFullRow +
         sizeof(MemT) * 2 * M * kD + sizeof(float) * (G * kD + G * Wc + Wf);
}

// Compressed attention of the G unrotated queries of `bh` over
// ckv[:num_cb] plus the M mem slots; then grouped importance, stride ->
// selection-block regroup, diagonal mask, pad(-1e3)-softmax-strip and a
// top-k by one warp (ties to the lowest index).  Writes c_out and the
// packed info row: [0, S) selected ids, [S, S + n_slide) trailing ids,
// [S + n_slide, 2S + n_slide) validity, the rest zero.  Reads no ckv row at
// or above num_cb.  mem_kv is bf16 (the split and fused routes) or float32
// (the whole-model kernel, as JAX's megakernel keeps it).
//
// The live rows, as chunks of kChunkRows whole packed rows (k || v, 256 B),
// are dealt to the warps in turn (chunk c to warp c % kBodyWarps); each
// warp streams its chunks through its own ring of kSelDepth slots, kSelDepth
// - 1 chunks in flight while it computes one, and reads every live row once.
// A chunk's logits are one lane per (row, head), dot_heads's float32
// order, kept in shared memory; softmax_fold folds them and the chunk's v
// halves into the warp's running c_out, and the warp pools the importance
// of the fine blocks the chunk holds (the same order as one thread per
// block).  Warp 0 takes the mem slots first, staged with its first chunk.
// After one barrier warp 0 takes the score softmax and the top-k (each lane
// keeps the best of its own blocks; a warp max picks the next id, and only
// the lane that gave it looks again), while the other warps merge the
// warps' running sums into c_out.  Dynamic shared memory:
// select_smem_bytes<G, MemT>.
template <int G, typename MemT>
__device__ void select_body(const bf16* q, const bf16* ckv, const MemT* __restrict__ mem_kv,
                            bf16* c_out, int* info, int kvh, int Wc, int M, int t, int num_cb,
                            int stride, int sel_block, int num_sel, int n_slide,
                            int max_blocks, int info_width, float scale, int bh,
                            unsigned char* smem_raw) {
  static_assert(kSelDepth >= 2, "a ring of one slot has nothing in flight");
  static_assert(sizeof(float) * (G * kD + 2 * G + 1) <=
                    sizeof(bf16) * kSelDepth * kChunkRows * kFullRow,
                "a warp's running sums fit in its ring");
  constexpr int NP = (kChunkRows * G + 31) / 32;
  constexpr int kSlot = kChunkRows * kFullRow;
  const int npf = sel_block / stride;
  const int Wf = Wc / npf;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [warps][kSelDepth][kChunkRows][kFullRow]
  MemT* mem = reinterpret_cast<MemT*>(ring + kBodyWarps * kSelDepth * kSlot);  // [2][M][kD]
  float* qs = reinterpret_cast<float*>(mem + 2 * M * kD);  // [G][kD]
  float* sim = qs + G * kD;                                 // [G][Wc] logits
  float* fsc = sim + G * Wc;                                // [Wf] fine-block scores

  const int h = bh % kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* rows = ckv + (size_t)bh * Wc * 2 * kD;
  const int n_live = min(num_cb, Wc);
  const int nchunks = (n_live + kChunkRows - 1) / kChunkRows;
  const int mine = nchunks > warp ? (nchunks - warp + kBodyWarps - 1) / kBodyWarps : 0;
  bf16* my_ring = ring + warp * kSelDepth * kSlot;
  // warp w's running sums after the stream, in its ring: [G][kD] weighted
  // v, [G] max, [G] sum of p, the largest importance it pooled
  auto state = [&](int w) { return reinterpret_cast<float*>(ring + w * kSelDepth * kSlot); };
  const int diag = t / sel_block;
  // the fine blocks the chunks pool as they stream (a chunk holds whole
  // blocks); warp 0 pools the rest after them
  const int pooled_early = kChunkRows % npf == 0 ? min(nchunks * kChunkRows / npf, Wf) : 0;

  // importance of fine block f: mean over the group (mem slots excluded),
  // pooled over its npf compressed blocks, own block masked; the lane keeps
  // the largest it has pooled
  float pmax = kNeg;
  auto pool = [&](int f) {
    float pooled = 0.f;
    for (int i = 0; i < npf; ++i) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) s += sim[g * Wc + f * npf + i];
      pooled += (s / G) * (1.f / npf);
    }
    fsc[f] = (npf > 1 && f == diag) ? kNeg : pooled;
    pmax = fmaxf(pmax, fsc[f]);
  };

  // the warp's i-th chunk into slot i % kSelDepth, one copy group (empty past the end)
  auto fetch = [&](int i) {
    if (i < mine) {
      const int r0 = (warp + kBodyWarps * i) * kChunkRows;
      bf16* dst = my_ring + (i % kSelDepth) * kSlot;
      for (int j = lane; j < kChunkRows * 16; j += 32) {    // 16 16-byte pieces a row
        const int r = j >> 4, piece = j & 15;
        if (r0 + r < n_live)
          cp_async16(dst + r * kFullRow + 8 * piece, rows + (size_t)(r0 + r) * 2 * kD + 8 * piece);
      }
    }
    cp_async_commit();
  };

  // phase: prologue
  // the queries' loads go out before the copies queue behind them
  float qv[(G * kD + 255) / 256];
#pragma unroll
  for (int k = 0; k < (G * kD + 255) / 256; ++k) {
    const int i = tid + 256 * k;
    qv[k] = i < G * kD ? __bfloat162float(q[(size_t)bh * G * kD + i]) : 0.f;
  }
  if (warp == 0) {             // the mem slots' k and v rows, with the first chunk
    constexpr int kVec = 16 / sizeof(MemT);
    for (int j = lane; j < 2 * M * kD / kVec; j += 32) {
      const int half = j / (M * kD / kVec), i = j % (M * kD / kVec);
      cp_async16(mem + half * M * kD + i * kVec,
                 mem_kv + (size_t)(half * kvh + h) * M * kD + i * kVec);
    }
  }
  for (int i = 0; i < kSelDepth - 1; ++i) fetch(i);
#pragma unroll
  for (int k = 0; k < (G * kD + 255) / 256; ++k)
    if (tid + 256 * k < G * kD) qs[tid + 256 * k] = qv[k];
  for (int j = n_live + tid; j < Wc; j += blockDim.x)
    for (int g = 0; g < G; ++g) sim[g * Wc + j] = kNeg;
  __syncthreads();

  // phase: stream
  float m[G], l[G], acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }
  if (warp == 0 && M > 0) {
    cp_async_wait<kSelDepth - 2>();              // the first group: chunk 0 and the mem rows
    __syncwarp();
    const MemT* memk = mem;
    const MemT* memv = mem + M * kD;
    for (int m0 = 0; m0 < M; m0 += kChunkRows) {
      float s[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int p = 32 * k + lane, r = p % kChunkRows, g = p / kChunkRows;
        s[k] = -INFINITY;
        if (g < G && m0 + r < M) s[k] = dot_row(qs + g * kD, memk + (m0 + r) * kD) * scale;
      }
      const int n = min(M - m0, kChunkRows);
      softmax_fold<G>(m, l, acc, s, (1u << n) - 1, [&](int r) {
        return load2(memv + (m0 + r) * kD + 2 * lane);
      });
    }
  }
  for (int i = 0; i < mine; ++i) {
    __syncwarp();                                // every lane is done with the slot refilled
    fetch(i + kSelDepth - 1);
    cp_async_wait<kSelDepth - 1>();
    __syncwarp();
    const bf16* slot = my_ring + (i % kSelDepth) * kSlot;
    const int r0 = (warp + kBodyWarps * i) * kChunkRows;
    float s[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int p = 32 * k + lane, r = p % kChunkRows, g = p / kChunkRows;
      s[k] = -INFINITY;
      if (g < G && r0 + r < n_live) {
        s[k] = dot_row(qs + g * kD, slot + r * kFullRow) * scale;
        sim[g * Wc + r0 + r] = s[k];
      }
    }
    const int n = min(n_live - r0, kChunkRows);
    softmax_fold<G>(m, l, acc, s, (1u << n) - 1, [&](int r) {
      return load_bf16x2(slot + r * kFullRow + kD + 2 * lane);
    });
    __syncwarp();                                // the chunk's logits, from the other lanes
    if (lane < kChunkRows / npf && r0 / npf + lane < pooled_early) pool(r0 / npf + lane);
  }
  pmax = warp_max(pmax);
  {
    float* st = state(warp);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      st[g * kD + 2 * lane] = acc[g][0];
      st[g * kD + 2 * lane + 1] = acc[g][1];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        st[G * kD + g] = m[g];
        st[G * kD + G + g] = l[g];
      }
      st[G * kD + 2 * G] = pmax;
    }
  }

  // phase: epilogue
  __syncthreads();
  int* irow = info + (size_t)bh * info_width;
  const int n_slots = num_sel + n_slide;
  if (warp == 0) {
    // the blocks no chunk pooled; then pad(-1e3) -> softmax -> strip,
    // without materializing the pad slot.  Lane j owns blocks j, j + 32, ...
    for (int f = pooled_early + lane; f < Wf; f += 32) pool(f);
    pmax = warp_max(pmax);
    float mx = pmax;
    for (int w = 1; w < kBodyWarps; ++w)
      mx = fmaxf(mx, state(w)[G * kD + 2 * G]);
    mx = fmaxf(mx, -1e3f);
    // one pass: the weights, their sum, and each lane's best and next-best
    // block by weight (ties to the lower id; the weights order the blocks as
    // the normalized scores do)
    float den = 0.f, best = -INFINITY, next = -INFINITY;
    int bidx = 0x7fffffff, nidx = 0x7fffffff;
#pragma unroll 4
    for (int f = lane; f < Wf; f += 32) {
      const float v = expf(fsc[f] - mx);
      fsc[f] = v;
      den += v;
      if (v > best) {
        next = best;
        nidx = bidx;
        best = v;
        bidx = f;
      } else if (v > next) {
        next = v;
        nidx = f;
      }
    }
    den = warp_sum(den) + expf(-1e3f - mx);
    // top-k: the largest lane best, the lowest id among equal ones; the lane
    // that gave it moves on to its next-best, and looks again only when it
    // has none
    for (int s = 0; s < num_sel; ++s) {
      const unsigned key = ordered(best);
      const unsigned top = __reduce_max_sync(kFull, key);
      const int id = (int)__reduce_min_sync(kFull, key == top ? (unsigned)bidx : 0xffffffffu);
      const float val = __shfl_sync(kFull, best, id & 31);
      if (lane == 0) {
        irow[s] = id;
        irow[n_slots + s] = val / den > kScoreEps ? 1 : 0;
      }
      if (bidx == id) {
        fsc[id] = kNeg;
        best = next;
        bidx = nidx;
        next = -INFINITY;
        nidx = 0x7fffffff;
        if (bidx == 0x7fffffff) {
#pragma unroll 4
          for (int f = lane; f < Wf; f += 32)
            if (fsc[f] > best) {
              best = fsc[f];
              bidx = f;
            }
        }
      }
    }
    // trailing window blocks, ascending; the last one is the diagonal block
    for (int j = lane; j < n_slide; j += 32)
      irow[num_sel + j] = min(max(diag - (n_slide - 1 - j), 0), max_blocks - 1);
    for (int c = n_slots + num_sel + lane; c < info_width; c += 32) irow[c] = 0;
  } else {
    // c_out: the warps' running sums merged in warp order
    constexpr int outs = G * kD;
    for (int o = tid - 32; o < outs; o += blockDim.x - 32) {
      const int g = o / kD;
      float mx = kNeg;
      for (int w = 0; w < kBodyWarps; ++w)
        mx = fmaxf(mx, state(w)[G * kD + g]);
      float den = 0.f, num = 0.f;
      for (int w = 0; w < kBodyWarps; ++w) {
        const float* st = state(w);
        const float f = expf(st[G * kD + g] - mx);
        den += st[G * kD + G + g] * f;
        num += st[o] * f;
      }
      c_out[(size_t)bh * outs + o] = __float2bfloat16(num / den);
    }
  }
}

// Where row r of item bh = (batch row, KV head) of the packed kv cache
// lives: a dense cache [b, kvh, max_len, 2kD], or a page pool [P, kvh,
// page, 2kD] under a page table [b, max_pages] (logical row r of batch
// row bi lives in page table[bi][r / page], at row r % page).
struct DenseRows {
  bf16* kv;
  int max_len;
  __device__ __forceinline__ bf16* row(int bh, int r) const {
    return kv + ((size_t)bh * max_len + r) * 2 * kD;
  }
};

struct PagedRows {
  bf16* pool;
  const int* table;
  int kvh, page, max_pages;
  __device__ __forceinline__ bf16* row(int bh, int r) const {
    const int pg = table[(size_t)(bh / kvh) * max_pages + r / page];
    return pool + (((size_t)pg * kvh + bh % kvh) * page + r % page) * 2 * kD;
  }
};

template <int G>
size_t attend_smem_bytes(int J) {
  const int ntiles = (J + kChunkRows - 1) / kChunkRows;
  return sizeof(bf16) * ntiles * kChunkRows * kFullRow + sizeof(float) * (2 * G * kD + 3 * G) +
         sizeof(int) * 2 * J;
}

// Fine and sliding attention of the G rotated queries of `bh` over the S
// selected + n_slide trailing blocks, read straight from the kv cache
// (`kv`: DenseRows or PagedRows) through the info row's block ids; two
// masked softmaxes sharing one q.K, and the gate combine g_c * c_out + g_f *
// fine + g_s * sliding.  Row t is staged from `row_t` instead of the cache
// when `row_t` is not null (the fused route writes that row in the same
// launch).  Returns the combined float32 output [G][kD] in shared memory,
// visible to the whole block.
//
// The queries, gates and c_out are read first, with each of the J = (S +
// n_slide) * sel_block columns' kv row and masks (one thread a column, the
// info row read once); then the columns, as tiles of kChunkRows, are dealt
// to the warps in turn, and a warp copies the rows of its own tiles that
// either mask keeps (whole packed rows) and waits only for its own copies.
// Per tile, one lane per (column, head) takes the logit, and softmax_fold
// folds it into the warp's running fine and sliding sums (skipped where the
// tile has no column of that mask); one merge across the warps (in the
// warps' first tiles) ends it.  Dynamic shared memory: attend_smem_bytes<G>.
template <int G, typename Rows>
__device__ float* attend_body(const bf16* rq, const Rows kv, const int* info, const bf16* c_out,
                              const bf16* gates, const bf16* row_t, int t, int sel_block,
                              int window, int num_sel, int n_slide, int info_width, float scale,
                              int bh, unsigned char* smem_raw) {
  constexpr int outs = G * kD;
  constexpr int NP = (kChunkRows * G + 31) / 32;
  static_assert(sizeof(float) * (2 * G * kD + 4 * G) <= sizeof(bf16) * kChunkRows * kFullRow,
                "a warp's running sums fit in its first tile");
  const int n_slots = num_sel + n_slide;
  const int J = n_slots * sel_block;
  const int ntiles = (J + kChunkRows - 1) / kChunkRows;
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);                 // [ntiles * 16][kFullRow]
  float* qs = reinterpret_cast<float*>(tile + ntiles * kChunkRows * kFullRow);  // [G][kD]
  float* cg = qs + outs;            // [G][kD] c_out, then [G][3] gates
  int* colrow = reinterpret_cast<int*>(cg + outs + 3 * G);        // [J] kv row of each column
  int* colok = colrow + J;          // [J] bit 0 fine, bit 1 sliding

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // phase: prologue
  const int* irow = info + (size_t)bh * info_width;
  const int last_blk = t / sel_block;
  for (int col = tid; col < J; col += blockDim.x) {
    const int slot = col / sel_block, within = col % sel_block;
    int row, ok;
    if (slot < num_sel) {
      row = irow[slot] * sel_block + within;
      ok = irow[n_slots + slot] != 0 ? 1 : 0;
    } else {
      const int blk = last_blk - (n_slide - 1) + (slot - num_sel);
      row = blk * sel_block + within;
      const bool fine = blk >= 0 && slot == n_slots - 1 && row <= t;
      const bool slide = blk >= 0 && row >= t - window && row <= t;
      ok = (fine ? 1 : 0) | (slide ? 2 : 0);
    }
    colrow[col] = row;
    colok[col] = ok;
  }
  for (int i = tid; i < outs; i += blockDim.x) {
    qs[i] = __bfloat162float(rq[(size_t)bh * outs + i]);
    cg[i] = __bfloat162float(c_out[(size_t)bh * outs + i]);
  }
  if (tid < 3 * G) cg[outs + tid] = __bfloat162float(gates[(size_t)bh * 3 * G + tid]);
  __syncthreads();
  // copy the kept rows of this warp's tiles
  for (int tl = warp; tl < ntiles; tl += kBodyWarps)
    for (int j = lane; j < kChunkRows * 16; j += 32) {    // 16 16-byte pieces a row
      const int col = tl * kChunkRows + (j >> 4), piece = j & 15;
      if (col >= J || !colok[col]) continue;
      const int row = colrow[col];
      const bf16* src = (row_t != nullptr && row == t) ? row_t : kv.row(bh, row);
      cp_async16(tile + col * kFullRow + 8 * piece, src + 8 * piece);
    }

  // phase: tiles
  float mf[G], lf[G], af[G][2], ms[G], ls[G], as[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mf[g] = ms[g] = kNeg;
    lf[g] = ls[g] = 0.f;
    af[g][0] = af[g][1] = as[g][0] = as[g][1] = 0.f;
  }
  cp_async_wait_all();
  __syncwarp();
  for (int tl = warp; tl < ntiles; tl += kBodyWarps) {
    float sf[NP], ss[NP];
    unsigned kept = 0;
    bool any_f = false, any_s = false;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int p = 32 * k + lane, r = p % kChunkRows, g = p / kChunkRows;
      const int col = tl * kChunkRows + r;
      int ok = 0;
      sf[k] = ss[k] = -INFINITY;
      if (g < G && col < J) {
        ok = colok[col];
        if (ok) {
          const float s = dot_row(qs + g * kD, tile + col * kFullRow) * scale;
          if (ok & 1) sf[k] = s;
          if (ok & 2) ss[k] = s;
        }
      }
      any_f |= (ok & 1) != 0;
      any_s |= (ok & 2) != 0;
      if (k == 0) kept = __ballot_sync(kFull, ok != 0) & 0xffffu;   // lanes 0-15: head 0
    }
    const bf16* base = tile + tl * kChunkRows * kFullRow + kD + 2 * lane;
    auto vrow = [&](int r) { return load_bf16x2(base + r * kFullRow); };
    if (__any_sync(kFull, any_f)) softmax_fold<G>(mf, lf, af, sf, kept, vrow);
    if (__any_sync(kFull, any_s)) softmax_fold<G>(ms, ls, as, ss, kept, vrow);
  }
  __syncwarp();
  if (warp < ntiles) {         // the warp's running sums, into its first tile
    float* st = reinterpret_cast<float*>(tile + warp * kChunkRows * kFullRow);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      st[g * kD + 2 * lane] = af[g][0];
      st[g * kD + 2 * lane + 1] = af[g][1];
      st[outs + g * kD + 2 * lane] = as[g][0];
      st[outs + g * kD + 2 * lane + 1] = as[g][1];
    }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        st[2 * outs + g] = mf[g];
        st[2 * outs + G + g] = lf[g];
        st[2 * outs + 2 * G + g] = ms[g];
        st[2 * outs + 3 * G + g] = ls[g];
      }
  }

  // phase: combine
  __syncthreads();
  const int nw = min(ntiles, kBodyWarps);
  for (int o = tid; o < outs; o += blockDim.x) {
    const int g = o / kD;
    float mxf = kNeg, mxs = kNeg;
    for (int w = 0; w < nw; ++w) {
      const float* st = reinterpret_cast<const float*>(tile + w * kChunkRows * kFullRow);
      mxf = fmaxf(mxf, st[2 * outs + g]);
      mxs = fmaxf(mxs, st[2 * outs + 2 * G + g]);
    }
    float lf_ = 0.f, af_ = 0.f, ls_ = 0.f, as_ = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* st = reinterpret_cast<const float*>(tile + w * kChunkRows * kFullRow);
      const float a = expf(st[2 * outs + g] - mxf), b = expf(st[2 * outs + 2 * G + g] - mxs);
      lf_ += st[2 * outs + G + g] * a;
      af_ += st[o] * a;
      ls_ += st[2 * outs + 3 * G + g] * b;
      as_ += st[outs + o] * b;
    }
    const float* gt = cg + outs + 3 * g;
    qs[o] = gt[0] * cg[o] + gt[1] * (af_ * (1.f / fmaxf(lf_, 1e-30f))) +
            gt[2] * (as_ * (1.f / fmaxf(ls_, 1e-30f)));
  }
  __syncthreads();
  return qs;
}

}  // namespace
}  // namespace nsa

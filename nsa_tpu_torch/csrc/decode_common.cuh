// Device code shared by the decode kernels of nsa_decode.cu (the split
// route: decode_select, decode_attend), nsa_decode_fused.cu and
// nsa_decode_ragged.cu (the fused and ragged select-emit, the one-launch
// attend) and nsa_decode_mega.cu (the whole-model decode step): the body of
// one thread block's compressed attention + selection, and of its fine +
// sliding attention with the gate combine.  Each body works on one (batch
// row, KV head) pair, `bh`, inside a block of any size that is a multiple
// of 32, out of the dynamic shared memory it is handed.  Pointers to
// buffers that the whole-model kernel writes during its own launch carry no
// __restrict__, so the compiler never reads them through the non-coherent
// read-only path.
#pragma once

#include "common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;             // dim_head; each lane owns two dims
constexpr float kScoreEps = 1e-10f;
constexpr int kPad = 8;                 // bf16 padding of a staged row
constexpr int kHalfRow = kD + kPad;     // staged half-row stride (144 B)
constexpr int kFullRow = 2 * kD + kPad; // staged packed-row stride (272 B)
constexpr int kSelTile = 512;           // rows staged per select tile

// Stage one half (0: k, 1: v) of rows [0, nr) of a packed [rows][2*kD] block.
__device__ __forceinline__ void stage_half(bf16* tile, const bf16* rows, int nr, int half) {
  constexpr int kVec = kD / 8;          // 16-byte vectors per half-row
  for (int i = threadIdx.x; i < nr * kVec; i += blockDim.x) {
    const int r = i / kVec, c = i % kVec;
    cp_async16(tile + r * kHalfRow + 8 * c, rows + (size_t)r * 2 * kD + half * kD + 8 * c);
  }
  cp_async_wait_all();
  __syncthreads();
}

template <int G>
size_t select_smem_bytes(int Wc, int M, int Wf, int threads) {
  const int outs = G * kD, parts = threads / outs > 1 ? threads / outs : 1;
  return sizeof(bf16) * kSelTile * kHalfRow +
         sizeof(float) * (G * Wc + G * M + Wf + G * kD + parts * outs + 32);
}

// Compressed attention of the G unrotated queries of `bh` over
// ckv[:num_cb] plus the M mem slots; then grouped importance, stride ->
// selection-block regroup, diagonal mask, pad(-1e3)-softmax-strip and an
// iterative top-k by one warp (ties to the lowest index).  Writes c_out and
// the packed info row: [0, S) selected ids, [S, S + n_slide) trailing ids,
// [S + n_slide, 2S + n_slide) validity, the rest zero.  Reads no ckv row at
// or above num_cb.  mem_kv is bf16 (the split and fused routes) or float32
// (the whole-model kernel, as JAX's megakernel keeps it).  The c_out sum
// keeps kPipe loads in flight (then a tail of one at a time), adding its
// terms in row order.
constexpr int kPipe = 8;

template <int G, typename MemT>
__device__ void select_body(const bf16* q, const bf16* ckv, const MemT* __restrict__ mem_kv,
                            bf16* c_out, int* info, int kvh, int Wc, int M, int t, int num_cb,
                            int stride, int sel_block, int num_sel, int n_slide,
                            int max_blocks, int info_width, float scale, int bh,
                            unsigned char* smem_raw) {
  const int npf = sel_block / stride;
  const int Wf = Wc / npf;
  constexpr int outs = G * kD;
  const int parts = max(1, (int)blockDim.x / outs);
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);                  // [kSelTile][kHalfRow]
  float* sim = reinterpret_cast<float*>(tile + kSelTile * kHalfRow);  // [G][Wc]
  float* simm = sim + G * Wc;      // [G][M] mem-slot logits, then probabilities
  float* fsc = simm + G * M;       // [Wf] fine-block scores
  float* qs = fsc + Wf;            // [G][kD] queries
  float* cacc = qs + G * kD;       // [parts][G*kD] partial c_out sums
  float* scratch = cacc + parts * outs;  // [32]

  const int h = bh % kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* rows = ckv + (size_t)bh * Wc * 2 * kD;
  const MemT* memk = mem_kv + (size_t)h * M * kD;
  const MemT* memv = mem_kv + (size_t)(kvh + h) * M * kD;
  const int n_live = min(num_cb, Wc);

  for (int i = tid; i < G * kD; i += blockDim.x)
    qs[i] = __bfloat162float(q[(size_t)bh * G * kD + i]);
  for (int i = tid; i < parts * outs; i += blockDim.x) cacc[i] = 0.f;
  for (int j = n_live + tid; j < Wc; j += blockDim.x)
    for (int g = 0; g < G; ++g) sim[g * Wc + j] = kNeg;
  __syncthreads();

  // logits of the live rows, tile by tile; then of the mem slots
  for (int r0 = 0; r0 < n_live; r0 += kSelTile) {
    const int nr = min(kSelTile, n_live - r0);
    stage_half(tile, rows + (size_t)r0 * 2 * kD, nr, 0);
    for (int r = tid; r < nr; r += blockDim.x) {
      float s[G];
      dot_heads<G, kD>(qs, tile + r * kHalfRow, s);
#pragma unroll
      for (int g = 0; g < G; ++g) sim[g * Wc + r0 + r] = s[g] * scale;
    }
    __syncthreads();               // the next tile overwrites this one
  }
  for (int o = tid; o < G * M; o += blockDim.x) {
    const int g = o / M, m = o % M;
    float s = 0.f;
    for (int e = 0; e < kD; ++e) s += qs[g * kD + e] * ldf(memk[m * kD + e]);
    simm[o] = s * scale;
  }
  __syncthreads();

  // importance: mean over the group (mem slots excluded), pooled over the
  // npf compressed blocks of each fine block, own block masked
  const int diag = t / sel_block;
  for (int f = tid; f < Wf; f += blockDim.x) {
    float pooled = 0.f;
    for (int i = 0; i < npf; ++i) {
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += sim[g * Wc + f * npf + i];
      pooled += (s / G) * (1.f / npf);
    }
    fsc[f] = (npf > 1 && f == diag) ? kNeg : pooled;
  }
  __syncthreads();

  // pad(-1e3) -> softmax -> strip, without materializing the pad slot
  float mx = kNeg;
  for (int f = tid; f < Wf; f += blockDim.x) mx = fmaxf(mx, fsc[f]);
  mx = fmaxf(block_reduce<true>(mx, scratch), -1e3f);
  float den = 0.f;
  for (int f = tid; f < Wf; f += blockDim.x) {
    const float p = expf(fsc[f] - mx);
    fsc[f] = p;
    den += p;
  }
  den = block_reduce<false>(den, scratch) + expf(-1e3f - mx);
  for (int f = tid; f < Wf; f += blockDim.x) fsc[f] /= den;

  // compressed softmax over the live rows and the mem slots
  float inv_den[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float m = kNeg;
    for (int j = tid; j < n_live; j += blockDim.x) m = fmaxf(m, sim[g * Wc + j]);
    for (int j = tid; j < M; j += blockDim.x) m = fmaxf(m, simm[g * M + j]);
    m = block_reduce<true>(m, scratch);
    float l = 0.f;
    for (int j = tid; j < n_live; j += blockDim.x) {
      const float p = expf(sim[g * Wc + j] - m);
      sim[g * Wc + j] = p;
      l += p;
    }
    for (int j = tid; j < M; j += blockDim.x) {
      const float p = expf(simm[g * M + j] - m);
      simm[g * M + j] = p;
      l += p;
    }
    inv_den[g] = 1.f / block_reduce<false>(l, scratch);
  }
  __syncthreads();

  // c_out = sum_j p_j v_j / den over the v halves, tile by tile; thread
  // (part, g, e) sums rows part, part + parts, ...
  for (int r0 = 0; r0 < n_live; r0 += kSelTile) {
    const int nr = min(kSelTile, n_live - r0);
    stage_half(tile, rows + (size_t)r0 * 2 * kD, nr, 1);
    for (int o = tid; o < parts * outs; o += blockDim.x) {
      const int part = o / outs, g = (o % outs) / kD, e = o % kD;
      const float* p = sim + g * Wc + r0;
      float acc = 0.f;
      int r = part;
      for (; r + (kPipe - 1) * parts < nr; r += kPipe * parts) {
        float pv[kPipe], tv[kPipe];
#pragma unroll
        for (int u = 0; u < kPipe; ++u) {
          pv[u] = p[r + u * parts];
          tv[u] = __bfloat162float(tile[(r + u * parts) * kHalfRow + e]);
        }
#pragma unroll
        for (int u = 0; u < kPipe; ++u) acc += pv[u] * tv[u];
      }
      for (; r < nr; r += parts) acc += p[r] * __bfloat162float(tile[r * kHalfRow + e]);
      cacc[o] += acc;
    }
    __syncthreads();
  }
  for (int o = tid; o < outs; o += blockDim.x) {
    const int g = o / kD, e = o % kD;
    float acc = 0.f;
    for (int part = 0; part < parts; ++part) acc += cacc[part * outs + o];
    for (int m = 0; m < M; ++m) acc += simm[g * M + m] * ldf(memv[m * kD + e]);
    c_out[(size_t)bh * outs + o] = __float2bfloat16(acc * inv_den[g]);
  }

  // iterative top-k by warp 0: num_sel passes of (max, lowest index)
  int* irow = info + (size_t)bh * info_width;
  const int n_slots = num_sel + n_slide;
  if (warp == 0) {
    for (int s = 0; s < num_sel; ++s) {
      float best = -INFINITY;
      int bidx = 0x7fffffff;
      for (int f = lane; f < Wf; f += 32)
        if (fsc[f] > best) { best = fsc[f]; bidx = f; }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int oi = __shfl_xor_sync(kFull, bidx, o);
        if (ob > best || (ob == best && oi < bidx)) { best = ob; bidx = oi; }
      }
      if (lane == 0) {
        irow[s] = bidx;
        irow[n_slots + s] = best > kScoreEps ? 1 : 0;
        fsc[bidx] = kNeg;
      }
      __syncwarp();
    }
    // trailing window blocks, ascending; the last one is the diagonal block
    for (int j = lane; j < n_slide; j += 32)
      irow[num_sel + j] = min(max(diag - (n_slide - 1 - j), 0), max_blocks - 1);
    for (int c = n_slots + num_sel + lane; c < info_width; c += 32) irow[c] = 0;
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
size_t attend_smem_bytes(int J, int threads) {
  const int outs = G * kD, parts = threads / outs > 1 ? threads / outs : 1;
  return sizeof(bf16) * J * kFullRow + sizeof(float) * (2 * G * J + G * kD + 2 * parts * outs + 32) +
         sizeof(int) * 2 * J;
}

// Fine and sliding attention of the G rotated queries of `bh` over the S
// selected + n_slide trailing blocks, read straight from the kv cache
// (`kv`: DenseRows or PagedRows) through the info row's block ids; two
// masked softmaxes sharing one q.K, and the gate combine g_c * c_out + g_f *
// fine + g_s * sliding.  Row t is staged from `row_t` instead of the cache
// when `row_t` is not null (the fused route writes that row in the same
// launch).  Returns the combined float32 output [G][kD] in shared memory,
// visible to the whole block.  The P.V sums keep kPipe columns' loads in
// flight (then a tail of one at a time), adding the kept columns' terms in
// column order.
template <int G, typename Rows>
__device__ float* attend_body(const bf16* rq, const Rows kv, const int* info, const bf16* c_out,
                              const bf16* gates, const bf16* row_t, int t, int sel_block,
                              int window, int num_sel, int n_slide, int info_width, float scale,
                              int bh, unsigned char* smem_raw) {
  const int n_slots = num_sel + n_slide;
  const int J = n_slots * sel_block;
  constexpr int outs = G * kD;
  const int parts = max(1, (int)blockDim.x / outs);
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);                 // [J][kFullRow]
  float* sf = reinterpret_cast<float*>(tile + J * kFullRow);     // [G][J] fine
  float* ss = sf + G * J;           // [G][J] sliding
  float* qs = ss + G * J;           // [G][kD] queries, then the combined output
  float* pf = qs + G * kD;          // [parts][outs] partial fine sums
  float* ps = pf + parts * outs;    // [parts][outs] partial sliding sums
  float* scratch = ps + parts * outs;                           // [32]
  int* okm = reinterpret_cast<int*>(scratch + 32);  // [J] bit 0 fine, bit 1 sliding
  int* rowid = okm + J;             // [J] kv row of each column

  const int tid = threadIdx.x;
  const int* irow = info + (size_t)bh * info_width;
  const int last_blk = t / sel_block;

  for (int i = tid; i < G * kD; i += blockDim.x)
    qs[i] = __bfloat162float(rq[(size_t)bh * G * kD + i]);
  for (int col = tid; col < J; col += blockDim.x) {
    const int slot = col / sel_block, within = col % sel_block;
    const bool sel_ok = slot < num_sel && irow[n_slots + slot] != 0;
    const int trail_blk = last_blk - (n_slide - 1) + (slot - num_sel);
    const int jg = trail_blk * sel_block + within;
    const bool trail_ok = slot >= num_sel && trail_blk >= 0;
    const bool fine = sel_ok || (trail_ok && slot == n_slots - 1 && jg <= t);
    const bool slide = trail_ok && jg >= t - window && jg <= t;
    okm[col] = (fine ? 1 : 0) | (slide ? 2 : 0);
    rowid[col] = irow[slot] * sel_block + within;
  }
  __syncthreads();

  // stage the rows either mask keeps (k and v), all in flight at once
  constexpr int kVec = 2 * kD / 8;
  for (int i = tid; i < J * kVec; i += blockDim.x) {
    const int col = i / kVec, c = i % kVec;
    if (!okm[col]) continue;
    const bf16* src = (row_t != nullptr && rowid[col] == t) ? row_t : kv.row(bh, rowid[col]);
    cp_async16(tile + col * kFullRow + 8 * c, src + 8 * c);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int col = tid; col < J; col += blockDim.x) {
    const int ok = okm[col];
    float s[G] = {};
    if (ok) dot_heads<G, kD>(qs, tile + col * kFullRow, s);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sf[g * J + col] = (ok & 1) ? s[g] * scale : kNeg;
      ss[g * J + col] = (ok & 2) ? s[g] * scale : kNeg;
    }
  }
  __syncthreads();

  float inv_f[G], inv_s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mf = kNeg, ms = kNeg;
    for (int c = tid; c < J; c += blockDim.x) {
      mf = fmaxf(mf, sf[g * J + c]);
      ms = fmaxf(ms, ss[g * J + c]);
    }
    mf = block_reduce<true>(mf, scratch);
    ms = block_reduce<true>(ms, scratch);
    float lf = 0.f, ls = 0.f;
    for (int c = tid; c < J; c += blockDim.x) {
      const int ok = okm[c];
      const float a = (ok & 1) ? expf(sf[g * J + c] - mf) : 0.f;
      const float b = (ok & 2) ? expf(ss[g * J + c] - ms) : 0.f;
      sf[g * J + c] = a;
      ss[g * J + c] = b;
      lf += a;
      ls += b;
    }
    inv_f[g] = 1.f / fmaxf(block_reduce<false>(lf, scratch), 1e-30f);
    inv_s[g] = 1.f / fmaxf(block_reduce<false>(ls, scratch), 1e-30f);
  }
  __syncthreads();

  for (int o = tid; o < parts * outs; o += blockDim.x) {
    const int part = o / outs, g = (o % outs) / kD, e = o % kD;
    float af = 0.f, as = 0.f;
    int c = part;
    for (; c + (kPipe - 1) * parts < J; c += kPipe * parts) {
      int ok[kPipe];
      float v[kPipe], pf_[kPipe], ps_[kPipe];
#pragma unroll
      for (int u = 0; u < kPipe; ++u) {
        const int cc = c + u * parts;
        ok[u] = okm[cc];
        v[u] = ok[u] ? __bfloat162float(tile[cc * kFullRow + kD + e]) : 0.f;
        pf_[u] = sf[g * J + cc];
        ps_[u] = ss[g * J + cc];
      }
#pragma unroll
      for (int u = 0; u < kPipe; ++u)
        if (ok[u]) {
          af += pf_[u] * v[u];
          as += ps_[u] * v[u];
        }
    }
    for (; c < J; c += parts) {
      if (okm[c] == 0) continue;     // unstaged row: never read
      const float v = __bfloat162float(tile[c * kFullRow + kD + e]);
      af += sf[g * J + c] * v;
      as += ss[g * J + c] * v;
    }
    pf[o] = af;
    ps[o] = as;
  }
  __syncthreads();
  float* comb = qs;
  for (int o = tid; o < outs; o += blockDim.x) {
    const int g = o / kD;
    float af = 0.f, as = 0.f;
    for (int part = 0; part < parts; ++part) {
      af += pf[part * outs + o];
      as += ps[part * outs + o];
    }
    const size_t gi = ((size_t)bh * G + g) * 3;
    const float gc = __bfloat162float(gates[gi]);
    const float gf = __bfloat162float(gates[gi + 1]);
    const float gs = __bfloat162float(gates[gi + 2]);
    const float c = __bfloat162float(c_out[(size_t)bh * outs + o]);
    comb[o] = gc * c + gf * (af * inv_f[g]) + gs * (as * inv_s[g]);
  }
  __syncthreads();
  return comb;
}

}  // namespace
}  // namespace nsa

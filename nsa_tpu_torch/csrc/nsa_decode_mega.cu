// The whole-model decode step for Hopper (sm_90a): one persistent
// cooperative kernel decodes `steps` tokens of every layer of the model.
//
// Replaces the TPU kernel of nsa_tpu/ops/pallas/nsa_megakernel.py:
//   decode_step_mega / _decode_step_mega_jit (:978, :1020; pallas_call
//   :1234), whose two bodies _mega_kernel (:88) and _mega_kernel_hb (:574)
//   are TPU schedules of the same math; one kernel here covers both.
//
// What bounds it on this card: bytes.  A step at the reference model (6
// layers, dim 512, 8/4 heads, dim_head 64) and b <= 16 reads every layer's
// weights once (34.8 MB in bf16), on the 1 step in `stride` that emits the
// compressors' weights (17.8 MB a layer), the live compressed cache rows
// (~25 MB at bs 8 and num_cb 499) and the gathered kv rows (~7 MB): a few
// FLOPs per byte, far below the H100's ~295 bf16 FLOP/byte ridge.  In
// practice it is bound by latency: 31 phases a step, each needing every
// row of the one before.
//
// Design: one cooperative launch of one block per SM; phases separated by
// cooperative_groups grid syncs, which every block reaches (they sit in the
// kernel's own loops over steps and layers, never inside a branch or a
// work-item loop).  The batch (b <= 16) is one 16-row tile, and every
// product runs on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// sums; decode_tc_common.cuh): the activations' rows are staged in shared
// memory and each block multiplies them by its own 8-column tiles of the
// weight (tile i of a product on block (off + i) % grid, so every weight
// byte is read once a step).  Each block's tiles of the layer's four
// products live in its own slice of shared memory, loaded by TMA; as soon
// as the block has used a product's tiles for layer l it issues the loads of
// its tiles for layer l + 1 (or the next step's layer 0), so they arrive
// during the rest of the layer and the grid syncs.  The LM head's tiles are
// loaded once.  Per layer:
//   1. RMSNorm of the 16 rows (layer 0: the embedding rows of this step's
//      tokens) and the fused q|k|v|gate product, rounded into `proj`.
//   2. Per (row, KV head): the queries, rotary of q and k at t in float32
//      (rounded), the gates' sigmoid in float32 (rounded), the new token's
//      unrotated and rotated k || v rows; compressed attention and selection
//      (select_body, which reads no ckv row at or above num_cb); the kv row
//      t written and the fine + sliding attention with row t staged from the
//      new token (attend_body), rounded into `comb`.  On emission steps,
//      on the blocks after those, per (KV head, half, 64 compressor hidden
//      columns): the emission's partial products over the OLD ring plus the
//      new token on the tensor cores (emit_tc_body, shared with the engine's
//      ragged select-emit).
//   3. y = x + comb . w_out (the heads' shares in head order, as the
//      engine's attend kernel does), rounded; on the last blocks, per (row,
//      KV head): the emitted row (partials in chunk order + b2) into
//      ckv[min(num_cb, Wc - 1)] on emission steps, and the ring shift
//      (after phase 2's readers of the old ring: no race).
//   4. RMSNorm of y and the FF's first product, + b1, exact erf GELU.
//   5. The FF's second product, + b2, + y, into the residual stream.
// After the last layer: the final RMSNorm and the LM head, rounded to bf16
// into float32 logits.  The next step's blocks each take the argmax of
// those logits (ties to the lowest index) as its token; block 0 writes it
// out.  5 syncs a layer and one a token.  Sums run in a fixed order with no
// atomics (each warp its own k-steps, the warps in order), so a launch of
// `steps` tokens gives the same bits as that many launches of one.
// Scratch buffers written during the launch are read with coherent loads
// only (no __restrict__ on their pointers; cp.async.cg reads through L2).
// A grid that cannot be co-resident, or a slice and work space that do not
// fit in shared memory, is an error and never runs.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_tc_common.cuh"

namespace cg = cooperative_groups;

namespace nsa {
namespace {

constexpr int kMaxDepth = 16;
constexpr int kMaxBatch = kRowTile;  // the batch is one row tile
constexpr int kProducts = 5;
constexpr int kQkvg = 0, kWout = 1, kFw1 = 2, kFw2 = 3, kHead = 4;
constexpr int kStaticSmem = 256;     // the kernel's static shared memory, at most
using MegaPlan = TilePlan<kProducts>;

// The rows of a TMA box of a product's weight tiles: the largest of 256,
// 128, 64 that divides its depth K (fewer, larger copies a refill).
__host__ __device__ __forceinline__ int tile_box_rows(int K) {
  return K % 256 == 0 ? 256 : K % 128 == 0 ? 128 : kBoxRows;
}

struct MegaArgs {
  bf16* kv[kMaxDepth];            // per layer [b, kvh, max_len, 2kD]
  bf16* ckv[kMaxDepth];           // per layer [b, kvh, Wc, 2kD]
  bf16* ring[kMaxDepth];          // per layer [b, kvh, Bc, 2kD]
  // weights; per-layer ones stacked [L, ...] (pack_mega_params)
  const bf16* emb;                // [vocab, dim]
  const bf16* to_logits;          // [dim, vocab]
  const bf16* out_norm;           // [dim]
  const bf16* attn_norm;          // [L, dim]
  const bf16* w_qkvg;             // [L, dim, P]
  const bf16* gate_b;             // [L, 3h]
  const float* mem_kv;            // [L, 2, kvh, M, kD]
  const bf16* pos_kv;             // [L, kvh, Bc, 2kD]
  const bf16* b1k;                // [L, kvh, hid]
  const bf16* b1v;
  const bf16* b2c;                // [L, kvh, 2kD]
  const bf16* w1k;                // [L, kvh, Bc*kD, hid]
  const bf16* w1v;
  const bf16* w2c;                // [L, kvh, hid, 2kD]
  const bf16* w_out;              // [L, h*kD, dim]
  const bf16* ff_norm;            // [L, dim]
  const bf16* fw1;                // [L, dim, hid4]
  const bf16* fb1;                // [L, hid4]
  const bf16* fw2;                // [L, hid4, dim]
  const bf16* fb2;                // [L, dim]
  const float* inv_freq;          // [kD / 2] rotary inverse frequencies
  const int* tok_in;              // [b]
  const int* t0;                  // the first step's position, one int on the device
  float* logits;                  // [b, vocab]
  int* tok_out;                   // [b, steps] (greedy)
  // scratch
  bf16* proj;                     // [b, P]
  // (q, rq, gates, c_out, info and comb keep every layer's, [L, ...], so
  // that a check can hold each layer's selection and attention to their
  // plain versions on the kernel's own inputs)
  bf16* q;                        // [L, b, kvh, G, kD] unrotated
  bf16* rq;                       // [L, b, kvh, G, kD] rotated
  bf16* gates;                    // [L, b, kvh, G, 3]
  bf16* kvn_unrot;                // [b, kvh, 2kD] the new token's k || v
  bf16* kvn_rot;                  // [b, kvh, 2kD] its rotated k || v
  bf16* c_out;                    // [L, b, kvh, G, kD]
  int* info;                      // [L, b, kvh, info_width]
  float* partial;                 // [kvh, hid / kEmitCols, b, 2kD]
  bf16* comb;                     // [L, b, kvh * G * kD] the rounded attention output
  bf16* x;                        // [b, dim] the residual stream
  bf16* y;                        // [b, dim] x + attention
  bf16* hbuf;                     // [b, hid4]
  // optional: the global timer in ns when block 0 starts and after each
  // grid sync, 1 + steps * (5 * depth + 1) values (where the time goes)
  unsigned long long* phase_ns;
  int depth, b, kvh, max_len, Wc, Bc, M, hid, dim, vocab, hid4, steps, greedy, stride,
      sel_block, num_sel, n_slide, window, info_width;
  float scale, eps;
  MegaPlan plan;
};

// Block 0 records the global timer into a.phase_ns[k++], when asked to.
__device__ __forceinline__ void mark(const MegaArgs& a, int& k) {
  if (a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.phase_ns[k] = ns;
  }
  ++k;
}

// The argmax of each row of logits [b, vocab] (ties to the lowest index)
// into toks; also into tok_out[row * steps + col] when tok_out is not null.
// One warp per row.  Ends with a barrier.
__device__ void argmax_rows(const float* logits, int b, int vocab, int* toks, int* tok_out,
                            int steps, int col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < b; r += blockDim.x >> 5) {
    float best = -INFINITY;
    int bidx = 0x7fffffff;
    for (int v = lane; v < vocab; v += 32) {
      const float x = logits[(size_t)r * vocab + v];
      if (x > best) { best = x; bidx = v; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, bidx, o);
      if (ob > best || (ob == best && oi < bidx)) { best = ob; bidx = oi; }
    }
    if (lane == 0) {
      bidx = min(bidx, vocab - 1);          // all NaN: stay inside the vocabulary
      toks[r] = bidx;
      if (tok_out != nullptr) tok_out[(size_t)r * steps + col] = bidx;
    }
  }
  __syncthreads();
}

// Phase 2's staging for (row, KV head) bh: the queries, rotated queries,
// gates and the new token's rows, from the rounded projection; q, rq and
// the gates into layer l's slices.
template <int G>
__device__ __forceinline__ void stage_head(const MegaArgs& a, int l, int t, int bh) {
  const int h = a.kvh * G, din = h * kD, dkv = a.kvh * kD;
  const int P = din + 2 * dkv + 3 * h;
  const int bi = bh / a.kvh, hi = bh % a.kvh;
  const bf16* pr = a.proj + (size_t)bi * P;
  const size_t lbh = (size_t)l * a.b * a.kvh;      // layer l's (row, KV head) items
  const float tf = (float)t;
  // rotary of the interleaved pair (2j, 2j+1) by t * inv_freq[j], float32
  // products and sums as the plain version takes them, rounded
  auto rotate = [&](const bf16* pair, int e) {
    const float x0 = __bfloat162float(pair[0]), x1 = __bfloat162float(pair[1]);
    const float ang = __fmul_rn(tf, a.inv_freq[e >> 1]);
    const float c = cosf(ang), s = sinf(ang);
    return __float2bfloat16((e & 1) ? __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c))
                                    : __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
  };
  for (int i = threadIdx.x; i < G * kD; i += blockDim.x) {
    const int col = hi * G * kD + i, e = i % kD;
    a.q[(lbh + bh) * G * kD + i] = pr[col];
    a.rq[(lbh + bh) * G * kD + i] = rotate(pr + col - (e & 1), e);
  }
  for (int i = threadIdx.x; i < 3 * G; i += blockDim.x) {
    const int c = hi * 3 * G + i;
    const float z = __fadd_rn(__bfloat162float(pr[din + 2 * dkv + c]),
                              __bfloat162float(a.gate_b[(size_t)l * 3 * h + c]));
    a.gates[(lbh + bh) * 3 * G + i] = __float2bfloat16(1.f / (1.f + expf(-z)));
  }
  for (int e = threadIdx.x; e < 2 * kD; e += blockDim.x) {
    const int src = e < kD ? din + hi * kD + e : din + dkv + hi * kD + e - kD;
    a.kvn_unrot[(size_t)bh * 2 * kD + e] = pr[src];
    a.kvn_rot[(size_t)bh * 2 * kD + e] = e < kD ? rotate(pr + src - (e & 1), e) : pr[src];
  }
  __syncthreads();
}

// The embedding rows of this step's tokens into As [16][K + 8] (rows past b
// zero); ends with a barrier.
__device__ void stage_embed(bf16* As, const bf16* emb, const int* toks, int b, int K) {
  const int vec = K / 8, lda = K + 8;
  for (int i = threadIdx.x; i < kRowTile * vec; i += blockDim.x) {
    const int m = i / vec, c = i % vec;
    bf16* dst = As + m * lda + 8 * c;
    if (m < b)
      cp_async16(dst, emb + (size_t)toks[m] * K + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The tiles of each product, which block holds them, and the shared memory
// a block takes, at one block per SM (grid = the SM count).
template <int G>
MegaPlan make_mega_plan(const MegaArgs& a, int grid) {
  const int h = a.kvh * G, P = h * kD + 2 * a.kvh * kD + 3 * h;
  MegaPlan p = {};
  p.grid = grid;
  const int rows[kProducts] = {a.dim, h * kD, a.dim, a.hid4, a.dim};
  const int tiles[kProducts] = {P / kTileCols, a.dim / kTileCols, a.hid4 / kTileCols,
                                a.dim / kTileCols, a.vocab / kTileCols};
  // placed in turn, each after the one before: ff w2 (the largest tiles),
  // w_out, the LM head, q|k|v|gate, ff w1
  const int order[kProducts] = {kFw2, kWout, kHead, kQkvg, kFw1};
  for (int i = 0, next = 0; i < kProducts; ++i) {
    const int q = order[i];
    p.rows[q] = rows[q];
    p.tiles[q] = tiles[q];
    p.off[q] = next % grid;
    next += tiles[q];
  }
  plan_slices(p);
  const int Wf = a.Wc / (a.sel_block / a.stride);
  const int J = (a.num_sel + a.n_slide) * a.sel_block;
  const int kmax = std::max(std::max(a.dim, h * kD), a.hid4);
  const size_t stage = (size_t)kRowTile * (kmax + 8) * sizeof(bf16) +
                       sizeof(float) * kWarps * std::max(a.kvh, 1) * 128;
  size_t work = std::max(select_smem_bytes<G, float>(a.Wc, a.M, Wf),
                         attend_smem_bytes<G>(J));
  work = std::max(work, emit_tc_smem_bytes(a.Bc * kD));
  work = std::max(work, (size_t)a.Bc * 2 * kD * sizeof(bf16));
  work = std::max(work, stage);
  p.work_bytes = (int)((work + 15) / 16 * 16);
  p.smem_bytes = kEmitAlign + (p.slice_bytes + kEmitAlign - 1) / kEmitAlign * kEmitAlign +
                 p.work_bytes;
  return p;
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
    mega_kernel(const MegaArgs a, const __grid_constant__ CUtensorMap m_qkvg,
                const __grid_constant__ CUtensorMap m_wout,
                const __grid_constant__ CUtensorMap m_fw1,
                const __grid_constant__ CUtensorMap m_fw2,
                const __grid_constant__ CUtensorMap m_head,
                const __grid_constant__ CUtensorMap m_w1k,
                const __grid_constant__ CUtensorMap m_w1v,
                const __grid_constant__ CUtensorMap m_w2c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int toks[kMaxBatch];
  __shared__ __align__(8) uint64_t pbar[kProducts];
  __shared__ __align__(8) uint64_t ebar[kEmitBars];
  cg::grid_group grid = cg::this_grid();
  const MegaPlan& p = a.plan;
  unsigned char* base =
      smem_raw + ((kEmitAlign - (smem_u32(smem_raw) & (kEmitAlign - 1))) & (kEmitAlign - 1));
  bf16* wsm = reinterpret_cast<bf16*>(base);
  unsigned char* work = base + (p.slice_bytes + kEmitAlign - 1) / kEmitAlign * kEmitAlign;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = blockIdx.x;
  const CUtensorMap* maps[kProducts] = {&m_qkvg, &m_wout, &m_fw1, &m_fw2, &m_head};
  int count[kProducts], first[kProducts], at[kProducts];   // at: the product's tiles, in bf16
  plan_slice(p, g, first, count, at);
  uint32_t uses[kProducts] = {};   // loads of each product this block has waited for
  const int h = a.kvh * G, din = h * kD, dkv = a.kvh * kD;
  const int P = din + 2 * dkv + 3 * h;
  const int nsel = a.b * a.kvh;
  const int nchunks = a.hid / kEmitCols, nemit = a.kvh * 2 * nchunks;
  const int e0 = nsel < (int)gridDim.x ? nsel : 0;   // the first block of the emission
  const int max_blocks = a.max_len / a.sel_block;
  const int o = tid, m = o >> 3, n = o & 7;   // threads 0..127: one element of a 16 x 8 tile
  const bool row_ok = o < 128 && m < a.b;
  const int t0 = *a.t0;            // nothing writes it during the launch
  int mk = 0;
  mark(a, mk);

  // this block's tiles of product q at layer l (the LM head: 0) into its
  // slice, by warp 0
  auto load = [&](int q, int l) {
    if (warp != 0 || count[q] == 0) return;
    fence_proxy_async();
    if (lane == 0) mbar_expect_tx(&pbar[q], (uint32_t)plan_bytes(p, q, g));
    __syncwarp();
    const int br = tile_box_rows(p.rows[q]), boxes = p.rows[q] / br;
    for (int j = lane; j < count[q] * boxes; j += 32) {
      const int tile = j / boxes, box = j % boxes;
      tma_load_2d(wsm + at[q] + (tile * p.rows[q] + box * br) * kTileCols, maps[q], &pbar[q],
                  (first[q] + tile * p.grid) * kTileCols, l * p.rows[q] + box * br);
    }
  };
  // after the block's last reader of product q at (step s, layer l): the
  // tiles of its next use
  auto refill = [&](int q, int s, int l) {
    __syncthreads();
    int nl = l + 1, ns = s;
    if (nl == a.depth) {
      nl = 0;
      ++ns;
    }
    if (ns < a.steps) load(q, nl);
  };
  auto wait_tiles = [&](int q) {
    mbar_wait(&pbar[q], uses[q] & 1);
    ++uses[q];
  };

  if (tid == 0)
    for (int q = 0; q < kProducts; ++q) mbar_init(&pbar[q], 1);
  emit_ring_init(ebar);
  __syncthreads();
  for (int q = 0; q < kProducts; ++q) load(q, 0);
  EmitRing er{ebar, 0u, 0u};

  for (int s = 0; s < a.steps; ++s) {
    const int t = t0 + s;
    const int num_cb = t / a.stride;
    const bool emit = (t + 1) % a.stride == 0;
    const int slot = min(num_cb, a.Wc - 1);
    // this step's tokens: the input, then the previous step's argmax
    if (s == 0) {
      for (int r = tid; r < a.b; r += blockDim.x) toks[r] = a.tok_in[r];
      __syncthreads();
    } else {
      argmax_rows(a.logits, a.b, a.vocab, toks, g == 0 ? a.tok_out : nullptr, a.steps, s - 1);
    }

    for (int l = 0; l < a.depth; ++l) {
      // ---- 1. RMSNorm + the fused q|k|v|gate projection ------------------
      {
        const int K = a.dim, lda = K + 8;
        bf16* As = reinterpret_cast<bf16*>(work);
        float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
        if (l == 0 && g == 0)          // the embedding rows start the residual stream
          for (int i = tid; i < a.b * a.dim; i += blockDim.x)
            a.x[i] = a.emb[(size_t)toks[i / a.dim] * a.dim + i % a.dim];
        if (count[kQkvg]) {
          if (l == 0)
            stage_embed(As, a.emb, toks, a.b, K);
          else
            stage_rows(As, a.x, a.b, K, 0);
          norm_rows(As, K, a.attn_norm + (size_t)l * K, a.eps);
          wait_tiles(kQkvg);
          for (int j = 0; j < count[kQkvg]; ++j) {
            const float v = tile_dot(As, lda, wsm + at[kQkvg] + j * K * kTileCols, K, 1, 0.f, red);
            const int col = (first[kQkvg] + j * p.grid) * kTileCols + n;
            if (row_ok) a.proj[(size_t)m * P + col] = __float2bfloat16(v);
            __syncthreads();
          }
          refill(kQkvg, s, l);
        }
      }
      grid.sync();
      mark(a, mk);

      // ---- 2. selection + attention per (row, KV head); emission partials -
      // on the blocks after the selection's (all blocks if there are none)
      for (int item = g; item < nsel; item += gridDim.x) {
        stage_head<G>(a, l, t, item);
        const size_t lbh = (size_t)l * nsel;   // layer l's slices of q, rq, gates, c_out, info
        const bf16* q = a.q + lbh * G * kD;
        bf16* rq = a.rq + lbh * G * kD;
        bf16* c_out = a.c_out + lbh * G * kD;
        bf16* gates = a.gates + lbh * 3 * G;
        int* info = a.info + lbh * a.info_width;
        select_body<G, float>(
            q, a.ckv[l], a.mem_kv + (size_t)l * 2 * a.kvh * a.M * kD, c_out, info, a.kvh, a.Wc,
            a.M, t, num_cb, a.stride, a.sel_block, a.num_sel, a.n_slide, max_blocks,
            a.info_width, a.scale, item, work);
        __syncthreads();             // info and c_out, from other threads
        const DenseRows kv{a.kv[l], a.max_len};
        const bf16* row_t = a.kvn_rot + (size_t)item * 2 * kD;
        if (tid < 2 * kD / 8)        // the new token's row, written in place
          reinterpret_cast<uint4*>(kv.row(item, t))[tid] =
              reinterpret_cast<const uint4*>(row_t)[tid];
        const float* comb = attend_body<G>(
            rq, kv, info, c_out, gates, row_t, t, a.sel_block, a.window, a.num_sel, a.n_slide,
            a.info_width, a.scale, item, work);
        for (int i = tid; i < G * kD; i += blockDim.x)
          a.comb[(lbh + item) * G * kD + i] = __float2bfloat16(comb[i]);
        __syncthreads();             // comb is shared memory the next item reuses
      }
      if (emit && g >= e0)
        for (int e = g - e0; e < nemit; e += (int)gridDim.x - e0) {
          const size_t lk = (size_t)l * a.kvh;
          emit_tc_body(a.ring[l], a.proj + din, a.proj + din + dkv, P, kD,
                       a.pos_kv + lk * a.Bc * 2 * kD, a.b1k + lk * a.hid, a.b1v + lk * a.hid,
                       &m_w1k, &m_w1v, &m_w2c, (int)lk, a.partial, a.b, a.kvh, a.Bc, a.hid, t,
                       e, er, work);
        }
      grid.sync();
      mark(a, mk);

      // ---- 3. y = x + comb . w_out; the emitted row and the ring shift ----
      {
        const int K = din, lda = K + 8;
        bf16* As = reinterpret_cast<bf16*>(work);
        float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
        if (count[kWout]) {
          stage_rows(As, a.comb + (size_t)l * a.b * din, a.b, K, 0);
          wait_tiles(kWout);
          for (int j = 0; j < count[kWout]; ++j) {
            const int col = (first[kWout] + j * p.grid) * kTileCols + n;
            const float x = row_ok ? ldcg_bf16(a.x + (size_t)m * a.dim + col) : 0.f;
            const float y = tile_dot(As, lda, wsm + at[kWout] + j * K * kTileCols, K, a.kvh, x,
                                     red);
            if (row_ok) a.y[(size_t)m * a.dim + col] = __float2bfloat16(y);
            __syncthreads();
          }
          refill(kWout, s, l);
        }
        for (int bh = gridDim.x - 1 - g; bh < nsel; bh += gridDim.x) {   // the last blocks
          if (emit)
            emit_row_body(a.partial, a.b2c + (size_t)l * a.kvh * 2 * kD,
                          a.ckv[l] + ((size_t)bh * a.Wc + slot) * 2 * kD, nchunks, a.b,
                          bh / a.kvh, bh % a.kvh);
          ring_shift_body(a.ring[l] + (size_t)bh * a.Bc * 2 * kD,
                          a.kvn_unrot + (size_t)bh * 2 * kD, a.Bc, work);
        }
      }
      grid.sync();
      mark(a, mk);

      // ---- 4. RMSNorm + the FF's first product, GELU ----------------------
      {
        const int K = a.dim, lda = K + 8;
        bf16* As = reinterpret_cast<bf16*>(work);
        float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
        if (count[kFw1]) {
          stage_rows(As, a.y, a.b, K, 0);
          norm_rows(As, K, a.ff_norm + (size_t)l * K, a.eps);
          wait_tiles(kFw1);
          for (int j = 0; j < count[kFw1]; ++j) {
            const int col = (first[kFw1] + j * p.grid) * kTileCols + n;
            const float bias = row_ok ? ldf(a.fb1[(size_t)l * a.hid4 + col]) : 0.f;
            const float v = tile_dot(As, lda, wsm + at[kFw1] + j * K * kTileCols, K, 1, 0.f, red);
            if (row_ok) {
              const float hv = round_bf16(round_bf16(v) + round_bf16(bias));
              a.hbuf[(size_t)m * a.hid4 + col] =
                  __float2bfloat16(0.5f * hv * (1.f + erff(hv * 0.7071067811865476f)));
            }
            __syncthreads();
          }
          refill(kFw1, s, l);
        }
      }
      grid.sync();
      mark(a, mk);

      // ---- 5. the FF's second product into the residual stream -----------
      {
        const int K = a.hid4, lda = K + 8;
        bf16* As = reinterpret_cast<bf16*>(work);
        float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
        if (count[kFw2]) {
          stage_rows(As, a.hbuf, a.b, K, 0);
          wait_tiles(kFw2);
          for (int j = 0; j < count[kFw2]; ++j) {
            const int col = (first[kFw2] + j * p.grid) * kTileCols + n;
            const size_t i = (size_t)m * a.dim + col;
            const float bias = row_ok ? ldf(a.fb2[(size_t)l * a.dim + col]) : 0.f;
            const float y = row_ok ? ldcg_bf16(a.y + i) : 0.f;
            const float v = tile_dot(As, lda, wsm + at[kFw2] + j * K * kTileCols, K, 1, 0.f, red);
            if (row_ok) a.x[i] = __float2bfloat16(y + round_bf16(round_bf16(v) + round_bf16(bias)));
            __syncthreads();
          }
          refill(kFw2, s, l);
        }
      }
      grid.sync();
      mark(a, mk);
    }

    // ---- final RMSNorm + LM head (its tiles loaded once) --------------------
    {
      const int K = a.dim, lda = K + 8;
      bf16* As = reinterpret_cast<bf16*>(work);
      float* red = reinterpret_cast<float*>(work + (size_t)kRowTile * lda * sizeof(bf16));
      if (count[kHead]) {
        stage_rows(As, a.x, a.b, K, 0);
        norm_rows(As, K, a.out_norm, a.eps);
        if (s == 0) wait_tiles(kHead);
        for (int j = 0; j < count[kHead]; ++j) {
          const float v = tile_dot(As, lda, wsm + at[kHead] + j * K * kTileCols, K, 1, 0.f, red);
          const int col = (first[kHead] + j * p.grid) * kTileCols + n;
          if (row_ok) a.logits[(size_t)m * a.vocab + col] = round_bf16(v);
          __syncthreads();
        }
      }
    }
    grid.sync();
    mark(a, mk);
  }
  if (a.greedy && g == 0)
    argmax_rows(a.logits, a.b, a.vocab, toks, a.tok_out, a.steps, a.steps - 1);
}

// The plan at one block per SM, and how many such blocks fit on an SM (0:
// the shared memory a block needs exceeds what the card allows).  The
// kernel's shared-memory attribute and occupancy are set and read once per
// device and size.
template <int G>
cudaError_t mega_plan(const MegaArgs& a, MegaPlan* plan, int* per_sm, int* smem_optin) {
  static int cached[kMaxDevices][2] = {};       // shared-memory bytes, blocks an SM
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = device_limits(&sms, smem_optin)) != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  *plan = make_mega_plan<G>(a, sms);
  *per_sm = 0;
  if (plan->smem_bytes + kStaticSmem > *smem_optin) return cudaSuccess;
  if (cached[dev][0] != plan->smem_bytes) {
    auto kern = mega_kernel<G>;
    if ((e = set_smem((const void*)kern, plan->smem_bytes)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev][1], kern, kThreads,
                                                           plan->smem_bytes)) != cudaSuccess)
      return e;
    cached[dev][0] = plan->smem_bytes;
  }
  *per_sm = cached[dev][1];
  return cudaSuccess;
}

// One cooperative launch of the plan's grid; a grid that cannot be
// co-resident is an error, never run.
template <int G>
cudaError_t launch_mega(MegaArgs& a, cudaStream_t stream) {
  int per_sm = 0, optin = 0;
  cudaError_t e = mega_plan<G>(a, &a.plan, &per_sm, &optin);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int L = a.depth, h = a.kvh * G, P = h * kD + 2 * a.kvh * kD + 3 * h, K = a.Bc * kD;
  CUtensorMap maps[8] = {};
  if (!encode_tiles(&maps[0], a.w_qkvg, L * a.dim, P, kTileCols, tile_box_rows(a.dim)) ||
      !encode_tiles(&maps[1], a.w_out, L * h * kD, a.dim, kTileCols, tile_box_rows(h * kD)) ||
      !encode_tiles(&maps[2], a.fw1, L * a.dim, a.hid4, kTileCols, tile_box_rows(a.dim)) ||
      !encode_tiles(&maps[3], a.fw2, L * a.hid4, a.dim, kTileCols, tile_box_rows(a.hid4)) ||
      !encode_tiles(&maps[4], a.to_logits, a.dim, a.vocab, kTileCols, tile_box_rows(a.dim)) ||
      !encode_tiles(&maps[5], a.w1k, L * a.kvh * K, a.hid, kEmitCols) ||
      !encode_tiles(&maps[6], a.w1v, L * a.kvh * K, a.hid, kEmitCols) ||
      !encode_tiles(&maps[7], a.w2c, L * a.kvh * a.hid, 2 * kD, kEmitCols))
    return cudaErrorInvalidValue;
  void* args[] = {&a, &maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &maps[5], &maps[6],
                  &maps[7]};
  if ((e = cudaLaunchCooperativeKernel((const void*)mega_kernel<G>, dim3(a.plan.grid),
                                       dim3(kThreads), args, a.plan.smem_bytes, stream)) !=
      cudaSuccess)
    return e;
  return cudaGetLastError();
}

// The ints of the C entries (see below) into a, with G; false when they are
// out of range.
bool parse_ints(MegaArgs& a, int* G, const int* ints, int nints) {
  if (nints != 20) return false;
  int k = 0;
  a.depth = ints[k++];
  a.b = ints[k++];
  a.kvh = ints[k++];
  *G = ints[k++];
  a.max_len = ints[k++];
  a.Wc = ints[k++];
  a.Bc = ints[k++];
  a.M = ints[k++];
  a.hid = ints[k++];
  a.dim = ints[k++];
  a.vocab = ints[k++];
  a.hid4 = ints[k++];
  a.steps = ints[k++];
  a.greedy = ints[k++];
  a.stride = ints[k++];
  a.sel_block = ints[k++];
  a.num_sel = ints[k++];
  a.n_slide = ints[k++];
  a.window = ints[k++];
  a.info_width = ints[k++];
  return a.depth >= 1 && a.depth <= kMaxDepth && a.b >= 1 && a.b <= kMaxBatch && a.steps >= 1;
}

}  // namespace
}  // namespace nsa

// ptrs, in order: kv[0..L), ckv[0..L), ring[0..L); token_emb, to_logits,
// out_norm, attn_norm, w_qkvg, gate_b, mem_kv (float32), pos_kv, b1k, b1v,
// b2c, w1k, w1v, w2c, w_out, ff_norm, fw1, fb1, fw2, fb2 (bf16, shapes of
// pack_mega_params); inv_freq [64/2] f32; tok_in [b] int32; t0 one int32,
// the first step's position (read on the device: a captured CUDA graph
// replays the launch at whatever position is there); logits [b,
// vocab] f32 and tok_out [b, steps] int32 (outputs); the scratch buffers
// proj, q, rq, gates, kvn_unrot, kvn_rot, c_out, info, partial, comb, x, y,
// hbuf (see MegaArgs); phase_ns (null, or 1 + steps * (5 * L + 1) uint64
// for the global timer after each grid sync).  ints: L, b, kvh, G, max_len,
// Wc, Bc, M, hid, dim, vocab, hid4, steps, greedy, stride, sel_block,
// num_sel, n_slide, window, info_width.  The caches are updated in place.
// Returns the launch's cudaError_t (cudaErrorCooperativeLaunchTooLarge when
// a block's weight tiles and work space do not fit, see
// nsa_decode_mega_plan).
extern "C" int nsa_decode_mega(const void* const* ptrs, int nptrs, const int* ints, int nints,
                               float scale, float eps, void* stream) {
  using nsa::bf16;
  nsa::MegaArgs a = {};
  int G = 0;
  if (!nsa::parse_ints(a, &G, ints, nints) || nptrs != 3 * a.depth + 39)
    return (int)cudaErrorInvalidValue;
  a.scale = scale;
  a.eps = eps;
  int p = 0;
  for (int l = 0; l < a.depth; ++l) a.kv[l] = (bf16*)ptrs[p++];
  for (int l = 0; l < a.depth; ++l) a.ckv[l] = (bf16*)ptrs[p++];
  for (int l = 0; l < a.depth; ++l) a.ring[l] = (bf16*)ptrs[p++];
  a.emb = (const bf16*)ptrs[p++];
  a.to_logits = (const bf16*)ptrs[p++];
  a.out_norm = (const bf16*)ptrs[p++];
  a.attn_norm = (const bf16*)ptrs[p++];
  a.w_qkvg = (const bf16*)ptrs[p++];
  a.gate_b = (const bf16*)ptrs[p++];
  a.mem_kv = (const float*)ptrs[p++];
  a.pos_kv = (const bf16*)ptrs[p++];
  a.b1k = (const bf16*)ptrs[p++];
  a.b1v = (const bf16*)ptrs[p++];
  a.b2c = (const bf16*)ptrs[p++];
  a.w1k = (const bf16*)ptrs[p++];
  a.w1v = (const bf16*)ptrs[p++];
  a.w2c = (const bf16*)ptrs[p++];
  a.w_out = (const bf16*)ptrs[p++];
  a.ff_norm = (const bf16*)ptrs[p++];
  a.fw1 = (const bf16*)ptrs[p++];
  a.fb1 = (const bf16*)ptrs[p++];
  a.fw2 = (const bf16*)ptrs[p++];
  a.fb2 = (const bf16*)ptrs[p++];
  a.inv_freq = (const float*)ptrs[p++];
  a.tok_in = (const int*)ptrs[p++];
  a.t0 = (const int*)ptrs[p++];
  a.logits = (float*)ptrs[p++];
  a.tok_out = (int*)ptrs[p++];
  a.proj = (bf16*)ptrs[p++];
  a.q = (bf16*)ptrs[p++];
  a.rq = (bf16*)ptrs[p++];
  a.gates = (bf16*)ptrs[p++];
  a.kvn_unrot = (bf16*)ptrs[p++];
  a.kvn_rot = (bf16*)ptrs[p++];
  a.c_out = (bf16*)ptrs[p++];
  a.info = (int*)ptrs[p++];
  a.partial = (float*)ptrs[p++];
  a.comb = (bf16*)ptrs[p++];
  a.x = (bf16*)ptrs[p++];
  a.y = (bf16*)ptrs[p++];
  a.hbuf = (bf16*)ptrs[p++];
  a.phase_ns = (unsigned long long*)ptrs[p++];
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 1: return (int)nsa::launch_mega<1>(a, s);
    case 2: return (int)nsa::launch_mega<2>(a, s);
    case 4: return (int)nsa::launch_mega<4>(a, s);
    case 8: return (int)nsa::launch_mega<8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel's launch plan on the current device for the ints of
// nsa_decode_mega, written to out[7]: grid, blocks that fit on an SM (0: a
// block needs more shared memory than the card allows; the kernel then
// refuses to launch), the largest block's weight-tile bytes, all blocks'
// weight-tile bytes, the work space a block, the dynamic shared memory a
// block, the card's limit a block.  Returns a cudaError_t.
extern "C" int nsa_decode_mega_plan(const int* ints, int nints, int* out) {
  nsa::MegaArgs a = {};
  int G = 0;
  if (!nsa::parse_ints(a, &G, ints, nints)) return (int)cudaErrorInvalidValue;
  nsa::MegaPlan p;
  int per_sm = 0, optin = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (G) {
    case 1: e = nsa::mega_plan<1>(a, &p, &per_sm, &optin); break;
    case 2: e = nsa::mega_plan<2>(a, &p, &per_sm, &optin); break;
    case 4: e = nsa::mega_plan<4>(a, &p, &per_sm, &optin); break;
    case 8: e = nsa::mega_plan<8>(a, &p, &per_sm, &optin); break;
  }
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {p.grid, per_sm, p.slice_bytes, p.slice_total, p.work_bytes,
                       p.smem_bytes, optin};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

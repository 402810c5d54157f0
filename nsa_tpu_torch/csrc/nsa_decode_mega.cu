// The whole-model decode step for Hopper (sm_90a): one persistent
// cooperative kernel decodes `steps` tokens of every layer of the model.
//
// Replaces the TPU kernel of nsa_tpu/ops/pallas/nsa_megakernel.py:
//   decode_step_mega / _decode_step_mega_jit (:978, :1020; pallas_call
//   :1234), whose two bodies _mega_kernel (:88) and _mega_kernel_hb (:574)
//   are TPU schedules of the same math; one kernel here covers both.
//
// What bounds it on this card: bytes.  A step at the reference model (6
// layers, dim 512, 8/4 heads, dim_head 64) and b <= 8 reads every layer's
// weights once (34.8 MB in bf16), on the 1 step in `stride` that emits the
// compressors' weights (17.8 MB a layer), the live compressed cache rows
// (~25 MB at bs 8 and num_cb 499) and the gathered kv rows (~7 MB): a few
// FLOPs per byte, far below the H100's ~295 bf16 FLOP/byte ridge.  The
// TPU version existed to remove per-launch cost; on this card the same
// holds: the per-layer route launches ~62 eager ops a layer and leaves the
// card idle most of the step.
//
// Design: one launch, a grid of co-resident blocks (cudaOccupancy... x SM
// count at the kernel's shared memory, launched cooperatively), the work of
// each phase spread over the blocks by grid-stride loops over work items,
// and cooperative_groups grid.sync() between phases.  Every block reaches
// every grid.sync(): the syncs sit in the kernel's own loops over steps and
// layers, never inside a branch or a work-item loop.  Per layer:
//   1. RMSNorm (each block, all <= 16 rows) and the fused q|k|v|gate
//      product, kProjCols columns an item, rounded to bf16 into `proj`
//      (layer 0 takes the embedding rows of this step's tokens).
//   2. Per (row, KV head): the queries, rotary of q and k at t in float32
//      (rounded), the gates' sigmoid in float32 (rounded), the new token's
//      unrotated and rotated k || v rows, then compressed attention and
//      selection (select_body, which reads no ckv row at or above num_cb).
//      On emission steps also per (KV head, kEmitColsM compressor columns):
//      the emission's partial products over the OLD ring plus the new token.
//   3. Per (row, KV head): the emitted row (partials in chunk order + b2)
//      into ckv[min(num_cb, Wc - 1)] on emission steps; the ring shift
//      (after phase 2's readers of the old ring: no race); the kv row write
//      and attention with row t staged from the new token, and the head's
//      share of w_out (attend_out_body).
//   4. Residual (x + the heads' partials in head order, rounded) and the
//      FF's first product, kFF1ColsM hidden columns an item.
//   5. The FF's second product into the residual stream, kFF2ColsM columns
//      an item.
// After the last layer: the final RMSNorm and the LM head, kLogitCols
// columns an item, rounded to bf16 into float32 logits.  The next step's
// blocks each take the argmax of those logits (ties to the lowest index)
// as its token; block 0 writes it out.  5 syncs a layer and one a token.
// Weights are read once per step for all rows (chunk_matvec); sums run in
// a fixed order with no atomics, so a launch of `steps` tokens gives the
// same bits as that many launches of one.  The bodies of phases 2-5 are the
// fused route's (decode_common.cuh, decode_fused_common.cuh).  Scratch
// buffers written during the launch are read with coherent loads only (no
// __restrict__ on their pointers; cp.async.cg reads through L2).  No tensor
// cores: at <= 16 rows each product is a few matrix-vector products.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_fused_common.cuh"

namespace cg = cooperative_groups;

namespace nsa {
namespace {

constexpr int kMaxDepth = 16;
constexpr int kMaxBatch = 16;
constexpr int kProjCols = 8;      // q|k|v|gate columns per item
constexpr int kEmitColsM = 32;    // compressor hidden columns per emission item
constexpr int kFF1ColsM = 16;     // FF hidden columns per item
constexpr int kFF2ColsM = 4;      // model columns per item of the FF's second product
constexpr int kLogitCols = 2;     // vocabulary columns per item

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
  float* logits;                  // [b, vocab]
  int* tok_out;                   // [b, steps] (greedy)
  // scratch
  bf16* proj;                     // [b, P]
  bf16* q;                        // [b, kvh, G, kD] unrotated
  bf16* rq;                       // [b, kvh, G, kD] rotated
  bf16* gates;                    // [b, kvh, G, 3]
  bf16* kvn_unrot;                // [b, kvh, 2kD] the new token's k || v
  bf16* kvn_rot;                  // [b, kvh, 2kD] its rotated k || v
  bf16* c_out;                    // [b, kvh, G, kD]
  int* info;                      // [b, kvh, info_width]
  float* partial;                 // [kvh, hid / kEmitColsM, b, 2kD]
  float* part;                    // [b, kvh, dim]
  bf16* x;                        // [b, dim] the residual stream
  bf16* y;                        // [b, dim] x + attention
  bf16* hbuf;                     // [b, hid4]
  // optional: the global timer in ns when block 0 starts and after each
  // grid sync, 1 + steps * (5 * depth + 1) values (where the time goes)
  unsigned long long* phase_ns;
  int depth, b, kvh, max_len, Wc, Bc, M, hid, dim, vocab, hid4, t0, steps, greedy, stride,
      sel_block, num_sel, n_slide, window, info_width;
  float scale, eps;
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

// Rows [b0, b0 + nb) of the residual stream (or, at layer 0, of the
// embedding of this step's tokens) into ys [kBG][dim] as floats, then
// RMSNorm with `scale`, rounded.  Block 0 writes the embedding rows into
// the residual stream at layer 0.
__device__ __forceinline__ void load_norm_rows(const MegaArgs& a, bool embed, const int* toks,
                                               int b0, int nb, const bf16* scale, float* ys,
                                               float* scratch) {
  for (int i = threadIdx.x; i < nb * a.dim; i += blockDim.x) {
    const int r = b0 + i / a.dim, n = i % a.dim;
    const bf16 v = embed ? a.emb[(size_t)toks[r] * a.dim + n] : a.x[(size_t)r * a.dim + n];
    ys[i] = __bfloat162float(v);
    if (embed && blockIdx.x == 0) a.x[(size_t)r * a.dim + n] = v;
  }
  __syncthreads();
  rms_norm_rows(ys, nb, a.dim, scale, a.eps, scratch);
}

// ys @ W [dim, N] for the items of this block, kCols columns an item,
// rounded to bf16; into out (bf16 [b, N]) or outf (float [b, N]).
template <int kCols>
__device__ __forceinline__ void norm_matvec(const MegaArgs& a, bool embed, const int* toks,
                                            const bf16* scale, const bf16* W, int N, bf16* out,
                                            float* outf, unsigned char* smem) {
  const int items = N / kCols;
  if ((int)blockIdx.x >= items) return;
  float* ys = reinterpret_cast<float*>(smem);       // [kBG][dim]
  float* red = ys + kBG * a.dim;                    // [kBG * kThreads * 2]
  float* res = red + kBG * kThreads * 2;            // [kBG][kCols]
  float* scratch = res + kBG * kCols;               // [32]
  for (int b0 = 0; b0 < a.b; b0 += kBG) {
    const int nb = min(kBG, a.b - b0);
    load_norm_rows(a, embed, toks, b0, nb, scale, ys, scratch);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int c0 = item * kCols;
      chunk_matvec<kCols>(ys, a.dim, nb, W, N, c0, red, res);
      for (int i = threadIdx.x; i < nb * kCols; i += blockDim.x) {
        const size_t o = (size_t)(b0 + i / kCols) * N + c0 + i % kCols;
        if (out != nullptr) out[o] = __float2bfloat16(res[i]);
        else outf[o] = round_bf16(res[i]);
      }
      __syncthreads();
    }
  }
}

// Phase 2's staging for (row, KV head) bh: the queries, rotated queries,
// gates and the new token's rows, from the rounded projection.
template <int G>
__device__ __forceinline__ void stage_head(const MegaArgs& a, int l, int t, int bh) {
  const int h = a.kvh * G, din = h * kD, dkv = a.kvh * kD;
  const int P = din + 2 * dkv + 3 * h;
  const int bi = bh / a.kvh, hi = bh % a.kvh;
  const bf16* pr = a.proj + (size_t)bi * P;
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
    a.q[(size_t)bh * G * kD + i] = pr[col];
    a.rq[(size_t)bh * G * kD + i] = rotate(pr + col - (e & 1), e);
  }
  for (int i = threadIdx.x; i < 3 * G; i += blockDim.x) {
    const int c = hi * 3 * G + i;
    const float z = __fadd_rn(__bfloat162float(pr[din + 2 * dkv + c]),
                              __bfloat162float(a.gate_b[(size_t)l * 3 * h + c]));
    a.gates[(size_t)bh * 3 * G + i] = __float2bfloat16(1.f / (1.f + expf(-z)));
  }
  for (int e = threadIdx.x; e < 2 * kD; e += blockDim.x) {
    const int src = e < kD ? din + hi * kD + e : din + dkv + hi * kD + e - kD;
    a.kvn_unrot[(size_t)bh * 2 * kD + e] = pr[src];
    a.kvn_rot[(size_t)bh * 2 * kD + e] = e < kD ? rotate(pr + src - (e & 1), e) : pr[src];
  }
  __syncthreads();
}

template <int G>
__global__ void __launch_bounds__(kThreads) mega_kernel(const MegaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int toks[kMaxBatch];
  cg::grid_group grid = cg::this_grid();
  const int h = a.kvh * G, din = h * kD, dkv = a.kvh * kD;
  const int P = din + 2 * dkv + 3 * h;
  const int nsel = a.b * a.kvh;
  const int nchunks = a.hid / kEmitColsM;
  const int max_blocks = a.max_len / a.sel_block;
  int mk = 0;
  mark(a, mk);

  for (int s = 0; s < a.steps; ++s) {
    const int t = a.t0 + s;
    const int num_cb = t / a.stride;
    const bool emit = (t + 1) % a.stride == 0;
    const int slot = min(num_cb, a.Wc - 1);
    // this step's tokens: the input, then the previous step's argmax
    if (s == 0) {
      for (int r = threadIdx.x; r < a.b; r += blockDim.x) toks[r] = a.tok_in[r];
      __syncthreads();
    } else {
      argmax_rows(a.logits, a.b, a.vocab, toks, blockIdx.x == 0 ? a.tok_out : nullptr, a.steps,
                  s - 1);
    }

    for (int l = 0; l < a.depth; ++l) {
      // ---- 1. RMSNorm + the fused q|k|v|gate projection ------------------
      norm_matvec<kProjCols>(a, l == 0, toks, a.attn_norm + (size_t)l * a.dim,
                             a.w_qkvg + (size_t)l * a.dim * P, P, a.proj, nullptr, smem);
      grid.sync();
      mark(a, mk);

      // ---- 2. staging + selection per (row, KV head); emission partials --
      const int items2 = nsel + (emit ? a.kvh * nchunks : 0);
      for (int item = blockIdx.x; item < items2; item += gridDim.x) {
        if (item < nsel) {
          stage_head<G>(a, l, t, item);
          select_body<G>(a.q, a.ckv[l], a.mem_kv + (size_t)l * 2 * a.kvh * a.M * kD, a.c_out,
                         a.info, a.kvh, a.Wc, a.M, t, num_cb, a.stride, a.sel_block, a.num_sel,
                         a.n_slide, max_blocks, a.info_width, a.scale, item, smem);
        } else {
          const size_t lk = (size_t)l * a.kvh;
          emit_partial_body<kEmitColsM>(
              a.ring[l], a.proj + din, a.proj + din + dkv, P, kD,
              a.pos_kv + lk * a.Bc * 2 * kD, a.w1k + lk * a.Bc * kD * a.hid, a.b1k + lk * a.hid,
              a.w1v + lk * a.Bc * kD * a.hid, a.b1v + lk * a.hid, a.w2c + lk * a.hid * 2 * kD,
              a.partial, a.b, a.kvh, a.Bc, a.hid, t, item - nsel, smem);
        }
        __syncthreads();
      }
      grid.sync();
      mark(a, mk);

      // ---- 3. emitted row, ring shift, kv row, attention, w_out partials -
      for (int bh = blockIdx.x; bh < nsel; bh += gridDim.x) {
        const int bi = bh / a.kvh, hi = bh % a.kvh;
        if (emit)
          emit_row_body(a.partial, a.b2c + (size_t)l * a.kvh * 2 * kD,
                        a.ckv[l] + ((size_t)bh * a.Wc + slot) * 2 * kD, nchunks, a.b, bi, hi);
        ring_shift_body(a.ring[l] + (size_t)bh * a.Bc * 2 * kD, a.kvn_unrot + (size_t)bh * 2 * kD,
                        a.Bc, smem);
        attend_out_body<G>(a.rq, DenseRows{a.kv[l], a.max_len}, a.kvn_rot, a.info, a.c_out,
                           a.gates, a.w_out + (size_t)l * din * a.dim, a.part, a.kvh, a.dim, t,
                           a.sel_block, a.window, a.num_sel, a.n_slide, a.info_width, a.scale, bh,
                           smem);
      }
      grid.sync();
      mark(a, mk);

      // ---- 4. residual + the FF's first product --------------------------
      for (int item = blockIdx.x; item < a.hid4 / kFF1ColsM; item += gridDim.x)
        resid_ff1_body<kFF1ColsM>(a.x, a.part, a.ff_norm + (size_t)l * a.dim,
                                  a.fw1 + (size_t)l * a.dim * a.hid4,
                                  a.fb1 + (size_t)l * a.hid4, a.hbuf,
                                  item == 0 ? a.y : nullptr, a.b, a.kvh, a.dim, a.hid4, a.eps,
                                  item, smem);
      grid.sync();
      mark(a, mk);

      // ---- 5. the FF's second product into the residual stream -----------
      for (int item = blockIdx.x; item < a.dim / kFF2ColsM; item += gridDim.x)
        ff2_body<kFF2ColsM>(a.hbuf, a.fw2 + (size_t)l * a.hid4 * a.dim,
                            a.fb2 + (size_t)l * a.dim, a.y, a.x, a.b, a.dim, a.hid4, item, smem);
      grid.sync();
      mark(a, mk);
    }

    // ---- final RMSNorm + LM head -------------------------------------------
    norm_matvec<kLogitCols>(a, false, toks, a.out_norm, a.to_logits, a.vocab, nullptr, a.logits,
                            smem);
    grid.sync();
    mark(a, mk);
  }
  if (a.greedy && blockIdx.x == 0)
    argmax_rows(a.logits, a.b, a.vocab, toks, a.tok_out, a.steps, a.steps - 1);
}

template <int G>
size_t mega_smem_bytes(const MegaArgs& a) {
  const int Wf = a.Wc / (a.sel_block / a.stride);
  const int J = (a.num_sel + a.n_slide) * a.sel_block;
  size_t m = sizeof(float) * (kBG * a.dim + kBG * kThreads * 2 + kBG * kProjCols + 32);
  m = std::max(m, select_smem_bytes<G>(a.Wc, a.M, Wf, kThreads));
  m = std::max(m, emit_smem_bytes<kEmitColsM>(a.Bc));
  m = std::max(m, (size_t)a.Bc * 2 * kD * sizeof(bf16));
  m = std::max(m, attend_smem_bytes<G>(J, kThreads));
  m = std::max(m, ff1_smem_bytes<kFF1ColsM>(a.dim));
  m = std::max(m, ff2_smem_bytes<kFF2ColsM>(a.hid4));
  return m;
}

// A grid of as many blocks as fit on the card at once, launched
// cooperatively; a grid that cannot be co-resident is an error, never run.
template <int G>
cudaError_t launch_mega(MegaArgs& a, cudaStream_t stream) {
  auto kern = mega_kernel<G>;
  const size_t smem = mega_smem_bytes<G>(a);
  cudaError_t e;
  if ((e = set_smem((const void*)kern, smem)) != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  if ((e = cudaLaunchCooperativeKernel((const void*)kern, dim3(per_sm * sms), dim3(kThreads),
                                       args, smem, stream)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// ptrs, in order: kv[0..L), ckv[0..L), ring[0..L); token_emb, to_logits,
// out_norm, attn_norm, w_qkvg, gate_b, mem_kv (float32), pos_kv, b1k, b1v,
// b2c, w1k, w1v, w2c, w_out, ff_norm, fw1, fb1, fw2, fb2 (bf16, shapes of
// pack_mega_params); inv_freq [64/2] f32; tok_in [b] int32; logits [b,
// vocab] f32 and tok_out [b, steps] int32 (outputs); the scratch buffers
// proj, q, rq, gates, kvn_unrot, kvn_rot, c_out, info, partial, part, x, y,
// hbuf (see MegaArgs); phase_ns (null, or 1 + steps * (5 * L + 1) uint64
// for the global timer after each grid sync).  ints: L, b, kvh, G, max_len, Wc, Bc, M, hid, dim,
// vocab, hid4, t, steps, greedy, stride, sel_block, num_sel, n_slide,
// window, info_width.  The caches are updated in place.  Returns the
// launch's cudaError_t.
extern "C" int nsa_decode_mega(const void* const* ptrs, int nptrs, const int* ints, int nints,
                               float scale, float eps, void* stream) {
  using nsa::bf16;
  if (nints != 21) return (int)cudaErrorInvalidValue;
  nsa::MegaArgs a = {};
  int k = 0;
  a.depth = ints[k++];
  a.b = ints[k++];
  a.kvh = ints[k++];
  const int G = ints[k++];
  a.max_len = ints[k++];
  a.Wc = ints[k++];
  a.Bc = ints[k++];
  a.M = ints[k++];
  a.hid = ints[k++];
  a.dim = ints[k++];
  a.vocab = ints[k++];
  a.hid4 = ints[k++];
  a.t0 = ints[k++];
  a.steps = ints[k++];
  a.greedy = ints[k++];
  a.stride = ints[k++];
  a.sel_block = ints[k++];
  a.num_sel = ints[k++];
  a.n_slide = ints[k++];
  a.window = ints[k++];
  a.info_width = ints[k++];
  a.scale = scale;
  a.eps = eps;
  if (a.depth < 1 || a.depth > nsa::kMaxDepth || a.b < 1 || a.b > nsa::kMaxBatch ||
      a.steps < 1 || nptrs != 3 * a.depth + 38)
    return (int)cudaErrorInvalidValue;
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
  a.part = (float*)ptrs[p++];
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

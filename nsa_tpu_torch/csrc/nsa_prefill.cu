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
// as few rows, and so as few selected blocks, as it can.  The block builds
// the sorted union of its rows' blocks and streams the band and then the
// union through a shared-memory ring, each key once per query tile
// (KeyStream, csrc/prefill_common.cuh).  A warp takes each 16-key sub-tile
// one of its rows uses (or, in the band, is near): S = Q.K^T as mma.sync
// m16n8k16 bf16 with float32 accumulators (q fragments in registers, K by
// ldmatrix), masked per element by the row's membership bit and key <= row
// (fine) or the band (sliding), an online softmax per (row, head) and
// branch in float32 in base 2 (no test for masked logits: the running max
// starts finite), and O += P.V with P rounded to bf16 (V by
// ldmatrix.trans).  A band sub-tile serves both branches from one S; the
// sliding output is written when the band is done, and the union's
// sub-tiles then go two to one softmax update.  P's rounding is the one
// departure from the TPU kernel, which keeps P float32 (so does the plain
// version); ``fine_sliding_tolerance`` states what it costs.  The blocks of
// one (batch, KV head) are adjacent, so the few KV heads in flight keep
// their keys in L2; within them the late query tiles, which have the most
// blocks to choose from, start first.
#include <type_traits>

#include "prefill_common.cuh"

namespace nsa {
namespace {

// The running max before any key, in base-2 units: finite and below every
// logit, so a masked logit (kNeg) gets the weight ex2(kNeg * scale * log2e
// - max) = 0 with no test, even in a row that has had no key yet.
constexpr float kInit = -1e20f;

// Online-softmax state of one branch for a warp's 16 mma rows, in base 2:
// m is the running max of the scaled logits times log2(e).
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
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      uint32_t a[4];
      pack_a(p[2 * i], p[2 * i + 1], a);
      product_nn(a, vt[i], acc, lane);
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

template <int G>
__global__ void __launch_bounds__(Tile<G>::kThreads, 2)
    prefill_fwd_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ rk,
                       const bf16* __restrict__ v, const int* __restrict__ sel_idx,
                       const uint8_t* __restrict__ sel_mask, bf16* __restrict__ fo,
                       bf16* __restrict__ so, float* __restrict__ flse,
                       float* __restrict__ slse, int num_tiles, int n, int S, int sel_block,
                       int window, int align, int max_union, int max_words, float scale) {
  constexpr int R = Tile<G>::kRows, RW = Tile<G>::kWarpRows;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long bh = blockIdx.x / num_tiles;                  // a KV head's tiles adjacent
  const int r0 = (num_tiles - 1 - (int)(blockIdx.x % num_tiles)) * R;   // heavy tiles first
  const int last = min(r0 + R, n) - 1;
  KeyStream<G> ks(smem_raw, max_union, max_words, rk, v, bh, n, r0, last, sel_block);
  ks.build(sel_idx + ((size_t)bh * n + r0) * S, sel_mask + ((size_t)bh * n + r0) * S, S,
           window, align);
  Stage& st = ks.st;
  const WarpRows<G> wr(bh, r0, n, warp, lane);
  uint32_t qf[4][4];
  wr.load(rq, qf, lane);
  const float sl2 = scale * kLog2e;
  Online fine, slide;
  fine.init();
  slide.init();

  const int wbit = wr.wbit, wr0 = wr.wr0;
  ks.start(warp, lane);
  // S = Q . K^T for the warp's 16 rows and sub-tile s4's 16 keys, with each
  // lane's four keys' positions and fine-mask bits
  auto logits = [&](int buf, int s4, float (&sc)[2][4], int (&kp)[2][2], uint32_t (&km)[2][2]) {
    product_nt(qf, st.k[buf] + s4 * 16 * kLd, sc, lane);
    wr.key_meta(st, buf, s4, kp, km);
  };
  // the lane's logits of one sub-tile under the fine set (or the band)
  auto masked = [&](bool band, const float (&sc)[2][4], const int (&kp)[2][2],
                    const uint32_t (&km)[2][2], float (*x)[4]) {
    bool ok[2][4];
    wr.keep(band, kp, km, window, ok);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[t][e] = ok[t][e] ? sc[t][e] : kNeg;
  };
  auto fine_rows = [&](int buf, int s4) {
    return ks.fine_rows(buf, s4, wbit, WarpRows<G>::kRowBits, lane);
  };

  // the band: both branches from one S per sub-tile, for the sub-tiles a
  // row of the warp uses (fine) or is near (sliding); then the sliding
  // output is done and its registers are free
  for (int c = 0; c < ks.band_chunks; ++c) {
    ks.enter(c, warp, lane);
    const int buf = c % kStages;
#pragma unroll 1
    for (int s4 = 0; s4 < kSub; ++s4) {
      const int k0 = ks.kb0 + c * kChunk + s4 * 16;
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
    ks.leave(c, lane);
  }
  slide.finish(so, slse, wr.at, wr.live, lane);

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
  for (int c = ks.band_chunks; c < ks.n_chunks; ++c) {
    ks.enter(c, warp, lane);
    const int buf = c % kStages;
    const int u0 = (c - ks.band_chunks) * kChunk;
    uint32_t todo = 0u;
#pragma unroll
    for (int s4 = 0; s4 < kSub; ++s4)
      if (u0 + s4 * 16 < ks.union_keys && fine_rows(buf, s4))
        todo |= 1u << s4;
    while (todo) {                       // uniform over the warp
      if (todo & (todo - 1))
        group(std::integral_constant<int, 2>(), buf, todo);
      else
        group(std::integral_constant<int, 1>(), buf, todo);
    }
    ks.leave(c, lane);
  }
  fine.finish(fo, flse, wr.at, wr.live, lane);
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
  int max_union, max_words;
  const size_t smem = union_smem(R, n, S, sel_block, max_union, max_words);
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

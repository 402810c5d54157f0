// The fused decode-step kernels for Hopper (sm_90a): one NSA layer's decode
// step at small batch as two kernels, each one or more launches from one C
// entry point.
//
// Replaces the TPU kernels of nsa_tpu/ops/pallas/nsa_decode_fused.py:
//   decode_select_emit   (_select_emit_kernel :216, _select_math :100,
//                         pallas_call :441)
//   decode_attend_fused  (_attend_fused_kernel :580, _attend_math :464,
//                         _ff_tail :556, pallas_call :830)
//
// What bounds them on this card: bytes.  At the reference model and bs 8:
//   decode_select_emit reads the live compressed cache (~1 MB at num_cb
//     499) every step, and on the 1 step in `stride` that emits, the
//     GroupedMLP compressor's weights (w1k + w1v + w2, ~4.4 MB per KV head).
//   decode_attend_fused reads the 144 gathered kv rows per (row, KV head),
//     w_out (0.5 MB) and the FF's two matrices (2 x 2 MB).
// A decode step does a few FLOPs per byte of weights at b <= 8, far below
// the H100's ~295 bf16 FLOP/byte ridge, so the design reads every weight
// once per launch for all batch rows (up to kBG = 8 rows at a time) and
// splits the weight columns over many blocks to have enough of the card's
// memory system in flight:
//
// decode_select_emit: on emission steps a first launch runs one block per
//   (KV head, 64 hidden columns of the compressor): it builds the emission
//   window (the SHIFTED ring: rows 1.. of the old ring, then the new
//   token, rows before position 0 zeroed, k_pos||v_pos added, rounded to
//   bf16), multiplies it by its 64 columns of w1k / w1v, adds the bias,
//   applies relu and rounds, and multiplies those 64 hidden values by their
//   64 rows of w2: a partial sum of the emitted row per (head, chunk).  The
//   second launch, one block per (batch row, KV head), reads the old ring
//   and the new token into shared memory before it writes the shifted ring
//   (the first launch has finished reading it: launches on one stream run
//   in order), sums the partials in chunk order, adds b2 and writes the
//   emitted row into ckv[num_cb] (on emission steps only), then runs the
//   split route's selection body, which reads only rows below num_cb.
//   Deterministic: no atomics.
// decode_attend_fused: launch 1, one block per (batch row, KV head), writes
//   the new token's row into kv[t], runs the split route's attention body
//   with row t staged from the new token, rounds the combined output to
//   bf16 and multiplies it by its head's rows of w_out: a partial
//   projection per (row, head) in float32.  Launch 2, one block per 64 FF
//   hidden columns (one block without the FF), adds x and the heads'
//   partials in head order in float32 and rounds once (y); block 0 writes
//   y to the output; with the FF it normalizes y, multiplies by its
//   columns of w1, adds b1 and applies the exact erf GELU into a bf16
//   hidden row.  Launch 3, one block per 16 output columns, multiplies the
//   hidden row by its columns of w2, adds b2 and y, and writes the output.
//   Deterministic: every sum in a fixed order, no atomics.
// Rounding points follow the TPU kernels (see ops/cuda/nsa_decode_fused.py).
// No tensor cores: at <= 8 rows a product is a few matrix-vector products.
#include "decode_common.cuh"

namespace nsa {
namespace {

constexpr int kThreads = 256;
constexpr int kBG = 8;            // batch rows per pass over a weight chunk
constexpr int kEmitCols = 64;     // compressor hidden columns per emission block
constexpr int kFF1Cols = 64;      // FF hidden columns per block
constexpr int kFF2Cols = 16;      // output columns per block of the FF's second product

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// res[bb][c] = sum_k in[bb][k] * W[k][c0 + c] for bb < nb, c < kCols: in is
// float [kBG][K] in shared memory, W a bf16 [K][N] matrix in global memory
// read once for all rows.  Thread (part, pair) sums rows k = part, part +
// nparts, ... for two adjacent columns, loading kLoads rows before it uses
// them so that their latencies overlap (in-order issue would otherwise wait
// out one memory latency per row); the parts are then added in order.  red
// holds kBG * kThreads * 2 floats.  Ends with a barrier.
constexpr int kLoads = 16;

template <int kCols>
__device__ void chunk_matvec(const float* in, int K, int nb, const bf16* __restrict__ W, int N,
                             int c0, float* red, float* res) {
  constexpr int kPairs = kCols / 2;
  const int nparts = blockDim.x / kPairs;
  const int p = threadIdx.x % kPairs, part = threadIdx.x / kPairs;
  float acc[kBG][2];
#pragma unroll
  for (int bb = 0; bb < kBG; ++bb) acc[bb][0] = acc[bb][1] = 0.f;
  for (int k0 = part; k0 < K; k0 += kLoads * nparts) {
    float2 w[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * nparts;
      w[u] = k < K ? load_bf16x2(W + (size_t)k * N + c0 + 2 * p) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = min(k0 + u * nparts, K - 1);   // past the end: w[u] is zero
#pragma unroll
      for (int bb = 0; bb < kBG; ++bb) {
        if (bb < nb) {
          const float a = in[bb * K + k];
          acc[bb][0] += a * w[u].x;
          acc[bb][1] += a * w[u].y;
        }
      }
    }
  }
#pragma unroll
  for (int bb = 0; bb < kBG; ++bb) {
    red[(part * kBG + bb) * kCols + 2 * p] = acc[bb][0];
    red[(part * kBG + bb) * kCols + 2 * p + 1] = acc[bb][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * kCols; i += blockDim.x) {
    const int bb = i / kCols, c = i % kCols;
    float s = 0.f;
    for (int q = 0; q < nparts; ++q) s += red[(q * kBG + bb) * kCols + c];
    res[i] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// decode_select_emit, launch 1 (emission steps only): one block per (KV
// head, kEmitCols hidden columns); partial[h][chunk][b][2*kD].
// ---------------------------------------------------------------------------
size_t emit_smem_bytes(int Bc) {
  return sizeof(float) * (kBG * Bc * kD + kBG * kThreads * 2 + kBG * kEmitCols);
}

__global__ void emit_partial_kernel(const bf16* __restrict__ ring, const bf16* __restrict__ kv_new,
                                    const bf16* __restrict__ pos_kv,
                                    const bf16* __restrict__ w1k, const float* __restrict__ b1k,
                                    const bf16* __restrict__ w1v, const float* __restrict__ b1v,
                                    const bf16* __restrict__ w2, float* __restrict__ partial,
                                    int b, int kvh, int Bc, int hid, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = Bc * kD;
  float* win = reinterpret_cast<float*>(smem_raw);  // [kBG][K] window, one half
  float* red = win + kBG * K;                       // [kBG * kThreads * 2]
  float* hs = red + kBG * kThreads * 2;             // [kBG][kEmitCols] hidden
  const int nchunks = hid / kEmitCols;
  const int h = blockIdx.x / nchunks, chunk = blockIdx.x % nchunks, c0 = chunk * kEmitCols;
  const int tid = threadIdx.x;

  for (int b0 = 0; b0 < b; b0 += kBG) {
    const int nb = min(kBG, b - b0);
    for (int half = 0; half < 2; ++half) {
      // the shifted window [t+1-Bc, t+1): zero before the sequence start,
      // plus the intra-block position, rounded to bf16 as the cache dtype
      for (int i0 = tid; i0 < nb * K; i0 += 8 * blockDim.x) {
        float v[8], pos[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {       // all loads first, then the math
          const int i = i0 + u * blockDim.x;
          const int bb = i / K, r = i % K, j = r / kD, e = half * kD + r % kD;
          const size_t bh = (size_t)(b0 + bb) * kvh + h;
          const bool live = i < nb * K && t + 1 - Bc + j >= 0;
          v[u] = live ? __bfloat162float(j < Bc - 1 ? ring[(bh * Bc + j + 1) * 2 * kD + e]
                                                    : kv_new[bh * 2 * kD + e])
                      : 0.f;
          pos[u] = i < nb * K ? __bfloat162float(pos_kv[((size_t)h * Bc + j) * 2 * kD + e]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * blockDim.x;
          if (i < nb * K) win[i] = round_bf16(v[u] + pos[u]);
        }
      }
      __syncthreads();
      const bf16* w1 = (half ? w1v : w1k) + (size_t)h * K * hid;
      const float* b1 = (half ? b1v : b1k) + (size_t)h * hid;
      chunk_matvec<kEmitCols>(win, K, nb, w1, hid, c0, red, hs);
      for (int i = tid; i < nb * kEmitCols; i += blockDim.x)
        hs[i] = round_bf16(fmaxf(hs[i] + b1[c0 + i % kEmitCols], 0.f));
      __syncthreads();
      // this chunk's share of the second layer, for this half's kD outputs
      for (int i = tid; i < nb * kD; i += blockDim.x) {
        const int bb = i / kD, e = i % kD;
        const bf16* w = w2 + ((size_t)h * hid + c0) * 2 * kD + half * kD + e;
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < kEmitCols; ++c) s += hs[bb * kEmitCols + c] * __bfloat162float(w[(size_t)c * 2 * kD]);
        partial[(((size_t)h * nchunks + chunk) * b + b0 + bb) * 2 * kD + half * kD + e] = s;
      }
      __syncthreads();             // win and hs are rewritten next
    }
  }
}

// ---------------------------------------------------------------------------
// decode_select_emit, launch 2: one block per (batch row, KV head): the ring
// shift, the emitted row (emission steps), then selection.
// ---------------------------------------------------------------------------
template <int G>
__global__ void select_emit_kernel(const bf16* __restrict__ q, bf16* ckv, bf16* __restrict__ ring,
                                   const bf16* __restrict__ kv_new,
                                   const bf16* __restrict__ mem_kv,
                                   const float* __restrict__ partial,
                                   const float* __restrict__ b2, bf16* __restrict__ c_out,
                                   int* __restrict__ info, int b, int kvh, int Wc, int M, int Bc,
                                   int nchunks, int t, int num_cb, int emit, int stride,
                                   int sel_block, int num_sel, int n_slide, int max_blocks,
                                   int info_width, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, bi = bh / kvh, h = bh % kvh;
  const int tid = threadIdx.x;
  constexpr int kVec = 2 * kD / 8;            // 16-byte vectors per packed row

  // ring shift: read every source row first, then write
  uint4* stage = reinterpret_cast<uint4*>(smem_raw);
  bf16* rg = ring + (size_t)bh * Bc * 2 * kD;
  for (int i = tid; i < Bc * kVec; i += blockDim.x) {
    const int j = i / kVec, c = i % kVec;
    const bf16* src = j < Bc - 1 ? rg + (size_t)(j + 1) * 2 * kD : kv_new + (size_t)bh * 2 * kD;
    stage[i] = reinterpret_cast<const uint4*>(src)[c];
  }
  __syncthreads();
  for (int i = tid; i < Bc * kVec; i += blockDim.x)
    reinterpret_cast<uint4*>(rg)[i] = stage[i];

  // the emitted row: the chunks' partials in order, plus b2
  if (emit) {
    bf16* row = ckv + ((size_t)bh * Wc + num_cb) * 2 * kD;
    for (int e = tid; e < 2 * kD; e += blockDim.x) {
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < nchunks; ++c)
        s += partial[(((size_t)h * nchunks + c) * b + bi) * 2 * kD + e];
      row[e] = __float2bfloat16(s + b2[h * 2 * kD + e]);
    }
  }
  __syncthreads();                 // the stage area is the selection's tile
  select_body<G>(q, ckv, mem_kv, c_out, info, kvh, Wc, M, t, num_cb, stride, sel_block,
                 num_sel, n_slide, max_blocks, info_width, scale, bh, smem_raw);
}

// ---------------------------------------------------------------------------
// decode_attend_fused, launch 1: one block per (batch row, KV head): the kv
// row write, attention, the head's partial projection part[b][h][dim].
// ---------------------------------------------------------------------------
template <int G>
__global__ void attend_fused_kernel(const bf16* __restrict__ rq, bf16* kv,
                                    const bf16* __restrict__ kv_new, const int* __restrict__ info,
                                    const bf16* __restrict__ c_out,
                                    const bf16* __restrict__ gates,
                                    const bf16* __restrict__ w_out, float* __restrict__ part,
                                    int kvh, int max_len, int dim, int t, int sel_block,
                                    int window, int num_sel, int n_slide, int info_width,
                                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int outs = G * kD;
  const int bh = blockIdx.x, h = bh % kvh;
  const bf16* row_t = kv_new + (size_t)bh * 2 * kD;
  if (threadIdx.x < 2 * kD / 8)    // the new token's row, written in place
    reinterpret_cast<uint4*>(kv + ((size_t)bh * max_len + t) * 2 * kD)[threadIdx.x] =
        reinterpret_cast<const uint4*>(row_t)[threadIdx.x];
  float* comb = attend_body<G>(rq, kv, info, c_out, gates, row_t, max_len, t, sel_block, window,
                               num_sel, n_slide, info_width, scale, bh, smem_raw);
  for (int o = threadIdx.x; o < outs; o += blockDim.x) comb[o] = round_bf16(comb[o]);
  __syncthreads();
  // this head's rows of w_out: [h*outs, (h+1)*outs) x dim
  const bf16* w = w_out + (size_t)h * outs * dim;
  for (int n = 2 * threadIdx.x; n < dim; n += 2 * blockDim.x) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int r = 0; r < outs; ++r) {
      const float2 wf = load_bf16x2(w + (size_t)r * dim + n);
      a0 += comb[r] * wf.x;
      a1 += comb[r] * wf.y;
    }
    part[(size_t)bh * dim + n] = a0;
    part[(size_t)bh * dim + n + 1] = a1;
  }
}

// ---------------------------------------------------------------------------
// decode_attend_fused, launch 2: y = round(x + sum_h part[h]) (block 0
// writes it to out); with the FF, hbuf = gelu(round(norm(y) @ w1) + b1) for
// this block's kFF1Cols columns.
// ---------------------------------------------------------------------------
size_t ff1_smem_bytes(int dim) {
  return sizeof(float) * (kBG * dim + kBG * kThreads * 2 + kBG * kFF1Cols + 32);
}

__global__ void resid_ff1_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                                 const float* __restrict__ ff_norm, const bf16* __restrict__ ff_w1,
                                 const float* __restrict__ ff_b1, bf16* __restrict__ hbuf,
                                 bf16* __restrict__ out, int b, int kvh, int dim, int hid4,
                                 float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);   // [kBG][dim]
  float* red = ys + kBG * dim;                      // [kBG * kThreads * 2]
  float* hs = red + kBG * kThreads * 2;             // [kBG][kFF1Cols]
  float* scratch = hs + kBG * kFF1Cols;             // [32]
  const int tid = threadIdx.x, c0 = blockIdx.x * kFF1Cols;

  for (int b0 = 0; b0 < b; b0 += kBG) {
    const int nb = min(kBG, b - b0);
    for (int i0 = tid; i0 < nb * dim; i0 += 4 * blockDim.x) {
      float y[4];
      size_t at[4];                         // [row][0][n] of each element in part
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * blockDim.x, nb * dim - 1);
        const size_t row = (size_t)(b0 + i / dim), n = i % dim;
        y[u] = __bfloat162float(x[row * dim + n]);
        at[u] = row * kvh * dim + n;
      }
      for (int h = 0; h < kvh; ++h) {       // the heads' partials, in head order
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] += part[at[u] + (size_t)h * dim];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i >= nb * dim) continue;
        ys[i] = round_bf16(y[u]);
        if (blockIdx.x == 0) out[(size_t)b0 * dim + i] = __float2bfloat16(y[u]);
      }
    }
    if (hid4 == 0) continue;
    __syncthreads();
    // RMSNorm in float32, rounded to bf16: every row's sum of squares, then
    // one pass that scales them all
    float inv[kBG];
#pragma unroll
    for (int bb = 0; bb < kBG; ++bb) {
      if (bb >= nb) break;                  // nb is the same in every thread
      float ss = 0.f;
      for (int n = tid; n < dim; n += blockDim.x) ss += ys[bb * dim + n] * ys[bb * dim + n];
      inv[bb] = rsqrtf(block_reduce<false>(ss, scratch) / dim + eps);
    }
    for (int n = tid; n < dim; n += blockDim.x) {
      const float sc = ff_norm[n];
#pragma unroll
      for (int bb = 0; bb < kBG; ++bb)
        if (bb < nb) ys[bb * dim + n] = round_bf16(ys[bb * dim + n] * inv[bb] * sc);
    }
    __syncthreads();
    chunk_matvec<kFF1Cols>(ys, dim, nb, ff_w1, hid4, c0, red, hs);
    for (int i = tid; i < nb * kFF1Cols; i += blockDim.x) {
      const int bb = i / kFF1Cols, c = c0 + i % kFF1Cols;
      const float hv = round_bf16(round_bf16(hs[i]) + round_bf16(ff_b1[c]));
      const float g = 0.5f * hv * (1.f + erff(hv * 0.7071067811865476f));
      hbuf[(size_t)(b0 + bb) * hid4 + c] = __float2bfloat16(g);
    }
    __syncthreads();               // ys, red and hs are rewritten next
  }
}

// ---------------------------------------------------------------------------
// decode_attend_fused, launch 3 (with the FF): out = round(y + round(round(
// hbuf @ w2) + b2)) for this block's kFF2Cols output columns.
// ---------------------------------------------------------------------------
size_t ff2_smem_bytes(int hid4) {
  return sizeof(float) * (kBG * hid4 + kBG * kThreads * 2 + kBG * kFF2Cols);
}

__global__ void ff2_kernel(const bf16* __restrict__ hbuf, const bf16* __restrict__ ff_w2,
                           const float* __restrict__ ff_b2, bf16* __restrict__ out, int b,
                           int dim, int hid4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);   // [kBG][hid4]
  float* red = hs + kBG * hid4;                     // [kBG * kThreads * 2]
  float* os = red + kBG * kThreads * 2;             // [kBG][kFF2Cols]
  const int tid = threadIdx.x, c0 = blockIdx.x * kFF2Cols;

  for (int b0 = 0; b0 < b; b0 += kBG) {
    const int nb = min(kBG, b - b0);
#pragma unroll 4
    for (int i = 8 * tid; i < nb * hid4; i += 8 * blockDim.x) {   // 8 values a load
      const uint4 raw = *reinterpret_cast<const uint4*>(hbuf + (size_t)b0 * hid4 + i);
      const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hp[e]);
        hs[i + 2 * e] = f.x;
        hs[i + 2 * e + 1] = f.y;
      }
    }
    __syncthreads();
    chunk_matvec<kFF2Cols>(hs, hid4, nb, ff_w2, dim, c0, red, os);
    for (int i = tid; i < nb * kFF2Cols; i += blockDim.x) {
      const int bb = i / kFF2Cols, c = c0 + i % kFF2Cols;
      const size_t o = (size_t)(b0 + bb) * dim + c;
      const float ov = round_bf16(round_bf16(os[i]) + round_bf16(ff_b2[c]));
      out[o] = __float2bfloat16(__bfloat162float(out[o]) + ov);
    }
    __syncthreads();
  }
}

cudaError_t set_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int G>
cudaError_t launch_select_emit(const bf16* q, bf16* ckv, bf16* ring, const bf16* kv_new,
                               const bf16* mem_kv, const bf16* pos_kv, const bf16* w1k,
                               const float* b1k, const bf16* w1v, const float* b1v,
                               const bf16* w2, const float* b2, bf16* c_out, int* info,
                               float* partial, int b, int kvh, int Wc, int M, int Bc, int hid,
                               int t, int num_cb, int stride, int sel_block, int num_sel,
                               int n_slide, int max_blocks, int info_width, int emit,
                               float scale, cudaStream_t stream) {
  cudaError_t e;
  const int nchunks = hid / kEmitCols;
  if (emit) {
    const size_t shmem = emit_smem_bytes(Bc);
    if ((e = set_smem((const void*)emit_partial_kernel, shmem)) != cudaSuccess) return e;
    emit_partial_kernel<<<kvh * nchunks, kThreads, shmem, stream>>>(
        ring, kv_new, pos_kv, w1k, b1k, w1v, b1v, w2, partial, b, kvh, Bc, hid, t);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const int Wf = Wc / (sel_block / stride);
  size_t shmem = select_smem_bytes<G>(Wc, M, Wf, kThreads);
  const size_t ring_bytes = (size_t)Bc * 2 * kD * sizeof(bf16);
  if (shmem < ring_bytes) shmem = ring_bytes;
  auto kern = select_emit_kernel<G>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(q, ckv, ring, kv_new, mem_kv, partial, b2, c_out,
                                             info, b, kvh, Wc, M, Bc, nchunks, t, num_cb, emit,
                                             stride, sel_block, num_sel, n_slide, max_blocks,
                                             info_width, scale);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_attend_fused(const bf16* rq, bf16* kv, const bf16* kv_new, const int* info,
                                const bf16* c_out, const bf16* gates, const bf16* x,
                                const bf16* w_out, const float* ff_norm, const bf16* ff_w1,
                                const float* ff_b1, const bf16* ff_w2, const float* ff_b2,
                                float* part, bf16* hbuf, bf16* out, int b, int kvh,
                                int max_len, int dim, int hid4, int t, int sel_block,
                                int window, int num_sel, int n_slide, int info_width,
                                float scale, float eps, cudaStream_t stream) {
  cudaError_t e;
  const int J = (num_sel + n_slide) * sel_block;
  const size_t shmem = attend_smem_bytes<G>(J, kThreads);
  auto kern = attend_fused_kernel<G>;
  if ((e = set_smem((const void*)kern, shmem)) != cudaSuccess) return e;
  kern<<<b * kvh, kThreads, shmem, stream>>>(rq, kv, kv_new, info, c_out, gates, w_out, part,
                                             kvh, max_len, dim, t, sel_block, window, num_sel,
                                             n_slide, info_width, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t shmem1 = ff1_smem_bytes(dim);
  if ((e = set_smem((const void*)resid_ff1_kernel, shmem1)) != cudaSuccess) return e;
  resid_ff1_kernel<<<hid4 ? hid4 / kFF1Cols : 1, kThreads, shmem1, stream>>>(
      x, part, ff_norm, ff_w1, ff_b1, hbuf, out, b, kvh, dim, hid4, eps);
  if ((e = cudaGetLastError()) != cudaSuccess || hid4 == 0) return e;

  const size_t shmem2 = ff2_smem_bytes(hid4);
  if ((e = set_smem((const void*)ff2_kernel, shmem2)) != cudaSuccess) return e;
  ff2_kernel<<<dim / kFF2Cols, kThreads, shmem2, stream>>>(hbuf, ff_w2, ff_b2, out, b, dim, hid4);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// q [b, kvh, G, 64] bf16 (unrotated); ckv [b, kvh, Wc, 128] and ring [b,
// kvh, Bc, 128] bf16 caches (updated in place); kv_new [b, kvh, 1, 128]
// bf16; mem_kv [2, kvh, M, 64] bf16; pos_kv [kvh, Bc, 128] bf16; w1k, w1v
// [kvh, Bc*64, hid] bf16, b1k, b1v [kvh, hid] f32; w2 [kvh, hid, 128] bf16,
// b2 [kvh, 128] f32; partial [kvh, hid/64, b, 128] f32 scratch (emission
// steps) -> c_out [b, kvh, G, 64] bf16, info [b, kvh * info_width] int32.
// Returns the first failing launch's cudaError_t.
extern "C" int nsa_decode_select_emit(
    const void* q, void* ckv, void* ring, const void* kv_new, const void* mem_kv,
    const void* pos_kv, const void* w1k, const void* b1k, const void* w1v, const void* b1v,
    const void* w2, const void* b2, void* c_out, void* info, void* partial, int b, int kvh,
    int G, int Wc, int M, int Bc, int hid, int t, int num_cb, int stride, int sel_block,
    int num_sel, int n_slide, int max_blocks, int info_width, int emit, float scale,
    void* stream) {
  using nsa::bf16;
#define NSA_SELECT_EMIT(GG)                                                                   \
  return (int)nsa::launch_select_emit<GG>(                                                    \
      (const bf16*)q, (bf16*)ckv, (bf16*)ring, (const bf16*)kv_new, (const bf16*)mem_kv,     \
      (const bf16*)pos_kv, (const bf16*)w1k, (const float*)b1k, (const bf16*)w1v,            \
      (const float*)b1v, (const bf16*)w2, (const float*)b2, (bf16*)c_out, (int*)info,        \
      (float*)partial, b, kvh, Wc, M, Bc, hid, t, num_cb, stride, sel_block, num_sel,        \
      n_slide, max_blocks, info_width, emit, scale, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_SELECT_EMIT(1);
    case 2: NSA_SELECT_EMIT(2);
    case 4: NSA_SELECT_EMIT(4);
    case 8: NSA_SELECT_EMIT(8);
  }
#undef NSA_SELECT_EMIT
  return (int)cudaErrorInvalidValue;
}

// rq [b, kvh, G, 64] bf16 (rotated); kv [b, kvh, max_len, 128] bf16 (row t
// written in place); kv_new [b, kvh, 1, 128] bf16 (rotated k || v); info
// [b, kvh * info_width] int32; c_out [b, kvh, G, 64] bf16; gates [b, kvh, G,
// 3] bf16; x [b, 1, dim] bf16; w_out [kvh*G*64, dim] bf16; the FF (null
// pointers and hid4 0 without it): norm [dim] f32, w1 [dim, hid4] bf16, b1
// [hid4] f32, w2 [hid4, dim] bf16, b2 [dim] f32; scratch part [b, kvh, dim]
// f32 and hbuf [b, hid4] bf16 -> out [b, 1, dim] bf16.  Returns the first
// failing launch's cudaError_t.
extern "C" int nsa_decode_attend_fused(
    const void* rq, void* kv, const void* kv_new, const void* info, const void* c_out,
    const void* gates, const void* x, const void* w_out, const void* ff_norm, const void* ff_w1,
    const void* ff_b1, const void* ff_w2, const void* ff_b2, void* part, void* hbuf, void* out,
    int b, int kvh, int G, int max_len, int dim, int hid4, int t, int sel_block, int window,
    int num_sel, int n_slide, int info_width, float scale, float eps, void* stream) {
  using nsa::bf16;
#define NSA_ATTEND_FUSED(GG)                                                                 \
  return (int)nsa::launch_attend_fused<GG>(                                                  \
      (const bf16*)rq, (bf16*)kv, (const bf16*)kv_new, (const int*)info, (const bf16*)c_out, \
      (const bf16*)gates, (const bf16*)x, (const bf16*)w_out, (const float*)ff_norm,        \
      (const bf16*)ff_w1, (const float*)ff_b1, (const bf16*)ff_w2, (const float*)ff_b2,     \
      (float*)part, (bf16*)hbuf, (bf16*)out, b, kvh, max_len, dim, hid4, t, sel_block,       \
      window, num_sel, n_slide, info_width, scale, eps, (cudaStream_t)stream)
  switch (G) {
    case 1: NSA_ATTEND_FUSED(1);
    case 2: NSA_ATTEND_FUSED(2);
    case 4: NSA_ATTEND_FUSED(4);
    case 8: NSA_ATTEND_FUSED(8);
  }
#undef NSA_ATTEND_FUSED
  return (int)cudaErrorInvalidValue;
}

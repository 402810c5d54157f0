// Device code shared by the fused decode kernels (nsa_decode_fused.cu), the
// ragged ones (nsa_decode_ragged.cu) and, for the emitted row and the ring
// shift, the whole-model decode kernel (nsa_decode_mega.cu): the
// small-batch products on the CUDA cores that read a weight matrix once for
// all batch rows, the compressed-block emission, the ring shift, attention
// with the head's share of the output projection, and the FF's two
// products.  Each body is
// one work item of a block of kThreads threads (an item is a block of the
// fused kernels' grids, and one step of the whole-model kernel's grid-stride
// loops), out of the dynamic shared memory it is handed.  The column width
// of each product is a template parameter: the fused kernels and the
// whole-model kernel split the same products over different numbers of
// blocks.  Every sum is taken in a fixed order; there are no atomics.
#pragma once

#include "decode_common.cuh"

namespace nsa {
namespace {

constexpr int kThreads = 256;
constexpr int kBG = 8;            // batch rows per pass over a weight chunk
// weight rows each thread loads before it uses them, so that their
// latencies overlap (in-order execution would otherwise wait out one memory
// latency per row)
constexpr int kLoads = 16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// res[bb][c] = sum_k in[bb][k] * W[k][c0 + c] for bb < nb, c < kCols: in is
// float [kBG][K] in shared memory, W a bf16 [K][N] matrix in global memory
// read once for all rows.  Thread (part, pair) sums rows k = part, part +
// nparts, ... for two adjacent columns, kLoads rows' loads ahead; the parts
// are then added in order.  red holds kBG * kThreads * 2 floats.  Ends with
// a barrier.
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

// RMSNorm of the nb rows of ys [kBG][dim] in place, in float32, rounded to
// bf16: every row's sum of squares, then one pass that scales them all.
// scratch holds 32 floats.  Ends with a barrier.
template <typename T>
__device__ void rms_norm_rows(float* ys, int nb, int dim, const T* __restrict__ scale, float eps,
                              float* scratch) {
  float inv[kBG];
#pragma unroll
  for (int bb = 0; bb < kBG; ++bb) {
    if (bb >= nb) break;                  // nb is the same in every thread
    float ss = 0.f;
    for (int n = threadIdx.x; n < dim; n += blockDim.x) ss += ys[bb * dim + n] * ys[bb * dim + n];
    inv[bb] = rsqrtf(block_reduce<false>(ss, scratch) / dim + eps);
  }
  for (int n = threadIdx.x; n < dim; n += blockDim.x) {
    const float sc = ldf(scale[n]);
#pragma unroll
    for (int bb = 0; bb < kBG; ++bb)
      if (bb < nb) ys[bb * dim + n] = round_bf16(ys[bb * dim + n] * inv[bb] * sc);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The emission, item (KV head h, hidden chunk) = (item / nchunks, item %
// nchunks): for every emitting batch row, the window [t+1-Bc, t+1) — rows
// 1.. of the OLD ring, then the new token's unrotated k || v — zero before
// the sequence start, plus k_pos || v_pos, rounded to bf16 as the cache
// dtype; times this chunk's kCols columns of w1k / w1v, plus b1, relu,
// rounded; times the chunk's kCols rows of w2: partial[h][chunk][b][2kD],
// the chunk's share of the emitted row.  The new token's k half of row (bi,
// h) is at new_k + bi * new_row + h * new_head, its v half likewise at
// new_v.  The emitting rows are all b rows at position t, or, for the
// ragged decode, the `nrows` rows listed in `rows` (shared memory), each at
// its own position tvec[row].
// ---------------------------------------------------------------------------
template <int kCols>
__host__ __device__ size_t emit_smem_bytes(int Bc) {
  return sizeof(float) * (kBG * Bc * kD + kBG * kThreads * 2 + kBG * kCols);
}

// Whether the step at position t, with num_cb compressed rows cached,
// completes a compressed block (JAX's run_fill + 1 == Bc).
__device__ __forceinline__ bool emits_at(int t, int num_cb, int stride) {
  return t - num_cb * stride + 1 == stride;
}

template <int kCols, typename BiasT>
__device__ void emit_partial_body(const bf16* ring, const bf16* new_k, const bf16* new_v,
                                  int new_row, int new_head, const bf16* __restrict__ pos_kv,
                                  const bf16* __restrict__ w1k, const BiasT* __restrict__ b1k,
                                  const bf16* __restrict__ w1v, const BiasT* __restrict__ b1v,
                                  const bf16* __restrict__ w2, float* partial, int b, int kvh,
                                  int Bc, int hid, int t, int item, unsigned char* smem_raw,
                                  const int* rows = nullptr, int nrows = 0,
                                  const int* tvec = nullptr) {
  const int K = Bc * kD;
  float* win = reinterpret_cast<float*>(smem_raw);  // [kBG][K] window, one half
  float* red = win + kBG * K;                       // [kBG * kThreads * 2]
  float* hs = red + kBG * kThreads * 2;             // [kBG][kCols] hidden
  const int nchunks = hid / kCols;
  const int h = item / nchunks, chunk = item % nchunks, c0 = chunk * kCols;
  const int tid = threadIdx.x;
  const int n_emit = rows != nullptr ? nrows : b;

  for (int b0 = 0; b0 < n_emit; b0 += kBG) {
    const int nb = min(kBG, n_emit - b0);
    for (int half = 0; half < 2; ++half) {
      const bf16* nw = (half ? new_v : new_k) + (size_t)h * new_head;
      for (int i0 = tid; i0 < nb * K; i0 += 8 * blockDim.x) {
        float v[8], pos[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {       // all loads first, then the math
          const int i = i0 + u * blockDim.x;
          const int bb = i / K, r = i % K, j = r / kD, e = r % kD;
          const int bi = i >= nb * K ? 0 : rows != nullptr ? rows[b0 + bb] : b0 + bb;
          const int tr = tvec != nullptr ? tvec[bi] : t;
          const size_t bh = (size_t)bi * kvh + h;
          const bool live = i < nb * K && tr + 1 - Bc + j >= 0;
          v[u] = live ? __bfloat162float(j < Bc - 1
                                             ? ring[(bh * Bc + j + 1) * 2 * kD + half * kD + e]
                                             : nw[(size_t)bi * new_row + e])
                      : 0.f;
          pos[u] = i < nb * K
                       ? __bfloat162float(pos_kv[((size_t)h * Bc + j) * 2 * kD + half * kD + e])
                       : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * blockDim.x;
          if (i < nb * K) win[i] = round_bf16(v[u] + pos[u]);
        }
      }
      __syncthreads();
      const bf16* w1 = (half ? w1v : w1k) + (size_t)h * K * hid;
      const BiasT* b1 = (half ? b1v : b1k) + (size_t)h * hid;
      chunk_matvec<kCols>(win, K, nb, w1, hid, c0, red, hs);
      for (int i = tid; i < nb * kCols; i += blockDim.x)
        hs[i] = round_bf16(fmaxf(hs[i] + ldf(b1[c0 + i % kCols]), 0.f));
      __syncthreads();
      // this chunk's share of the second layer, for this half's kD outputs
      for (int i = tid; i < nb * kD; i += blockDim.x) {
        const int bb = i / kD, e = i % kD;
        const int bi = rows != nullptr ? rows[b0 + bb] : b0 + bb;
        const bf16* w = w2 + ((size_t)h * hid + c0) * 2 * kD + half * kD + e;
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < kCols; ++c) s += hs[bb * kCols + c] * __bfloat162float(w[(size_t)c * 2 * kD]);
        partial[(((size_t)h * nchunks + chunk) * b + bi) * 2 * kD + half * kD + e] = s;
      }
      __syncthreads();             // win and hs are rewritten next
    }
  }
}

// The emitted row of (batch row bi, KV head h): the nchunks partials in
// chunk order, plus b2, rounded to bf16, into `row`.
template <typename BiasT>
__device__ void emit_row_body(const float* partial, const BiasT* __restrict__ b2, bf16* row,
                              int nchunks, int b, int bi, int h) {
  for (int e = threadIdx.x; e < 2 * kD; e += blockDim.x) {
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c) s += partial[(((size_t)h * nchunks + c) * b + bi) * 2 * kD + e];
    row[e] = __float2bfloat16(s + ldf(b2[h * 2 * kD + e]));
  }
}

// The ring shift of one (batch row, KV head): rows 1.. of `rg` [Bc][2kD]
// move down one and the new token's unrotated k || v (`new_row`, 2kD values)
// becomes the last; every source row is read into shared memory before any
// is written.  Ends with a barrier.
__device__ void ring_shift_body(bf16* rg, const bf16* new_row, int Bc, unsigned char* smem_raw) {
  constexpr int kVec = 2 * kD / 8;            // 16-byte vectors per packed row
  uint4* stage = reinterpret_cast<uint4*>(smem_raw);
  for (int i = threadIdx.x; i < Bc * kVec; i += blockDim.x) {
    const int j = i / kVec, c = i % kVec;
    const bf16* src = j < Bc - 1 ? rg + (size_t)(j + 1) * 2 * kD : new_row;
    stage[i] = reinterpret_cast<const uint4*>(src)[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Bc * kVec; i += blockDim.x)
    reinterpret_cast<uint4*>(rg)[i] = stage[i];
  __syncthreads();
}

// Attention of item bh = (batch row, KV head) with the head's share of the
// output projection: writes the new token's row (kv_new + bh * 2kD, rotated
// k || v) into row t of the kv cache (`kv`: DenseRows or PagedRows), runs
// attend_body with row t staged from it, rounds the combined output to bf16
// and multiplies it by the head's rows of w_out: part[bh][dim] in float32.
template <int G, typename Rows>
__device__ void attend_out_body(const bf16* rq, const Rows kv, const bf16* kv_new,
                                const int* info, const bf16* c_out, const bf16* gates,
                                const bf16* __restrict__ w_out, float* part, int kvh, int dim,
                                int t, int sel_block, int window, int num_sel, int n_slide,
                                int info_width, float scale, int bh, unsigned char* smem_raw) {
  constexpr int outs = G * kD;
  const int h = bh % kvh;
  const bf16* row_t = kv_new + (size_t)bh * 2 * kD;
  if (threadIdx.x < 2 * kD / 8)    // the new token's row, written in place
    reinterpret_cast<uint4*>(kv.row(bh, t))[threadIdx.x] =
        reinterpret_cast<const uint4*>(row_t)[threadIdx.x];
  float* comb = attend_body<G>(rq, kv, info, c_out, gates, row_t, t, sel_block, window, num_sel,
                               n_slide, info_width, scale, bh, smem_raw);
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
  __syncthreads();                 // comb is shared memory the next item reuses
}

// ---------------------------------------------------------------------------
// The residual and the FF's first product, item = kCols FF hidden columns:
// y = round(x + sum_h part[h]) (the heads in order, in float32), written to
// y_out when it is not null; with the FF (hid4 > 0), hbuf = gelu(round(round(
// norm(y) @ w1) + round(b1))) for this item's columns, the exact erf GELU.
// ---------------------------------------------------------------------------
template <int kCols>
size_t ff1_smem_bytes(int dim) {
  return sizeof(float) * (kBG * dim + kBG * kThreads * 2 + kBG * kCols + 32);
}

template <int kCols, typename T>
__device__ void resid_ff1_body(const bf16* x, const float* part, const T* __restrict__ ff_norm,
                               const bf16* __restrict__ ff_w1, const T* __restrict__ ff_b1,
                               bf16* hbuf, bf16* y_out, int b, int kvh, int dim, int hid4,
                               float eps, int item, unsigned char* smem_raw) {
  float* ys = reinterpret_cast<float*>(smem_raw);   // [kBG][dim]
  float* red = ys + kBG * dim;                      // [kBG * kThreads * 2]
  float* hs = red + kBG * kThreads * 2;             // [kBG][kCols]
  float* scratch = hs + kBG * kCols;                // [32]
  const int tid = threadIdx.x, c0 = item * kCols;

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
        if (y_out != nullptr) y_out[(size_t)b0 * dim + i] = __float2bfloat16(y[u]);
      }
    }
    if (hid4 == 0) continue;
    __syncthreads();
    rms_norm_rows(ys, nb, dim, ff_norm, eps, scratch);
    chunk_matvec<kCols>(ys, dim, nb, ff_w1, hid4, c0, red, hs);
    for (int i = tid; i < nb * kCols; i += blockDim.x) {
      const int bb = i / kCols, c = c0 + i % kCols;
      const float hv = round_bf16(round_bf16(hs[i]) + round_bf16(ldf(ff_b1[c])));
      const float g = 0.5f * hv * (1.f + erff(hv * 0.7071067811865476f));
      hbuf[(size_t)(b0 + bb) * hid4 + c] = __float2bfloat16(g);
    }
    __syncthreads();               // ys, red and hs are rewritten next
  }
  __syncthreads();                 // ys is shared memory the next item reuses
}

// ---------------------------------------------------------------------------
// The FF's second product, item = kCols output columns: out = round(y +
// round(round(hbuf @ w2) + round(b2))) with y read from y_in (out itself
// in the fused kernels, which wrote y there).
// ---------------------------------------------------------------------------
template <int kCols>
size_t ff2_smem_bytes(int hid4) {
  return sizeof(float) * (kBG * hid4 + kBG * kThreads * 2 + kBG * kCols);
}

template <int kCols, typename T>
__device__ void ff2_body(const bf16* hbuf, const bf16* __restrict__ ff_w2,
                         const T* __restrict__ ff_b2, const bf16* y_in, bf16* out, int b, int dim,
                         int hid4, int item, unsigned char* smem_raw) {
  float* hs = reinterpret_cast<float*>(smem_raw);   // [kBG][hid4]
  float* red = hs + kBG * hid4;                     // [kBG * kThreads * 2]
  float* os = red + kBG * kThreads * 2;             // [kBG][kCols]
  const int tid = threadIdx.x, c0 = item * kCols;

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
    chunk_matvec<kCols>(hs, hid4, nb, ff_w2, dim, c0, red, os);
    for (int i = tid; i < nb * kCols; i += blockDim.x) {
      const int bb = i / kCols, c = c0 + i % kCols;
      const size_t o = (size_t)(b0 + bb) * dim + c;
      const float ov = round_bf16(round_bf16(os[i]) + round_bf16(ldf(ff_b2[c])));
      out[o] = __float2bfloat16(__bfloat162float(y_in[o]) + ov);
    }
    __syncthreads();
  }
}

cudaError_t set_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// The per-layer kernels' tail after attention (decode_attend_fused and its
// ragged and paged variants): launch 2, one block per kFF1Cols FF hidden
// columns (one block without the FF), adds x and the heads' partials in
// head order in float32 and rounds once (y); block 0 writes y to out; with
// the FF it runs the FF's first product into hbuf.  Launch 3, one block per
// kFF2Cols output columns: the FF's second product, + b2 + y, into out.
// ---------------------------------------------------------------------------
constexpr int kFF1Cols = 64;      // FF hidden columns per block
constexpr int kFF2Cols = 16;      // output columns per block of the FF's second product

__global__ void resid_ff1_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                                 const float* __restrict__ ff_norm, const bf16* __restrict__ ff_w1,
                                 const float* __restrict__ ff_b1, bf16* __restrict__ hbuf,
                                 bf16* __restrict__ out, int b, int kvh, int dim, int hid4,
                                 float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  resid_ff1_body<kFF1Cols>(x, part, ff_norm, ff_w1, ff_b1, hbuf, blockIdx.x == 0 ? out : nullptr,
                           b, kvh, dim, hid4, eps, blockIdx.x, smem_raw);
}

__global__ void ff2_kernel(const bf16* __restrict__ hbuf, const bf16* __restrict__ ff_w2,
                           const float* __restrict__ ff_b2, bf16* out, int b, int dim, int hid4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ff2_body<kFF2Cols>(hbuf, ff_w2, ff_b2, out, out, b, dim, hid4, blockIdx.x, smem_raw);
}

cudaError_t launch_resid_ff(const bf16* x, const float* part, const float* ff_norm,
                            const bf16* ff_w1, const float* ff_b1, const bf16* ff_w2,
                            const float* ff_b2, bf16* hbuf, bf16* out, int b, int kvh, int dim,
                            int hid4, float eps, cudaStream_t stream) {
  cudaError_t e;
  const size_t shmem1 = ff1_smem_bytes<kFF1Cols>(dim);
  if ((e = set_smem((const void*)resid_ff1_kernel, shmem1)) != cudaSuccess) return e;
  resid_ff1_kernel<<<hid4 ? hid4 / kFF1Cols : 1, kThreads, shmem1, stream>>>(
      x, part, ff_norm, ff_w1, ff_b1, hbuf, out, b, kvh, dim, hid4, eps);
  if ((e = cudaGetLastError()) != cudaSuccess || hid4 == 0) return e;

  const size_t shmem2 = ff2_smem_bytes<kFF2Cols>(hid4);
  if ((e = set_smem((const void*)ff2_kernel, shmem2)) != cudaSuccess) return e;
  ff2_kernel<<<dim / kFF2Cols, kThreads, shmem2, stream>>>(hbuf, ff_w2, ff_b2, out, b, dim, hid4);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

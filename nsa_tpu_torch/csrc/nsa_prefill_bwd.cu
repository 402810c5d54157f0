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
// What the design does about it: like the forward (csrc/nsa_prefill.cu), it
// visits only the keys each row needs, not the causal triangle the TPU
// kernels scan with masks (~13x the work at n 4096).
//
// * bwd_dq_kernel: one warp per (batch, KV head, query row), the forward's
//   layout; the G heads share every key load.  It recomputes p from the
//   saved LSEs, one key per lane; dq is accumulated with dS broadcast by
//   shuffle and k read 128 bytes per warp; d_gates is reduced per fine block
//   with warp sums (a fixed order) and handed to every valid slot that names
//   the block.  It also writes both deltas (rowsum(o * do)), which the
//   dkv kernel reads, so no separate elementwise pass is needed.  The row
//   owns all its outputs: no atomics.
// * bwd_dkv_kernel: one block of 4 warps per (batch, KV head, tile of 16
//   keys), design (b) of the port's plan, deterministic.  A key is read by
//   the band rows [k, k + window], by the later rows of its own block, and
//   by every row that selected its block.  The block walks the rows from
//   the tile on, 32 at a time per warp, keeping the band rows and the rows
//   whose selection or own block touches the tile (a ballot over the rows'
//   selections, read from L2: the inverted list is built on the fly, with no
//   pre-pass).  Per row, lane (key j, head group) holds key j's k and v rows
//   in registers and computes s, p and dS for both branches; then every lane
//   owns two of the 64 dims and accumulates dk, dv for the 16 keys.  The four
//   warps' sums are added in a fixed order in shared memory.  Load is uneven:
//   a block that many rows select (a "sink") walks more rows.
// No tensor cores: this is the simple first version.
#include "common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;
constexpr int kWarps = 4;          // rows (dq) or row streams (dkv) per block
constexpr int kMaxSel = 16;        // selected blocks per row the kernels take
constexpr int kTile = 16;          // keys per dkv block

// One chunk of up to 32 keys of one branch, key `pos` on this lane: dS for
// the G heads, dq += dS k (this lane's two dims); returns sum_g dS_g * s_g.
template <int G>
__device__ __forceinline__ float chunk_grad(const float* qs, const float* dos,
                                            const bf16* kbase, const bf16* vbase, int pos,
                                            bool valid, const float* lse, const float* del,
                                            float (*acc)[2], int lane) {
  float dS[G];
  float gsum = 0.f;
  if (valid) {
    float s[G], dp[G];
    dot_heads<G, kD>(qs, kbase + (size_t)pos * kD, s);
    dot_heads<G, kD>(dos, vbase + (size_t)pos * kD, dp);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = expf(fminf(s[g] - lse[g], 30.f));
      dS[g] = p * (dp[g] - del[g]);
      gsum += dS[g] * s[g];
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) dS[g] = 0.f;
  }
  unsigned rem = __ballot_sync(kFull, valid);
  while (rem) {
    const int j = __ffs(rem) - 1;
    rem &= rem - 1;
    const int pj = __shfl_sync(kFull, pos, j);
    const float2 k = load_bf16x2(kbase + (size_t)pj * kD + 2 * lane);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = __shfl_sync(kFull, dS[g], j);
      acc[g][0] += w * k.x;
      acc[g][1] += w * k.y;
    }
  }
  return gsum;
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dq_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ rk,
              const bf16* __restrict__ v, const int* __restrict__ sel_idx,
              const uint8_t* __restrict__ sel_mask, const bf16* __restrict__ fo,
              const bf16* __restrict__ so, const float* __restrict__ flse,
              const float* __restrict__ slse, const bf16* __restrict__ dfo,
              const bf16* __restrict__ dso, bf16* __restrict__ dq, float* __restrict__ dgates,
              float* __restrict__ fdel, float* __restrict__ sdel, long long rows, int n, int S,
              int sel_block, int window, float scale) {
  __shared__ __align__(16) float qs_all[kWarps][G * kD];   // scale * q
  __shared__ __align__(16) float fd_all[kWarps][G * kD];   // dfo
  __shared__ __align__(16) float sd_all[kWarps][G * kD];   // dso
  __shared__ int blk_all[kWarps][kMaxSel + 2];              // blocks, then their count
  __shared__ float tot_all[kWarps][kMaxSel + 1];            // per block: sum dS_fine * s
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wid = (long long)blockIdx.x * kWarps + warp;
  if (wid >= rows) return;         // uniform over the warp
  const int i = (int)(wid % n);
  const long long bh = wid / n;    // b * kvh + kv head
  float* qs = qs_all[warp];
  float* fd = fd_all[warp];
  float* sd = sd_all[warp];
  int* blk = blk_all[warp];
  float* tot = tot_all[warp];

  const size_t head0 = (size_t)bh * G;
  float f_lse[G], s_lse[G], f_del[G], s_del[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t row = (head0 + g) * n + i;
    const size_t off = row * kD + 2 * lane;
    const float2 q2 = load_bf16x2(rq + off);
    const float2 df = load_bf16x2(dfo + off);
    const float2 ds = load_bf16x2(dso + off);
    const float2 o1 = load_bf16x2(fo + off);
    const float2 o2 = load_bf16x2(so + off);
    qs[g * kD + 2 * lane] = q2.x * scale;
    qs[g * kD + 2 * lane + 1] = q2.y * scale;
    fd[g * kD + 2 * lane] = df.x;
    fd[g * kD + 2 * lane + 1] = df.y;
    sd[g * kD + 2 * lane] = ds.x;
    sd[g * kD + 2 * lane + 1] = ds.y;
    f_del[g] = warp_sum(o1.x * df.x + o1.y * df.y);
    s_del[g] = warp_sum(o2.x * ds.x + o2.y * ds.y);
    f_lse[g] = flse[row];
    s_lse[g] = slse[row];
    if (lane == 0) {
      fdel[row] = f_del[g];
      sdel[row] = s_del[g];
    }
  }
  // the row's fine blocks: valid selections, each once, then the diagonal
  const int q_blk = i / sel_block;
  const int* idx = sel_idx + ((size_t)bh * n + i) * S;
  const uint8_t* msk = sel_mask + ((size_t)bh * n + i) * S;
  if (lane == 0) {
    int nb = 0;
    for (int s = 0; s < S; ++s) {
      if (!msk[s] || idx[s] == q_blk) continue;
      bool dup = false;
      for (int r = 0; r < nb; ++r) dup |= blk[r] == idx[s];
      if (!dup) blk[nb++] = idx[s];
    }
    blk[nb++] = q_blk;
    blk[kMaxSel + 1] = nb;
  }
  if (lane <= kMaxSel) tot[lane] = 0.f;
  __syncwarp();

  const bf16* kbase = rk + (size_t)bh * n * kD;
  const bf16* vbase = v + (size_t)bh * n * kD;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  const int nb = blk[kMaxSel + 1];
  const int n_fine = nb * sel_block;
  for (int c0 = 0; c0 < n_fine; c0 += 32) {
    const int kk = c0 + lane;
    const int pos = kk < n_fine ? blk[kk / sel_block] * sel_block + kk % sel_block : 0;
    const float gs = chunk_grad<G>(qs, fd, kbase, vbase, pos,
                                   kk < n_fine && pos >= 0 && pos <= i, f_lse, f_del, acc,
                                   lane);
    const int b_hi = min(c0 + 31, n_fine - 1) / sel_block;
    for (int bi = c0 / sel_block; bi <= b_hi; ++bi) {
      const float t = warp_sum(kk / sel_block == bi ? gs : 0.f);
      if (lane == 0) tot[bi] += t;
    }
  }
  const int lo = max(0, i - window);
  for (int c0 = lo; c0 <= i; c0 += 32) {
    const int pos = c0 + lane;
    chunk_grad<G>(qs, sd, kbase, vbase, pos, pos <= i, s_lse, s_del, acc, lane);
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
    store_bf16x2(dq + ((head0 + g) * n + i) * kD + 2 * lane, acc[g][0] * scale,
                 acc[g][1] * scale);
  __syncwarp();
  if (lane < S) {
    float val = 0.f;
    if (msk[lane]) {
      for (int r = 0; r < nb; ++r)
        if (blk[r] == idx[lane]) val = tot[r];
    }
    dgates[((size_t)bh * n + i) * S + lane] = val;
  }
}

// s = q.k for 64 dims: q in shared memory (float, 16-byte aligned), k as 64
// bf16 in registers.
__device__ __forceinline__ float dot_reg(const float* q, const uint4* k) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kD / 8; ++u) {
    const float4 a = *reinterpret_cast<const float4*>(q + 8 * u);
    const float4 b = *reinterpret_cast<const float4*>(q + 8 * u + 4);
    const float2 k0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k[u].x));
    const float2 k1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k[u].y));
    const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k[u].z));
    const float2 k3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k[u].w));
    s += a.x * k0.x + a.y * k0.y + a.z * k1.x + a.w * k1.y + b.x * k2.x + b.y * k2.y +
         b.z * k3.x + b.w * k3.y;
  }
  return s;
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32)
bwd_dkv_kernel(const bf16* __restrict__ rq, const bf16* __restrict__ rk,
               const bf16* __restrict__ v, const int* __restrict__ sel_idx,
               const uint8_t* __restrict__ sel_mask, const float* __restrict__ flse,
               const float* __restrict__ slse, const float* __restrict__ fdel,
               const float* __restrict__ sdel, const bf16* __restrict__ dfo,
               const bf16* __restrict__ dso, bf16* __restrict__ dk, bf16* __restrict__ dv,
               int n, int n_tiles, int S, int sel_block, int window, float scale) {
  __shared__ __align__(16) float q_all[kWarps][G * kD];    // scale * q of the row
  __shared__ __align__(16) float fd_all[kWarps][G * kD];   // dfo
  __shared__ __align__(16) float sd_all[kWarps][G * kD];   // dso
  __shared__ float pf_all[kWarps][G][kTile];               // p_fine per (head, key)
  __shared__ float ps_all[kWarps][G][kTile];               // p_slide
  __shared__ float ds_all[kWarps][G][kTile];               // dS_fine + dS_slide
  __shared__ int sel_all[kWarps][kMaxSel];                 // the row's valid blocks, -1 else
  __shared__ float red[kTile][kD];                         // cross-warp sum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = (blockIdx.x % n_tiles) * kTile;
  const long long bh = blockIdx.x / n_tiles;
  const size_t head0 = (size_t)bh * G;
  float* qs = q_all[warp];
  float* fd = fd_all[warp];
  float* sd = sd_all[warp];
  int* sel = sel_all[warp];

  // dot phase layout: lane = (head group hg, key j); its key's rows in registers
  const int j = lane & (kTile - 1), hg = lane >> 4;
  const int kpos = t0 + j;
  const bool key_in = kpos < n;
  const int kblk = kpos / sel_block;
  uint4 kr[kD / 8], vr[kD / 8];
#pragma unroll
  for (int u = 0; u < kD / 8; ++u) {
    kr[u] = key_in ? reinterpret_cast<const uint4*>(rk + ((size_t)bh * n + kpos) * kD)[u]
                   : make_uint4(0, 0, 0, 0);
    vr[u] = key_in ? reinterpret_cast<const uint4*>(v + ((size_t)bh * n + kpos) * kD)[u]
                   : make_uint4(0, 0, 0, 0);
  }
  const int blk_lo = t0 / sel_block, blk_hi = min(t0 + kTile - 1, n - 1) / sel_block;
  const int band_end = min(n - 1, t0 + kTile - 1 + window);  // last row whose band meets the tile

  // accumulation layout: lane owns dims 2*lane, 2*lane+1 of the 16 keys
  float dk_acc[kTile][2], dv_acc[kTile][2];
#pragma unroll
  for (int t = 0; t < kTile; ++t) dk_acc[t][0] = dk_acc[t][1] = dv_acc[t][0] = dv_acc[t][1] = 0.f;

  // this warp's rows: t0 + warp + 4 * (32 c + lane), c = 0, 1, ...
  for (int first = t0 + warp; first < n; first += kWarps * 32) {
    const int r = first + kWarps * lane;
    bool cand = false;
    if (r < n) {
      const int qb = r / sel_block;
      cand = r <= band_end || (qb >= blk_lo && qb <= blk_hi);
      const int* ri = sel_idx + ((size_t)bh * n + r) * S;
      const uint8_t* rm = sel_mask + ((size_t)bh * n + r) * S;
      for (int s = 0; s < S && !cand; ++s) cand = rm[s] && ri[s] >= blk_lo && ri[s] <= blk_hi;
    }
    unsigned todo = __ballot_sync(kFull, cand);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int row = first + kWarps * src;
      const bool band_row = row <= band_end;
      // the row's q (scaled), dfo, dso: smem for the dots, registers for the sums
      float qv[G][2], fv[G][2], sv[G][2];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const size_t off = ((head0 + g) * n + row) * kD + 2 * lane;
        const float2 q2 = load_bf16x2(rq + off);
        const float2 f2 = load_bf16x2(dfo + off);
        const float2 s2 = band_row ? load_bf16x2(dso + off) : make_float2(0.f, 0.f);
        qv[g][0] = q2.x * scale;
        qv[g][1] = q2.y * scale;
        fv[g][0] = f2.x;
        fv[g][1] = f2.y;
        sv[g][0] = s2.x;
        sv[g][1] = s2.y;
        qs[g * kD + 2 * lane] = qv[g][0];
        qs[g * kD + 2 * lane + 1] = qv[g][1];
        fd[g * kD + 2 * lane] = fv[g][0];
        fd[g * kD + 2 * lane + 1] = fv[g][1];
        sd[g * kD + 2 * lane] = sv[g][0];
        sd[g * kD + 2 * lane + 1] = sv[g][1];
      }
      if (lane < S) {
        const size_t o = ((size_t)bh * n + row) * S + lane;
        sel[lane] = sel_mask[o] ? sel_idx[o] : -1;
      }
      __syncwarp();
      const int qb = row / sel_block;
      bool hit = kblk == qb;
      for (int s = 0; s < S; ++s) hit |= sel[s] == kblk;
      const bool fine_ok = key_in && kpos <= row && hit;
      const bool slide_ok = key_in && kpos <= row && row - kpos <= window;
      for (int g = hg; g < G; g += 2) {
        const size_t rg = (head0 + g) * n + row;
        float pf = 0.f, ps = 0.f, dsum = 0.f;
        if (fine_ok || slide_ok) {
          const float s = dot_reg(qs + g * kD, kr);
          if (fine_ok) {
            pf = expf(fminf(s - flse[rg], 30.f));
            dsum += pf * (dot_reg(fd + g * kD, vr) - fdel[rg]);
          }
          if (slide_ok) {
            ps = expf(fminf(s - slse[rg], 30.f));
            dsum += ps * (dot_reg(sd + g * kD, vr) - sdel[rg]);
          }
        }
        pf_all[warp][g][j] = pf;
        ps_all[warp][g][j] = ps;
        ds_all[warp][g][j] = dsum;
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pf = pf_all[warp][g][t], ps = ps_all[warp][g][t];
          const float d = ds_all[warp][g][t];
          dv_acc[t][0] += pf * fv[g][0] + ps * sv[g][0];
          dv_acc[t][1] += pf * fv[g][1] + ps * sv[g][1];
          dk_acc[t][0] += d * qv[g][0];
          dk_acc[t][1] += d * qv[g][1];
        }
      }
      __syncwarp();   // the next row overwrites this warp's shared rows
    }
  }

  // the four warps' sums, added in a fixed order; dk first, then dv
  for (int which = 0; which < 2; ++which) {
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const float a = which ? dv_acc[t][0] : dk_acc[t][0];
          const float b = which ? dv_acc[t][1] : dk_acc[t][1];
          red[t][2 * lane] = w ? red[t][2 * lane] + a : a;
          red[t][2 * lane + 1] = w ? red[t][2 * lane + 1] + b : b;
        }
      }
      __syncthreads();
    }
    bf16* out = which ? dv : dk;
    for (int e = threadIdx.x; e < kTile * kD / 2; e += kWarps * 32) {
      const int t = e / (kD / 2), c = 2 * (e % (kD / 2));
      if (t0 + t < n)
        store_bf16x2(out + ((size_t)bh * n + t0 + t) * kD + c, red[t][c], red[t][c + 1]);
    }
    __syncthreads();
  }
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
  const long long rows = (long long)b * kvh * n;
  const unsigned blocks = (unsigned)((rows + nsa::kWarps - 1) / nsa::kWarps);
  const cudaStream_t st = (cudaStream_t)stream;
  typedef const nsa::bf16* B;
#define NSA_BWD_DQ(GG)                                                                     \
  nsa::bwd_dq_kernel<GG><<<blocks, nsa::kWarps * 32, 0, st>>>(                             \
      (B)rq, (B)rk, (B)v, (const int*)sel_idx, (const uint8_t*)sel_mask, (B)fo, (B)so,     \
      (const float*)flse, (const float*)slse, (B)dfo, (B)dso, (nsa::bf16*)dq,              \
      (float*)dgates, (float*)fdel, (float*)sdel, rows, n, S, sel_block, window, scale);   \
  return (int)cudaGetLastError()
  switch (G) {
    case 1: NSA_BWD_DQ(1);
    case 2: NSA_BWD_DQ(2);
    case 4: NSA_BWD_DQ(4);
    case 8: NSA_BWD_DQ(8);
  }
#undef NSA_BWD_DQ
  return (int)cudaErrorInvalidValue;
}

// fdel, sdel from nsa_prefill_bwd_dq; the rest as there -> dk, dv
// [b, kvh, n, 64] bf16.
extern "C" int nsa_prefill_bwd_dkv(const void* rq, const void* rk, const void* v,
                                   const void* sel_idx, const void* sel_mask, const void* flse,
                                   const void* slse, const void* fdel, const void* sdel,
                                   const void* dfo, const void* dso, void* dk, void* dv, int b,
                                   int kvh, int G, int n, int S, int sel_block, int window,
                                   float scale, void* stream) {
  if (S > nsa::kMaxSel) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + nsa::kTile - 1) / nsa::kTile;
  const unsigned blocks = (unsigned)((long long)b * kvh * n_tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  typedef const nsa::bf16* B;
#define NSA_BWD_DKV(GG)                                                                    \
  nsa::bwd_dkv_kernel<GG><<<blocks, nsa::kWarps * 32, 0, st>>>(                            \
      (B)rq, (B)rk, (B)v, (const int*)sel_idx, (const uint8_t*)sel_mask,                   \
      (const float*)flse, (const float*)slse, (const float*)fdel, (const float*)sdel,      \
      (B)dfo, (B)dso, (nsa::bf16*)dk, (nsa::bf16*)dv, n, n_tiles, S, sel_block, window,    \
      scale);                                                                              \
  return (int)cudaGetLastError()
  switch (G) {
    case 1: NSA_BWD_DKV(1);
    case 2: NSA_BWD_DKV(2);
    case 4: NSA_BWD_DKV(4);
    case 8: NSA_BWD_DKV(8);
  }
#undef NSA_BWD_DKV
  return (int)cudaErrorInvalidValue;
}

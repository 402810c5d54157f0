// Causal (or not) GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel nsa_tpu/ops/pallas/flash.py::flash_attention
// (:185, pallas_call :248; bodies _flash_kernel :44, _flash_kernel_stream
// :105), the attention of the full-attention baseline model's prefill and
// forward.  q [b, h, n, 64], k / v [b, kvh, n_k, 64] bf16 -> o [b, h, n, 64]
// bf16; query row r sits at key position r; the online softmax keeps the
// logits, the running max and sum and the accumulator in float32, masked
// columns get exactly zero weight, the row sum is clamped at 1e-30.
//
// What bounds it on this card: operations.  Causal at n = n_k, each
// (row, key <= row, head) costs 4 * 64 FLOPs (q.k and p.v): at b 64, h 8,
// n 3900 that is ~1.0e12 FLOPs, ~1.0 ms at the 989 TFLOP/s bf16 peak,
// against ~0.77 GB of q, k, v and o, 0.23 ms at 3.35 TB/s.  So the products
// have to run on the tensor cores.
// What the design does about it: one block per (batch, KV head, 64-row
// query tile) serves all G query heads of the KV head (4 warps a head, 16
// rows a warp) from one shared-memory copy of each K/V tile, so K/V are read
// from L2/HBM once per G heads.  Q . K^T and P . V are mma.sync m16n8k16
// bf16 products with float32 accumulators; the warp keeps its q fragments,
// the 16 x 64 logits and the 16 x 64 accumulator in registers, and the
// logits' accumulator layout is reused as the A operand of P . V (P rounded
// to bf16 there: the one place it departs from the TPU kernel, which keeps
// P float32; the plain version keeps it float32 too).  K/V tiles of 64 keys
// come in with cp.async, double-buffered, rows padded to 144 bytes so the
// ldmatrix reads are free of bank conflicts.  Causal blocks stop their key
// loop at the diagonal tile and mask only the diagonal and the ragged last
// tile; the ragged edges (n = 3900 is no multiple of 64) are masked in the
// kernel, nothing is padded in memory.  The late query tiles, which carry
// the most keys, get the lowest block ids so they start first.  The TPU
// kernel's streaming variant (k || v packed on the lane dim for n_k >= 8192)
// only chose where K/V live in VMEM; this kernel streams K/V tiles through
// shared memory at every length, so one kernel covers both.  No wgmma/TMA:
// this is the simple first version.
#include "common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;          // head dim
constexpr int kBq = 64;         // query rows a block, per head
constexpr int kBk = 64;         // keys a tile
constexpr int kLd = kD + 8;     // shared-memory row stride in bf16: 144 bytes

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Rows k0 .. k0 + kBk - 1 of one head's [n_k, kD] keys or values into a
// [kBk][kLd] tile; rows at or past n_k are zeroed (their weights are zero,
// and zero times zero stays finite).
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int k0, int n_k) {
  for (int c = threadIdx.x; c < kBk * (kD / 8); c += blockDim.x) {
    const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    bf16* dst = tile + r * kLd + col;
    if (k0 + r < n_k) {
      cp_async16(dst, src + (size_t)(k0 + r) * kD + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One block: query tile qt of KV head bh (= batch * kvh + head) for its G
// query heads; warp w serves head w / 4, rows 16 * (w % 4) .. + 15 of the
// tile.  In the mma fragments lane = 4 * grp + tq owns rows grp and grp + 8
// of the warp's 16 and columns 2 * tq, 2 * tq + 1 of every 8-wide tile.
template <int G>
__global__ void __launch_bounds__(128 * G)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int bkvh, int n, int n_k,
                     int num_qt, int causal, float scale) {
  __shared__ __align__(16) bf16 ks[2][kBk * kLd];
  __shared__ __align__(16) bf16 vs[2][kBk * kLd];
  const int qt = num_qt - 1 - (int)(blockIdx.x / bkvh);      // heavy tiles first
  const int bh = (int)(blockIdx.x % bkvh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int r0 = qt * kBq + (warp & 3) * 16;                  // the warp's first row
  const size_t qo = ((size_t)bh * G + (warp >> 2)) * n * kD;  // its query head
  const bf16* kh = k + (size_t)bh * n_k * kD;
  const bf16* vh = v + (size_t)bh * n_k * kD;

  // q fragments for the four 16-wide steps over the head dim; rows past n are 0
  uint32_t qf[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + grp + (r & 1) * 8, col = s * 16 + 2 * tq + (r >> 1) * 8;
      qf[s][r] = row < n ? *reinterpret_cast<const uint32_t*>(q + qo + (size_t)row * kD + col)
                         : 0u;
    }
  }

  const int num_kb = (n_k + kBk - 1) / kBk;
  const int live = causal ? min(num_kb, ((qt + 1) * kBq + kBk - 1) / kBk) : num_kb;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  if (live > 0) {
    load_tile(ks[0], kh, 0, n_k);
    load_tile(vs[0], vh, 0, n_k);
  }
  cp_async_commit();
  for (int j = 0; j < live; ++j) {
    const int buf = j & 1;
    if (j + 1 < live) {
      load_tile(ks[buf ^ 1], kh, (j + 1) * kBk, n_k);
      load_tile(vs[buf ^ 1], vh, (j + 1) * kBk, n_k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q . K^T for the warp's 16 rows and the tile's 64 keys
    float s[kBk / 8][4];
#pragma unroll
    for (int t = 0; t < kBk / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int st = 0; st < 4; ++st) {
#pragma unroll
      for (int np = 0; np < kBk / 16; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, ks[buf] + key * kLd + st * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[st], b);
        mma_bf16(s[2 * np + 1], qf[st], b + 2);
      }
    }

    // online softmax over the tile; mask only the diagonal and ragged tiles
    const int k0 = j * kBk;
    const bool edge = (causal && k0 + kBk - 1 > r0) || k0 + kBk > n_k;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < kBk / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale;
        if (edge) {
          const int key = k0 + t * 8 + 2 * tq + (e & 1), row = r0 + grp + (e >> 1) * 8;
          if (key >= n_k || (causal && key > row)) x = kNeg;
        }
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int t = 0; t < kBk / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // explicit zero under the mask: a row whose max is still kNeg would
        // otherwise give exp(0) = 1 to a masked column
        const float p = s[t][e] == kNeg ? 0.f : __expf(s[t][e] - m[e >> 1]);
        s[t][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int t = 0; t < kD / 8; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    // acc += P . V: the logits' tiles 2kk, 2kk + 1 are the A operand of the
    // kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, vs[buf] + key * kLd + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b);
        mma_bf16(acc[2 * dp + 1], a, b + 2);
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }

  // the row sums are split over the quad's four lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    const int col = t * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + grp + r * 8;
      if (row < n)
        store_bf16x2(o + qo + (size_t)row * kD + col, acc[t][2 * r] / l[r],
                     acc[t][2 * r + 1] / l[r]);
    }
  }
}

template <int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bkvh, int n,
                   int n_k, int causal, float scale, cudaStream_t stream) {
  const int num_qt = (n + kBq - 1) / kBq;
  const long long blocks = (long long)num_qt * bkvh;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<G><<<(unsigned)blocks, 128 * G, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, bkvh, n, n_k, num_qt, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nsa

// q [b, kvh*G, n, 64] bf16 (the G query heads of a KV head adjacent); k, v
// [b, kvh, n_k, 64] bf16 -> o [b, kvh*G, n, 64] bf16; causal 0 or 1.
extern "C" int nsa_flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                                   int kvh, int G, int n, int n_k, int causal, float scale,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int bkvh = b * kvh;
  switch (G) {
    case 1: return (int)nsa::launch<1>(q, k, v, o, bkvh, n, n_k, causal, scale, s);
    case 2: return (int)nsa::launch<2>(q, k, v, o, bkvh, n, n_k, causal, scale, s);
    case 4: return (int)nsa::launch<4>(q, k, v, o, bkvh, n, n_k, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

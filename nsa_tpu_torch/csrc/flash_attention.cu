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
// against ~0.77 GB of q, k, v and o, 0.23 ms at 3.35 TB/s.  Only wgmma
// reaches the tensor cores' full rate; beside it, the one exponential per
// (row, key) on the SM's 16-a-clock special-function units and the ~5 other
// instructions per (row, key) of the softmax each cost about as much again.
// What the design does about it: one block per (batch, KV head, tile of
// 128 query rows; 64 at G = 4) serves all G query heads of the KV head
// from one shared copy of each K/V tile, so a K/V byte read from L2 serves
// 256 query rows at G = 2, and the block is warp-specialised.  A producer
// warpgroup (its first warp, one lane) issues TMA loads of K and V tiles of
// 64 keys into a ring of kStages stages in the 128-byte swizzle, each
// stage with "full" mbarriers for K and V and an "empty" one the consumers
// release it on; it then gives its registers to the consumers (setmaxnreg).
// Consumer warpgroup c (4 warps, 128 threads) owns 64 rows of one head: it
// keeps Q in registers as the A operand of S = Q.K^T (4 wgmma m64n64k16,
// K's tile K-major in shared memory), runs the online softmax on the
// float32 accumulator in registers in base 2 (the scale folded into one
// FFMA before ex2), rounds P to bf16 there as the A operand of O += P.V
// (4 wgmma m64n64k16, V's MN-major tile under the transpose bit), and
// leaves that P.V running while it issues the next tile's S.  Four
// consumer warpgroups a block keep the tensor cores, the exponentials and
// the issue slots busy in turn.  P's rounding is the one place it departs
// from the TPU kernel, which keeps P float32 (so does the plain version).
// TMA zero-fills the rows past n_k, so no edge is cleared by hand; causal
// blocks stop their key loop at the diagonal tile and mask only the
// diagonal and the ragged last tile.  The blocks of one (batch, KV head)
// are adjacent, so the few KV heads in flight keep their K/V in L2; within
// them the late query tiles, which carry the most keys, start first.
#include "hopper_common.cuh"

namespace nsa {
namespace {

constexpr int kD = 64;          // head dim
constexpr int kBk = 64;         // keys a tile
constexpr int kStages = 4;      // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// Query rows a block takes per head: 128 (two consumer warpgroups a head)
// where that keeps the block within 1024 threads, else 64.
template <int G>
struct Shape {
  static constexpr int kRowGroups = G >= 4 ? 1 : 2;     // 64-row warpgroups a head
  static constexpr int kRows = 64 * kRowGroups;
  static constexpr int kConsumers = G * kRowGroups;     // consumer warpgroups
  static constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer warpgroup
  // Four consumer warpgroups and the producer's put 5 warps on each of the
  // SM's four register files (16,384 each), which caps a launch at 96
  // registers a thread.  The producer warpgroup then gives its registers
  // up (setmaxnreg, a whole warpgroup at a time) and the consumers take
  // them: 4 x 128 x 112 + 128 x 24 stays within the launch's 640 x 96.
  // With fewer warps the launch has enough.
  static constexpr int kConsumerRegs = kConsumers == 4 ? 112 : 0;
};

struct Smem {                   // every tile 1024-byte aligned (the swizzle atom)
  bf16 k[kStages][kBk * kD];
  bf16 v[kStages][kBk * kD];
  uint64_t k_full[kStages], v_full[kStages], empty[kStages];
};

// One box of a 3-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 1024-aligned [rows][64] bf16 tile in
// the 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset),
// the leading byte offset unused under this swizzle, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define NSA_ACC32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define NSA_REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
// d = A . B (accumulate 0) or d += A . B for a 64 x 64 x 16 step, A (bf16
// pairs) in registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NSA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : NSA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d += A . B for a 64 x 64 x 16 step, A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NSA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : NSA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A consumer warpgroup: 64 rows of query head g of the block's tile.
template <int G>
__device__ __forceinline__ void consume(Smem& sm, const bf16* __restrict__ q,
                                        bf16* __restrict__ o, int bh, int qt, int live, int n,
                                        int n_k, bool causal, float scale) {
  using S = Shape<G>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = wg / S::kRowGroups;
  const int grp = lane >> 2, tq = lane & 3;
  const int w0 = qt * S::kRows + (wg % S::kRowGroups) * 64;     // the warpgroup's first row
  const int r0 = w0 + (warp & 3) * 16;                          // the warp's first row
  // the warpgroup's last tile (a causal tile past its rows holds no key)
  const int mine = causal ? min(live, (w0 + 64 + kBk - 1) / kBk) : live;
  const size_t qo = ((size_t)bh * G + g) * n * kD;
  const float sl2 = scale * kLog2e;   // logits in base-2 units

  // Q as the A operand of S = Q . K^T, four 16-deep steps; rows past n are 0
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + grp + (r & 1) * 8, col = kk * 16 + 2 * tq + (r >> 1) * 8;
      qf[kk][r] = row < n ? *reinterpret_cast<const uint32_t*>(q + qo + (size_t)row * kD + col)
                          : 0u;
    }

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[32], sc[32];
  uint32_t p[kBk / 16][4];      // P in bf16 pairs, the A operand of P.V
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int j = 0; j < mine; ++j) {
    const int st = j % kStages;
    const uint32_t par = (j / kStages) & 1;
    // S = Q . K^T; waiting for it also completes the previous tile's P.V
    mbar_wait(&sm.k_full[st], par);
    const uint64_t dk = sw128_desc(sm.k[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) wgmma_rs_k(sc, qf[kk], dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[(j - 1) % kStages]);   // this warp is done with it
    }

    const int k0 = j * kBk;
    if ((causal && k0 + kBk - 1 > r0) || k0 + kBk > n_k) {   // the diagonal or ragged tile
#pragma unroll
      for (int t = 0; t < kBk / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + t * 8 + 2 * tq + (e & 1), row = r0 + grp + (e >> 1) * 8;
          if (key >= n_k || (causal && key > row)) sc[4 * t + e] = kNeg;
        }
    }
    // A row always has key 0 in tile 0, so its running max is finite after
    // the first tile and a masked logit's weight ex2(-1e30 * sl2 - m) is 0.
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int t = 0; t < kBk / 8; ++t) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = ex2(fmaf(sc[4 * t + e], sl2, -m[e >> 1]));
        rs[e >> 1] += w[e];
      }
      // column groups 2 kk and 2 kk + 1 are the A operand of the kk-th
      // 16-key step: (row, keys 2 tq..), (row + 8, ..), then 8 keys on
      p[t >> 1][(t & 1) * 2] = pack_bf16(w[0], w[1]);
      p[t >> 1][(t & 1) * 2 + 1] = pack_bf16(w[2], w[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int t = 0; t < kD / 8; ++t) {
      acc[4 * t] *= alpha[0];
      acc[4 * t + 1] *= alpha[0];
      acc[4 * t + 2] *= alpha[1];
      acc[4 * t + 3] *= alpha[1];
    }

    // O += P . V: four 16-key steps, 16 rows of 128 bytes apart; left
    // running while the next tile's S is issued
    mbar_wait(&sm.v_full[st], par);
    const uint64_t dv = sw128_desc(sm.v[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) wgmma_rs_mn(acc, p[kk], dv + 128 * kk);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the row sums are split over the quad's four lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    const int row = r0 + grp + r * 8;
    if (row >= n) continue;
#pragma unroll
    for (int t = 0; t < kD / 8; ++t)
      store_bf16x2(o + qo + (size_t)row * kD + t * 8 + 2 * tq, acc[4 * t + 2 * r] / l[r],
                   acc[4 * t + 2 * r + 1] / l[r]);
  }
}

// One block: a tile of Shape<G>::kRows query rows of KV head bh (= batch *
// kvh + head) for its G query heads.  Warpgroup c < kConsumers consumes
// rows 64 (c % kRowGroups) .. + 63 of the tile for query head
// c / kRowGroups; warp 4 kConsumers produces.  In a warpgroup's
// accumulators (S and O alike) thread 32 w + 4 grp + tq owns rows
// 16 w + grp and + 8 of its 64 and, in every 8-wide column group t,
// columns 8 t + 2 tq and + 1: registers 4 t .. 4 t + 3 hold (row, c),
// (row, c + 1), (row + 8, c), (row + 8, c + 1).  The register A operand
// (Q, then P) has the same rows, 16 keys (or head dims) a step: (row,
// 2 tq ..), (row + 8, 2 tq ..), (row, 8 + 2 tq ..), (row + 8, 8 + 2 tq ..).
template <int G>
__global__ void __launch_bounds__(Shape<G>::kThreads, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int num_qt,
                     int n, int n_k, int causal, float scale) {
  using S = Shape<G>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int bh = (int)(blockIdx.x / num_qt);                    // a KV head's tiles adjacent
  const int qt = num_qt - 1 - (int)(blockIdx.x % num_qt);       // heavy tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_kb = (n_k + kBk - 1) / kBk;
  const int live = causal ? min(num_kb, ((qt + 1) * S::kRows + kBk - 1) / kBk) : num_kb;
  constexpr uint32_t kTileBytes = kBk * kD * 2;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 4 * S::kConsumers);   // each consumer warp releases a stage once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * S::kConsumers) {
    // the producer warpgroup, on few registers; its first warp keeps the
    // K/V ring full
    if constexpr (S::kConsumerRegs > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * S::kConsumers && lane == 0) {
      for (int j = 0; j < live; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&sm.empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load_3d(sm.k[s], &tk, &sm.k_full[s], 0, j * kBk, bh);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load_3d(sm.v[s], &tv, &sm.v_full[s], 0, j * kBk, bh);
      }
    }
  } else {
    if constexpr (S::kConsumerRegs > 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs) : "memory");
    consume<G>(sm, q, o, bh, qt, live, n, n_k, causal != 0, scale);
  }
}

// A [heads, rows, 64] bf16 tensor as box_rows x 64 boxes in the 128-byte swizzle;
// boxes reaching past `rows` are zero-filled.
bool encode_rows(CUtensorMap* map, const void* base, int rows, int heads, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)rows * kD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bkvh, int n,
                   int n_k, int causal, float scale, cudaStream_t stream) {
  const int num_qt = (n + Shape<G>::kRows - 1) / Shape<G>::kRows;
  const long long blocks = (long long)num_qt * bkvh;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n_k == 0)   // no key: every output row is 0 / 1e-30 = 0
    return cudaMemsetAsync(o, 0, (size_t)bkvh * G * n * kD * sizeof(bf16), stream);
  CUtensorMap mk, mv;
  if (!encode_rows(&mk, k, n_k, bkvh, kBk) || !encode_rows(&mv, v, n_k, bkvh, kBk))
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem) + 1024;   // + the 1024-byte alignment
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  flash_fwd_kernel<G><<<(unsigned)blocks, Shape<G>::kThreads, smem, stream>>>(
      (const bf16*)q, mk, mv, (bf16*)o, num_qt, n, n_k, causal, scale);
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


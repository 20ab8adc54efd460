// The Hopper (sm_90a) prefill attention pipeline shared by kernel A
// (flash_prefill.cu: causal, with a key-valid mask) and kernel F
// (sink_prefill.cu: causal, StreamingLLM sink + window). The two differ only
// in which 128-key tiles a query block visits and which keys of those tiles
// its rows may see: a tile plan, a template argument of attn_fwd_cta. Each
// .cu defines its plan, its __global__ kernel around attn_fwd_cta and its
// extern "C" entry point.
//
// Bound on the card: tensor-core operations, 4 * 128 * Hq per (row, key it
// sees). Design (what it does about that bound):
// * One CTA per (128 query rows, q-head): two consumer warpgroups of 64 rows
//   and a producer warpgroup, which hands its registers to the consumers
//   (setmaxnreg: 40 a thread there, 232 here). The grid runs the q-heads of
//   one query block side by side (blockIdx.x = head), so the G q-heads of a
//   KV head read each K/V tile at about the same time and share it through
//   L2; query blocks run last to first (the longest rows first, so the short
//   ones fill the tail of the wave).
// * Loads: a 3-stage ring of 128-key K and V tiles (64 KB a stage) in
//   dynamic shared memory, filled by TMA from the producer a tile ahead of
//   the products, with a `full` (bytes landed) and an `empty` (both
//   warpgroups done) mbarrier per stage. A 256-byte row of 128 dims lands as
//   two 64-dim halves of 128-byte rows with the hardware's 128-byte swizzle:
//   wgmma's swizzled K-major layout for K and MN-major layout for V, read
//   without bank conflicts; keys >= S are zero-filled by the TMA unit.
// * S = Q K^T: wgmma.m64n128k16, Q as the register A operand (loaded once
//   per CTA), K from shared memory. O += P V: wgmma.m64n128k16, P as the
//   bf16 register A operand (the score accumulator's layout is the A
//   fragment's), V from shared memory (the transpose bit).
// * Ping-pong: a warpgroup's turn at the tensor cores issues P V of the
//   previous tile and Q K^T of this one back to back under one wait; the
//   two warpgroups take turns (named barriers), so one's softmax runs while
//   the other's products do.
// * Softmax: online, fp32, in log2 units (one FFMA and one ex2 a score); m
//   is stored back in natural-log units where the kernel writes it.
// * Masks: the plan runs its per-element test only on the tiles that need
//   it; every other tile skips the mask math.
//
// Everything here has internal linkage: each .cu that includes the header
// gets its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_map.cuh"
#include "wgmma_rs.cuh"

namespace {

constexpr int kD = 128;                       // head dim
constexpr int kWGs = 2;                       // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kWGs;                // query rows per CTA
constexpr int kBN = 128;                      // keys per K/V tile
constexpr int kConsumers = 128 * kWGs;
constexpr int kFwdThreads = kConsumers + 128;  // and a producer warpgroup (one thread issues)
constexpr int kStages = 3;
constexpr int kHalfBytes = kBN * 128;         // one 64-dim half of a tile: kBN keys x 128 bytes
constexpr int kTileBytes = 2 * kHalfBytes;    // a K or V tile
constexpr int kStageBytes = 2 * kTileBytes;   // K then V
constexpr int kRingBytes = kStages * kStageBytes;
// Dynamic shared memory before a plan's own: alignment slack (the 128-byte
// swizzle wants 1024-byte aligned stages), the ring and its barriers.
constexpr int kRingSmem = 1024 + kRingBytes + 16 * kStages;
constexpr int kMaxSmem = 232448;              // an H100 block's shared memory
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}
// One kBN-key tile of KV head hk from an (S, Hk, 128) tensor into shared
// memory as [half][key][64 dims], 128-byte swizzled; keys >= S arrive as zeros.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int key0, int hk, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(key0), "r"(0), "r"(hk)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pin a register's value at this point of the program: wgmma reads and
// writes registers asynchronously, which the compiler does not see.
__device__ __forceinline__ void reg_fence(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1). K-major:
// lbo unused (1), sbo = the stride between 8-row groups. MN-major: lbo = the
// stride between 64-element halves along MN, sbo = between 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float fast_exp2(float x) {  // MUFU.EX2; subnormal results flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One turn of a consumer warpgroup at the tensor cores: O += P V on tile
// i - 1 (MN-major V: 16-key k-steps 2,048 bytes apart, the two 64-dim
// halves kHalfBytes apart), then S = Q K^T on tile i (K-major K: 16-dim
// k-steps 32 bytes apart inside a half's 128-byte rows; the first k-step
// overwrites s). The warpgroups take turns (named barrier 1 + warpgroup),
// so one's softmax runs while the other's products do. Which products a
// turn has is a template argument, so no branch sits between wgmma's fence
// and its wait (a branch there makes the compiler serialise them).
template <bool kPV, bool kQK>
__device__ __forceinline__ void turn(int i, int wg, uint32_t ring0, uint32_t empty0, float (&o)[kD / 2],
                                     float (&s)[kBN / 2], uint32_t (&pa)[kBN / 16][4], uint32_t (&qa)[kD / 16][4]) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");  // my turn
#pragma unroll
  for (int x = 0; x < kD / 2; ++x) reg_fence(o[x]);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
  wgmma_fence();
  if constexpr (kPV) {
    const uint32_t vs = ring0 + ((i - 1) % kStages) * kStageBytes + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      WgmmaRS<kD, 1>::run(o, pa[kk], desc_sw128(vs + kk * 2048, kHalfBytes, 1024), 1);
  }
  if constexpr (kQK) {
    const uint32_t ks = ring0 + (i % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      WgmmaRS<kBN, 0>::run(s, qa[kk], desc_sw128(ks + (kk >> 2) * kHalfBytes + (kk & 3) * 32, 16, 1024), kk > 0);
  }
  if (kQK || wg < kWGs - 1)  // the next warpgroup's turn (none after the last)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % kWGs) : "memory");
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int x = 0; x < kBN / 2; ++x) reg_fence(s[x]);
#pragma unroll
  for (int x = 0; x < kD / 2; ++x) reg_fence(o[x]);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
  if (kPV && (threadIdx.x & 127) == 0) mbar_arrive(empty0 + ((i - 1) % kStages) * 8);  // P V read its stage
}

// The body of a CTA. `make_plan(scratch, q0, warp, lane)` builds the tile
// plan; every thread of the CTA calls it before the barrier that publishes
// the ring's mbarriers, so a plan may fill `scratch` (the dynamic shared
// memory past the ring) and synchronise the CTA (uniformly) in between. A
// plan provides
//   int n_tiles() const   the tiles the CTA visits (0: none);
//   int tile(int i) const the key tile of the i-th visit, ascending;
//   void mask(s, tile, wrow0, r0, r1, tq) const
//                         the scores of `tile` that rows r0 / r1 (of the
//                         warpgroup whose first row is wrow0) may not see
//                         set to -inf, with the per-element test only on the
//                         tiles that need it (a warp-uniform choice).
// kStats: write each row's softmax max m (natural-log units) and sum l,
// fp32 (Hq, S). Rows that see no key give 0 (m = -inf, l = 0).
template <bool kStats, class MakePlan>
__device__ __forceinline__ void attn_fwd_cta(const CUtensorMap& map_k, const CUtensorMap& map_v,
                                             const uint16_t* __restrict__ q, uint16_t* __restrict__ out,
                                             float* __restrict__ m_out, float* __restrict__ l_out, int S, int Hq,
                                             int Hk, float scale_log2, MakePlan make_plan) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t ring0 = (raw0 + 1023u) & ~1023u;
  uint8_t* ring = smem_raw + (ring0 - raw0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kRingBytes);  // full[kStages], empty[kStages]
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * kStages;

  const int h = blockIdx.x;
  const int hk = h / (Hq / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // the last query block first
  const int tid = threadIdx.x;
  // The warp index broadcast from lane 0: uniform to the compiler, so the
  // role branch below does not make the wgmma path look divergent (which
  // would serialise the wgmma instructions).
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const auto plan = make_plan(reinterpret_cast<uint8_t*>(bars + 2 * kStages), q0, warp, lane);
  __syncthreads();  // the barriers are initialised and the plan's shared memory written
  const int n_tiles = __shfl_sync(0xffffffffu, plan.n_tiles(), 0);

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");  // its registers go to the consumers
    if (warp == kConsumers / 32 && lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + st * 8, (i / kStages - 1) & 1);  // both warpgroups are done with it
        const int key0 = plan.tile(i) * kBN;
        const uint32_t dst = ring0 + st * kStageBytes;
        mbar_expect(full0 + st * 8, kStageBytes);
        tma_tile(dst, &map_k, key0, hk, full0 + st * 8);
        tma_tile(dst + kTileBytes, &map_v, key0, hk, full0 + st * 8);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2;  // this thread's warpgroup
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread within the group
  const int wrow0 = q0 + wg * 64;  // the warpgroup's first row
  const int r0 = wrow0 + ((tid >> 5) & 3) * 16 + g;
  const int r1 = r0 + 8;

  // Q as the register A operand of each 16-dim k-step, zero past S.
  uint32_t qa[kD / 16][4];
  {
    const uint16_t* q0p = q + (static_cast<size_t>(r0) * Hq + h) * kD;
    const uint16_t* q1p = q + (static_cast<size_t>(r1) * Hq + h) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + tq * 2;
      qa[kk][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(q0p + c) : 0u;
      qa[kk][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(q1p + c) : 0u;
      qa[kk][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(q0p + c + 8) : 0u;
      qa[kk][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(q1p + c + 8) : 0u;
    }
  }

  // Accumulator layout (m64nN): element 4 * j + e is row r0 (e < 2) or r1,
  // column 8 * j + 2 * tq + (e & 1).
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};  // log2 units
  float l_i[2] = {0.f, 0.f};              // this thread's share of the row sums
  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  uint32_t pa[kBN / 16][4];  // P in bf16: the A operand of each 16-key k-step

  // Softmax of tile i's scores, in place: the plan's masks, the online max
  // and sum, P into pa as bf16, and the rescale of o when a row max moved.
  auto softmax = [&](int i) {
    plan.mask(s, plan.tile(i), wrow0, r0, r1, tq);
    float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores: scale > 0 keeps the order
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = fast_exp2(m_i[r] - m_use[r]);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int x = 0; x < kBN / 2; x += 2) {
      const int r = (x >> 1) & 1;
      const float p0 = fast_exp2(fmaf(s[x], scale_log2, -m_use[r]));
      const float p1 = fast_exp2(fmaf(s[x + 1], scale_log2, -m_use[r]));
      l_i[r] += p0 + p1;
      pa[x >> 3][(x >> 1) & 3] = pack_floats(p0, p1);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row max moved
#pragma unroll
      for (int x = 0; x < kD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    }
  };

  if (wg == kWGs - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // warpgroup 0 goes first
  if (n_tiles > 0) {
    mbar_wait(full0, 0);
    turn<false, true>(0, wg, ring0, empty0, o, s, pa, qa);
    softmax(0);
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(full0 + (i % kStages) * 8, (i / kStages) & 1);  // the tile has landed
      turn<true, true>(i, wg, ring0, empty0, o, s, pa, qa);
      softmax(i);
    }
    turn<true, false>(n_tiles, wg, ring0, empty0, o, s, pa, qa);  // P V of the last tile
  } else {
    turn<false, false>(0, wg, ring0, empty0, o, s, pa, qa);  // no tile: only the turn order
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = 1.f / fmaxf(l_i[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(r0) * Hq + h) * kD + c) =
          pack_floats(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(r1) * Hq + h) * kD + c) =
          pack_floats(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  if constexpr (kStats) {
    if (tq == 0) {  // m back in natural-log units
      if (r0 < S) {
        m_out[static_cast<size_t>(h) * S + r0] = m_i[0] * kLn2;
        l_out[static_cast<size_t>(h) * S + r0] = l_i[0];
      }
      if (r1 < S) {
        m_out[static_cast<size_t>(h) * S + r1] = m_i[1] * kLn2;
        l_out[static_cast<size_t>(h) * S + r1] = l_i[1];
      }
    }
  }
}

// The TMA map of an (S, Hk, 128) bf16 tensor as four dims, innermost first:
// 64 dims of a half, keys (Hk * 256 bytes apart), halves (128 bytes apart),
// KV heads (256 bytes apart); its box is one kBN-key tile of one KV head,
// landing as [half][key][64 dims] with the 128-byte swizzle.
int kv_map(CUtensorMap* map, const void* ptr, int S, int Hk) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(S), 2, static_cast<cuuint64_t>(Hk)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Hk) * kD * 2, 128, kD * 2};
  const cuuint32_t box[4] = {64, kBN, 2, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// The K and V maps of one launch, and the opt-in above 48 KB of dynamic
// shared memory for `kernel` (once per device: `set` remembers).
int attn_fwd_setup(const void* kernel, bool (&set)[64], CUtensorMap* map_k, CUtensorMap* map_v, const void* k,
                   const void* v, int S, int Hk) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set[dev] = true;
  }
  const int status = kv_map(map_k, k, S, Hk);
  return status != 0 ? status : kv_map(map_v, v, S, Hk);
}

}  // namespace

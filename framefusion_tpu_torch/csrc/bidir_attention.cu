// Bidirectional (non-causal) attention for the vision towers on Hopper
// (sm_90a), bound through a plain C interface (ctypes).
//
// E. ff_bidir_attn_fwd — exact softmax attention per (batch, head) over
//    q/k/v in the towers' (B, N, H, hd) layout, read in place (no padded or
//    transposed copies). Replaces framefusion_tpu/ops/kernels/
//    bidir_attention.py: _bidir_kernel via flash_bidir_attention. The TPU
//    kernel padded N to 128 and hd to 128 in device memory and held a whole
//    (N_pad, N_pad) fp32 score tile in VMEM; a Hopper block has at most
//    227 KB of shared memory, so here K/V stream through shared memory one
//    64-key tile at a time with an fp32 online softmax, and keys >= N are
//    masked in the kernel.
//
//    Bound on the card: at SigLIP-so400m geometry (B 16, N 729, H 16,
//    hd 72) one call does 39.2 GFLOP (0.040 ms at 989 TFLOP/s) and moves
//    107.5 MB (0.032 ms at 3.35 TB/s): near the ridge, so it needs both the
//    tensor cores' full rate (wgmma) and loads that stream while they run.
//    At hd 72 the softmax's exponentials (one per score, 16 a clock per
//    SM) cost about as much as the products.
//
//    Design:
//    * One CTA per (128 query rows, batch * head): two warpgroups of 64
//      rows (6 query blocks per head at N 729, so K/V are read 6 times
//      through L2, not 12).
//    * Loads: a 4-stage ring of 64-key K and V tiles filled by TMA, issued
//      by one thread two tiles ahead, completing on a `full` mbarrier per
//      stage; each warpgroup arrives on the stage's `empty` mbarrier when
//      its P V has read the tile. A 5-D tensor map (8 dims of a chunk,
//      keys, 8-dim chunks 16 bytes apart, heads, batches) lands a tile as
//      [chunk][key][8 dims]: wgmma's no-swizzle core-matrix layout, for
//      every head dim (a 144-byte row, hd 72, fits no swizzle width), with
//      keys >= N zero-filled by the TMA unit.
//    * S = Q K^T: wgmma.m64n64k16 per 16 dims, Q as the register A operand
//      (loaded once per CTA, zero past hd), K from shared memory K-major.
//      An odd hd / 8 pads the last k-step with a chunk of zeros in shared
//      memory, written once at kernel start (never in device memory).
//    * Online softmax in fp32 on the accumulator registers (log2 units,
//      one FFMA and one ex2 a score); keys >= N masked in the last tile.
//    * O += P V: wgmma.m64n(hd)k16, P as the bf16 register A operand (the
//      score accumulator's layout is the A fragment's), V from shared
//      memory MN-major (the transpose bit): N = hd exactly, no pad tile.
//    * Ping-pong: a warpgroup's turn at the tensor cores issues P V of the
//      previous tile and S of this one back to back under one wait; the two
//      warpgroups take turns (named barriers), so one's softmax (the ex2
//      unit) runs while the other's products do, instead of both
//      contending for the same unit at once.
//    Template parameter: hd / 8 (hd a multiple of 8 up to 128).
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_map.cuh"
#include "wgmma_rs.cuh"

namespace {

constexpr int kWGs = 2;                 // warpgroups per CTA, 64 query rows each
constexpr int kBM = 64 * kWGs;          // query rows per CTA
constexpr int kBN = 64;                 // keys per K/V tile
constexpr int kThreads = 128 * kWGs;
constexpr int kStages = 4;              // tiles j - 1 (P V) and j (Q K^T) in use, j + 1 and j + 2 loading
// CTAs an SM the registers must allow: two (128 registers a thread) up to hd 72.
constexpr int min_blocks(int hd8) { return hd8 <= 9 ? 2 : 1; }
constexpr int kChunkBytes = kBN * 16;  // one 8-dim chunk of a tile: 64 keys x 16 bytes

template <int HD8>
struct Geometry {
  static constexpr int kHD = HD8 * 8;
  static constexpr int kSteps = (HD8 + 1) / 2;         // 16-dim k-steps of Q K^T
  static constexpr int kBytesK = 2 * kSteps * kChunkBytes;  // K tile, a zero chunk when hd / 8 is odd
  static constexpr int kBytesV = HD8 * kChunkBytes;
  static constexpr int kStage = kBytesK + kBytesV;
  static constexpr int kSmem = kStages * kStage;
};

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
// One (8 dims x 64 keys x hd/8 chunks) box of a (B, N, H, hd) tensor into
// shared memory as [chunk][key][8 dims]; keys >= N arrive as zeros.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int key0, int h, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(key0), "r"(0), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pin a register's value at this point of the program: wgmma reads and
// writes registers asynchronously, which the compiler does not see.
__device__ __forceinline__ void reg_fence(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// Shared-memory matrix descriptor, no swizzle: leading byte offset = the
// stride between core matrices along K, stride byte offset = along M/N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
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

template <int HD8>
__global__ void __launch_bounds__(kThreads, min_blocks(HD8))
bidir_attn_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                  const uint16_t* __restrict__ q, uint16_t* __restrict__ out, int N, int H, float scale_log2) {
  using Geo = Geometry<HD8>;
  constexpr int HD = Geo::kHD, KS = Geo::kSteps;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];   // a stage's tile has landed
  __shared__ __align__(8) uint64_t empty[kStages];  // both warpgroups are done with a stage's tile
  const uint32_t smem0 = smem_addr(smem);

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * HD;  // elements between tokens
  const size_t base = static_cast<size_t>(b) * N * stride + static_cast<size_t>(h) * HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  // This thread's two rows: warpgroup tid / 128, warp (tid / 32) % 4 of it.
  const int r0 = blockIdx.x * kBM + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
  const int r1 = r0 + 8;

  const int n_tiles = (N + kBN - 1) / kBN;
  const int wg = tid >> 7;  // this thread's warpgroup
  const uint32_t full0 = smem_addr(full), empty0 = smem_addr(empty);
  // Thread 0 asks the TMA unit for tile `tile`'s K and V boxes, once both
  // warpgroups are done with the tile its stage held before.
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages;
      if (tile >= kStages) mbar_wait(empty0 + st * 8, (tile / kStages - 1) & 1);
      const uint32_t ks = smem0 + st * Geo::kStage;
      mbar_expect(full0 + st * 8, 2 * Geo::kBytesV);
      tma_tile(ks, &map_k, tile * kBN, h, b, full0 + st * 8);
      tma_tile(ks + Geo::kBytesK, &map_v, tile * kBN, h, b, full0 + st * 8);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < kStages - 2; ++st) issue(st);
  }
  if (HD8 & 1) {  // the zero chunk that pads the last k-step of Q K^T; TMA never writes it
    for (int i = tid; i < kStages * kBN; i += kThreads)
      *reinterpret_cast<uint4*>(smem + (i / kBN) * Geo::kStage + HD8 * kChunkBytes + (i % kBN) * 16) =
          make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma's reads
  }

  // Q as the register A operand of each 16-dim k-step, zero past hd and N.
  uint32_t qa[KS][4];
  {
    const uint16_t* q0 = q + base + static_cast<size_t>(r0) * stride;
    const uint16_t* q1 = q + base + static_cast<size_t>(r1) * stride;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = (r0 < N && c < HD) ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qa[kk][1] = (r1 < N && c < HD) ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
      qa[kk][2] = (r0 < N && c + 8 < HD) ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qa[kk][3] = (r1 < N && c + 8 < HD) ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
    }
  }

  // Accumulator layout (m64nN): element 4 * j + e is row r0 (e < 2) or r1,
  // column 8 * j + 2 * t + (e & 1).
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums
  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  uint32_t pa[kBN / 16][4];  // P in bf16: the A operand of each 16-key k-step

  // One turn of this warpgroup at the tensor cores: O += P V on the tile
  // before (MN-major V: the transpose bit, 8-key core matrices 128 bytes
  // apart along K, chunks kChunkBytes apart along N), then S = Q K^T on
  // this tile (K-major K: chunks kChunkBytes apart along K, 8-key core
  // matrices 128 bytes apart; the first k-step overwrites s). The
  // warpgroups take turns (named barrier 1 + warpgroup), so one's softmax
  // runs while the other's products do.
  auto turn = [&](int tile) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");  // my turn
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) reg_fence(o[i]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
    wgmma_fence();
    if (tile > 0) {
      const uint32_t vs = smem0 + ((tile - 1) % kStages) * Geo::kStage + Geo::kBytesK;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        WgmmaRS<HD, 1>::run(o, pa[kk], smem_desc(vs + kk * 16 * 16, 128, kChunkBytes), 1);
    }
    if (tile < n_tiles) {
      const uint32_t ks = smem0 + (tile % kStages) * Geo::kStage;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaRS<kBN, 0>::run(s, qa[kk], smem_desc(ks + 2 * kk * kChunkBytes, kChunkBytes, 128), kk > 0);
    }
    if (wg < kWGs - 1 || tile < n_tiles)  // the next warpgroup's turn (none after the last)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % kWGs) : "memory");
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) reg_fence(s[i]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) reg_fence(o[i]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
    if (tile > 0 && (tid & 127) == 0) mbar_arrive(empty0 + ((tile - 1) % kStages) * 8);  // P V read its stage
  };

  __syncthreads();  // the barriers are initialised and the zero chunk written
  if (wg == kWGs - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // warpgroup 0 goes first
  for (int tile = 0; tile < n_tiles; ++tile) {
    mbar_wait(full0 + (tile % kStages) * 8, (tile / kStages) & 1);  // the tile has landed
    turn(tile);
    if (tid == 0) issue(tile + kStages - 2);  // two tiles ahead, into the stage tile - 2 used

    // Softmax of S_tile in log2 units; keys >= N are -inf.
    if ((tile + 1) * kBN > N) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if (tile * kBN + (i >> 2) * 8 + t * 2 + (i & 1) >= N) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores: scale > 0 keeps the order
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
    for (int i = 0; i < kBN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = fast_exp2(fmaf(s[i], scale_log2, -m_use[r]));
      const float p1 = fast_exp2(fmaf(s[i + 1], scale_log2, -m_use[r]));
      l_i[r] += p0 + p1;
      pa[i >> 3][(i >> 1) & 3] = pack_floats(p0, p1);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row max moved
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
  }
  turn(n_tiles);  // P V of the last tile

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = 1.f / fmaxf(l_i[r], 1e-30f);
  }
  uint16_t* ob = out + base;
#pragma unroll
  for (int j = 0; j < HD8; ++j) {
    const int c = j * 8 + t * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * stride + c) =
          pack_floats(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * stride + c) =
          pack_floats(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
}

// The TMA map of a (B, N, H, hd) bf16 tensor as five dims, innermost first:
// 8 dims of a chunk, keys (H * hd apart), chunks (16 bytes apart), heads,
// batches; its box is one 64-key tile of one (batch, head).
int tile_map(CUtensorMap* map, const void* ptr, int B, int N, int H, int hd) {
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(hd / 8),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(H) * hd * 2;  // bytes between keys
  const cuuint64_t strides[4] = {row, 16, static_cast<cuuint64_t>(hd) * 2, row * N};
  const cuuint32_t box[5] = {8, kBN, static_cast<cuuint32_t>(hd / 8), 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

template <int HD8>
int launch(const void* q, const void* k, const void* v, void* out, int B, int N, int H, float scale_log2,
           cudaStream_t stream) {
  constexpr int smem = Geometry<HD8>::kSmem;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set[64] = {};  // the opt-in above 48 KB, once per device
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(bidir_attn_kernel<HD8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  CUtensorMap map_k, map_v;
  int status = tile_map(&map_k, k, B, N, H, HD8 * 8);
  if (status == 0) status = tile_map(&map_v, v, B, N, H, HD8 * 8);
  if (status != 0) return status;
  const dim3 grid((N + kBM - 1) / kBM, B * H);
  bidir_attn_kernel<HD8><<<grid, kThreads, smem, stream>>>(map_k, map_v, static_cast<const uint16_t*>(q),
                                                           static_cast<uint16_t*>(out), N, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scale > 0 (the towers' 1 / sqrt(hd)).
extern "C" int ff_bidir_attn_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                 int N, int H, int hd, float scale, void* stream) {
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<1>(q, k, v, out, B, N, H, scale_log2, s);
    case 16: return launch<2>(q, k, v, out, B, N, H, scale_log2, s);
    case 24: return launch<3>(q, k, v, out, B, N, H, scale_log2, s);
    case 32: return launch<4>(q, k, v, out, B, N, H, scale_log2, s);
    case 40: return launch<5>(q, k, v, out, B, N, H, scale_log2, s);
    case 48: return launch<6>(q, k, v, out, B, N, H, scale_log2, s);
    case 56: return launch<7>(q, k, v, out, B, N, H, scale_log2, s);
    case 64: return launch<8>(q, k, v, out, B, N, H, scale_log2, s);
    case 72: return launch<9>(q, k, v, out, B, N, H, scale_log2, s);
    case 80: return launch<10>(q, k, v, out, B, N, H, scale_log2, s);
    case 88: return launch<11>(q, k, v, out, B, N, H, scale_log2, s);
    case 96: return launch<12>(q, k, v, out, B, N, H, scale_log2, s);
    case 104: return launch<13>(q, k, v, out, B, N, H, scale_log2, s);
    case 112: return launch<14>(q, k, v, out, B, N, H, scale_log2, s);
    case 120: return launch<15>(q, k, v, out, B, N, H, scale_log2, s);
    case 128: return launch<16>(q, k, v, out, B, N, H, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Attention-sink (StreamingLLM) prefill attention for Hopper (sm_90a), bound
// through a plain C interface (ctypes).
//
// F. ff_sink_attn_fwd — query i of q-head h attends the keys
//    {j : j <= i and (j < init_num or j > i - window)} of KV head h / G
//    (HF repeat_kv order); `window` counts the query itself. Replaces the
//    Pallas kernel framefusion_tpu/ops/kernels/sink_prefill.py
//    (sink_flash_attention, _sink_kernel), which kept a head's whole K/V
//    resident in VMEM and walked the sink and window blocks of each 512-query
//    block. Here K/V stream through shared memory one 64-key tile at a time.
//
//    Bound on the card: tensor-core math, about 4 * S * Hq * D *
//    (init_num + window + 64) operations: O(S * window), where causal
//    attention (kernel A) is O(S^2 / 2).
//
//    Design: kernel A's structure (csrc/flash_prefill.cu) — four warps of 16
//    rows, bf16 mma.sync.m16n8k16 with fp32 accumulation, fp32 online softmax
//    in registers — with two changes.
//    * GQA rows are packed. A CTA owns 64 consecutive rows of one KV head's
//      (position, q-head) row space: row r is position r / G of q-head
//      hk * G + r % G. Each 64-key tile a CTA loads into shared memory serves
//      all G q-heads of its positions, at A's register budget (a CTA of 64
//      positions x G heads would need 4G warps of accumulators).
//    * The tile list. A CTA visits the sink tiles [0, ceil(init_num / 64)),
//      then the window tiles from floor(max(p_first - window + 1, 0) / 64) up
//      to the tile of its last position p_last, skipping those already
//      visited as sink tiles. Each tile is visited once and each key passes
//      the one combined mask once, so a tile that is both a sink tile and a
//      window tile counts its keys once. A warp skips a tile that lies wholly
//      past its rows, or wholly before their windows and holds no sink key.
//    Keys >= S are zero-filled in shared memory and masked. Every row sees at
//    least itself, so no row's softmax is empty.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;        // head dim
constexpr int kBM = 64;        // packed rows per CTA (4 warps x 16)
constexpr int kBN = 64;        // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kRow = kD + 8;   // padded shared-memory row, in bf16 units

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// c += a * b for one m16n8k16 bf16 tile, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
sink_attn_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                     int S, int Hq, int Hk, int init_num, int window, float scale) {
  __shared__ __align__(16) uint16_t ks[kBN * kRow];
  __shared__ __align__(16) uint16_t vs[kBN * kRow];

  const int G = Hq / Hk;
  const int hk = blockIdx.y;
  const int n_rows = S * G;           // packed rows of this KV head
  const int row0 = blockIdx.x * kBM;  // this CTA's first packed row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int wrow = row0 + warp * 16;
  const bool warp_live = wrow < n_rows;
  const int pr0 = wrow + g;
  const int pr1 = pr0 + 8;
  const bool live0 = pr0 < n_rows;
  const bool live1 = pr1 < n_rows;
  const int i0 = pr0 / G;  // positions of this thread's two rows
  const int i1 = pr1 / G;
  const size_t off0 = ((size_t)i0 * Hq + hk * G + (pr0 - i0 * G)) * kD;
  const size_t off1 = ((size_t)i1 * Hq + hk * G + (pr1 - i1 * G)) * kD;
  const int w_first = wrow / G;  // this warp's positions
  const int w_last = min(wrow + 15, n_rows - 1) / G;
  const int c_first = row0 / G;  // this CTA's positions
  const int c_last = min(row0 + kBM - 1, n_rows - 1) / G;

  // Q fragments (A operand, row-major 16x16 per k-step), read once.
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = live0 ? *reinterpret_cast<const uint32_t*>(q + off0 + c) : 0u;
    qa[kk][1] = live1 ? *reinterpret_cast<const uint32_t*>(q + off1 + c) : 0u;
    qa[kk][2] = live0 ? *reinterpret_cast<const uint32_t*>(q + off0 + c + 8) : 0u;
    qa[kk][3] = live1 ? *reinterpret_cast<const uint32_t*>(q + off1 + c + 8) : 0u;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  // Sink tiles [0, n_sink), then window tiles [win_lo, last_tile].
  const int last_tile = c_last / kBN;
  const int n_sink = min((init_num + kBN - 1) / kBN, last_tile + 1);
  const int win_lo = max(max(c_first - window + 1, 0) / kBN, n_sink);
  const int n_tiles = n_sink + max(last_tile - win_lo + 1, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = (it < n_sink ? it : win_lo + (it - n_sink)) * kBN;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBN * (kD / 8); idx += kThreads) {
      const int row = idx >> 4;
      const int chunk = idx & 15;
      const int key = n0 + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < S) {
        const size_t off = ((size_t)key * Hk + hk) * kD + chunk * 8;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[row * kRow + chunk * 8]) = kv4;
      *reinterpret_cast<uint4*>(&vs[row * kRow + chunk * 8]) = vv4;
    }
    __syncthreads();
    // Nothing here for this warp: past its rows, or before every row's
    // window with no sink key in the tile.
    if (!warp_live || n0 > w_last || (n0 >= init_num && n0 + kBN - 1 <= w_first - window)) continue;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint16_t* kr = &ks[(nt * 8 + g) * kRow + kk * 16 + t * 2];
        mma_16816(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Mask, scale, and the online-softmax update for rows r0 (e<2), r1 (e>=2).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nt * 8 + t * 2 + (e & 1);
        const int pos = e < 2 ? i0 : i1;
        const bool ok = key <= pos && key < S && (key < init_num || key > pos - window);
        const float s = ok ? sc[nt][e] * scale : -INFINITY;
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float m_use[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_i[r] - m_use[r]);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m_use[e >> 1]);
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_i[r] = l_i[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are reused as A operands (bf16).
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_floats(sc[2 * kt][0], sc[2 * kt][1]);
      pa[1] = pack_floats(sc[2 * kt][2], sc[2 * kt][3]);
      pa[2] = pack_floats(sc[2 * kt + 1][0], sc[2 * kt + 1][1]);
      pa[3] = pack_floats(sc[2 * kt + 1][2], sc[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const uint16_t* vp = &vs[(kt * 16 + t * 2) * kRow + dt * 8 + g];
        mma_16816(o[dt], pa, pack_raw(vp[0], vp[kRow]), pack_raw(vp[8 * kRow], vp[9 * kRow]));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l_i[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_i[1], 1e-30f);
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (live0)
      *reinterpret_cast<uint32_t*>(out + off0 + c) = pack_floats(o[dt][0] * inv0, o[dt][1] * inv0);
    if (live1)
      *reinterpret_cast<uint32_t*>(out + off1 + c) = pack_floats(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int ff_sink_attn_fwd(const void* q, const void* k, const void* v, void* out, int S, int Hq,
                                int Hk, int init_num, int window, float scale, void* stream) {
  const dim3 grid((S * (Hq / Hk) + kBM - 1) / kBM, Hk);
  sink_attn_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), S, Hq, Hk, init_num, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

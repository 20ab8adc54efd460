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
//    64-key tile at a time with an fp32 online softmax (as kernel A does),
//    and keys >= N are masked in the kernel.
//    Bound on the card: at SigLIP-so400m geometry (N = 729, H = 16,
//    hd = 72, 16 frames a batch) a 64-frame video spends ~4.2 TFLOP in
//    tower attention against ~38 TFLOP in the tower's projections, so the
//    encode is GEMM-bound; this kernel's job is to keep the (B*H, N, N)
//    scores and probabilities out of device memory (the plain version
//    writes ~0.5 GB of fp32 scores per layer and batch) and to run QK^T and
//    PV on the tensor cores.
//    Design: one CTA per (64-query block, batch*head), four warps of 16
//    query rows; bf16 mma.sync.m16n8k16 with fp32 accumulation for both
//    products. The head dim need not be a multiple of the 16-deep k-step
//    (hd = 72 for so400m): Q's fragment columns >= hd are zero in
//    registers and each K/V row is zero-filled from hd up to the next
//    multiple of 16 in shared memory, never in device memory. P.V has the
//    head dim as its n dimension, which steps by 8, so it needs no padding
//    (the pad tile of an odd hd/8 is computed on zeros and not stored).
//    V fragments come from shared memory through ldmatrix.trans.
//    Template parameter: hd / 8 (hd a multiple of 8 up to 128).
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // query rows per CTA (4 warps x 16)
constexpr int kBN = 64;       // keys per K/V tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 bf16 tile, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed: the B fragments of
// two neighbouring 8-column tiles of a row-major [key][dim] V tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int HD8>
__global__ void __launch_bounds__(kThreads)
bidir_attn_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                  int N, int H, float scale_log2) {
  constexpr int HD = HD8 * 8;          // real head dim
  constexpr int KS = (HD8 + 1) / 2;    // 16-deep k-steps over the head dim
  constexpr int KD = KS * 16;          // head dim zero-padded in shared memory
  constexpr int ROW = KD + 8;          // padded shared-memory row (no bank conflicts)
  constexpr int CHUNKS = KD / 8;       // 16-byte chunks per shared row
  __shared__ __align__(16) uint16_t ks[kBN * ROW];
  __shared__ __align__(16) uint16_t vs[kBN * ROW];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * HD;  // elements between tokens
  const size_t base = static_cast<size_t>(b) * N * stride + static_cast<size_t>(h) * HD;
  const uint16_t* qb = q + base;
  const uint16_t* kb = k + base;
  const uint16_t* vb = v + base;
  uint16_t* ob = out + base;

  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q fragments (A operand, row-major 16x16 per k-step), zero past hd.
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + t * 2;
    const uint16_t* p0 = qb + static_cast<size_t>(r0) * stride + c;
    const uint16_t* p1 = qb + static_cast<size_t>(r1) * stride + c;
    qa[kk][0] = (r0 < N && c < HD) ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
    qa[kk][1] = (r1 < N && c < HD) ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
    qa[kk][2] = (r0 < N && c + 8 < HD) ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
    qa[kk][3] = (r1 < N && c + 8 < HD) ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
  }

  float o[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  // ldmatrix.x4.trans row address of this lane within a 16-key x 16-dim block.
  const int ld_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ld_dim = (lane >> 4) * 8;

  for (int n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBN * CHUNKS; idx += kThreads) {
      const int row = idx / CHUNKS;
      const int chunk = idx % CHUNKS;
      const int key = n0 + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < N && chunk < HD8) {
        const size_t off = static_cast<size_t>(key) * stride + chunk * 8;
        kv4 = *reinterpret_cast<const uint4*>(kb + off);
        vv4 = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&ks[row * ROW + chunk * 8]) = kv4;
      *reinterpret_cast<uint4*>(&vs[row * ROW + chunk * 8]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint16_t* kr = &ks[(nt * 8 + g) * ROW + kk * 16 + t * 2];
        mma_16816(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Mask keys >= N, scale (in log2 units), online-softmax update for rows
    // r0 (e < 2) and r1 (e >= 2).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nt * 8 + t * 2 + (e & 1);
        const float s = key < N ? sc[nt][e] * scale_log2 : -INFINITY;
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
      alpha[r] = exp2f(m_i[r] - m_use[r]);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nt][e] - m_use[e >> 1]);
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
    for (int dt = 0; dt < 2 * KS; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments become A operands (bf16); V's B
    // fragments for two 8-dim tiles per ldmatrix.x4.trans.
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_floats(sc[2 * kt][0], sc[2 * kt][1]);
      pa[1] = pack_floats(sc[2 * kt][2], sc[2 * kt][3]);
      pa[2] = pack_floats(sc[2 * kt + 1][0], sc[2 * kt + 1][1]);
      pa[3] = pack_floats(sc[2 * kt + 1][2], sc[2 * kt + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < KS; ++d2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, &vs[(kt * 16 + ld_key) * ROW + d2 * 16 + ld_dim]);
        mma_16816(o[2 * d2], pa, vb4[0], vb4[1]);
        mma_16816(o[2 * d2 + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l_i[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_i[1], 1e-30f);
#pragma unroll
  for (int dt = 0; dt < HD8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * stride + c) =
          pack_floats(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * stride + c) =
          pack_floats(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

template <int HD8>
void launch(const void* q, const void* k, const void* v, void* out, int B, int N, int H,
            float scale_log2, cudaStream_t stream) {
  const dim3 grid((N + kBM - 1) / kBM, B * H);
  bidir_attn_kernel<HD8><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), N, H, scale_log2);
}

}  // namespace

extern "C" int ff_bidir_attn_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                 int N, int H, int hd, float scale, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: launch<1>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 16: launch<2>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 24: launch<3>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 32: launch<4>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 40: launch<5>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 48: launch<6>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 56: launch<7>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 64: launch<8>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 72: launch<9>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 80: launch<10>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 88: launch<11>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 96: launch<12>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 104: launch<13>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 112: launch<14>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 120: launch<15>(q, k, v, out, B, N, H, scale_log2, s); break;
    case 128: launch<16>(q, k, v, out, B, N, H, scale_log2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

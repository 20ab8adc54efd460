// Prefill attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Two kernels:
//
// A. ff_flash_attn_fwd — causal GQA flash attention with an (S,) key-valid
//    mask. Replaces the Pallas kernels of framefusion_tpu/ops/kernels/
//    flash_prefill.py: flash_causal_attention (dispatcher), the per-q-head
//    _flash_kernel, _flash_grouped_multi and _flash_blocked_grouped. The TPU
//    needed three regimes because a head's K/V had to fit VMEM; here K/V
//    stream through shared memory one 64-key tile at a time, so one kernel
//    covers every S.
//    Bound on the card: tensor-core math (S^2 * D * Hq operations over the
//    causal half) once S is in the thousands. Design: one CTA per
//    (64-query block, q-head), four warps of 16 rows each; bf16
//    mma.sync.m16n8k16 for Q.K^T and P.V with fp32 accumulation; fp32 online
//    softmax in registers; key tiles past the causal diagonal are never
//    loaded, and a warp skips tiles that lie wholly past its own rows. GQA is
//    indexing: q-head h reads KV head h / G (HF repeat_kv order), so the
//    group's K/V tiles are shared through L2, not re-laid out.
//    Rows with every key masked give 0 (m = -inf, l = 0). The kernel also
//    writes each row's softmax max m and sum l (fp32, (Hq, S)) for kernel B.
//
// B. ff_attn_importance_rows — the prune's importance vector: for the <= num
//    capture rows (the last live rows, -1 = absent), exp(q.k*scale - m)/l per
//    key from A's statistics, summed over rows and heads in a FIXED order (no
//    atomics) and divided by Hq*num. Replaces the importance epilogue of
//    _flash_kernel_imp / _imp_grouped_multi (_flash_kernel_gm_imp) and the
//    plain mid-regime fallback in flash_causal_attention_importance. The
//    order is fixed because the prune's top-k reads this vector: run-to-run
//    jitter would show up as flipped keep decisions.
//    Bound on the card: reading K once (S * Hk * D * 2 bytes); the math is
//    num * Hq * D per key. Design: one warp per key, each lane holds four
//    dims of the key; the capture rows' q live in shared memory.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;             // head dim
constexpr int kBM = 64;             // query rows per CTA (4 warps x 16)
constexpr int kBN = 64;             // keys per K/V tile
constexpr int kThreadsA = 128;
constexpr int kRow = kD + 8;        // padded shared-memory row, in bf16 units

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

__global__ void __launch_bounds__(kThreadsA)
flash_attn_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, const uint8_t* __restrict__ key_valid,
                      uint16_t* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int S, int Hq, int Hk, float scale) {
  __shared__ __align__(16) uint16_t ks[kBN * kRow];
  __shared__ __align__(16) uint16_t vs[kBN * kRow];
  __shared__ uint8_t kval[kBN];

  const int h = blockIdx.y;
  const int hk = h / (Hq / Hk);
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const int warp_last = q0 + warp * 16 + 15;

  // Q fragments (A operand, row-major 16x16 per k-step), read once.
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    const uint16_t* p0 = q + ((size_t)r0 * Hq + h) * kD + c;
    const uint16_t* p1 = q + ((size_t)r1 * Hq + h) * kD + c;
    qa[kk][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
    qa[kk][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
    qa[kk][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
    qa[kk][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  const int n_end = min(S, q0 + kBM);  // causal: no key past the block's last row
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBN * (kD / 8); idx += kThreadsA) {
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
    if (threadIdx.x < kBN) {
      const int key = n0 + threadIdx.x;
      kval[threadIdx.x] = (key < S && (key_valid == nullptr || key_valid[key])) ? 1 : 0;
    }
    __syncthreads();
    if (n0 > warp_last) continue;  // every key of this tile is in this warp's future

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
        const int col = nt * 8 + t * 2 + (e & 1);
        const int key = n0 + col;
        const int row = e < 2 ? r0 : r1;
        const bool ok = key <= row && kval[col];
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
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)r0 * Hq + h) * kD + c) =
          pack_floats(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)r1 * Hq + h) * kD + c) =
          pack_floats(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  if (t == 0) {
    if (r0 < S) {
      m_out[(size_t)h * S + r0] = m_i[0];
      l_out[(size_t)h * S + r0] = l_i[0];
    }
    if (r1 < S) {
      m_out[(size_t)h * S + r1] = m_i[1];
      l_out[(size_t)h * S + r1] = l_i[1];
    }
  }
}

constexpr int kThreadsB = 256;
constexpr int kKeysPerWarpB = 8;
constexpr int kKeysPerBlockB = (kThreadsB / 32) * kKeysPerWarpB;

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__global__ void __launch_bounds__(kThreadsB)
attn_importance_rows_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                            const uint8_t* __restrict__ key_valid, const int64_t* __restrict__ rows,
                            const float* __restrict__ m, const float* __restrict__ l,
                            float* __restrict__ imp, int S, int Hq, int Hk, int num, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ms = reinterpret_cast<float*>(smem);        // (num, Hq)
  float* ls = ms + num * Hq;                         // (num, Hq)
  int* rs = reinterpret_cast<int*>(ls + num * Hq);   // (num,)
  uint16_t* qs = reinterpret_cast<uint16_t*>(rs + ((num + 3) & ~3));  // (num, Hq, D)

  for (int r = threadIdx.x; r < num; r += kThreadsB) rs[r] = static_cast<int>(rows[r]);
  __syncthreads();
  for (int idx = threadIdx.x; idx < num * Hq; idx += kThreadsB) {
    const int r = idx / Hq, h = idx % Hq;
    const int row = rs[r];
    ms[idx] = row >= 0 ? m[(size_t)h * S + row] : 0.f;
    ls[idx] = row >= 0 ? l[(size_t)h * S + row] : 1.f;
  }
  for (int idx = threadIdx.x; idx < num * Hq * kD; idx += kThreadsB) {
    const int r = idx / (Hq * kD), rem = idx % (Hq * kD);
    const int row = rs[r];
    qs[idx] = row >= 0 ? q[(size_t)row * Hq * kD + rem] : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = Hq / Hk;
  const float inv_norm = 1.f / static_cast<float>(Hq * num);
  for (int i = 0; i < kKeysPerWarpB; ++i) {
    const int j = blockIdx.x * kKeysPerBlockB + warp * kKeysPerWarpB + i;
    if (j >= S) break;
    const bool kv_ok = key_valid == nullptr || key_valid[j];
    float acc = 0.f;
    // Fixed summation order: kv head, capture row, head within the group.
    for (int hk = 0; hk < Hk; ++hk) {
      const uint2 raw = *reinterpret_cast<const uint2*>(k + ((size_t)j * Hk + hk) * kD + lane * 4);
      const float k0 = bf16_bits_to_float(raw.x & 0xffffu), k1 = bf16_bits_to_float(raw.x >> 16);
      const float k2 = bf16_bits_to_float(raw.y & 0xffffu), k3 = bf16_bits_to_float(raw.y >> 16);
      for (int r = 0; r < num; ++r) {
        const int row = rs[r];
        const bool take = kv_ok && row >= 0 && j <= row;
        for (int gi = 0; gi < group; ++gi) {
          const int h = hk * group + gi;
          const uint16_t* qp = qs + ((size_t)r * Hq + h) * kD + lane * 4;
          float s = bf16_bits_to_float(qp[0]) * k0;
          s = fmaf(bf16_bits_to_float(qp[1]), k1, s);
          s = fmaf(bf16_bits_to_float(qp[2]), k2, s);
          s = fmaf(bf16_bits_to_float(qp[3]), k3, s);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (take) acc += expf(s * scale - ms[r * Hq + h]) / ls[r * Hq + h];
        }
      }
    }
    if (lane == 0) imp[j] = acc * inv_norm;
  }
}

}  // namespace

extern "C" int ff_flash_attn_fwd(const void* q, const void* k, const void* v, const void* key_valid,
                                 void* out, void* m_out, void* l_out, int S, int Hq, int Hk,
                                 float scale, void* stream) {
  const dim3 grid((S + kBM - 1) / kBM, Hq);
  flash_attn_fwd_kernel<<<grid, kThreadsA, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<uint16_t*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out),
      S, Hq, Hk, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ff_attn_importance_rows_smem(int Hq, int num) {
  return num * Hq * 2 * 4 + ((num + 3) & ~3) * 4 + num * Hq * kD * 2;
}

extern "C" int ff_attn_importance_rows(const void* q, const void* k, const void* key_valid,
                                       const void* rows, const void* m, const void* l, void* imp,
                                       int S, int Hq, int Hk, int num, float scale, void* stream) {
  const int smem = ff_attn_importance_rows_smem(Hq, num);
  const dim3 grid((S + kKeysPerBlockB - 1) / kKeysPerBlockB);
  attn_importance_rows_kernel<<<grid, kThreadsB, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint8_t*>(key_valid), static_cast<const int64_t*>(rows),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<float*>(imp),
      S, Hq, Hk, num, scale);
  return static_cast<int>(cudaGetLastError());
}

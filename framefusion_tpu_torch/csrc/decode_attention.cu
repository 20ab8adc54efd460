// Ragged decode attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes).
//
// G. ff_ragged_decode_attn — one query token, q (Hq, 128) bf16, against the
//    first `cache_len` keys of a cache view (S_view, Hk, 128) bf16 in the
//    decode pool's natural layout; q-head h reads KV head h / G (G = Hq / Hk,
//    HF repeat_kv order). fp32 softmax with `scale`; the result is (Hq, 128)
//    bf16. Replaces the Pallas kernel
//    framefusion_tpu/ops/kernels/decode_attention.py (ragged_decode_attention,
//    _decode_kernel), whose grid walked the key blocks in order on one core,
//    carrying (m, l, acc) from step to step in VMEM scratch, and clamped its
//    block index map so that blocks past the length were not fetched.
//
//    Bound on the card: bytes. The live K and V rows, 2 * cache_len * Hk *
//    128 * 2 bytes, are read once; the work is 4 * G * 128 operations per
//    (key, KV head), ~3.5 per byte at G = 7, far below the ~295 operations
//    per byte where the tensor cores would matter, so the math runs on CUDA
//    cores in fp32.
//
//    Design: split-K flash decoding. Blocks run in parallel and in no order,
//    so the sequential key loop becomes a grid (n_split, Hk): each CTA owns a
//    contiguous range of 64-key tiles of one KV head, and only the CTAs below
//    cache_len are launched, so no byte past the length is read. A CTA loads
//    each K/V tile once into shared memory with 16-byte loads (the next
//    tile's loads are issued before the current tile is used) and serves all
//    G query heads of its KV head from it, keeping fp32 (m, l, acc[128]) per
//    head: in the score pass each thread owns one key and every other head,
//    in the P.V pass one output dimension of every head. The splits' partial
//    (m, l, acc) go to a workspace, and a second kernel merges them in split
//    order: no atomics, the result is bitwise repeatable.
//
// The entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;         // head dim; also the threads of a CTA (one per output dim)
constexpr int kBN = 64;         // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kMaxG = 16;       // query heads per KV head
constexpr int kMaxSplit = 1024; // key ranges a launch may split into
constexpr int kGroups = 4;      // thread groups of the combine, each summing every kGroups-th split
constexpr int kKRow = kD + 8;   // padded K row (bf16 units): a warp's 16-byte reads of 32 rows hit every bank once
constexpr int kChunks = kBN * (kD / 8) / kThreads;  // 16-byte K (and V) loads per thread per tile

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Partial attention of one KV head's G query heads over keys
// [split * keys_per_split, min(cache_len, (split + 1) * keys_per_split)).
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, int cache_len, int Hq, int Hk,
                    int keys_per_split, float scale, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml) {
  __shared__ __align__(16) uint16_t ks[kBN * kKRow];
  __shared__ __align__(16) uint16_t vs[kBN * kD];
  __shared__ __align__(16) float qs[kMaxG * kD];
  __shared__ __align__(16) float ps[kMaxG * kBN];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int G = Hq / Hk;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k_begin = split * keys_per_split;
  const int k_end = min(cache_len, k_begin + keys_per_split);

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  // Tile loads: thread tid moves 16-byte chunks tid + i * kThreads (row =
  // chunk / 16) of K and of V; rows at or past k_end are zero.
  uint4 kr[kChunks], vr[kChunks];
  auto load_tile = [&](int n0) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = tid + i * kThreads;
      const int key = n0 + (idx >> 4);
      kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
      if (key < k_end) {
        const size_t off = ((size_t)key * Hk + hk) * kD + (idx & 15) * 8;
        kr[i] = *reinterpret_cast<const uint4*>(k + off);
        vr[i] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };
  load_tile(k_begin);  // in flight while q is read

  // This KV head's G query rows, fp32, pre-scaled: one 16-byte load a
  // thread (two at G = 16).
  for (int i = tid; i < G * kD / 8; i += kThreads) {
    const uint4 w = reinterpret_cast<const uint4*>(q + (size_t)hk * G * kD)[i];
    *reinterpret_cast<float4*>(&qs[i * 8]) =
        make_float4(bf16_lo(w.x) * scale, bf16_hi(w.x) * scale, bf16_lo(w.y) * scale, bf16_hi(w.y) * scale);
    *reinterpret_cast<float4*>(&qs[i * 8 + 4]) =
        make_float4(bf16_lo(w.z) * scale, bf16_hi(w.z) * scale, bf16_lo(w.w) * scale, bf16_hi(w.w) * scale);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int j = tid & (kBN - 1);  // this thread's key in the score pass
  const int g0 = tid >> 6;        // and its first head: heads g0, g0 + 2, ...

  for (int n0 = k_begin; n0 < k_end; n0 += kBN) {
    __syncthreads();  // the previous tile is consumed (and qs, m_s, l_s are set)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&ks[(idx >> 4) * kKRow + (idx & 15) * 8]) = kr[i];
      *reinterpret_cast<uint4*>(&vs[(idx >> 4) * kD + (idx & 15) * 8]) = vr[i];
    }
    if (n0 + kBN < k_end) load_tile(n0 + kBN);  // in flight while this tile is used
    __syncthreads();

    // Scores of key j for heads g0, g0 + 2, ...; keys past the length are -inf.
    float s[kMaxG / 2];
#pragma unroll
    for (int i = 0; i < kMaxG / 2; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kD / 8; ++c) {
      const uint4 kw = *reinterpret_cast<const uint4*>(&ks[j * kKRow + c * 8]);
      const float kf[8] = {bf16_lo(kw.x), bf16_hi(kw.x), bf16_lo(kw.y), bf16_hi(kw.y),
                           bf16_lo(kw.z), bf16_hi(kw.z), bf16_lo(kw.w), bf16_hi(kw.w)};
#pragma unroll
      for (int i = 0; i < kMaxG / 2; ++i) {
        const int g = g0 + 2 * i;
        if (g < G) {
          const float4 qa = *reinterpret_cast<const float4*>(&qs[g * kD + c * 8]);
          const float4 qb = *reinterpret_cast<const float4*>(&qs[g * kD + c * 8 + 4]);
          float t = s[i];
          t = fmaf(qa.x, kf[0], t);
          t = fmaf(qa.y, kf[1], t);
          t = fmaf(qa.z, kf[2], t);
          t = fmaf(qa.w, kf[3], t);
          t = fmaf(qb.x, kf[4], t);
          t = fmaf(qb.y, kf[5], t);
          t = fmaf(qb.z, kf[6], t);
          t = fmaf(qb.w, kf[7], t);
          s[i] = t;
        }
      }
    }
    const bool live = n0 + j < k_end;
#pragma unroll
    for (int i = 0; i < kMaxG / 2; ++i) {
      const int g = g0 + 2 * i;
      if (g < G) ps[g * kBN + j] = live ? s[i] : -INFINITY;
    }
    __syncthreads();

    // Online softmax, one warp per head (two keys a lane). Every tile holds
    // at least one live key, so the new running max is finite.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = ps[g * kBN + lane], s1 = ps[g * kBN + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[g * kBN + lane] = p0;
      ps[g * kBN + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g] of output dim tid: rescale, then add P.V over the tile's live
    // keys (rounded up to 4; the extra keys have p = 0 and zero V rows).
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] *= alpha_s[g];
    const int n_keys = (min(kBN, k_end - n0) + 3) & ~3;
#pragma unroll 4
    for (int jj = 0; jj < n_keys; jj += 4) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = __uint_as_float(static_cast<uint32_t>(vs[(jj + u) * kD + tid]) << 16);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(&ps[g * kBN + jj]);
          float a = acc[g];
          a = fmaf(p.x, vv[0], a);
          a = fmaf(p.y, vv[1], a);
          a = fmaf(p.z, vv[2], a);
          a = fmaf(p.w, vv[3], a);
          acc[g] = a;
        }
      }
    }
  }

  // This split's unnormalised (m, l, acc) per query head.
  const size_t row0 = (size_t)split * Hq + (size_t)hk * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) ws_acc[(row0 + g) * kD + tid] = acc[g];
  if (tid < G) {
    ws_ml[(row0 + tid) * 2] = m_s[tid];
    ws_ml[(row0 + tid) * 2 + 1] = l_s[tid];
  }
}

// out[h, d] = sum_s acc_s[h, d] * e^(m_s - M) / sum_s l_s e^(m_s - M). The
// splits' weights are computed once per head into shared memory (their m
// read in parallel); kGroups groups of 128 threads each sum every kGroups-th
// split in split order, and the group sums are added in group order: a fixed
// order, so the result is bitwise repeatable.
__global__ void __launch_bounds__(kD * kGroups)
decode_combine_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml, int n_split,
                      int Hq, __nv_bfloat16* __restrict__ out) {
  __shared__ float w_s[kMaxSplit];
  __shared__ float red[kD * kGroups / 32];
  __shared__ float part_o[kGroups][kD];
  __shared__ float part_l[kGroups];
  const int h = blockIdx.x, tid = threadIdx.x;
  const int d = tid % kD, grp = tid / kD;
  const int warp = tid >> 5, lane = tid & 31;

  float m = -INFINITY;
  for (int s = tid; s < n_split; s += kD * kGroups) m = fmaxf(m, ws_ml[((size_t)s * Hq + h) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kD * kGroups / 32; ++w) m = fmaxf(m, red[w]);
  for (int s = tid; s < n_split; s += kD * kGroups) w_s[s] = expf(ws_ml[((size_t)s * Hq + h) * 2] - m);
  __syncthreads();

  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int s = grp; s < n_split; s += kGroups) {
    const size_t r = (size_t)s * Hq + h;
    l = fmaf(ws_ml[r * 2 + 1], w_s[s], l);
    o = fmaf(ws_acc[r * kD + d], w_s[s], o);
  }
  part_o[grp][d] = o;
  if (d == 0) part_l[grp] = l;
  __syncthreads();
  if (grp == 0) {
    o = part_o[0][d];
    l = part_l[0];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      o += part_o[g][d];
      l += part_l[g];
    }
    out[(size_t)h * kD + d] = __float2bfloat16(o / l);
  }
}

}  // namespace

extern "C" int ff_ragged_decode_max_group() { return kMaxG; }

// ws_acc: (n_split, Hq, 128) fp32, ws_ml: (n_split, Hq, 2) fp32 scratch;
// n_split * keys_per_split >= cache_len > (n_split - 1) * keys_per_split,
// n_split <= kMaxSplit.
extern "C" int ff_ragged_decode_attn(const void* q, const void* k, const void* v, void* out, void* ws_acc,
                                     void* ws_ml, int cache_len, int Hq, int Hk, int keys_per_split,
                                     int n_split, float scale, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > kMaxG || cache_len <= 0 || keys_per_split % kBN != 0 ||
      n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_split_kernel<<<dim3(n_split, Hk), kThreads, 0, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
      cache_len, Hq, Hk, keys_per_split, scale, static_cast<float*>(ws_acc), static_cast<float*>(ws_ml));
  decode_combine_kernel<<<Hq, kD * kGroups, 0, s>>>(static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
                                          n_split, Hq, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

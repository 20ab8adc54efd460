// Decode matvec kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Two kernels share one weight-streaming pass:
//
// C. ff_gemv_stacked — (B <= 64, K) bf16 activations times layer `l` of one,
//    two or three (L, K, N) weight stacks, bf16 or int8 (a template), fp32
//    accumulation, (B, N) fp32 outputs; the caller applies per-channel int8
//    scales. Replaces framefusion_tpu/ops/kernels/matvec_q8.py
//    matvec_stacked (wo, w_down) and matvec_stacked_qkv (wq/wk/wv in one
//    launch).
// D. ff_gemv_gateup — the same pass over the gate and up stacks with the
//    epilogue silu(g * sg) * (u * su). Replaces matvec_stacked_gateup.
//
// Bound on the card: weight bytes. A decode step at B = 1 reads every
// weight once and does two operations per weight byte (int8) or one (bf16),
// far below the ~295 operations per byte where the tensor cores would
// become the limit, so the design only has to keep enough 16-byte loads in
// flight: each thread streams 16 contiguous bytes of a weight row (8 bf16 or
// 16 int8 columns), a warp covers 256 or 512 columns of one row, the eight
// warps of a CTA walk interleaved rows of a K-chunk, and the K dimension is
// split across CTAs (about four CTAs per SM) so a 512-column projection
// still fills 132 SMs. The split-K partial sums go to a workspace and a
// second kernel adds them in a fixed order: outputs are bitwise repeatable
// run to run (no atomics). Activation rows are grid.z, so B > 1 re-reads the
// weights through L2; the main path is B = 1.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKChunk = 2048;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) {
  return __uint_as_float(b << 16);
}

template <typename T>
struct WeightVec;

template <>
struct WeightVec<uint16_t> {  // bf16 bits
  static constexpr int kN = 8;
  __device__ static void load(const uint16_t* p, float out[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_bits_to_float(w[i] & 0xffffu);
      out[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
    }
  }
};

template <>
struct WeightVec<int8_t> {
  static constexpr int kN = 16;
  __device__ static void load(const int8_t* p, float out[16]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
    }
  }
};

struct Stacks {
  const void* w[3];
  int n[3];
  int tiles[3];
};

// Partial sums of x[b, k-chunk] @ w_s[l][k-chunk, tile] into ws[chunk, b, :].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv_partial_kernel(const uint16_t* __restrict__ x, int B, int K, size_t layer_off, Stacks st,
                    float* __restrict__ ws, int n_total, int kchunk) {
  constexpr int V = WeightVec<T>::kN;
  constexpr int kTile = 32 * V;
  __shared__ float xs[kMaxKChunk];
  __shared__ float red[kWarps][kTile];

  int tile = blockIdx.x, s = 0, col_off = 0;
  while (tile >= st.tiles[s]) {
    tile -= st.tiles[s];
    col_off += st.n[s];
    ++s;
  }
  const int n = st.n[s];
  const T* w = static_cast<const T*>(st.w[s]) + (size_t)n * layer_off;
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = tile * kTile + lane * V;

  for (int kk = k0 + threadIdx.x; kk < k1; kk += kThreads)
    xs[kk - k0] = bf16_bits_to_float(x[(size_t)b * K + kk]);
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (col < n) {
    for (int kk = k0 + warp; kk < k1; kk += kWarps) {
      float wv[V];
      WeightVec<T>::load(w + (size_t)kk * n + col, wv);
      const float xv = xs[kk - k0];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(xv, wv[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) red[warp][lane * V + i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int gc = tile * kTile + c;
    if (gc >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) sum += red[w8][c];
    ws[((size_t)blockIdx.y * B + b) * n_total + col_off + gc] = sum;
  }
}

// out_s[b, c] = sum over chunks, in chunk order.
__global__ void gemv_reduce_kernel(const float* __restrict__ ws, int n_chunks, int B, int n_total,
                                   float* o0, float* o1, float* o2, int n0, int n1) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n_total) return;
  const int b = idx / n_total, c = idx % n_total;
  float sum = 0.f;
  for (int y = 0; y < n_chunks; ++y) sum += ws[((size_t)y * B + b) * n_total + c];
  if (c < n0) {
    o0[(size_t)b * n0 + c] = sum;
  } else if (c < n0 + n1) {
    o1[(size_t)b * n1 + c - n0] = sum;
  } else {
    o2[(size_t)b * (n_total - n0 - n1) + c - n0 - n1] = sum;
  }
}

// out[b, c] = silu(g * sg[c]) * (u * su[c]); g, u are the two stacks' sums.
__global__ void gateup_reduce_kernel(const float* __restrict__ ws, int n_chunks, int B, int n,
                                     const float* __restrict__ sg, const float* __restrict__ su,
                                     float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n) return;
  const int b = idx / n, c = idx % n;
  float gs = 0.f, us = 0.f;
  for (int y = 0; y < n_chunks; ++y) {
    const float* row = ws + ((size_t)y * B + b) * 2 * n;
    gs += row[c];
    us += row[n + c];
  }
  if (sg != nullptr) gs *= sg[c];
  if (su != nullptr) us *= su[c];
  out[(size_t)b * n + c] = gs / (1.f + expf(-gs)) * us;
}

Stacks make_stacks(int vec, const void* w0, const void* w1, const void* w2, int n0, int n1, int n2,
                   int* n_tiles) {
  Stacks st;
  const void* ws[3] = {w0, w1, w2};
  const int ns[3] = {n0, n1, n2};
  const int tile = 32 * vec;
  *n_tiles = 0;
  for (int i = 0; i < 3; ++i) {
    st.w[i] = ws[i];
    st.n[i] = ns[i];
    st.tiles[i] = ws[i] ? (ns[i] + tile - 1) / tile : 0;
    *n_tiles += st.tiles[i];
  }
  return st;
}

void launch_partial(int wtype, const void* x, int B, int K, int layer, const Stacks& st,
                    int n_tiles, float* ws, int n_total, int n_chunks, int kchunk,
                    cudaStream_t stream) {
  const dim3 grid(n_tiles, n_chunks, B);
  const size_t layer_off = (size_t)layer * K;  // times N inside the kernel
  if (wtype == 1) {
    gemv_partial_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), B, K, layer_off, st, ws, n_total, kchunk);
  } else {
    gemv_partial_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), B, K, layer_off, st, ws, n_total, kchunk);
  }
}

}  // namespace

extern "C" int ff_gemv_max_kchunk() { return kMaxKChunk; }

// wtype: 0 = bf16 stacks, 1 = int8 stacks. Unused stacks pass nullptr / 0.
extern "C" int ff_gemv_stacked(const void* x, int B, int K, int layer, int wtype,
                               const void* w0, const void* w1, const void* w2,
                               int n0, int n1, int n2, void* o0, void* o1, void* o2,
                               void* ws, int n_chunks, int kchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0;
  const Stacks st = make_stacks(wtype == 1 ? 16 : 8, w0, w1, w2, n0, n1, n2, &n_tiles);
  const int n_total = n0 + n1 + n2;
  launch_partial(wtype, x, B, K, layer, st, n_tiles, static_cast<float*>(ws), n_total, n_chunks,
                 kchunk, s);
  const int total = B * n_total;
  gemv_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), n_chunks, B, n_total, static_cast<float*>(o0),
      static_cast<float*>(o1), static_cast<float*>(o2), n0, n1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ff_gemv_gateup(const void* x, int B, int K, int layer, int wtype,
                              const void* wg, const void* wu, int n, const void* sg,
                              const void* su, void* out, void* ws, int n_chunks, int kchunk,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0;
  const Stacks st = make_stacks(wtype == 1 ? 16 : 8, wg, wu, nullptr, n, n, 0, &n_tiles);
  launch_partial(wtype, x, B, K, layer, st, n_tiles, static_cast<float*>(ws), 2 * n, n_chunks,
                 kchunk, s);
  const int total = B * n;
  gateup_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), n_chunks, B, n, static_cast<const float*>(sg),
      static_cast<const float*>(su), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

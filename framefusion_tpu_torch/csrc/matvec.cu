// Decode matvec kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Two kernels share one weight-streaming pass:
//
// C. ff_gemv_stacked — (B <= 64, K) bf16 activations times layer `l` of one,
//    two or three (L, K, N) weight stacks, bf16 or int8 (a template), fp32
//    accumulation, (B, N) fp32 outputs; the caller applies per-channel int8
//    scales. Replaces framefusion_tpu/ops/kernels/matvec_q8.py _matvec,
//    matvec_q8, matvec_bf16, matvec_stacked (wo, w_down) and
//    matvec_stacked_qkv (wq/wk/wv in one launch).
// D. ff_gemv_gateup — the same pass over the gate and up stacks with the
//    epilogue silu(g * sg) * (u * su) in a second launch. Replaces
//    matvec_stacked_gateup.
// Routed rows (Qwen2-MoE decode): both take an optional device array of
// int32 stack indices, one an activation row; row b then reads matrix
// row_idx[b] of the stacks viewed as (L * E, K, N) in place of the host
// `layer`, and kernel D's epilogue reads that matrix's scales from the
// (L * E, N) tables. The index never leaves the card, so a decode step that
// routes on the device stays one capturable graph. A null array is the
// unrouted path, unchanged.
//
// Bound on the card: weight bytes. A decode step at B = 1 reads every
// weight once and does two operations per weight byte (int8) or one (bf16),
// far below the ~295 operations per byte where the tensor cores would
// become the limit, so the design only has to keep the memory busy from the
// first microsecond to the last, and keep the per-weight arithmetic off the
// critical path:
// * Loads: a CTA reads 512 contiguous bytes of each weight row of its
//   K-chunk (256 bf16 or 512 int8 columns: a column tile). A producer warp
//   copies them into a 6-stage ring of 32-row stages in shared memory with
//   the bulk-copy engine, a row a lane, up to six stages (96 KB) ahead, with
//   a `full` and an `empty` mbarrier per stage; the CTA's whole K-chunk is
//   in flight from its first cycle at the decode shapes. Eight consumer
//   warps take interleaved rows of each stage, 16 bytes a lane.
// * Split plan (ops/kernels/matvec_q8.py split_plan): K is split across
//   CTAs so that the column tiles times the K-chunks make one wave of
//   about two CTAs an SM, the smallest projection (wo, N 3,584) included.
// * One launch: each CTA writes its partial sums to a workspace, then takes
//   a ticket from its column tile's arrival counter (a barrier, one
//   thread's __threadfence, atomicAdd). The CTA that arrives last adds the
//   partials in a fixed order (each warp a contiguous range of K-chunks in
//   chunk order, its loads in flight together, then the warps in order), so
//   the result does not depend on which CTA arrives last and is bitwise
//   repeatable, and resets the counter to 0.
//   Stream order: a call's kernel starts after the previous call's on the
//   same stream has ended, so it finds the counters at 0; the wrapper keeps
//   one counter buffer per (device, stream), and a CUDA graph replays on
//   one stream at a time.
// * int8 widening: a byte permute puts each (sign-flipped) byte into the
//   mantissa of 2^23, and one subtraction gives its value: two operations a
//   weight instead of a shift, a mask and an int-to-float conversion.
// Activation rows are grid.z, so B > 1 rows read the weights B times (through
// L2 at best): the batched decode pays for each row, where the TPU kernel
// reads each weight tile once for all rows. Kernel D runs the same pass without the counters and
// its gate-up epilogue kernel adds the partials in chunk order.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kSeg = 512;                      // bytes of each weight row a CTA reads: 32 lanes x 16
constexpr int kRows = 32;                      // weight rows a ring stage holds
constexpr int kStages = 6;
constexpr int kStageBytes = kRows * kSeg;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxKChunk = 2048;               // rows of x staged in shared memory
constexpr int kRedBytes = kConsumerWarps * 16 * 33 * 4;  // the cross-warp sums, padded: aliases the ring
static_assert(kRedBytes <= kRingBytes, "the cross-warp sums fit the ring");
constexpr int kSmemBytes = kRingBytes + kMaxKChunk * 4 + 2 * kStages * 8 + 16;

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
// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine,
// completing on the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// The consumer warps' own barrier (the producer warp has left).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

template <typename T>
struct WeightVec;

template <>
struct WeightVec<uint16_t> {  // bf16 bits
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& r, float out[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct WeightVec<int8_t> {
  static constexpr int kN = 16;
  // 0x4B000000 is 2^23 as a float; a byte u in its low mantissa bits reads
  // 2^23 + u. Flipping the sign bit first maps int8 b to u = b + 128.
  __device__ static void widen(const uint4& r, float out[16]) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540)) - 8388736.f;
      out[4 * i + 1] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7541)) - 8388736.f;
      out[4 * i + 2] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7542)) - 8388736.f;
      out[4 * i + 3] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7543)) - 8388736.f;
    }
  }
};

struct Stacks {
  const void* w[3];
  void* out[3];
  int n[3];
  int tiles[3];
};

// The consumer warps' V column sums a lane (column lane * V + j of the
// tile) added across the warps, in warp order, through shared memory padded
// to 33 floats a row (neither the writes nor the reads conflict). On return
// part[h] holds column (t % 32) * V + t / 32 + 8 * h of thread t, h < V / 8.
template <int V>
__device__ __forceinline__ void cta_sums(float* red, float (&part)[V], int warp, int lane) {
  consumers_sync();  // red is free
#pragma unroll
  for (int j = 0; j < V; ++j) red[(warp * V + j) * 33 + lane] = part[j];
  consumers_sync();
#pragma unroll
  for (int h = 0; h < V / 8; ++h) {
    const int j = (threadIdx.x >> 5) + 8 * h;
    float sum = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kConsumerWarps; ++w8) sum += red[(w8 * V + j) * 33 + (threadIdx.x & 31)];
    part[h] = sum;
  }
}

// Partial sums of x[b, k-chunk] @ w_s[l][k-chunk, tile] into ws[chunk, b, :];
// with counters, the last CTA of the (b, tile) to arrive adds the chunks in
// order into out_s[b, tile] (counters == nullptr: kernel D's epilogue does).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const uint16_t* __restrict__ x, int B, int K, size_t layer_off, Stacks st,
            float* __restrict__ ws, int n_total, int kchunk, int n_chunks, unsigned int* __restrict__ counters,
            const int* __restrict__ row_idx) {
  constexpr int V = WeightVec<T>::kN;
  constexpr int kTile = 32 * V;  // columns of a tile: kSeg bytes
  extern __shared__ __align__(128) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem + kRingBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kMaxKChunk);  // full[kStages], empty[kStages]
  int* is_last = reinterpret_cast<int*>(bars + 2 * kStages);
  const uint32_t ring0 = smem_addr(smem), full0 = smem_addr(bars), empty0 = full0 + 8 * kStages;

  // This CTA's stack and column tile (constant indices into st: a
  // parameter array indexed at run time would be copied to local memory).
  int tile = blockIdx.x, s = 0, col_off = 0;
  if (tile >= st.tiles[0]) {
    tile -= st.tiles[0];
    col_off = st.n[0];
    s = 1;
    if (tile >= st.tiles[1]) {
      tile -= st.tiles[1];
      col_off += st.n[1];
      s = 2;
    }
  }
  const int n = s == 0 ? st.n[0] : s == 1 ? st.n[1] : st.n[2];
  const int b = blockIdx.z;
  if (row_idx != nullptr) layer_off = static_cast<size_t>(__ldg(row_idx + b)) * K;  // this row's matrix
  const T* w = static_cast<const T*>(s == 0 ? st.w[0] : s == 1 ? st.w[1] : st.w[2]) + static_cast<size_t>(n) * layer_off;
  float* out = static_cast<float*>(s == 0 ? st.out[0] : s == 1 ? st.out[1] : st.out[2]);
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const int n_stages = (k1 - k0 + kRows - 1) / kRows;
  const int col0 = tile * kTile;
  const int seg = min(kSeg, (n - col0) * static_cast<int>(sizeof(T)));  // bytes of each row in this tile
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + i * 8, 1);
      mbar_init(empty0 + i * 8, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: a row's segment a lane, a stage at a time
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w + static_cast<size_t>(k0) * n + col0);
    const size_t row_bytes = static_cast<size_t>(n) * sizeof(T);
    for (int i = 0; i < n_stages; ++i) {
      const int slot = i % kStages;
      if (i >= kStages) mbar_wait(empty0 + slot * 8, (i / kStages - 1) & 1);  // the consumers are done with it
      const int rows = min(kRows, k1 - k0 - i * kRows);
      if (lane == 0) mbar_expect(full0 + slot * 8, rows * seg);
      __syncwarp();
      if (lane < rows)
        bulk_copy(ring0 + slot * kStageBytes + lane * kSeg, src + static_cast<size_t>(i * kRows + lane) * row_bytes,
                  seg, full0 + slot * 8);
    }
    return;
  }

  for (int kk = k0 + threadIdx.x; kk < k1; kk += kConsumers)
    xs[kk - k0] = __uint_as_float(static_cast<uint32_t>(x[static_cast<size_t>(b) * K + kk]) << 16);
  consumers_sync();

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const bool live = lane * 16 < seg;  // this thread's 16 bytes lie inside the tile's columns
  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % kStages;
    mbar_wait(full0 + slot * 8, (i / kStages) & 1);  // the stage has landed
    const int rows = min(kRows, k1 - k0 - i * kRows);
    if (live) {
      uint4 r[kRows / kConsumerWarps];
#pragma unroll
      for (int u = 0; u < kRows / kConsumerWarps; ++u)
        r[u] = *reinterpret_cast<const uint4*>(smem + slot * kStageBytes + (warp + u * kConsumerWarps) * kSeg + lane * 16);
#pragma unroll
      for (int u = 0; u < kRows / kConsumerWarps; ++u) {
        const int row = warp + u * kConsumerWarps;
        if (row < rows) {
          const float xv = xs[i * kRows + row];
          float wv[V];
          WeightVec<T>::widen(r[u], wv);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + slot * 8);  // this warp is done with the stage
  }

  // The warps' sums meet in shared memory (the ring's bytes, all consumed).
  cta_sums<V>(reinterpret_cast<float*>(smem), acc, warp, lane);
#pragma unroll
  for (int h = 0; h < V / 8; ++h) {
    const int gc = col0 + (threadIdx.x & 31) * V + (threadIdx.x >> 5) + 8 * h;
    if (gc >= n) continue;
    if (counters != nullptr && n_chunks == 1)
      out[static_cast<size_t>(b) * n + gc] = acc[h];
    else
      ws[(static_cast<size_t>(blockIdx.y) * B + b) * n_total + col_off + gc] = acc[h];
  }
  if (counters == nullptr || n_chunks == 1) return;

  // The last CTA of this (row, column tile) to arrive adds every chunk's
  // partials (the barrier-then-one-thread fence of a grid barrier publishes
  // the whole CTA's partials before its ticket).
  consumers_sync();
  unsigned int* counter = counters + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    __threadfence();
    *is_last = atomicAdd(counter, 1u) == static_cast<unsigned int>(n_chunks - 1);
    if (*is_last) {
      *counter = 0u;     // zeroed for the next call (and graph replay) on this stream
      __threadfence();   // every other CTA's partials are visible to this one
    }
  }
  consumers_sync();
  if (!*is_last) return;
  // The merge, in a fixed order whichever CTA arrives last: warp w adds the
  // contiguous K-chunks [w * n_chunks / 8, (w + 1) * n_chunks / 8) in chunk
  // order (each lane its V columns, four chunks' loads in flight at a
  // time), then the warps' sums meet in warp order as above. (A column a
  // thread over every chunk, in strict chunk order, needs enough registers
  // to halve the CTAs an SM holds, which costs more than it saves.)
  float part[V];
#pragma unroll
  for (int j = 0; j < V; ++j) part[j] = 0.f;
  if (lane * V < n - col0) {
    const int y0 = warp * n_chunks / kConsumerWarps, y1 = (warp + 1) * n_chunks / kConsumerWarps;
    const float* p = ws + static_cast<size_t>(b) * n_total + col_off + col0 + lane * V;
    const size_t step = static_cast<size_t>(B) * n_total;
    for (int y = y0; y < y1; y += 4) {
      float4 v[4][V / 4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (y + u < y1)
#pragma unroll
          for (int q = 0; q < V / 4; ++q) v[u][q] = __ldcg(reinterpret_cast<const float4*>(p + (y + u) * step) + q);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (y + u < y1)
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            part[4 * q] += v[u][q].x;
            part[4 * q + 1] += v[u][q].y;
            part[4 * q + 2] += v[u][q].z;
            part[4 * q + 3] += v[u][q].w;
          }
    }
  }
  cta_sums<V>(reinterpret_cast<float*>(smem), part, warp, lane);
#pragma unroll
  for (int h = 0; h < V / 8; ++h) {
    const int gc = col0 + (threadIdx.x & 31) * V + (threadIdx.x >> 5) + 8 * h;
    if (gc < n) out[static_cast<size_t>(b) * n + gc] = part[h];
  }
}

// out[b, c] = silu(g * sg[c]) * (u * su[c]); g, u are the two stacks' sums.
// With row_idx the scales are row row_idx[b] of (L * E, n) tables.
__global__ void gateup_reduce_kernel(const float* __restrict__ ws, int n_chunks, int B, int n,
                                     const float* __restrict__ sg, const float* __restrict__ su,
                                     float* __restrict__ out, const int* __restrict__ row_idx) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n) return;
  const int b = idx / n;
  const size_t c = static_cast<size_t>(idx % n) + (row_idx != nullptr ? static_cast<size_t>(row_idx[b]) * n : 0);
  float gs = 0.f, us = 0.f;
  for (int y = 0; y < n_chunks; ++y) {
    const float* row = ws + ((size_t)y * B + b) * 2 * n;
    gs += row[idx % n];
    us += row[n + idx % n];
  }
  if (sg != nullptr) gs *= sg[c];
  if (su != nullptr) us *= su[c];
  out[idx] = gs / (1.f + expf(-gs)) * us;
}

Stacks make_stacks(int vec, const void* w0, const void* w1, const void* w2, void* o0, void* o1, void* o2,
                   int n0, int n1, int n2, int* n_tiles) {
  Stacks st;
  const void* ws[3] = {w0, w1, w2};
  void* os[3] = {o0, o1, o2};
  const int ns[3] = {n0, n1, n2};
  const int tile = 32 * vec;
  *n_tiles = 0;
  for (int i = 0; i < 3; ++i) {
    st.w[i] = ws[i];
    st.out[i] = os[i];
    st.n[i] = ns[i];
    st.tiles[i] = ws[i] ? (ns[i] + tile - 1) / tile : 0;
    *n_tiles += st.tiles[i];
  }
  return st;
}

template <typename T>
int launch_typed(const void* x, int B, int K, int layer, const Stacks& st, int n_tiles, float* ws, int n_total,
                 int n_chunks, int kchunk, unsigned int* counters, const int* row_idx, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set[64] = {};  // the opt-in above 48 KB, once per device
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(gemv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid(n_tiles, n_chunks, B);
  gemv_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(static_cast<const uint16_t*>(x), B, K,
                                                         static_cast<size_t>(layer) * K, st, ws, n_total, kchunk,
                                                         n_chunks, counters, row_idx);
  return static_cast<int>(cudaGetLastError());
}

int launch_gemv(int wtype, const void* x, int B, int K, int layer, const Stacks& st, int n_tiles, float* ws,
                int n_total, int n_chunks, int kchunk, unsigned int* counters, const int* row_idx,
                cudaStream_t stream) {
  return wtype == 1 ? launch_typed<int8_t>(x, B, K, layer, st, n_tiles, ws, n_total, n_chunks, kchunk, counters,
                                           row_idx, stream)
                    : launch_typed<uint16_t>(x, B, K, layer, st, n_tiles, ws, n_total, n_chunks, kchunk, counters,
                                             row_idx, stream);
}

bool plan_ok(int K, int n_chunks, int kchunk) {
  return n_chunks > 0 && kchunk > 0 && kchunk <= kMaxKChunk && static_cast<long long>(n_chunks) * kchunk >= K &&
         static_cast<long long>(n_chunks - 1) * kchunk < K;
}

}  // namespace

// wtype: 0 = bf16 stacks, 1 = int8 stacks. Unused stacks pass nullptr / 0.
// ws: (n_chunks, B, n0 + n1 + n2) fp32 scratch; counters: B * (column
// tiles) uint32, zero, owned by the calling stream (left at zero).
// row_idx: nullptr, or B int32 stack indices on the device (then `layer`
// is unused).
extern "C" int ff_gemv_stacked(const void* x, int B, int K, int layer, int wtype,
                               const void* w0, const void* w1, const void* w2,
                               int n0, int n1, int n2, void* o0, void* o1, void* o2,
                               void* ws, void* counters, int n_chunks, int kchunk, const void* row_idx,
                               void* stream) {
  if (!plan_ok(K, n_chunks, kchunk) || counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = 0;
  const Stacks st = make_stacks(wtype == 1 ? 16 : 8, w0, w1, w2, o0, o1, o2, n0, n1, n2, &n_tiles);
  return launch_gemv(wtype, x, B, K, layer, st, n_tiles, static_cast<float*>(ws), n0 + n1 + n2, n_chunks, kchunk,
                     static_cast<unsigned int*>(counters), static_cast<const int*>(row_idx),
                     static_cast<cudaStream_t>(stream));
}

// sg, su: (n,) fp32 scales of `layer`, or with row_idx the whole (L * E,
// n) tables; nullptr for bf16 stacks.
extern "C" int ff_gemv_gateup(const void* x, int B, int K, int layer, int wtype,
                              const void* wg, const void* wu, int n, const void* sg,
                              const void* su, void* out, void* ws, int n_chunks, int kchunk,
                              const void* row_idx, void* stream) {
  if (!plan_ok(K, n_chunks, kchunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0;
  const Stacks st = make_stacks(wtype == 1 ? 16 : 8, wg, wu, nullptr, nullptr, nullptr, nullptr, n, n, 0, &n_tiles);
  const int* rows = static_cast<const int*>(row_idx);
  const int status = launch_gemv(wtype, x, B, K, layer, st, n_tiles, static_cast<float*>(ws), 2 * n, n_chunks, kchunk,
                                 nullptr, rows, s);
  if (status != 0) return status;
  const int total = B * n;
  gateup_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), n_chunks, B, n, static_cast<const float*>(sg),
      static_cast<const float*>(su), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

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
// unrouted path.
//
// Bound on the card: weight bytes. A decode step reads every weight once;
// at B rows it does 2B operations per weight (one byte of int8, two of
// bf16): at B = 64 still below the ~295 operations per byte where the
// tensor cores would become the limit. So the design has to keep the memory
// busy from the first microsecond to the last, read each weight once
// whatever the rows, and keep the per-weight arithmetic off the critical
// path. Two passes share the loads, the split plan and the merge:
// * Loads: a CTA reads a column tile of each weight row of its K-chunk. A
//   producer warp copies them into a ring of stages in shared memory, about
//   96 KB ahead, with a `full` and an `empty` mbarrier per stage; the CTA's
//   whole K-chunk is in flight from its first cycle at the decode shapes.
//   Eight consumer warps take the stages.
// * Split plan (ops/kernels/matvec_q8.py split_plan): K is split across
//   CTAs so that the column tiles times the K-chunks make one wave of
//   about two CTAs an SM, the smallest projection (wo, N 3,584) included.
//   The plan does not depend on the rows: each CTA serves all of them.
// * One launch: each CTA writes its partial sums to a workspace, then takes
//   a ticket from its column tile's arrival counter (a barrier, one
//   thread's __threadfence, atomicAdd). The CTA that arrives last adds the
//   partials in a fixed order, so the result does not depend on which CTA
//   arrives last and is bitwise repeatable, and resets the counter to 0.
//   Stream order: a call's kernel starts after the previous call's on the
//   same stream has ended, so it finds the counters at 0; the wrapper keeps
//   one counter buffer per (device, stream), and a CUDA graph replays on
//   one stream at a time. Kernel D runs the same pass without the counters
//   and its gate-up epilogue kernel adds the partials in chunk order.
// * One row (gemv_kernel): a column tile is 512 bytes of each weight row
//   (256 bf16 or 512 int8 columns), one bulk copy a row and lane, in a
//   6-stage ring of 32-row stages; each consumer lane takes 16 bytes of a
//   row and keeps its columns' sums in fp32 on the CUDA cores; the warps'
//   sums meet in shared memory. int8 widening: a byte permute puts each
//   (sign-flipped) byte into the mantissa of 2^23, and one subtraction
//   gives its value.
// * 2-64 rows (rows_kernel): all the launch's rows share each weight tile,
//   as the TPU kernel's (rows, bk) activation block does, and the products
//   run on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 out) with
//   the operands swapped: the weight tile, transposed, is the 16-row A
//   operand (ldmatrix.trans from the K-major ring), the rows are the 8-wide
//   B operand (NT tiles of 8 rows), and a warp owns 32 columns of a
//   256-column tile for the whole K-chunk, so no cross-warp sum is needed.
//   int8 widens exactly to bf16 (|v| <= 127 fits its mantissa): ldmatrix
//   gives a lane two columns of two K rows in one register, which the
//   2^23 trick and a byte permute turn into the A fragments of two M rows
//   (a column order the store undoes). A stage is 32 weight rows as TMA
//   boxes of 128 bytes (two int8, four bf16; the 128-byte swizzle puts
//   ldmatrix's 8 rows in 8 bank groups) and the same 32 K-values of the
//   rows' activations (one box; routed rows a bulk copy a row), so x never
//   has to fit shared memory whole. Copies a row of 256 bytes held the
//   rate at ~5 G copies/s, half the bytes bound for int8: the boxes take
//   two to five copies a stage. The accumulators (8 NT a thread, at most
//   64) keep two CTAs an SM. The last CTA of a tile adds the chunks in
//   chunk order, each thread four columns of a row.
//   Routed rows: the CTAs of one (tile, K-chunk) are a fixed grid of
//   min(B, L * E) group slots; each CTA groups the indices itself (slot s
//   is the s-th distinct index in order of first occurrence, its rows in
//   ascending order), so each distinct matrix is read once for all the
//   rows that chose it, and the CTAs of empty slots exit.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_map.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kSeg = 512;                      // bytes of each weight row a CTA reads: 32 lanes x 16
constexpr int kRows = 32;                      // weight rows a ring stage holds
constexpr int kStages = 6;
constexpr int kStageBytes = kRows * kSeg;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxKChunk = 2048;               // rows of x a one-row CTA stages in shared memory
constexpr int kRedBytes = kConsumerWarps * 16 * 33 * 4;  // the cross-warp sums, padded: aliases the ring
static_assert(kRedBytes <= kRingBytes, "the cross-warp sums fit the ring");
constexpr int kSmemBytes = kRingBytes + kMaxKChunk * 4 + 2 * kStages * 8 + 16;

// The rows kernel (2-64 activation rows).
constexpr int kMaxRows = 64;                   // MAX_ROWS
constexpr int kTileCols = 256;                 // columns of its tile: 32 a consumer warp
constexpr int kBoxSize = kRows * 128;          // a TMA box: 128 bytes of 32 weight rows, 128-byte swizzled
constexpr int kXRowBytes = 80;                 // a staged activation row: 32 bf16 of K and the next 8
constexpr int kMaxStagesM = 12;
constexpr int kHeadBytes = 1024;               // mbarriers and the row groups, after the rings
constexpr int kSmemBudgetM = 113 * 1024;       // two CTAs an SM: 2 x (113 KB + 1 KB reserved) = 228 KB

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
// One box of a 3-D / 2-D tensor map (coordinates innermost first) into
// shared memory, completing on the barrier; what lies outside the tensor
// arrives as zeros.
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// The consumer warps' own barrier (the producer warp has left).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a * b for one m16n8k16 bf16 tile, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0x4B000000 is 2^23 as a float; a byte u in its low mantissa bits reads
// 2^23 + u. Flipping the sign bit first maps int8 b to u = b + 128, so
// byte i of w ^ 0x80808080 gives b exactly.
__device__ __forceinline__ float int8_byte(uint32_t flipped, uint32_t sel) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, sel)) - 8388736.f;
}

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
  __device__ static void widen(const uint4& r, float out[16]) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = int8_byte(w[i], 0x7540);
      out[4 * i + 1] = int8_byte(w[i], 0x7541);
      out[4 * i + 2] = int8_byte(w[i], 0x7542);
      out[4 * i + 3] = int8_byte(w[i], 0x7543);
    }
  }
};

struct Stacks {
  const void* w[3];
  void* out[3];
  int n[3];
  int tiles[3];
};

// The stack (s), its first column in the workspace (col_off) and the column
// tile within it of tile `tile` of all the stacks (constant indices into st:
// a parameter array indexed at run time would be copied to local memory).
__device__ __forceinline__ void locate_tile(const Stacks& st, int& tile, int& s, int& col_off) {
  s = 0;
  col_off = 0;
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
}

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

// One row: partial sums of x[k-chunk] @ w_s[l][k-chunk, tile] into
// ws[chunk, :]; with counters, the last CTA of the column tile to arrive
// adds the chunks in order into out_s[tile] (counters == nullptr: kernel D's
// epilogue does).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const uint16_t* __restrict__ x, int K, size_t layer_off, Stacks st, float* __restrict__ ws,
            int n_total, int kchunk, int n_chunks, unsigned int* __restrict__ counters,
            const int* __restrict__ row_idx) {
  constexpr int V = WeightVec<T>::kN;
  constexpr int kTile = 32 * V;  // columns of a tile: kSeg bytes
  extern __shared__ __align__(128) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem + kRingBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kMaxKChunk);  // full[kStages], empty[kStages]
  int* is_last = reinterpret_cast<int*>(bars + 2 * kStages);
  const uint32_t ring0 = smem_addr(smem), full0 = smem_addr(bars), empty0 = full0 + 8 * kStages;

  int tile = blockIdx.x, s, col_off;
  locate_tile(st, tile, s, col_off);
  const int n = s == 0 ? st.n[0] : s == 1 ? st.n[1] : st.n[2];
  if (row_idx != nullptr) layer_off = static_cast<size_t>(__ldg(row_idx)) * K;  // the row's matrix
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
    xs[kk - k0] = __uint_as_float(static_cast<uint32_t>(x[kk]) << 16);
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
      out[gc] = acc[h];
    else
      ws[static_cast<size_t>(blockIdx.y) * n_total + col_off + gc] = acc[h];
  }
  if (counters == nullptr || n_chunks == 1) return;

  // The last CTA of this column tile to arrive adds every chunk's partials
  // (the barrier-then-one-thread fence of a grid barrier publishes the
  // whole CTA's partials before its ticket).
  consumers_sync();
  unsigned int* counter = counters + blockIdx.x;
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
    const float* p = ws + col_off + col0 + lane * V;
    for (int y = y0; y < y1; y += 4) {
      float4 v[4][V / 4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (y + u < y1)
#pragma unroll
          for (int q = 0; q < V / 4; ++q)
            v[u][q] = __ldcg(reinterpret_cast<const float4*>(p + static_cast<size_t>(y + u) * n_total) + q);
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
    if (gc < n) out[gc] = part[h];
  }
}

// The rows kernel's shared-memory plan for weight type T and NT row tiles:
// a stage holds the tile's 32 weight rows as boxes of 128 bytes of columns
// (the 128-byte swizzle: 16-byte chunk c of row r at c ^ (r % 8), so
// ldmatrix's 8 rows hit 8 bank groups) and the rows' 32 K-values; as many
// stages as fit the budget beside 1 KB of alignment slack and the header.
template <typename T>
__host__ __device__ constexpr int boxes_m() {
  return kTileCols * static_cast<int>(sizeof(T)) / 128;
}
template <typename T, int NT>
__host__ __device__ constexpr int stage_bytes_m() {
  return boxes_m<T>() * kBoxSize + NT * 8 * kXRowBytes;
}
template <typename T, int NT>
__host__ __device__ constexpr int stages_m() {
  return (kSmemBudgetM - 1024 - kHeadBytes) / stage_bytes_m<T, NT>() < kMaxStagesM
             ? (kSmemBudgetM - 1024 - kHeadBytes) / stage_bytes_m<T, NT>()
             : kMaxStagesM;
}
template <typename T, int NT>
__host__ __device__ constexpr int smem_bytes_m() {
  return 1024 + stages_m<T, NT>() * stage_bytes_m<T, NT>() + kHeadBytes;
}
// Shared address of 16-byte chunk `chunk` of row `row` of a swizzled box.
__device__ __forceinline__ uint32_t box_at(uint32_t box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The A fragments (weights, transposed) of one 16-row K group (rows row0
// to row0 + 15 of a stage's box) for a warp's two 16-column M tiles, which
// start at 16-byte chunk chunk0 of the box, and the tile column of M row m
// (0-15) of M tile c.
template <typename T>
struct AFrag;

template <>
struct AFrag<uint16_t> {
  // M row m of tile c is column 16 c + m: matrices (K 0-7, M 0-7), (K 0-7,
  // M 8-15), (K 8-15, M 0-7), (K 8-15, M 8-15) are a0-a3.
  __device__ static void load(uint32_t a[2][4], uint32_t box, int row0, int chunk0, int lane) {
    const int row = row0 + (lane & 7) + 8 * (lane >> 4), chunk = chunk0 + ((lane >> 3) & 1);
    ldmatrix_x4_trans(a[0], box_at(box, row, chunk));
    ldmatrix_x4_trans(a[1], box_at(box, row, chunk + 2));
  }
  __device__ static int column(int c, int m) { return 16 * c + m; }
};

template <>
struct AFrag<int8_t> {
  // Read as bf16 pairs, an 8x8 matrix is 8 K rows of 16 int8 columns, and
  // ldmatrix.trans gives lane (g, t) the bytes (K 2t, col 2g), (2t, 2g + 1),
  // (2t + 1, 2g), (2t + 1, 2g + 1): columns 2g and 2g + 1 of K rows 2t and
  // 2t + 1, the A fragments of M rows g and g + 8 once widened. So M row m
  // of tile c is column 16 c + 2 (m % 8) + m / 8.
  __device__ static void load(uint32_t a[2][4], uint32_t box, int row0, int chunk0, int lane) {
    uint32_t r[4];  // (K 0-7, cols 0-15), (K 8-15, cols 0-15), (K 0-7, cols 16-31), (K 8-15, cols 16-31)
    ldmatrix_x4_trans(r, box_at(box, row0 + (lane & 7) + 8 * ((lane >> 3) & 1), chunk0 + (lane >> 4)));
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t u = r[2 * c + h] ^ 0x80808080u;
        const uint32_t f0 = __float_as_uint(int8_byte(u, 0x7540)), f1 = __float_as_uint(int8_byte(u, 0x7541));
        const uint32_t f2 = __float_as_uint(int8_byte(u, 0x7542)), f3 = __float_as_uint(int8_byte(u, 0x7543));
        // an integer of at most 8 significant bits: its bf16 is its float's high half
        a[c][2 * h] = __byte_perm(f0, f2, 0x7632);
        a[c][2 * h + 1] = __byte_perm(f1, f3, 0x7632);
      }
  }
  __device__ static int column(int c, int m) { return 16 * c + 2 * (m & 7) + (m >> 3); }
};

// Keeps the bf16 halves of K values k and k + 1 (lo, hi) below `valid`.
__device__ __forceinline__ uint32_t k_mask(int k, int valid) {
  return (k < valid ? 0x0000ffffu : 0u) | (k + 1 < valid ? 0xffff0000u : 0u);
}

// 2-64 rows: partial sums of x[rows, k-chunk] @ w_s[m][k-chunk, tile] into
// ws[chunk, row, :] for the CTA's rows (all B, m = `layer`; or the rows of
// routed group slot blockIdx.z, m its index), on the tensor cores; with
// counters, the last CTA of the (slot, column tile) adds the chunks in
// order into out_s[row, tile]. map_s: stack s as (matrices, K, N); map_x:
// x as (B, K) (unrouted rows), whose rows are ldx (a multiple of 8) apart.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
rows_kernel(const __grid_constant__ CUtensorMap map_0, const __grid_constant__ CUtensorMap map_1,
            const __grid_constant__ CUtensorMap map_2, const __grid_constant__ CUtensorMap map_x,
            const uint16_t* __restrict__ x, int B, int ldx, int K, int layer, Stacks st, float* __restrict__ ws,
            int n_total, int kchunk, int n_chunks, unsigned int* __restrict__ counters,
            const int* __restrict__ row_idx) {
  constexpr int kS = stages_m<T, NT>(), kWBytes = boxes_m<T>() * kBoxSize, kXBytes = NT * 8 * kXRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The weight ring (1024-byte aligned, as the swizzle wants), the x ring,
  // then the mbarriers and the row groups.
  const uint32_t raw0 = smem_addr(smem_raw), ring0 = (raw0 + 1023u) & ~1023u, xring0 = ring0 + kS * kWBytes;
  uint8_t* head = smem_raw + (xring0 + kS * kXBytes - raw0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(head);  // full[kS], empty[kS]
  int* g_idx = reinterpret_cast<int*>(head + 2 * kMaxStagesM * 8);
  int* g_first = g_idx + kMaxRows;
  int* g_rows = g_first + kMaxRows;  // the CTA's rows, ascending
  int* g_info = g_rows + kMaxRows;   // matrix, row count, is_last
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * kS;
  const int tid = threadIdx.x;

  int m = layer;  // the matrix the CTA reads
  if (row_idx == nullptr) {
    if (tid < B) g_rows[tid] = tid;
    if (tid == 0) g_info[1] = B;
  } else {  // the slot's group: the blockIdx.z-th distinct index in order of first occurrence
    if (tid < B) g_idx[tid] = __ldg(row_idx + tid);
    if (tid == 0) g_info[0] = -1;
    __syncthreads();
    if (tid < B) {
      const int v = g_idx[tid];
      int first = 1;
      for (int j = 0; j < tid; ++j) first &= g_idx[j] != v;
      g_first[tid] = first;
    }
    __syncthreads();
    if (tid < B && g_first[tid]) {
      int rank = 0;
      for (int j = 0; j < tid; ++j) rank += g_first[j];
      if (rank == static_cast<int>(blockIdx.z)) g_info[0] = g_idx[tid];
    }
    __syncthreads();
    m = g_info[0];
    if (m < 0) return;  // an empty slot: fewer distinct indices than slots
    if (tid < B) {
      int pos = 0;
      for (int j = 0; j < tid; ++j) pos += g_idx[j] == m;
      if (g_idx[tid] == m) g_rows[pos] = tid;
      if (tid == B - 1) g_info[1] = pos + (g_idx[tid] == m);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      mbar_init(full0 + i * 8, 1);
      mbar_init(empty0 + i * 8, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int count = g_info[1], nt = (count + 7) >> 3;
  int tile = blockIdx.x, s, col_off;
  locate_tile(st, tile, s, col_off);
  const int n = s == 0 ? st.n[0] : s == 1 ? st.n[1] : st.n[2];
  const CUtensorMap* map_w = s == 0 ? &map_0 : s == 1 ? &map_1 : &map_2;
  float* out = static_cast<float*>(s == 0 ? st.out[0] : s == 1 ? st.out[1] : st.out[2]);
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const int n_stages = (k1 - k0 + kRows - 1) / kRows;
  const int col0 = tile * kTileCols;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;

  if (warp == kConsumerWarps) {  // the producer warp: the tile's boxes, then the rows' K-values
    for (int i = 0; i < n_stages; ++i) {
      const int slot = i % kS;
      if (i >= kS) mbar_wait(empty0 + slot * 8, (i / kS - 1) & 1);  // the consumers are done with it
      const int k = k0 + i * kRows;
      // Routed rows copy their own K-values, a row at a time (x's rows are
      // padded to a multiple of 8); unrouted rows are one box of map_x.
      const int x_bytes = ((min(kRows, k1 - k) + 7) & ~7) * 2;
      const uint32_t stage = ring0 + slot * kWBytes, xs = xring0 + slot * kXBytes, bar = full0 + slot * 8;
      if (lane == 0) {
        mbar_expect(bar, kWBytes + (row_idx == nullptr ? kXBytes : count * x_bytes));
#pragma unroll
        for (int p = 0; p < boxes_m<T>(); ++p)
          tma_3d(stage + p * kBoxSize, map_w, col0 + p * (128 / static_cast<int>(sizeof(T))), k, m, bar);
        if (row_idx == nullptr) tma_2d(xs, &map_x, k, 0, bar);
      }
      if (row_idx != nullptr) {
        __syncwarp();
        for (int j = lane; j < count; j += 32)
          bulk_copy(xs + j * kXRowBytes, x + static_cast<size_t>(g_rows[j]) * ldx + k, x_bytes, bar);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  float acc[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c][e] = 0.f;
  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % kS;
    mbar_wait(full0 + slot * 8, (i / kS) & 1);  // the stage's weights and K-values have landed
    const int rows = min(kRows, k1 - k0 - i * kRows);
    const int wcol = warp * 32 * static_cast<int>(sizeof(T));  // the warp's first byte of a tile row
    const uint32_t box = ring0 + slot * kWBytes + (wcol / 128) * kBoxSize, xs = xring0 + slot * kXBytes;
#pragma unroll
    for (int kg = 0; kg < 2; ++kg) {  // the stage's two 16-row K groups
      if (16 * kg >= rows) break;
      uint32_t a[2][4];  // [M tile][fragment]
      AFrag<T>::load(a, box, 16 * kg, (wcol % 128) / 16, lane);
      // The chunk's short last stage: zero what lies past its rows (stale
      // bytes, or the next chunk's) in both operands.
      const uint32_t lo = rows < kRows ? k_mask(16 * kg + 2 * t, rows) : ~0u;
      const uint32_t hi = rows < kRows ? k_mask(16 * kg + 2 * t + 8, rows) : ~0u;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        a[c][0] &= lo;
        a[c][1] &= lo;
        a[c][2] &= hi;
        a[c][3] &= hi;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t b[2];  // row 8 j + g: K 16 kg + 2 t (b[0]) and 16 kg + 8 + 2 t
          ldmatrix_x2(b, xs + (8 * j + (lane & 7)) * kXRowBytes + 32 * kg + 16 * ((lane >> 3) & 1));
          b[0] &= lo;
          b[1] &= hi;
          mma_16816(acc[j][0], a[0], b[0], b[1]);
          mma_16816(acc[j][1], a[1], b[0], b[1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + slot * 8);  // this warp is done with the stage's rows
  }

  // acc[j][c][e]: row 8 j + 2 t + e % 2, M row g + 8 (e / 2) of tile c.
  const bool direct = counters != nullptr && n_chunks == 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + 2 * t + (e & 1);
      if (r >= count) continue;
      const size_t row = g_rows[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gc = col0 + 32 * warp + AFrag<T>::column(c, g + 8 * (e >> 1));
        if (gc >= n) continue;
        if (direct)
          out[row * n + gc] = acc[j][c][e];
        else
          ws[(static_cast<size_t>(blockIdx.y) * B + row) * n_total + col_off + gc] = acc[j][c][e];
      }
    }
  }
  if (counters == nullptr || n_chunks == 1) return;

  // The last CTA of this (slot, column tile) to arrive adds every chunk's
  // partials, as the one-row kernel's does.
  consumers_sync();
  unsigned int* counter = counters + static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    g_info[2] = atomicAdd(counter, 1u) == static_cast<unsigned int>(n_chunks - 1);
    if (g_info[2]) {
      *counter = 0u;     // zeroed for the next call (and graph replay) on this stream
      __threadfence();   // every other CTA's partials are visible to this one
    }
  }
  consumers_sync();
  if (!g_info[2]) return;
  // The merge: thread (q, c4) adds rows q, q + 4, ... of columns 4 c4 to
  // 4 c4 + 3, each over the chunks in chunk order, kDepth chunks' loads in
  // flight at a time (eight at NT = 8, whose accumulators leave the
  // registers for no more without spilling).
  constexpr int kDepth = NT < 8 ? 16 : 8;
  const int c4 = 4 * (tid & 63);
  if (c4 >= n - col0) return;
  const float* p = ws + col_off + col0 + c4;
  const size_t step = static_cast<size_t>(B) * n_total;
  for (int r = tid >> 6; r < count; r += 4) {
    const size_t row = g_rows[r];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int y = 0; y < n_chunks; y += kDepth) {
      float4 v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        if (y + u < n_chunks) v[u] = __ldcg(reinterpret_cast<const float4*>(p + (y + u) * step + row * n_total));
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        if (y + u < n_chunks) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
    }
    *reinterpret_cast<float4*>(out + row * n + col0 + c4) = sum;
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

// The stacks and their column tiles of `tile` columns.
Stacks make_stacks(int tile, const void* w0, const void* w1, const void* w2, void* o0, void* o1, void* o2,
                   int n0, int n1, int n2, int* n_tiles) {
  Stacks st;
  const void* ws[3] = {w0, w1, w2};
  void* os[3] = {o0, o1, o2};
  const int ns[3] = {n0, n1, n2};
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

// The opt-in above 48 KB of dynamic shared memory, once per kernel and device.
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set[dev] = true;
  }
  return cudaSuccess;
}

struct Launch {
  const void* x;
  int B, ldx, K, layer, n_mats;
  Stacks st;
  float* ws;
  int n_total, n_chunks, kchunk, slots;
  unsigned int* counters;
  const int* row_idx;
  cudaStream_t stream;
};

template <typename T, int NT>
int launch_rows(const Launch& a, int n_tiles) {
  constexpr int bytes = smem_bytes_m<T, NT>();
  static_assert(bytes <= kSmemBudgetM, "two CTAs an SM");
  const cudaError_t err = allow_smem<rows_kernel<T, NT>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Stack s as (matrices, K, N), boxes of 32 rows x 128 bytes, swizzled; x
  // as (B, K), one box of the 8 NT rows' next 32 K-values (and 8 more: 80
  // bytes a row).
  CUtensorMap maps[3] = {}, map_x = {};
  const CUtensorMapDataType type = sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  for (int i = 0; i < 3; ++i) {
    if (a.st.w[i] == nullptr) continue;
    const cuuint64_t n = static_cast<cuuint64_t>(a.st.n[i]);
    const cuuint64_t dims[3] = {n, static_cast<cuuint64_t>(a.K), static_cast<cuuint64_t>(a.n_mats)};
    const cuuint64_t strides[2] = {n * sizeof(T), n * sizeof(T) * a.K};
    const cuuint32_t box[3] = {128 / sizeof(T), kRows, 1};
    const int status = encode_tiled(&maps[i], type, 3, a.st.w[i], dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    if (status != 0) return status;
  }
  if (a.row_idx == nullptr) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.K), static_cast<cuuint64_t>(a.B)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.ldx) * 2};
    const cuuint32_t box[2] = {kXRowBytes / 2, NT * 8};
    const int status = encode_tiled(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    if (status != 0) return status;
  }
  const dim3 grid(n_tiles, a.n_chunks, a.slots);
  rows_kernel<T, NT><<<grid, kThreads, bytes, a.stream>>>(maps[0], maps[1], maps[2], map_x,
                                                         static_cast<const uint16_t*>(a.x), a.B, a.ldx, a.K, a.layer,
                                                         a.st, a.ws, a.n_total, a.kchunk, a.n_chunks, a.counters,
                                                         a.row_idx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const Launch& a, int n_tiles) {
  if (a.B > 1) {
    const int nt = (a.B + 7) / 8;
    return nt == 1 ? launch_rows<T, 1>(a, n_tiles)
           : nt == 2 ? launch_rows<T, 2>(a, n_tiles)
           : nt <= 4 ? launch_rows<T, 4>(a, n_tiles)
                     : launch_rows<T, 8>(a, n_tiles);
  }
  const cudaError_t err = allow_smem<gemv_kernel<T>>(kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, a.n_chunks);
  gemv_kernel<T><<<grid, kThreads, kSmemBytes, a.stream>>>(static_cast<const uint16_t*>(a.x), a.K,
                                                           static_cast<size_t>(a.layer) * a.K, a.st, a.ws,
                                                           a.n_total, a.kchunk, a.n_chunks, a.counters, a.row_idx);
  return static_cast<int>(cudaGetLastError());
}

// The launch's column tiles: 512 bytes of a weight row at one row, 256
// columns at more.
int tile_cols(int wtype, int B) { return B > 1 ? kTileCols : wtype == 1 ? 512 : 256; }

int launch_gemv(int wtype, const Launch& a, int n_tiles) {
  return wtype == 1 ? launch_typed<int8_t>(a, n_tiles) : launch_typed<uint16_t>(a, n_tiles);
}

bool plan_ok(int B, int ldx, int K, int n_mats, int n_chunks, int kchunk, int slots) {
  return B >= 1 && B <= kMaxRows && n_mats >= 1 && n_chunks > 0 && kchunk > 0 && kchunk <= kMaxKChunk &&
         static_cast<long long>(n_chunks) * kchunk >= K && static_cast<long long>(n_chunks - 1) * kchunk < K &&
         kchunk % 8 == 0 && slots >= 1 && slots <= B && slots <= n_mats && (B == 1 || (ldx % 8 == 0 && ldx >= K));
}

}  // namespace

// wtype: 0 = bf16 stacks, 1 = int8 stacks. Unused stacks pass nullptr / 0.
// x: (B, K) bf16, rows ldx apart (B > 1: ldx a multiple of 8, x 16-byte
// aligned; the kernel reads up to K rounded up to 8 of each row).
// ws: (n_chunks, B, n0 + n1 + n2) fp32 scratch; counters: slots * (column
// tiles) uint32, zero, owned by the calling stream (left at zero).
// n_mats: the stacks' matrices (L, or L * E viewed for routed rows).
// row_idx: nullptr, or B int32 stack indices on the device (then `layer`
// is unused); slots: 1, or with row_idx min(B, n_mats).
extern "C" int ff_gemv_stacked(const void* x, int B, int ldx, int K, int layer, int n_mats, int wtype,
                               const void* w0, const void* w1, const void* w2,
                               int n0, int n1, int n2, void* o0, void* o1, void* o2,
                               void* ws, void* counters, int n_chunks, int kchunk, const void* row_idx, int slots,
                               void* stream) {
  if (!plan_ok(B, ldx, K, n_mats, n_chunks, kchunk, slots) || counters == nullptr || (row_idx == nullptr && slots != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = 0;
  const Stacks st = make_stacks(tile_cols(wtype, B), w0, w1, w2, o0, o1, o2, n0, n1, n2, &n_tiles);
  const Launch a{x, B, ldx, K, layer, n_mats, st, static_cast<float*>(ws), n0 + n1 + n2, n_chunks, kchunk, slots,
                 static_cast<unsigned int*>(counters), static_cast<const int*>(row_idx),
                 static_cast<cudaStream_t>(stream)};
  return launch_gemv(wtype, a, n_tiles);
}

// sg, su: (n,) fp32 scales of `layer`, or with row_idx the whole (L * E,
// n) tables; nullptr for bf16 stacks. x, ldx, n_mats, row_idx and slots as
// above.
extern "C" int ff_gemv_gateup(const void* x, int B, int ldx, int K, int layer, int n_mats, int wtype,
                              const void* wg, const void* wu, int n, const void* sg,
                              const void* su, void* out, void* ws, int n_chunks, int kchunk,
                              const void* row_idx, int slots, void* stream) {
  if (!plan_ok(B, ldx, K, n_mats, n_chunks, kchunk, slots) || (row_idx == nullptr && slots != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_tiles = 0;
  const Stacks st = make_stacks(tile_cols(wtype, B), wg, wu, nullptr, nullptr, nullptr, nullptr, n, n, 0, &n_tiles);
  const int* rows = static_cast<const int*>(row_idx);
  const Launch a{x, B, ldx, K, layer, n_mats, st, static_cast<float*>(ws), 2 * n, n_chunks, kchunk, slots, nullptr,
                 rows, s};
  const int status = launch_gemv(wtype, a, n_tiles);
  if (status != 0) return status;
  const int total = B * n;
  gateup_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ws), n_chunks, B, n, static_cast<const float*>(sg),
      static_cast<const float*>(su), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

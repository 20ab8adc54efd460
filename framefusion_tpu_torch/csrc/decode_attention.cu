// Ragged decode attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes).
//
// G. ff_ragged_decode_attn — one query token, q (Hq, 128) bf16, against the
//    first `cache_len` keys of a cache view (S_view, Hk, 128) bf16 in the
//    decode pool's natural layout. The length is a host int, or an int64 the
//    kernel reads from device memory when it starts (the decode step of a
//    captured CUDA graph, which replays at a new length every step, as the
//    TPU kernel reads its `len_ref` scalar); the launch is planned for the
//    largest length it may see (`max_len`); q-head h reads KV head h / G (G = Hq / Hk,
//    HF repeat_kv order). fp32 softmax with `scale`; the result is (Hq, 128)
//    bf16. Replaces the Pallas kernel
//    framefusion_tpu/ops/kernels/decode_attention.py (ragged_decode_attention,
//    _decode_kernel), whose grid walked the key blocks in order on one core,
//    carrying (m, l, acc) from step to step in VMEM scratch, and clamped its
//    block index map so that blocks past the length were not fetched.
//
//    Bound on the card: bytes. The live K and V rows, 2 * cache_len * Hk *
//    128 * 2 bytes, are read once; the work is 4 * G * 128 operations per
//    (key, KV head), ~3.5 per byte at G = 7. The kernel has to keep enough
//    loads in flight on every SM to stream at the memory rate, and do its
//    arithmetic without a pipe of the SM (shared-memory loads, CUDA-core
//    FMAs) becoming the limit instead.
//
//    Design: split-K flash decoding in one launch.
//    * Grid (n_split, Hk), about one CTA per SM: each CTA streams a
//      contiguous range of whole 64-key tiles of one KV head (5-6 tiles at
//      the 64-frame decode lengths). The plan covers `max_len` keys; rows
//      past the live length are never fetched (cp.async zero-fills them),
//      and a CTA whose range starts at or past it loads nothing, writes an
//      empty partial (m = -inf, l = 0) and still arrives on the counter, so
//      the merge below runs over the same splits in the same order at every
//      length: bitwise repeatable, and safe to replay. A device length
//      outside [1, max_len] writes NaN rows and reads no key.
//    * A 4-stage cp.async.cg ring of K+V tiles (34 KB a stage): three tiles
//      are in flight while one is used, well above the ~25-40 KB per SM that
//      3.35 TB/s needs.
//    * Scores and P.V on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//      out): the KV head's G <= 16 query heads are the 16 rows of the A
//      operand (rows >= G are zero), loaded once into registers; K's B
//      fragments come by ldmatrix, V's by ldmatrix.trans, and the score
//      accumulator becomes P's A operand in registers. No scalar
//      shared-memory traffic: each 16-byte ldmatrix row feeds 16 rows of
//      products. Each of the four warps takes its own 16 keys of every tile
//      with its own (m, l, acc); the CTA merges its warps in warp order.
//    * The splits merge inside the same launch: each CTA writes its
//      (m, l, acc) per query head to the workspace, then takes a ticket
//      from its KV head's arrival counter (__threadfence, then atomicAdd).
//      The CTA that arrives last merges all splits in split order (so the
//      result does not depend on which CTA arrives last, and is bitwise
//      repeatable) and resets the counter to 0. Stream order: a call's
//      kernel starts after the previous call's on the same stream has
//      ended, so it finds the counters at 0; calls that may overlap (other
//      streams) need their own counters, which the wrapper keeps per
//      (device, stream); a CUDA graph replays on one stream at a time.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;          // head dim
constexpr int kBN = 64;          // keys per K/V tile
constexpr int kWarps = 4;        // each takes 16 keys of every tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;        // query heads per KV head: the 16 rows of an mma tile
constexpr int kMaxSplit = 256;   // key ranges a launch may split into
constexpr int kStages = 4;       // K+V tiles in the cp.async ring
constexpr int kRow = kD + 8;     // padded shared row (bf16): ldmatrix's 8 rows hit 8 bank groups
constexpr int kTile = kBN * kRow;                           // elements of one K (or V) tile
constexpr int kSmemBytes = kStages * 2 * kTile * 2;         // 139,264 bytes
constexpr int kChunks = kBN * (kD / 8) / kThreads;          // 16-byte copies per thread per tile and tensor
constexpr int kORow = kD + 8;    // padded fp32 row of the warp merge
static_assert(kWarps * kMaxG * kORow * 4 + 2 * kWarps * kMaxG * 4 + 2 * kMaxG * 4 <= kSmemBytes,
              "warp merge fits the ring");
static_assert(kMaxSplit * kMaxG * 8 + kMaxG * 4 + 128 + kMaxG * kD * 4 <= kSmemBytes,
              "the split merge's (m, l) and one split's acc rows fit the ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}
// `bytes` (a multiple of 16) global -> shared by the bulk-copy unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__global__ void __launch_bounds__(kThreads, 1)
decode_attn_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   unsigned int* __restrict__ counters, const long long* __restrict__ len_dev, int max_len, int Hq,
                   int Hk, int keys_per_split, int n_split, float scale_log2) {
  extern __shared__ __align__(128) uint16_t ring[];  // [stage][K | V][key][kRow]
  __shared__ int is_last;
  __shared__ __align__(8) uint64_t bar;  // the split merge's bulk copies have landed

  const int G = Hq / Hk;
  const int split = blockIdx.x, hk = blockIdx.y, h0 = hk * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  int cache_len = max_len;
  if (len_dev != nullptr) {
    const long long len = *len_dev;  // every CTA reads the same value: all return here, or none
    if (len < 1 || len > max_len) {
      const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
      if (split == 0)
        for (int i = tid; i < G * kD; i += kThreads) out[static_cast<size_t>(h0) * kD + i] = nan;
      return;
    }
    cache_len = static_cast<int>(len);
  }
  const int k_begin = split * keys_per_split;
  const int k_end = min(cache_len, k_begin + keys_per_split);
  const int n_tiles = max(0, (k_end - k_begin + kBN - 1) / kBN);  // 0: a split past the live length
  const size_t key_stride = static_cast<size_t>(Hk) * kD;
  const uint16_t* kh = k + static_cast<size_t>(hk) * kD;
  const uint16_t* vh = v + static_cast<size_t>(hk) * kD;

  // Tile `tile` of this split into its ring stage; every call commits a
  // group (empty past the last tile) so that wait_group counts stay fixed.
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      uint16_t* ks = ring + (tile % kStages) * 2 * kTile;
      uint16_t* vs = ks + kTile;
      const int n0 = k_begin + tile * kBN;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 4, chunk = idx & 15;
        const bool live = n0 + row < k_end;
        const size_t off = static_cast<size_t>(live ? n0 + row : k_begin) * key_stride + chunk * 8;
        cp_async_16(ks + row * kRow + chunk * 8, kh + off, live ? 16 : 0);
        cp_async_16(vs + row * kRow + chunk * 8, vh + off, live ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // Q as the A operand: rows = this KV head's query heads (>= G are zero),
  // 8 k-steps of 16 dims.
  uint32_t qa[kD / 16][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + static_cast<size_t>(h0 + g) * kD);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(q + static_cast<size_t>(h0 + g + 8) * kD);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = (kk * 16 + t * 2) / 2;
      qa[kk][0] = g < G ? q0[c] : 0u;
      qa[kk][1] = g + 8 < G ? q1[c] : 0u;
      qa[kk][2] = g < G ? q0[c + 4] : 0u;
      qa[kk][3] = g + 8 < G ? q1[c + 4] : 0u;
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max (log2 units) of rows g and g + 8
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running sums

  // ldmatrix row addresses within the warp's 16 keys. Scores: matrices
  // (keys 0-7 | 8-15) x (dims 0-7 | 8-15) of a k-step; P.V (trans): keys
  // (0-7 | 8-15) x dims (0-7 | 8-15) of a 16-dim pair of n-tiles.
  const int kq_key = warp * 16 + (lane >> 4) * 8 + (lane & 7);
  const int kq_dim = ((lane >> 3) & 1) * 8;
  const int v_key = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_dim = (lane >> 4) * 8;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();               // everyone's have; and every warp is done with tile - 1
    issue(tile + kStages - 1);     // into the stage tile - 1 used
    const uint16_t* ks = ring + (tile % kStages) * 2 * kTile;
    const uint16_t* vs = ks + kTile;

    // S = Q K^T over this warp's 16 keys: two n-tiles, even and odd k-steps
    // in separate accumulators (four independent mma chains).
    float sc[2][4], sd[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = sd[0][e] = sd[1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + kq_key * kRow + kk * 16 + kq_dim);
      float(*acc)[4] = (kk & 1) ? sd : sc;
      mma_16816(acc[0], qa[kk], kb[0], kb[1]);
      mma_16816(acc[1], qa[kk], kb[2], kb[3]);
    }

    // Online softmax in log2 units; keys past the length are -inf.
    const int key0 = k_begin + tile * kBN + warp * 16 + t * 2;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = key0 + nt * 8 + (e & 1) < k_end ? (sc[nt][e] + sd[nt][e]) * scale_log2 : -INFINITY;
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a slice with no live key yet
      alpha[r] = exp2f(m_r[r] - m_use[r]);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nt][e] - m_use[e >> 1]);
        sc[nt][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V over the warp's 16 keys; rows past the length are zero in
    // shared memory and have p = 0.
    uint32_t pa[4];
    pa[0] = pack_floats(sc[0][0], sc[0][1]);
    pa[1] = pack_floats(sc[0][2], sc[0][3]);
    pa[2] = pack_floats(sc[1][0], sc[1][1]);
    pa[3] = pack_floats(sc[1][2], sc[1][3]);
#pragma unroll
    for (int d2 = 0; d2 < kD / 16; ++d2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + v_key * kRow + d2 * 16 + v_dim);
      mma_16816(o[2 * d2], pa, vb[0], vb[1]);
      mma_16816(o[2 * d2 + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the merges

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }

  // Merge the four warps in warp order: per (row, dim), this split's
  // max M, sum l and unnormalised acc.
  float* w_o = reinterpret_cast<float*>(ring);      // [warp][row][kORow]
  float* w_m = w_o + kWarps * kMaxG * kORow;        // [warp][row]: max, then weight
  float* w_l = w_m + kWarps * kMaxG;                // [warp][row]
  float* row_ml = w_l + kWarps * kMaxG;             // [row]: (M, l) of the split
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    const int c = i * 8 + t * 2;
    *reinterpret_cast<float2*>(&w_o[(warp * kMaxG + g) * kORow + c]) = make_float2(o[i][0], o[i][1]);
    *reinterpret_cast<float2*>(&w_o[(warp * kMaxG + g + 8) * kORow + c]) = make_float2(o[i][2], o[i][3]);
  }
  if (t == 0) {
    w_m[warp * kMaxG + g] = m_r[0];
    w_m[warp * kMaxG + g + 8] = m_r[1];
    w_l[warp * kMaxG + g] = l_r[0];
    w_l[warp * kMaxG + g + 8] = l_r[1];
  }
  __syncthreads();
  if (tid < kMaxG) {  // per row: the split's max M, the warps' weights, l
    // M is finite when the split holds a live key (warp 0 holds its first);
    // an empty split keeps M = -inf, and weights and l of 0.
    float m = w_m[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, w_m[w * kMaxG + tid]);
    const float m_ref = m == -INFINITY ? 0.f : m;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(w_m[w * kMaxG + tid] - m_ref);
      w_m[w * kMaxG + tid] = wt;
      l = fmaf(w_l[w * kMaxG + tid], wt, l);
    }
    row_ml[2 * tid] = m;
    row_ml[2 * tid + 1] = l;
  }
  __syncthreads();

  const size_t ws_row0 = static_cast<size_t>(split) * Hq + h0;
#pragma unroll 4
  for (int r = 0; r < G; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = fmaf(w_o[(w * kMaxG + r) * kORow + tid], w_m[w * kMaxG + r], acc);
    if (n_split == 1)
      out[static_cast<size_t>(h0 + r) * kD + tid] = __float2bfloat16(acc / row_ml[2 * r + 1]);
    else
      ws_acc[(ws_row0 + r) * kD + tid] = acc;
  }
  if (n_split == 1) return;
  if (tid < G) *reinterpret_cast<float2*>(&ws_ml[(ws_row0 + tid) * 2]) = make_float2(row_ml[2 * tid], row_ml[2 * tid + 1]);

  // The last CTA of this KV head to arrive merges every split (the
  // barrier-then-one-thread fence of a grid barrier publishes the whole
  // CTA's partials before its ticket).
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(&counters[hk], 1u) == static_cast<unsigned>(n_split - 1);
    if (is_last) {
      counters[hk] = 0u;  // zeroed for the next call (and graph replay) on this stream
      __threadfence();    // every other CTA's partials are visible to this one
      asm volatile("fence.proxy.async.global;\n" ::: "memory");  // and to the bulk copies below
      mbar_init(smem_addr(&bar), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  if (!is_last) return;

  // The splits' acc rows of this KV head come to shared memory by bulk
  // copies, one a split (as many splits at a time as fit: all of them at
  // Hk 4); meanwhile every split's (m, l), then per row M, the weights
  // 2^(m_s - M) (in place of m_s) and l = sum_s l_s 2^(m_s - M) in a fixed
  // lane order and shuffle tree; then acc in split order, four dims of a
  // row a thread.
  float2* ml_s = reinterpret_cast<float2*>(ring);  // [split][row]: (m, l), then (weight, l)
  float* l_row = reinterpret_cast<float*>(ml_s + n_split * G);
  const int ml_bytes = (n_split * G * 8 + G * 4 + 127) & ~127;
  float* acc_s = reinterpret_cast<float*>(reinterpret_cast<char*>(ring) + ml_bytes);  // [split][row][kD]
  const int row_bytes = G * kD * 4;  // one split's acc rows of this KV head
  const int per_chunk = min(n_split, (kSmemBytes - ml_bytes) / row_bytes);
  auto stage = [&](int s0) {  // warp 0: a copy a lane
    const int n = min(per_chunk, n_split - s0);
    if (lane == 0) mbar_expect(smem_addr(&bar), n * row_bytes);
    __syncwarp();
    for (int s = lane; s < n; s += 32)
      bulk_copy(smem_addr(acc_s) + s * row_bytes, ws_acc + (static_cast<size_t>(s0 + s) * Hq + h0) * kD, row_bytes,
                smem_addr(&bar));
  };
  if (warp == 0) stage(0);
  for (int i = tid; i < n_split * G; i += kThreads)
    ml_s[i] = __ldcg(reinterpret_cast<const float2*>(&ws_ml[(static_cast<size_t>(i / G) * Hq + h0 + i % G) * 2]));
  __syncthreads();
  for (int r = warp; r < G; r += kWarps) {  // M is finite: split 0 holds key 0
    float m = -INFINITY;
    for (int s = lane; s < n_split; s += 32) m = fmaxf(m, ml_s[s * G + r].x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float wt = exp2f(ml_s[s * G + r].x - m);
      l = fmaf(ml_s[s * G + r].y, wt, l);
      ml_s[s * G + r].x = wt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) l_row[r] = l;
  }
  __syncthreads();  // the weights are set

  constexpr int kItems = kMaxG * kD / 4 / kThreads;  // (row, 4 dims) items a thread, at most
  const int units = G * kD / 4;
  float4 acc[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0, phase = 0; s0 < n_split; s0 += per_chunk, phase ^= 1) {
    mbar_wait(smem_addr(&bar), phase);  // the chunk has landed
    const int n = min(per_chunk, n_split - s0);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int item = tid + k * kThreads;
      if (item < units) {
        const int r = item / (kD / 4);
#pragma unroll 8
        for (int s = 0; s < n; ++s) {
          const float wt = ml_s[(s0 + s) * G + r].x;
          const float4 x = reinterpret_cast<const float4*>(acc_s)[s * units + item];
          acc[k].x = fmaf(x.x, wt, acc[k].x);
          acc[k].y = fmaf(x.y, wt, acc[k].y);
          acc[k].z = fmaf(x.z, wt, acc[k].z);
          acc[k].w = fmaf(x.w, wt, acc[k].w);
        }
      }
    }
    if (s0 + per_chunk < n_split) {
      __syncthreads();  // the chunk is consumed
      if (warp == 0) stage(s0 + per_chunk);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int item = tid + k * kThreads;
    if (item < units) {
      const int r = item / (kD / 4);
      const float inv = 1.f / l_row[r];
      const uint2 packed =
          make_uint2(pack_floats(acc[k].x * inv, acc[k].y * inv), pack_floats(acc[k].z * inv, acc[k].w * inv));
      *reinterpret_cast<uint2*>(out + static_cast<size_t>(h0 + r) * kD + (item % (kD / 4)) * 4) = packed;
    }
  }
}

}  // namespace

extern "C" int ff_ragged_decode_max_group() { return kMaxG; }

// ws_acc: (n_split, Hq, 128) fp32, ws_ml: (n_split, Hq, 2) fp32 scratch;
// counters: Hk uint32, zero, owned by the calling stream (left at zero);
// len_dev: null (the length is max_len), or one int64 in device memory
// holding the length, read when the kernel runs (values outside
// [1, max_len] give NaN rows); n_split * keys_per_split >= max_len >
// (n_split - 1) * keys_per_split, keys_per_split a multiple of 64,
// n_split <= kMaxSplit.
extern "C" int ff_ragged_decode_attn(const void* q, const void* k, const void* v, void* out, void* ws_acc,
                                     void* ws_ml, void* counters, const void* len_dev, int max_len, int Hq, int Hk,
                                     int keys_per_split, int n_split, float scale, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > kMaxG || max_len <= 0 || keys_per_split <= 0 ||
      keys_per_split % kBN != 0 || n_split <= 0 || n_split > kMaxSplit ||
      static_cast<long long>(n_split - 1) * keys_per_split >= max_len ||
      static_cast<long long>(n_split) * keys_per_split < max_len)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_set[64] = {};  // the opt-in above 48 KB, once per device
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(decode_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))
  decode_attn_kernel<<<dim3(n_split, Hk), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<unsigned int*>(counters), static_cast<const long long*>(len_dev), max_len, Hq, Hk, keys_per_split,
      n_split, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

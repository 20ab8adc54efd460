// Prefill attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Two kernels:
//
// A. ff_flash_attn_fwd — causal GQA flash attention with an optional (S,)
//    key-valid mask, q (S, Hq, 128) and k, v (S, Hk, 128) bf16 read in
//    place; q-head h reads KV head h / G (HF repeat_kv order). Also writes
//    each row's softmax max m (natural-log units) and sum l, fp32 (Hq, S),
//    for kernel B. Rows with every key masked give 0 (m = -inf, l = 0).
//    Replaces the Pallas kernels of framefusion_tpu/ops/kernels/
//    flash_prefill.py: _flash_kernel, _flash_blocked, _flash_blocked_grouped,
//    _flash_grouped, _flash_grouped_multi, the attention of
//    _flash_kernel_gm_imp and _flash_kernel_imp, and the dispatcher
//    flash_causal_attention. The TPU needed those regimes because a head's
//    K/V had to fit VMEM; here K/V stream through shared memory one 128-key
//    tile at a time, so one kernel covers G in {1, 7}, every S and both
//    mask cases.
//
//    Bound on the card: tensor-core operations, 4 * 128 * Hq per (row, live
//    key at or before it): 1.0 ms at 989 TFLOP/s for the dense 11,776-token
//    prefill, against 0.06 ms to read q, k, v once. The pipeline that keeps
//    the tensor cores fed (TMA ring, wgmma, two warpgroups taking turns,
//    softmax in log2 units) is flash_fwd.cuh's, shared with kernel F; this
//    file gives it A's tile plan:
//    * Causal: tiles past the block's diagonal are never loaded; only the
//      tiles that reach past a warpgroup's first row run the per-element
//      causal test.
//    * key_valid: before the loop the CTA reads its tiles' validity once,
//      as two 64-bit words a tile (ballots), into shared memory, and lists
//      the tiles with a live key. Dead tiles are neither loaded nor
//      multiplied; fully live tiles skip the mask math; the others test one
//      bit a score.
//
// B. ff_attn_importance_rows — the prune's importance vector: for the <= num
//    capture rows (the last live rows, -1 = absent), exp(q.k*scale - m)/l per
//    key from A's statistics, summed over rows and heads in a FIXED order (no
//    atomics) and divided by Hq*num. Replaces the importance epilogue of
//    _flash_kernel_imp / _imp_grouped_multi (_flash_kernel_gm_imp) and the
//    plain mid-regime fallback in flash_causal_attention_importance. The
//    order is fixed because the prune's top-k reads this vector: run-to-run
//    jitter would show up as flipped keep decisions.
//    Bound on the card: reading K once (S * Hk * D * 2 bytes, 2 us at S
//    6,528); the math is 2 * num * Hq * D per key. So the kernel is a
//    latency problem: every K byte in flight at once, and no dependent chain
//    per key. Design: a CTA of four warps owns 32 keys (204 CTAs at S 6,528,
//    one wave); warp w takes KV heads w, w + 4, ... For its head a warp loads
//    the 32 keys straight into mma.sync B fragments (all loads issued before
//    the first product) and computes the (capture rows x G heads, padded to
//    16) x 32 score tile with mma.sync.m16n8k16, Q's capture rows as the A
//    operand. The epilogue is one FFMA, one ex2 and one multiply a score
//    (m in log2 units and 1 / l read once per (row, head) from shared
//    memory); absent rows, keys past a row and dead keys add nothing. The
//    order: each thread sums its rows (m16 tiles in order, then heads in
//    order), a shuffle tree sums the 8 row groups, and the warps' sums are
//    added in warp order through shared memory.
//
// Every entry point returns cudaGetLastError() after its launches.

#include "flash_fwd.cuh"

namespace {

constexpr int kWords = kBN / 64;  // 64-bit validity words a tile

// Dynamic shared memory of kernel A for S keys: the ring, a slot for the
// live-tile count, then per tile its validity words and list entry.
size_t smem_bytes_a(int S) {
  const size_t tiles = (static_cast<size_t>(S) + kBN - 1) / kBN;
  return kRingSmem + 8 + tiles * (8 * kWords + 4);
}

// Kernel A's tile plan: the tiles up to the block's diagonal or, with
// key_valid, the ones among them with a live key (listed in shared memory).
struct CausalValidPlan {
  const uint8_t* key_valid;
  const uint64_t* tbits;  // a tile's validity bits, kWords words
  const int* tlist;       // the live tiles, in order
  const int* n_live;
  int n_all;              // tiles up to the diagonal

  __device__ CausalValidPlan(const uint8_t* key_valid_, uint8_t* scratch, int S, int q0, int warp, int lane)
      : key_valid(key_valid_), n_all((min(S, q0 + kBM) + kBN - 1) / kBN) {
    int* n_live_s = reinterpret_cast<int*>(scratch);
    uint64_t* bits = reinterpret_cast<uint64_t*>(scratch) + 1;
    int* list = reinterpret_cast<int*>(bits + (S + kBN - 1) / kBN * kWords);
    tbits = bits;
    tlist = list;
    n_live = n_live_s;
    if (key_valid != nullptr) {  // each tile's validity as 64-bit words, then the list of live tiles
      for (int jw = warp; jw < n_all * kWords; jw += kFwdThreads / 32) {
        const int k0 = jw * 64 + lane;
        const uint32_t lo = __ballot_sync(0xffffffffu, k0 < S && key_valid[k0]);
        const uint32_t hi = __ballot_sync(0xffffffffu, k0 + 32 < S && key_valid[k0 + 32]);
        if (lane == 0) bits[jw] = lo | (static_cast<uint64_t>(hi) << 32);
      }
      __syncthreads();
      if (warp == 0) {
        int base = 0;
        for (int j0 = 0; j0 < n_all; j0 += 32) {
          const int j = j0 + lane;
          bool live = false;
#pragma unroll
          for (int w = 0; w < kWords; ++w) live = live || (j < n_all && bits[j * kWords + w] != 0ull);
          const uint32_t ballot = __ballot_sync(0xffffffffu, live);
          if (live) list[base + __popc(ballot & ((1u << lane) - 1u))] = j;
          base += __popc(ballot);
        }
        if (lane == 0) *n_live_s = base;
      }
    }
  }

  __device__ int n_tiles() const { return key_valid != nullptr ? *n_live : n_all; }
  __device__ int tile(int i) const { return key_valid != nullptr ? tlist[i] : i; }

  // The per-element test only where the tile reaches past the warpgroup's
  // first row (causal) or has dead keys.
  __device__ void mask(float (&s)[kBN / 2], int tile, int wrow0, int r0, int r1, int tq) const {
    const int n0 = tile * kBN;
    uint64_t mine[kWords];  // this thread's bits: word w's column 8 * j + 2 * tq + e at bit 8 * j + e
    bool all_live = true;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint64_t bits = key_valid != nullptr ? tbits[tile * kWords + w] : ~0ull;
      all_live = all_live && bits == ~0ull;
      mine[w] = bits >> (2 * tq);
    }
    if (n0 + kBN - 1 > wrow0 || !all_live) {
#pragma unroll
      for (int x = 0; x < kBN / 2; ++x) {
        const int col = (x >> 2) * 8 + (x & 1);  // minus 2 * tq
        const int row = (x & 2) ? r1 : r0;
        if (!((mine[col >> 6] >> (col & 63)) & 1ull) || n0 + col + 2 * tq > row) s[x] = -INFINITY;
      }
    }
  }
};

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                      const uint16_t* __restrict__ q, const uint8_t* __restrict__ key_valid,
                      uint16_t* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                      int S, int Hq, int Hk, float scale_log2) {
  attn_fwd_cta<true>(map_k, map_v, q, out, m_out, l_out, S, Hq, Hk, scale_log2,
                     [=](uint8_t* scratch, int q0, int warp, int lane) {
                       return CausalValidPlan(key_valid, scratch, S, q0, warp, lane);
                     });
}

// -- kernel B ------------------------------------------------------------------

constexpr int kKeysB = 32;                // keys per CTA
constexpr int kWarpsB = 4;                // warp w takes KV heads w, w + kWarpsB, ...
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kTilesB = kKeysB / 8;       // m16n8 score tiles across the CTA's keys

// c += a * b for one m16n8k16 bf16 tile, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__global__ void __launch_bounds__(kThreadsB)
attn_importance_rows_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                            const uint8_t* __restrict__ key_valid, const int64_t* __restrict__ rows,
                            const float* __restrict__ m, const float* __restrict__ l,
                            float* __restrict__ imp, int S, int Hq, int Hk, int num, float scale_log2,
                            float inv_norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* pos_s = reinterpret_cast<int*>(smem);         // (num,) capture-row positions, -1 absent
  float* ml2 = reinterpret_cast<float*>(pos_s + num);  // (num, Hq) m in log2 units
  float* inv_l = ml2 + num * Hq;                     // (num, Hq) 1 / l
  float* part = inv_l + num * Hq;                    // (kWarpsB, kKeysB) each warp's sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row group (the B operand's key)
  const int tq = lane & 3;  // thread within the group
  const int G = Hq / Hk;
  const int n_rows = num * G;  // capture (row, q-head) pairs of one KV head
  const int j0 = blockIdx.x * kKeysB;

  for (int r = tid; r < num; r += kThreadsB) pos_s[r] = static_cast<int>(rows[r]);
  __syncthreads();
  for (int idx = tid; idx < num * Hq; idx += kThreadsB) {
    const int row = pos_s[idx / Hq], h = idx % Hq;
    ml2[idx] = row >= 0 ? m[static_cast<size_t>(h) * S + row] * kLog2e : 0.f;
    inv_l[idx] = row >= 0 ? 1.f / l[static_cast<size_t>(h) * S + row] : 0.f;
  }
  __syncthreads();

  // This thread's keys in the epilogue: j0 + 8 nt + 2 tq + e.
  bool live[kTilesB][2];
#pragma unroll
  for (int nt = 0; nt < kTilesB; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + nt * 8 + 2 * tq + e;
      live[nt][e] = j < S && (key_valid == nullptr || key_valid[j]);
    }
  float acc[kTilesB][2] = {};  // summed over this thread's rows: m16 tiles in order, heads in order

  for (int hk = warp; hk < Hk; hk += kWarpsB) {
    // K as the B operand of each 16-dim k-step: key j0 + 8 nt + g, dims
    // 16 kk + 2 tq (+ 8), zero past S; every load issued before the products.
    uint32_t kb[kTilesB][kD / 16][2];
#pragma unroll
    for (int nt = 0; nt < kTilesB; ++nt) {
      const int j = j0 + nt * 8 + g;
      const uint16_t* kp = k + (static_cast<size_t>(j < S ? j : 0) * Hk + hk) * kD + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        kb[nt][kk][0] = j < S ? ld_u32(kp + kk * 16) : 0u;
        kb[nt][kk][1] = j < S ? ld_u32(kp + kk * 16 + 8) : 0u;
      }
    }
    for (int mt = 0; mt * 16 < n_rows; ++mt) {
      // Capture pair c = 16 mt + g (+ 8): row c / G's position, q-head hk G + c % G.
      int pos[2];
      float mrow[2], irow[2];
      const uint16_t* qp[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = mt * 16 + g + 8 * half;
        const int r = c / G, h = hk * G + c % G;
        pos[half] = c < n_rows ? pos_s[r] : -1;
        mrow[half] = pos[half] >= 0 ? ml2[r * Hq + h] : 0.f;
        irow[half] = pos[half] >= 0 ? inv_l[r * Hq + h] : 0.f;
        qp[half] = q + (static_cast<size_t>(pos[half] >= 0 ? pos[half] : 0) * Hq + h) * kD + 2 * tq;
      }
      uint32_t qa[kD / 16][4];  // the A operand: rows g and g + 8, dims 16 kk + 2 tq (+ 8)
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        qa[kk][0] = pos[0] >= 0 ? ld_u32(qp[0] + kk * 16) : 0u;
        qa[kk][1] = pos[1] >= 0 ? ld_u32(qp[1] + kk * 16) : 0u;
        qa[kk][2] = pos[0] >= 0 ? ld_u32(qp[0] + kk * 16 + 8) : 0u;
        qa[kk][3] = pos[1] >= 0 ? ld_u32(qp[1] + kk * 16 + 8) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < kTilesB; ++nt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};  // rows g (c[0], c[1]) and g + 8, keys 2 tq and 2 tq + 1
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) mma_16816(c, qa[kk], kb[nt][kk][0], kb[nt][kk][1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + 2 * tq + e;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (live[nt][e] && j <= pos[half])
              acc[nt][e] += fast_exp2(fmaf(c[2 * half + e], scale_log2, -mrow[half])) * irow[half];
        }
      }
    }
  }
  // The 8 row groups of a key, lanes 4, 8 and 16 apart: a fixed tree.
#pragma unroll
  for (int nt = 0; nt < kTilesB; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) acc[nt][e] += __shfl_xor_sync(0xffffffffu, acc[nt][e], off);
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < kTilesB; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) part[warp * kKeysB + nt * 8 + 2 * tq + e] = acc[nt][e];
  }
  __syncthreads();
  if (tid < kKeysB && j0 + tid < S) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsB; ++w) sum += part[w * kKeysB + tid];
    imp[j0 + tid] = sum * inv_norm;
  }
}

bool smem_set_a[64] = {};  // A's opt-in above 48 KB, per device

}  // namespace

// scale > 0 (1 / sqrt(128)). Returns cudaErrorInvalidValue for a shape the
// kernel does not take (Hq not a multiple of Hk, or S beyond the tile list
// that fits shared memory beside the ring).
extern "C" int ff_flash_attn_fwd(const void* q, const void* k, const void* v, const void* key_valid,
                                 void* out, void* m_out, void* l_out, int S, int Hq, int Hk,
                                 float scale, void* stream) {
  if (S <= 0 || Hk <= 0 || Hq % Hk != 0 || !(scale > 0.f) || smem_bytes_a(S) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_k, map_v;
  const int status = attn_fwd_setup(reinterpret_cast<const void*>(flash_attn_fwd_kernel), smem_set_a, &map_k,
                                    &map_v, k, v, S, Hk);
  if (status != 0) return status;
  const dim3 grid(Hq, (S + kBM - 1) / kBM);
  flash_attn_fwd_kernel<<<grid, kFwdThreads, smem_bytes_a(S), static_cast<cudaStream_t>(stream)>>>(
      map_k, map_v, static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(key_valid),
      static_cast<uint16_t*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), S, Hq, Hk,
      scale * kLog2e);  // exp(x) = exp2(x * log2(e))
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ff_attn_importance_rows_smem(int Hq, int num) {
  return num * 4 + num * Hq * 2 * 4 + kWarpsB * kKeysB * 4;
}

extern "C" int ff_attn_importance_rows(const void* q, const void* k, const void* key_valid,
                                       const void* rows, const void* m, const void* l, void* imp,
                                       int S, int Hq, int Hk, int num, float scale, void* stream) {
  if (S <= 0 || Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kKeysB - 1) / kKeysB);
  attn_importance_rows_kernel<<<grid, kThreadsB, ff_attn_importance_rows_smem(Hq, num),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint8_t*>(key_valid), static_cast<const int64_t*>(rows),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<float*>(imp),
      S, Hq, Hk, num, scale * kLog2e, 1.f / static_cast<float>(Hq * num));
  return static_cast<int>(cudaGetLastError());
}

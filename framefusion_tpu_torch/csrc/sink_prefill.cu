// Attention-sink (StreamingLLM) prefill attention for Hopper (sm_90a), bound
// through a plain C interface (ctypes).
//
// F. ff_sink_attn_fwd — query i of q-head h attends the keys
//    {j : j <= i and (j < init_num or j > i - window)} of KV head h / G
//    (HF repeat_kv order); `window` counts the query itself. Replaces the
//    Pallas kernel framefusion_tpu/ops/kernels/sink_prefill.py
//    (sink_flash_attention, _sink_kernel), which kept a head's whole K/V
//    resident in VMEM and walked the sink and window blocks of each 512-query
//    block. Here K/V stream through shared memory one 128-key tile at a time.
//
//    Bound on the card: tensor-core operations, 4 * 128 * Hq per (row, key it
//    sees): O(S * (init_num + window)), where causal attention (kernel A) is
//    O(S^2 / 2).
//
//    Design: kernel A's pipeline (flash_fwd.cuh: TMA ring of 128-key tiles,
//    wgmma for both products, two consumer warpgroups taking turns, softmax
//    in log2 units) with F's own tile plan and mask, and no m / l output.
//    * The plan of a CTA of 128 query rows [q0, q0 + 127] is arithmetic, with
//      nothing in shared memory: the sink tiles [0, n_sink), n_sink =
//      min(ceil(init_num / 128), diag + 1) where diag = q0 / 128 is the
//      block's diagonal tile, then the window tiles from
//      max(floor(max(q0 - window + 1, 0) / 128), n_sink) to diag. Each tile
//      is visited once, so a tile that is both a sink and a window tile
//      counts its keys once; every row sees itself, so no row's softmax is
//      empty.
//    * The mask: a warpgroup (64 rows, first wrow0, last wrow0 + 63) runs
//      the per-element test only on a tile that reaches past its first row
//      (the causal edge) or that starts before its last row's window start
//      and holds a key past the sinks (the window edge). Every other tile is
//      wholly visible to its 64 rows. Keys >= S arrive as zeros from the TMA
//      unit and fail the causal test.
//
// The entry point returns cudaGetLastError() after its launch.

#include "flash_fwd.cuh"

namespace {

struct SinkWindowPlan {
  int init_num, window;
  int n_sink;  // sink tiles, visited first
  int w_lo;    // the first window tile
  int n;       // tiles visited

  __device__ SinkWindowPlan(int init_num_, int window_, int q0) : init_num(init_num_), window(window_) {
    const int diag = q0 / kBN;
    n_sink = min((init_num + kBN - 1) / kBN, diag + 1);
    w_lo = max(max(q0 - window + 1, 0) / kBN, n_sink);
    n = n_sink + max(diag - w_lo + 1, 0);
  }

  __device__ int n_tiles() const { return n; }
  __device__ int tile(int i) const { return i < n_sink ? i : w_lo + (i - n_sink); }

  __device__ void mask(float (&s)[kBN / 2], int tile, int wrow0, int r0, int r1, int tq) const {
    const int n0 = tile * kBN;
    const bool causal_edge = n0 + kBN - 1 > wrow0;
    const bool window_edge = n0 < wrow0 + 64 - window && n0 + kBN > init_num;
    if (causal_edge || window_edge) {
#pragma unroll
      for (int x = 0; x < kBN / 2; ++x) {
        const int j = n0 + (x >> 2) * 8 + (x & 1) + 2 * tq;
        const int row = (x & 2) ? r1 : r0;
        if (j > row || (j >= init_num && j <= row - window)) s[x] = -INFINITY;
      }
    }
  }
};

__global__ void __launch_bounds__(kFwdThreads, 1)
sink_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const uint16_t* __restrict__ q, uint16_t* __restrict__ out, int S, int Hq, int Hk,
                     int init_num, int window, float scale_log2) {
  attn_fwd_cta<false>(map_k, map_v, q, out, nullptr, nullptr, S, Hq, Hk, scale_log2,
                      [=](uint8_t*, int q0, int, int) { return SinkWindowPlan(init_num, window, q0); });
}

bool smem_set_f[64] = {};  // the opt-in above 48 KB, per device

}  // namespace

// init_num >= 0, window >= 1, scale > 0 (1 / sqrt(128)); cudaErrorInvalidValue
// otherwise, or for Hq not a multiple of Hk.
extern "C" int ff_sink_attn_fwd(const void* q, const void* k, const void* v, void* out, int S, int Hq,
                                int Hk, int init_num, int window, float scale, void* stream) {
  if (S <= 0 || Hk <= 0 || Hq % Hk != 0 || init_num < 0 || window < 1 || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_k, map_v;
  const int status = attn_fwd_setup(reinterpret_cast<const void*>(sink_attn_fwd_kernel), smem_set_f, &map_k,
                                    &map_v, k, v, S, Hk);
  if (status != 0) return status;
  const dim3 grid(Hq, (S + kBM - 1) / kBM);
  // init_num and window past S change nothing; clamped, the plan's sums cannot overflow.
  sink_attn_fwd_kernel<<<grid, kFwdThreads, kRingSmem, static_cast<cudaStream_t>(stream)>>>(
      map_k, map_v, static_cast<const uint16_t*>(q), static_cast<uint16_t*>(out), S, Hq, Hk,
      init_num < S ? init_num : S, window < S ? window : S, scale * kLog2e);  // exp(x) = exp2(x * log2(e))
  return static_cast<int>(cudaGetLastError());
}

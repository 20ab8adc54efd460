// Throughput of wgmma in the operand modes and shared-memory layouts that
// kernel E (../bidir_attention.cu) can use: A from registers (RS) or shared
// memory (SS), B K-major or MN-major (transposed), no swizzle or 128-byte
// swizzle, N 64 or 72. Each warpgroup issues 8 products, commits, waits,
// 2,000 times, on constant operands; 132 x 2 CTAs of one or two
// warpgroups. Prints TFLOP/s per mode (dense bf16 peak: 989).
//
// Not part of the kernels' library (_build.py compiles csrc/*.cu only).
// On a card with the CUDA toolkit, from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -Iframefusion_tpu_torch/csrc -o wgmma_bench framefusion_tpu_torch/csrc/bench/wgmma_bench.cu
//   ./wgmma_bench
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include "wgmma_rs.cuh"
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}
struct SS64 {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int sc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),"+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),"+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),
        "+f"(d[16]),"+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),"+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),"+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31])
      : "l"(da), "l"(db), "r"(sc));
  }
};
// MODE 0: RS n64 K-major, no swizzle; 1: RS n64 K-major, 128-byte swizzle; 2: SS n64, no
// swizzle; 3: SS n64, 128-byte swizzle; 4: RS n72 MN-major, no swizzle; 5: RS n64 MN-major,
// 128-byte swizzle.
template <int MODE>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  extern __shared__ __align__(1024) uint8_t smem[];
  for (int i = threadIdx.x; i < 65536 / 16; i += blockDim.x) ((uint4*)smem)[i] = make_uint4(0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int wg = threadIdx.x >> 7;
  float d[36];
  for (int i = 0; i < 36; ++i) d[i] = 0.f;
  uint32_t a[4] = {0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u};
  const uint32_t b = base + wg * 16384;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (MODE == 0) WgmmaRS<64, 0>::run(d, a, desc(b + kk * 2048, 1024, 128, 0), 1);
      if (MODE == 1) WgmmaRS<64, 0>::run(d, a, desc(b + (kk & 3) * 32 + (kk >> 2) * 8192, 16, 1024, 1), 1);
      if (MODE == 2) SS64::run(d, desc(b + 32768 + kk * 2048, 1024, 128, 0), desc(b + kk * 2048, 1024, 128, 0), 1);
      if (MODE == 3) SS64::run(d, desc(b + 32768 + (kk & 3) * 32 + (kk >> 2) * 8192, 16, 1024, 1), desc(b + (kk & 3) * 32 + (kk >> 2) * 8192, 16, 1024, 1), 1);
      if (MODE == 4) WgmmaRS<72, 1>::run(d, a, desc(b + kk * 256, 128, 1024, 0), 1);
      if (MODE == 5) WgmmaRS<64, 1>::run(d, a, desc(b + kk * 2048, 16, 1024, 1), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int i = 0; i < 36; ++i) s += d[i];
  if (s == 123.f) out[threadIdx.x] = s;
}
template <int MODE>
void run(const char* name, int n_flop_n, int wgs, int ctas_per_sm) {
  float* out; cudaMalloc(&out, 4096);
  cudaFuncSetAttribute(bench<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536 + 32768);
  const int iters = 2000, blocks = 132 * ctas_per_sm;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  bench<MODE><<<blocks, 128 * wgs, 65536 + 32768>>>(out, 10);
  cudaEventRecord(e0);
  bench<MODE><<<blocks, 128 * wgs, 65536 + 32768>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double flop = 2.0 * 64 * n_flop_n * 16 * 8 * (double)iters * blocks * wgs;
  printf("%-28s wgs %d ctas/SM %d: %.1f TFLOP/s (%s)\n", name, wgs, ctas_per_sm, flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  for (int w = 1; w <= 2; ++w) {
    run<0>("RS n64 K-major no-swizzle", 64, w, 2);
    run<1>("RS n64 K-major SW128", 64, w, 2);
    run<2>("SS n64 no-swizzle", 64, w, 2);
    run<3>("SS n64 SW128", 64, w, 2);
    run<4>("RS n72 MN-major no-swizzle", 72, w, 2);
    run<5>("RS n64 MN-major SW128", 64, w, 2);
  }
  return 0;
}

// A TMA tensor map, encoded by cuTensorMapEncodeTiled, found through the
// runtime's entry-point query (the library links no libcuda): `rank` dims
// innermost first, the strides of the outer ones in bytes, boxes of
// `box` elements; elements outside the tensor arrive as zeros. Returns 0 or
// a cudaError_t.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle, CUtensorMapL2promotion l2) {
  using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

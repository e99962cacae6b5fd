// Stand-in for <cuda.h>, the driver API's types that a kernel's host code
// uses to describe a TMA load: CUtensorMap and the arguments of
// cuTensorMapEncodeTiled, whose stand-in emu_encode_tiled (reached through
// cudaGetDriverEntryPoint, as on the card) checks what the driver checks
// and records the map for hopper.cuh's tma_load stand-ins.
#pragma once
#include <cstdint>
#include <cstring>

typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef enum { CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 }
    CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B
} CUtensorMapSwizzle;
typedef enum {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
  CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_256B
} CUtensorMapL2promotion;
typedef enum {
  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0,  // zeros
  CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA
} CUtensorMapFloatOOBfill;

// the tensor, its box and its swizzle (the driver's map is opaque)
struct alignas(64) CUtensorMap {
  const char* base;
  int rank, elem, swizzle;
  uint64_t dims[5], strides[5];  // strides in bytes, strides[0] the element's
  uint32_t box[5];
};

// cuTensorMapEncodeTiled's checks (CUDA driver API reference): rank 1-5, a
// 16-byte aligned address, strides that are multiples of 16 bytes, box
// dimensions of 1-256 whose innermost spans a multiple of 16 bytes and at
// most the swizzle's width, element strides of 1 (all this emulation takes)
static CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType dtype, cuuint32_t rank,
                                 void* address, const cuuint64_t* dims,
                                 const cuuint64_t* strides, const cuuint32_t* box,
                                 const cuuint32_t* element_strides, CUtensorMapInterleave,
                                 CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill fill) {
  const int elem = dtype == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 4;
  const uint32_t span[] = {0, 32, 64, 128};
  if (rank < 1 || rank > 5 || reinterpret_cast<uintptr_t>(address) % 16 != 0 ||
      fill != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE || (box[0] * elem) % 16 != 0 ||
      (swizzle != CU_TENSOR_MAP_SWIZZLE_NONE && box[0] * elem > span[swizzle]))
    return CUDA_ERROR_INVALID_VALUE;
  std::memset(map, 0, sizeof *map);
  map->base = static_cast<const char*>(address);
  map->rank = rank;
  map->elem = elem;
  map->swizzle = swizzle;
  for (cuuint32_t d = 0; d < rank; ++d) {
    if (box[d] < 1 || box[d] > 256 || element_strides[d] != 1 || dims[d] < 1)
      return CUDA_ERROR_INVALID_VALUE;
    if (d > 0 && strides[d - 1] % 16 != 0) return CUDA_ERROR_INVALID_VALUE;
    map->dims[d] = dims[d];
    map->strides[d] = d == 0 ? elem : strides[d - 1];
    map->box[d] = box[d];
  }
  return CUDA_SUCCESS;
}
